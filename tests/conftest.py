import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_DIR = os.path.join(REPO, "build", "oracle")

sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

# Multi-chip sharding tests run on a virtual CPU mesh; the real-TPU bench
# path sets its own flags. Must be set before jax import anywhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(REPO, "build", "jaxcache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault(
    "XLA_FLAGS",
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
)

try:    # env-var cache config is unreliable here; set it explicitly
    from broadway_tpu.utils.cache import ensure_compile_cache
    ensure_compile_cache()
except Exception:
    pass


def _ensure_oracle():
    dectest = os.path.join(ORACLE_DIR, "dectest")
    harness = os.path.join(ORACLE_DIR, "harness")
    if not (os.path.exists(dectest) and os.path.exists(harness)):
        subprocess.run([os.path.join(REPO, "tools", "build_oracle.sh")],
                       check=True, capture_output=True)
    return dectest, harness


@pytest.fixture(scope="session")
def oracle_dectest():
    return _ensure_oracle()[0]


@pytest.fixture(scope="session")
def oracle_harness_bin():
    return _ensure_oracle()[1]


class HarnessProc:
    """Line-oriented driver for build/oracle/harness."""

    def __init__(self, path):
        self.proc = subprocess.Popen(
            [path], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def ask(self, line: str) -> str:
        self.proc.stdin.write(line.rstrip("\n") + "\n")
        self.proc.stdin.flush()
        return self.proc.stdout.readline().strip()

    def cavlc(self, nc: int, max_coeffs: int, data: bytes):
        """Returns (total_coeff, consumed_bits, coeffs[16]) or None on error."""
        resp = self.ask(f"cavlc {nc} {max_coeffs} {data.hex()}")
        if not resp.startswith("ok"):
            return None
        parts = resp.split()
        return int(parts[1]), int(parts[2]), [int(x) for x in parts[3:19]]

    def close(self):
        self.proc.stdin.close()
        self.proc.wait(timeout=5)


@pytest.fixture(scope="session")
def harness(oracle_harness_bin):
    h = HarnessProc(oracle_harness_bin)
    yield h
    h.close()


def run_oracle(dectest, stream_path, out_path, extra_args=()):
    """Run the reference decoder testbench on an Annex-B stream; returns
    the decoded YUV bytes."""
    cwd = os.path.dirname(out_path)
    r = subprocess.run(
        [dectest, f"-O{out_path}", *extra_args, stream_path],
        cwd=cwd, capture_output=True, text=True, timeout=120)
    if not os.path.exists(out_path):
        raise RuntimeError(
            f"oracle produced no output: {r.stdout}\n{r.stderr}")
    with open(out_path, "rb") as f:
        return f.read(), r.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the torch port's hand-written "
        "kernels); skips without one")
