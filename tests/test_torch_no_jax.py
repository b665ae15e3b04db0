"""The torch port never imports JAX nor anything of the JAX package
(``broadway_tpu``): not at import, not while making a stream, not while
decoding, and chip_smoke.py neither. Checked in fresh interpreters, so
nothing a test process imported earlier can hide an import."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DECODE_NO_JAX = r"""
import importlib, pkgutil, sys
sys.path.insert(0, %(repo)r)
import broadway_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(broadway_tpu_torch.__path__,
                                              "broadway_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.tools import streams
data, _ = streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3,
                               seed=3, deblock=True)
for kw in ({}, {"recon": "numpy"}, {"frontend": "python"}):
    outs = Decoder(device="cpu", **kw).decode_annexb(data)
    assert len(outs) == 3 and all(
        len(o.frame.tobytes()) == 64 * 48 * 3 // 2 for o in outs)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "broadway_tpu"))
assert not bad, bad
print("NO-JAX-OK", len(mods))
"""


def _run(code, cwd=REPO, env_extra=None):
    env = dict(os.environ)
    env.pop("BW_FRONTEND", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_port_imports_and_decodes_without_jax():
    r = _run(["-c", _DECODE_NO_JAX % {"repo": REPO}])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "NO-JAX-OK" in r.stdout


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "broadway_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_statement(path):
    """No `import`/`from` of jax, jaxlib or broadway_tpu (the name not
    followed by `_torch`), at any indentation."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|broadway_tpu)"
                     r"(?![A-Za-z0-9_])")
    with open(path) as f:
        hits = [ln for ln in f if bad.match(ln)]
    assert not hits, hits


def test_cuda_decoder_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the refusal is for hosts "
                    "without it")
    from broadway_tpu_torch.core.decoder import Decoder
    with pytest.raises(RuntimeError, match="CUDA"):
        Decoder(device="cuda")


def test_chip_smoke_fails_without_cuda():
    r = _run(["chip_smoke.py"], env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
