"""Build and load the port's CUDA kernels (``broadway_tpu_torch/csrc``).

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper
(``sm_90a``) into one shared library with a plain C interface under
``build/torch_kernels/`` of the repository, named by a hash of the
sources and flags, and ``ctypes`` loads it. No PyTorch headers are
compiled, so a build takes seconds. A failed build or load raises with
the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes as ct
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ct.c_void_p, ct.c_int
# exported C functions: name -> argtypes (all return cudaError_t as int)
SIGNATURES = {
    # ref_y, ref_c, mv, ref_blk, pred_y, pred_c, n, w_mbs, h_mbs, R, stream
    "bw_mc_predict": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # Y, C, RY, RC, P, table, w_mbs, h_mbs, stream
    "bw_intra_wavefront": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # Y, C, P, w_mbs, h_mbs, stream
    "bw_deblock_wavefront": [_P, _P, _P, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of broadway_tpu_torch cannot be built")


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources():
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libbw_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}"
                           f"\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ct.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ct.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ct.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` on
    `device` (what a kernel's raw pointer arguments assume)."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
