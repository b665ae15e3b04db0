"""Build and load the port's two native libraries from
``broadway_tpu_torch/csrc`` into ``build/torch_kernels/`` of the
repository.

* The CUDA kernel library: ``nvcc`` compiles every ``csrc/*.cu`` for
  Hopper (``sm_90a``), one process per source, all started together,
  and links the objects into one shared library with a plain C
  interface that ``ctypes`` loads. No PyTorch headers are compiled, so
  a build takes seconds.
* The host front-end library (slice-data parser and v2 packer,
  ``csrc/frontend.cpp`` + ``csrc/tables.inc``): ``g++`` into a second
  shared library, loaded by ``bitstream/native.py``.

Each library is named by a hash of its own sources and flags, and is
built at first use. A failed build or load raises with the compiler's
output; nothing falls back.
"""

from __future__ import annotations

import contextlib
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
              "-O3", "-Xcompiler", "-fPIC"]
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
FRONTEND_SOURCES = ("frontend.cpp", "tables.inc")

_P, _I = ct.c_void_p, ct.c_int
# exported C functions: name -> argtypes (the kernels return cudaError_t
# as int, the bw_wavefront_* helpers plain counts)
SIGNATURES = {
    # ref_y, ref_c, mv, ref_blk, pred_y, pred_c, stack_base (or null), n,
    # w_mbs, h_mbs, R (planes per picture), S (planes in the stacks), mb0
    # (the band's raster offset), ref_h_mbs (the references' MB rows), stream
    "bw_mc_predict": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _P],
    # n MBs -> CTAs of K1's launch; -> threads per CTA
    "bw_mc_ctas": [_I],
    "bw_mc_threads": [],
    # ctas, threads, stream: an empty kernel of that grid and block
    "bw_launch_probe": [_I, _I, _P],
    # cycles, stream: one thread spinning, to queue launches up behind
    "bw_hold_stream": [ct.c_longlong, _P],
    # Y, C, RY, RC, P, table, progress, w_mbs, h_mbs, batch, stream
    "bw_intra_wavefront": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # Y, C, P, progress, skip (per picture, or null), w_mbs, h_mbs, batch,
    # stream
    "bw_deblock_wavefront": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # progress, w_mbs, h_mbs, batch, stream: the wavefront scaffold, empty
    # MB body
    "bw_handoff_probe": [_P, _I, _I, _I, _P],
    # n -> previous cap on the CTAs of a wavefront launch (0: none)
    "bw_wavefront_set_max_ctas": [_I],
    # which (0 intra, 1 deblock, 2 probe), reset -> kernel launches so far
    "bw_wavefront_device_launches": [_I, _I],
    # which -> launches that stream captures on this thread recorded since
    # the last call (zeroed by the read)
    "bw_wavefront_take_captured": [_I],
    # which, n -> 0: n launches added to the count (a graph replay's)
    "bw_wavefront_add_launches": [_I, _I],
    # which -> CTAs of the newest launch
    "bw_wavefront_last_grid": [_I],
    # which -> CTAs that could be resident at once, at the newest launch
    "bw_wavefront_last_resident": [_I],
}

_lock = threading.Lock()
_lib = None
_capture = threading.local()     # .tally while this thread captures a graph
# the wrappers' launch counts: a thread switch may not split an increment
# (a pumped decoder, or decoders on several threads, launch at once)
_count_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of broadway_tpu_torch cannot be built")


def _cxx() -> str:
    """The host C++ compiler: $CXX if set, else g++ on the PATH."""
    want = os.environ.get("CXX") or "g++"
    found = shutil.which(want)
    if not found:
        raise RuntimeError(f"C++ compiler {want!r} not found (set CXX); the "
                           "native front end of broadway_tpu_torch cannot "
                           "be built")
    return found


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _hashed(stem: str, flags, paths) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for s in paths:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def library_path() -> str:
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return _hashed("libbw_kernels", NVCC_FLAGS, sources() + headers)


def frontend_library_path() -> str:
    return _hashed("libbw_frontend", CXX_FLAGS,
                   [os.path.join(CSRC, s) for s in FRONTEND_SOURCES])


def _fail(tool: str, cmd, rc: int, out: str, err: str) -> RuntimeError:
    return RuntimeError(f"{tool} failed ({rc}):\n{' '.join(cmd)}"
                        f"\n{out}\n{err}")


def build() -> str:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.path.basename(out)}.{os.getpid()}"
    jobs = []
    for s in sources():
        obj = os.path.join(BUILD_DIR, f"{tag}.{os.path.basename(s)}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, s]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objs, failed, log = [], None, []
    for cmd, obj, p in jobs:
        so, se = p.communicate()
        log.append(se)
        if p.returncode != 0 and failed is None:
            failed = _fail("nvcc", cmd, p.returncode, so, se)
        objs.append(obj)
    try:
        if failed is not None:
            raise failed
        tmp = os.path.join(BUILD_DIR, f"{tag}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise _fail("nvcc", cmd, r.returncode, r.stdout, r.stderr)
        with open(out + ".ptxas.txt", "w") as f:
            f.write("\n".join(log))
        os.replace(tmp, out)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return out


def build_frontend() -> str:
    """Compile csrc/frontend.cpp unless its library exists."""
    out = frontend_library_path()
    if os.path.exists(out):
        return out
    cxx = _cxx()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, os.path.join(CSRC, "frontend.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise _fail(cxx, cmd, r.returncode, r.stdout, r.stderr)
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


def count_launch(wrapper) -> None:
    """One launch of `wrapper`'s kernel. Added to ``wrapper.launches`` when
    the kernel runs now; while this thread captures a CUDA graph
    (``recorded_launches``) the launch is only recorded, and goes into the
    graph's tally instead, which ``core.graphs.GroupGraph`` adds to
    ``wrapper.launches`` at every replay."""
    tally = getattr(_capture, "tally", None)
    if tally is None:
        add_launches(wrapper, 1)
    else:
        tally[wrapper] = tally.get(wrapper, 0) + 1


def add_launches(wrapper, n: int) -> None:
    """n launches of `wrapper`'s kernel that ran (one launch, or a graph
    replay's), added to ``wrapper.launches`` under a lock."""
    with _count_lock:
        wrapper.launches += n


@contextlib.contextmanager
def recorded_launches():
    """Around a stream capture on this thread: yields the tally
    {wrapper: launches recorded} that ``count_launch`` fills meanwhile."""
    if getattr(_capture, "tally", None) is not None:
        raise RuntimeError("a graph capture is already under way on this "
                           "thread")
    _capture.tally = {}
    try:
        yield _capture.tally
    finally:
        _capture.tally = None
