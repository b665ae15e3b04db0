"""K2 (intra) and K3 (deblock): wrappers of ``csrc/intra.cu`` and
``csrc/deblock.cu``.

Replace the Pallas kernels of ``broadway_tpu/ops/tpu/wavefront_pallas.py``
(``_intra_kernel`` via ``intra_wavefront``, ``_db_kernel`` via
``deblock_wavefront``). Both work in place on raster uint8 planes,
without the TPU's diagonal-major packing (``WavefrontLayout``) or its
one-hot MXU transposes: ONE persistent kernel launch per picture on the
current stream, one CUDA block per MB row, rows kept in x + 2y order by
per-row progress counters (``csrc/wavefront.cuh``). The counters are a
small int32 workspace that this module owns per device and stream.

Each wrapper takes the plain version (ops/gpu/intra.py, deblock.py) for
CPU tensors and launches the kernel for CUDA tensors; ``launches``
counts the wrapper calls that launched the kernel. The launch is
cooperative: if the card refuses it, the wrapper raises, and never goes
back to per-diagonal launches or to the plain version.
"""

from __future__ import annotations

import torch

from . import _build
from .deblock import N_PARAMS as DB_PARAMS, deblock_wavefront_plain
from .intra import N_PARAMS as IN_PARAMS, intra_wavefront_plain
from .tables import tables


INTRA, DEBLOCK, PROBE = 0, 1, 2      # bwwf::Which of csrc/wavefront.cuh

_progress = {}      # (device index, stream) -> int32 [rows] counters


def _check_planes(Y, C, w_mbs, h_mbs):
    dev = Y.device
    _build.check_tensor(Y, "Y", torch.uint8, (16 * h_mbs, 16 * w_mbs), dev)
    _build.check_tensor(C, "C", torch.uint8, (2, 8 * h_mbs, 8 * w_mbs), dev)
    if Y.data_ptr() % 4 or C.data_ptr() % 4:
        raise ValueError("Y and C must be 4-byte aligned (the kernels move "
                         "32-bit words)")


def _workspace(dev: torch.device, stream: int, h_mbs: int) -> torch.Tensor:
    """The progress counters for launches on (dev, stream): kernels on one
    stream run one after the other, so they share one workspace."""
    key = (dev.index, stream)
    ws = _progress.get(key)
    if ws is None or ws.numel() < h_mbs:
        ws = torch.zeros(max(h_mbs, 256), dtype=torch.int32, device=dev)
        _progress[key] = ws
    return ws


def device_launches(which: int, reset: bool = False) -> int:
    """Kernel launches made so far by wavefront `which` (INTRA, DEBLOCK,
    PROBE), as counted next to the launch in csrc/wavefront.cuh."""
    return _build.load().bw_wavefront_device_launches(which, int(reset))


def last_grid(which: int) -> int:
    """CTAs in the newest launch of wavefront `which`."""
    return _build.load().bw_wavefront_last_grid(which)


def set_max_ctas(n: int) -> int:
    """For tests only: cap every wavefront launch at n CTAs (0 lifts the
    cap) so that a small picture drives the more-rows-than-CTAs stride;
    returns the previous cap. The cap is process-wide and not
    thread-safe: no decoding path calls this."""
    return _build.load().bw_wavefront_set_max_ctas(n)


def handoff_probe(w_mbs: int, h_mbs: int, device) -> None:
    """Launch the wavefront scaffold with an empty MB body over a
    w_mbs x h_mbs grid: w + 2 (h - 1) dependent hand-offs and nothing
    else (the dependency floor of K2 and K3 on this card)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("handoff_probe runs on a CUDA device only")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace(dev, stream, h_mbs)
    err = _build.load().bw_handoff_probe(ws.data_ptr(), w_mbs, h_mbs, stream)
    _build.check(err, "bw_handoff_probe")


def intra_wavefront(Y: torch.Tensor, C: torch.Tensor, RY: torch.Tensor,
                    RC: torch.Tensor, P: torch.Tensor, w_mbs: int,
                    h_mbs: int) -> None:
    """Intra reconstruction in place. Y [H, W] u8 and C [2, H/2, W/2] u8
    hold the base planes; RY [n, 16, 16] and RC [n, 2, 8, 8] int32
    residuals; P [n, 32] int32 from ``intra.intra_params``."""
    if Y.device.type == "cpu":
        intra_wavefront_plain(Y, C, RY, RC, P, w_mbs, h_mbs)
        return
    if Y.device.type != "cuda":
        raise ValueError(f"intra_wavefront: unsupported device {Y.device}")
    n = w_mbs * h_mbs
    dev = Y.device
    _check_planes(Y, C, w_mbs, h_mbs)
    _build.check_tensor(RY, "RY", torch.int32, (n, 16, 16), dev)
    _build.check_tensor(RC, "RC", torch.int32, (n, 2, 8, 8), dev)
    _build.check_tensor(P, "P", torch.int32, (n, IN_PARAMS), dev)
    tab = tables(dev)["I4_KERNEL"]
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace(dev, stream, h_mbs)
    err = lib.bw_intra_wavefront(
        Y.data_ptr(), C.data_ptr(), RY.data_ptr(), RC.data_ptr(),
        P.data_ptr(), tab.data_ptr(), ws.data_ptr(), w_mbs, h_mbs, stream)
    _build.check(err, "bw_intra_wavefront")
    intra_wavefront.launches += 1


def deblock_wavefront(Y: torch.Tensor, C: torch.Tensor, P: torch.Tensor,
                      w_mbs: int, h_mbs: int) -> None:
    """Deblocking in place. Y [H, W] u8, C [2, H/2, W/2] u8, P [n, 64]
    int32 from ``deblock.deblock_params``."""
    if Y.device.type == "cpu":
        deblock_wavefront_plain(Y, C, P, w_mbs, h_mbs)
        return
    if Y.device.type != "cuda":
        raise ValueError(f"deblock_wavefront: unsupported device {Y.device}")
    n = w_mbs * h_mbs
    dev = Y.device
    _check_planes(Y, C, w_mbs, h_mbs)
    _build.check_tensor(P, "P", torch.int32, (n, DB_PARAMS), dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace(dev, stream, h_mbs)
    err = lib.bw_deblock_wavefront(
        Y.data_ptr(), C.data_ptr(), P.data_ptr(), ws.data_ptr(), w_mbs, h_mbs,
        stream)
    _build.check(err, "bw_deblock_wavefront")
    deblock_wavefront.launches += 1


intra_wavefront.launches = 0
deblock_wavefront.launches = 0
