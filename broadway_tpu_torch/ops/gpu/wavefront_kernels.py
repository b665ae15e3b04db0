"""K2 (intra) and K3 (deblock): wrappers of ``csrc/intra.cu`` and
``csrc/deblock.cu``.

Replace the Pallas kernels of ``broadway_tpu/ops/tpu/wavefront_pallas.py``
(``_intra_kernel`` via ``intra_wavefront``, ``_db_kernel`` via
``deblock_wavefront``). Both work in place on raster uint8 planes,
without the TPU's diagonal-major packing (``WavefrontLayout``) or its
one-hot MXU transposes: one kernel launch per x + 2y diagonal on the
current stream, one CUDA block per MB.

Each wrapper takes the plain version (ops/gpu/intra.py, deblock.py) for
CPU tensors and launches the kernel for CUDA tensors; ``launches``
counts the wrapper calls that ran the kernel (each is S per-diagonal
launches).
"""

from __future__ import annotations

import torch

from . import _build
from .deblock import N_PARAMS as DB_PARAMS, deblock_wavefront_plain
from .intra import N_PARAMS as IN_PARAMS, intra_wavefront_plain
from .tables import tables


def _check_planes(Y, C, w_mbs, h_mbs):
    dev = Y.device
    _build.check_tensor(Y, "Y", torch.uint8, (16 * h_mbs, 16 * w_mbs), dev)
    _build.check_tensor(C, "C", torch.uint8, (2, 8 * h_mbs, 8 * w_mbs), dev)


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
    err = lib.bw_intra_wavefront(
        Y.data_ptr(), C.data_ptr(), RY.data_ptr(), RC.data_ptr(),
        P.data_ptr(), tab.data_ptr(), w_mbs, h_mbs,
        torch.cuda.current_stream(dev).cuda_stream)
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
    err = lib.bw_deblock_wavefront(
        Y.data_ptr(), C.data_ptr(), P.data_ptr(), w_mbs, h_mbs,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bw_deblock_wavefront")
    deblock_wavefront.launches += 1


intra_wavefront.launches = 0
deblock_wavefront.launches = 0
