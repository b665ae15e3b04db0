"""K1: quarter-pel motion compensation, wrapper of ``csrc/mc.cu``.

Replaces the Pallas MC kernel ``broadway_tpu/ops/tpu/mc_pallas.py``
(``_mc_kernel``, called from ``mc_predict``) and its host/device side
tables (``mc_tables_dev``: DMA modes, slab origins, one-hot gather
targets), which exist only to feed TPU DMAs; here each thread computes
its own addresses.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .inter import mc_predict_plain


def mc_predict(ref_y: torch.Tensor, ref_c: torch.Tensor, mv: torch.Tensor,
               ref_blk: torch.Tensor, w_mbs: int, h_mbs: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-picture MC. ref_y [R, H, W] u8, ref_c [R, 2, H/2, W/2] u8,
    mv [n, 4, 4, 2] i32 (x, y quarter-pel), ref_blk [n, 4, 4] i32 (stack
    slot, -1 on intra MBs). Returns pred_y [n, 16, 16] i32 and pred_c
    [n, 8, 16] i32 (lane 2k = cb column k, 2k+1 = cr column k).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if ref_y.device.type == "cpu":
        return mc_predict_plain(ref_y, ref_c, mv, ref_blk, w_mbs, h_mbs)
    if ref_y.device.type != "cuda":
        raise ValueError(f"mc_predict: unsupported device {ref_y.device}")
    dev = ref_y.device
    R, H, W = ref_y.shape
    n = w_mbs * h_mbs
    if (H, W) != (16 * h_mbs, 16 * w_mbs) or R < 1:
        raise ValueError(f"ref_y shape {tuple(ref_y.shape)} does not fit "
                         f"{w_mbs}x{h_mbs} MBs")
    _build.check_tensor(ref_y, "ref_y", torch.uint8, (R, H, W), dev)
    _build.check_tensor(ref_c, "ref_c", torch.uint8,
                        (R, 2, H // 2, W // 2), dev)
    _build.check_tensor(mv, "mv", torch.int32, (n, 4, 4, 2), dev)
    _build.check_tensor(ref_blk, "ref_blk", torch.int32, (n, 4, 4), dev)
    lib = _build.load()
    pred_y = torch.empty((n, 16, 16), dtype=torch.int32, device=dev)
    pred_c = torch.empty((n, 8, 16), dtype=torch.int32, device=dev)
    err = lib.bw_mc_predict(
        ref_y.data_ptr(), ref_c.data_ptr(), mv.data_ptr(),
        ref_blk.data_ptr(), pred_y.data_ptr(), pred_c.data_ptr(),
        n, w_mbs, h_mbs, R, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bw_mc_predict")
    mc_predict.launches += 1
    return pred_y, pred_c


mc_predict.launches = 0
