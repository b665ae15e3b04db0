"""Every constant table of the decode pipeline as a torch tensor.

Sources: the port's ``ops.transform`` (LEVEL_SCALE, QP_C, ZIGZAG_4x4,
_POS_CLASS) and ``core.deblock_impl`` (ALPHAS, BETAS, TC0). The Intra4x4
tap tables (IDX/COEF/RND/SHIFT), BLK_ORDER and NO_UPRIGHT of
``broadway_tpu.ops.tpu.intra`` are re-derived here in numpy; tests pin
them equal.

``tables(device)`` builds the tensors once per device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ...core.deblock_impl import ALPHAS, BETAS, TC0
from ..transform import LEVEL_SCALE, QP_C, ZIGZAG_4x4, \
    _POS_CLASS

# ---------------------------------------------------------------------------
# Intra4x4 3-tap tables: pixel(mode, y, x) = (sum c_k * v[i_k] + rnd) >> shift
# v layout: v[0] = upleft, v[1+i] = up_i (i 0..7), v[9+i] = left_i (i 0..3).
# Mode 2 (DC) depends on availability and is computed separately.
# ---------------------------------------------------------------------------

N_MODES = 9


def _u(i):      # up pel index in v (i == -1 is the up-left pel)
    return 0 if i < 0 else 1 + i


def _l(i):      # left pel index in v (i == -1 is the up-left pel)
    return 0 if i < 0 else 9 + i


def _i4_taps(m: int, y: int, x: int):
    """(taps [(v index, coef)], rnd, shift) of Intra4x4 mode m at (y, x)."""
    if m == 0:                                          # vertical
        return [(_u(x), 1)], 0, 0
    if m == 1:                                          # horizontal
        return [(_l(y), 1)], 0, 0
    if m == 2:                                          # DC: not a tap sum
        return [], 0, 0
    if m == 3:                                          # diagonal down-left
        i = x + y
        if i == 6:
            return [(_u(6), 1), (_u(7), 3)], 2, 2
        return [(_u(i), 1), (_u(i + 1), 2), (_u(i + 2), 1)], 2, 2
    if m == 4:                                          # diagonal down-right
        if x > y:
            i = x - y
            return [(_u(i - 2), 1), (_u(i - 1), 2), (_u(i), 1)], 2, 2
        if x < y:
            i = y - x
            return [(_l(i - 2), 1), (_l(i - 1), 2), (_l(i), 1)], 2, 2
        return [(_u(0), 1), (0, 2), (_l(0), 1)], 2, 2
    if m == 5:                                          # vertical-right
        zv, i = 2 * x - y, x - (y >> 1)
        if zv >= 0 and zv % 2 == 0:
            return [(_u(i - 1), 1), (_u(i), 1)], 1, 1
        if zv >= 0:
            return [(_u(i - 2), 1), (_u(i - 1), 2), (_u(i), 1)], 2, 2
        if zv == -1:
            return [(_l(0), 1), (0, 2), (_u(0), 1)], 2, 2
        k = y - 2 * x
        return [(_l(k - 1), 1), (_l(k - 2), 2), (_l(k - 3), 1)], 2, 2
    if m == 6:                                          # horizontal-down
        zh, i = 2 * y - x, y - (x >> 1)
        if zh >= 0 and zh % 2 == 0:
            return [(_l(i - 1), 1), (_l(i), 1)], 1, 1
        if zh >= 0:
            return [(_l(i - 2), 1), (_l(i - 1), 2), (_l(i), 1)], 2, 2
        if zh == -1:
            return [(_u(0), 1), (0, 2), (_l(0), 1)], 2, 2
        k = x - 2 * y
        return [(_u(k - 1), 1), (_u(k - 2), 2), (_u(k - 3), 1)], 2, 2
    if m == 7:                                          # vertical-left
        i = x + (y >> 1)
        if y % 2 == 0:
            return [(_u(i), 1), (_u(i + 1), 1)], 1, 1
        return [(_u(i), 1), (_u(i + 1), 2), (_u(i + 2), 1)], 2, 2
    zv, i = x + 2 * y, y + (x >> 1)                     # 8: horizontal-up
    if zv <= 4 and zv % 2 == 0:
        return [(_l(i), 1), (_l(i + 1), 1)], 1, 1
    if zv <= 4:
        return [(_l(i), 1), (_l(i + 1), 2), (_l(i + 2), 1)], 2, 2
    if zv == 5:
        return [(_l(2), 1), (_l(3), 3)], 2, 2
    return [(_l(3), 1)], 0, 0


def _build_i4_tables():
    idx = np.zeros((N_MODES, 4, 4, 3), np.int32)
    coef = np.zeros((N_MODES, 4, 4, 3), np.int32)
    rnd = np.zeros((N_MODES, 4, 4), np.int32)
    shift = np.zeros((N_MODES, 4, 4), np.int32)
    for m in range(N_MODES):
        for y in range(4):
            for x in range(4):
                taps, r, s = _i4_taps(m, y, x)
                for k, (i, c) in enumerate(taps):
                    idx[m, y, x, k] = i
                    coef[m, y, x, k] = c
                rnd[m, y, x] = r
                shift[m, y, x] = s
    return idx, coef, rnd, shift


I4_IDX, I4_COEF, I4_RND, I4_SHIFT = _build_i4_tables()

# blocks (bx, by) with no up-right inside the MB (z-order decode)
NO_UPRIGHT = {(1, 1), (3, 1), (1, 3), (3, 2), (3, 3)}
# z-order Intra4x4 block list as (bx, by)
BLK_ORDER = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
             (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3)]
# raster block index of the z-th block
Z_PERM = np.array([by * 4 + bx for bx, by in BLK_ORDER], np.int32)
# up-right availability code of the z-th block: 0 = MB B's, 1 = MB C's,
# 2 = inside the MB (available), 3 = never available
AVUR_CODE = np.array(
    [(0 if bx < 3 else 1) if by == 0 else
     (3 if (bx, by) in NO_UPRIGHT else 2) for bx, by in BLK_ORDER],
    np.int32)

# raster position -> zig-zag scan position
INV_ZZ = np.zeros(16, np.int32)
INV_ZZ[ZIGZAG_4x4] = np.arange(16, dtype=np.int32)


def i4_kernel_table() -> np.ndarray:
    """The Intra4x4 tables flattened for the CUDA intra kernel:
    [9*16, 8] int32 rows (idx0..2, coef0..2, rnd, shift) per (mode, y, x),
    then 16 rows (bx, by, avur_code, 0...) per z-order block."""
    taps = np.concatenate(
        [I4_IDX.reshape(-1, 3), I4_COEF.reshape(-1, 3),
         I4_RND.reshape(-1, 1), I4_SHIFT.reshape(-1, 1)], axis=1)
    blk = np.zeros((16, 8), np.int32)
    blk[:, 0] = [bx for bx, _ in BLK_ORDER]
    blk[:, 1] = [by for _, by in BLK_ORDER]
    blk[:, 2] = AVUR_CODE
    return np.ascontiguousarray(np.concatenate([taps, blk]), np.int32)


_NUMPY = {
    "LEVEL_SCALE": LEVEL_SCALE, "POS_CLASS": _POS_CLASS, "QP_C": QP_C,
    "ZIGZAG": ZIGZAG_4x4, "INV_ZZ": INV_ZZ,
    "ALPHAS": ALPHAS, "BETAS": BETAS, "TC0": TC0,
    "I4_IDX": I4_IDX, "I4_COEF": I4_COEF, "I4_RND": I4_RND,
    "I4_SHIFT": I4_SHIFT, "Z_PERM": Z_PERM, "AVUR_CODE": AVUR_CODE,
    "I4_KERNEL": i4_kernel_table(),
}

_CACHE: Dict[torch.device, Dict[str, torch.Tensor]] = {}
_DIAG_CACHE: Dict[tuple, list] = {}


def _norm(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def diagonals(w_mbs: int, h_mbs: int, device) -> List[Tuple[
        torch.Tensor, torch.Tensor]]:
    """The x + 2y anti-diagonals of a w x h MB grid in wavefront order:
    S = (w-1) + 2(h-1) + 1 pairs (ys, xs) of int64 index tensors on
    `device`. An MB depends on its A/B/C/D neighbours only, all on
    earlier diagonals, so the MBs of one diagonal are independent."""
    device = _norm(device)
    key = (w_mbs, h_mbs, device)
    if key not in _DIAG_CACHE:
        out = []
        for d in range(w_mbs - 1 + 2 * (h_mbs - 1) + 1):
            ys = np.arange(max(0, (d - w_mbs + 2) // 2),
                           min(h_mbs - 1, d // 2) + 1)
            out.append((torch.as_tensor(ys, device=device),
                        torch.as_tensor(d - 2 * ys, device=device)))
        _DIAG_CACHE[key] = out
    return _DIAG_CACHE[key]


def tables(device) -> Dict[str, torch.Tensor]:
    """All tables as int32 tensors on `device` (built once per device)."""
    device = _norm(device)
    if device not in _CACHE:
        _CACHE[device] = {
            k: torch.as_tensor(np.ascontiguousarray(v, np.int32),
                               device=device)
            for k, v in _NUMPY.items()}
    return _CACHE[device]
