"""Dequantization + inverse transforms, vectorized over blocks (NumPy
reference backend; device twins live in ops/gpu/).

Bit-exact semantics mirror h264bsd_transform.c: h264bsdProcessBlock :94
(inverse zig-zag + dequant + 4x4 integer IDCT, [-512,511] range rule),
h264bsdProcessLumaDc :252 (4x4 Hadamard + scaling), h264bsdProcessChromaDc
:356 (2x2 transform + scaling). All arithmetic is int32 with arithmetic
shifts; the reference's DC-only fast paths are mathematically identical to
the full path, so one vectorized path covers all blocks.
"""

from __future__ import annotations

import numpy as np

# scan position -> raster position (inverse zig-zag), 4x4
ZIGZAG_4x4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                      np.int32)

# levelScale[qp%6] classes: [0]: positions (0,0),(0,2),(2,0),(2,2);
# [2]: (1,1),(1,3),(3,1),(3,3); [1]: the rest (standard LevelScale4x4).
LEVEL_SCALE = np.array(
    [[10, 13, 16], [11, 14, 18], [13, 16, 20],
     [14, 18, 23], [16, 20, 25], [18, 23, 29]], np.int32)

# raster position -> levelScale class
_POS_CLASS = np.zeros(16, np.int32)
for _p in range(16):
    _y, _x = _p // 4, _p % 4
    if _y % 2 == 0 and _x % 2 == 0:
        _POS_CLASS[_p] = 0
    elif _y % 2 == 1 and _x % 2 == 1:
        _POS_CLASS[_p] = 2
    else:
        _POS_CLASS[_p] = 1

# chroma QP mapping (spec table 8-15 / h264bsdQpC)
QP_C = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30,
                 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38,
                 38, 39, 39, 39, 39], np.int32)


def dequant_idct(coeffs: np.ndarray, qp: np.ndarray,
                 dc: np.ndarray = None) -> np.ndarray:
    """coeffs: [N, 16] int32 scan-order levels; qp: [N]; dc: optional [N]
    pre-scaled DC values that REPLACE position 0 (Intra16x16 / chroma DC
    paths, already transformed+scaled). Returns [N, 4, 4] int32 residual.
    """
    coeffs = np.asarray(coeffs, np.int32)
    qp = np.asarray(qp, np.int32)
    n = coeffs.shape[0]
    qp_div = qp // 6
    scale = (LEVEL_SCALE[qp % 6][:, _POS_CLASS] << qp_div[:, None]).astype(
        np.int32)  # [N, 16] by raster position

    # inverse zig-zag: raster[ZIGZAG[s]] = scan[s]
    raster = np.zeros((n, 16), np.int32)
    raster[:, ZIGZAG_4x4] = coeffs
    d = raster * scale
    if dc is not None:
        d[:, 0] = dc

    d = d.reshape(n, 4, 4)
    # horizontal butterfly (rows)
    t0 = d[:, :, 0] + d[:, :, 2]
    t1 = d[:, :, 0] - d[:, :, 2]
    t2 = (d[:, :, 1] >> 1) - d[:, :, 3]
    t3 = d[:, :, 1] + (d[:, :, 3] >> 1)
    h = np.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], axis=2)
    # vertical butterfly (cols) + rounding
    t0 = h[:, 0] + h[:, 2]
    t1 = h[:, 0] - h[:, 2]
    t2 = (h[:, 1] >> 1) - h[:, 3]
    t3 = h[:, 1] + (h[:, 3] >> 1)
    out = np.stack([(t0 + t3 + 32) >> 6, (t1 + t2 + 32) >> 6,
                    (t1 - t2 + 32) >> 6, (t0 - t3 + 32) >> 6], axis=1)
    return out.astype(np.int32)


def luma_dc_transform(dc_scan: np.ndarray, qp: np.ndarray) -> np.ndarray:
    """Intra16x16 luma DC: [N, 16] scan-order -> [N, 4, 4] raster DC value
    per 4x4 block position (by, bx)."""
    dc_scan = np.asarray(dc_scan, np.int32)
    qp = np.asarray(qp, np.int32)
    n = dc_scan.shape[0]
    raster = np.zeros((n, 16), np.int32)
    raster[:, ZIGZAG_4x4] = dc_scan
    d = raster.reshape(n, 4, 4)
    # horizontal Hadamard
    t0 = d[:, :, 0] + d[:, :, 2]
    t1 = d[:, :, 0] - d[:, :, 2]
    t2 = d[:, :, 1] - d[:, :, 3]
    t3 = d[:, :, 1] + d[:, :, 3]
    h = np.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], axis=2)
    # vertical Hadamard
    t0 = h[:, 0] + h[:, 2]
    t1 = h[:, 0] - h[:, 2]
    t2 = h[:, 1] - h[:, 3]
    t3 = h[:, 1] + h[:, 3]
    v = np.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], axis=1)

    qp_div = qp // 6
    lev = LEVEL_SCALE[qp % 6, 0]
    hi = v * (lev << np.maximum(qp_div - 2, 0))[:, None, None]
    rnd = np.where(qp_div == 1, 1, 2)[:, None, None]
    shift = (2 - qp_div)[:, None, None]
    lo = (v * lev[:, None, None] + rnd) >> np.maximum(shift, 0)
    return np.where((qp >= 12)[:, None, None], hi, lo).astype(np.int32)


def chroma_dc_transform(dc: np.ndarray, qp: np.ndarray) -> np.ndarray:
    """Chroma DC 2x2: [N, 4] (raster a b c d) -> [N, 4] transformed DC per
    chroma block (cy*2+cx). qp is the chroma QP."""
    dc = np.asarray(dc, np.int32)
    qp = np.asarray(qp, np.int32)
    a, b, c, d = dc[:, 0], dc[:, 1], dc[:, 2], dc[:, 3]
    t0, t1 = a + c, a - c
    t2, t3 = b - d, b + d
    v = np.stack([t0 + t3, t0 - t3, t1 + t2, t1 - t2], axis=1)
    qp_div = qp // 6
    lev = LEVEL_SCALE[qp % 6, 0]
    hi = v * (lev << np.maximum(qp_div - 1, 0))[:, None]
    lo = (v * lev[:, None]) >> 1
    return np.where((qp >= 6)[:, None], hi, lo).astype(np.int32)
