"""Inter prediction: quarter-pel luma MC (6-tap) + eighth-pel chroma
bilinear (NumPy reference backend).

Reference: h264bsd_reconstruct.c — 15 fractional luma positions
(lumaFracPos :73, h264bsdPredictSamples :1819), 6-tap (1,-5,20,20,-5,1)
half-pel filters :491-1817, bilinear chroma :110-416, out-of-picture
references by clamped edge extension (h264bsdFillBlock :2222, here index
clamping — identical results).
"""

from __future__ import annotations

import numpy as np


def _gather(plane: np.ndarray, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """Edge-clamped window [y0:y0+h, x0:x0+w] as int32."""
    H, W = plane.shape
    ys = np.clip(np.arange(y0, y0 + h), 0, H - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, W - 1)
    return plane[np.ix_(ys, xs)].astype(np.int32)


def _tap6(a: np.ndarray, axis: int) -> np.ndarray:
    """Unclipped 6-tap (1,-5,20,20,-5,1) along axis; output length = len-5."""
    s = [slice(None)] * a.ndim

    def sl(i, n):
        s2 = list(s)
        s2[axis] = slice(i, i + n)
        return a[tuple(s2)]

    n = a.shape[axis] - 5
    return (sl(0, n) - 5 * sl(1, n) + 20 * sl(2, n) + 20 * sl(3, n)
            - 5 * sl(4, n) + sl(5, n))


def _clip8(a: np.ndarray) -> np.ndarray:
    return np.clip(a, 0, 255)


def mc_luma(plane: np.ndarray, px: int, py: int, mvx: int, mvy: int,
            w: int, h: int) -> np.ndarray:
    """Predict a w x h luma block at pixel (px, py) with quarter-pel MV
    (mvx, mvy). Returns int32 [h, w] in [0, 255]."""
    xi = px + (mvx >> 2)
    yi = py + (mvy >> 2)
    fx = mvx & 3
    fy = mvy & 3

    if fx == 0 and fy == 0:
        return _gather(plane, xi, yi, w, h)

    # integer grid with one extra row/col for quarter averages
    if fy == 0:
        # horizontal only: b over rows [0,h), cols [0,w] extended
        win = _gather(plane, xi - 2, yi, w + 6, h)
        b = _clip8((_tap6(win, 1) + 16) >> 5)      # [h, w+1]
        if fx == 2:
            return b[:, :w]
        g = win[:, 2:2 + w + 1]                     # integer samples
        if fx == 1:
            return (g[:, :w] + b[:, :w] + 1) >> 1
        return (g[:, 1:w + 1] + b[:, :w] + 1) >> 1

    if fx == 0:
        win = _gather(plane, xi, yi - 2, w, h + 6)
        hh = _clip8((_tap6(win, 0) + 16) >> 5)      # [h+1, w]
        if fy == 2:
            return hh[:h]
        g = win[2:2 + h + 1]
        if fy == 1:
            return (g[:h] + hh[:h] + 1) >> 1
        return (g[1:h + 1] + hh[:h] + 1) >> 1

    # both fractional: need j (center), b (horizontal halves, rows 0..h),
    # hh (vertical halves, cols 0..w)
    win = _gather(plane, xi - 2, yi - 2, w + 6, h + 6)
    raw_h = _tap6(win, 1)                           # [h+6, w+1] unclipped
    j_full = _clip8((_tap6(raw_h, 0) + 512) >> 10)  # [h+1, w+1]
    b = _clip8((raw_h[2:2 + h + 1] + 16) >> 5)      # [h+1, w+1]
    hh = _clip8((_tap6(win[:, 2:2 + w + 1], 0) + 16) >> 5)  # [h+1, w+1]

    if fx == 2 and fy == 2:
        return j_full[:h, :w]
    if fy == 2:   # (1,2) i / (3,2) k: avg(j, hh at x or x+1)
        hc = hh[:h, :w] if fx == 1 else hh[:h, 1:w + 1]
        return (j_full[:h, :w] + hc + 1) >> 1
    if fx == 2:   # (2,1) f / (2,3) q: avg(j, b at y or y+1)
        bc = b[:h, :w] if fy == 1 else b[1:h + 1, :w]
        return (j_full[:h, :w] + bc + 1) >> 1
    # diagonal quarters: avg(b at row y or y+1, hh at col x or x+1)
    bc = b[:h, :w] if fy == 1 else b[1:h + 1, :w]
    hc = hh[:h, :w] if fx == 1 else hh[:h, 1:w + 1]
    return (bc + hc + 1) >> 1


def mc_chroma(plane: np.ndarray, px: int, py: int, mvx: int, mvy: int,
              w: int, h: int) -> np.ndarray:
    """Predict a w x h chroma block at chroma pixel (px, py) with the luma
    quarter-pel MV (interpreted as eighth-pel for chroma)."""
    xi = px + (mvx >> 3)
    yi = py + (mvy >> 3)
    dx = mvx & 7
    dy = mvy & 7
    win = _gather(plane, xi, yi, w + 1, h + 1)
    A = win[:h, :w]
    B = win[:h, 1:w + 1]
    C = win[1:h + 1, :w]
    D = win[1:h + 1, 1:w + 1]
    return ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B +
            (8 - dx) * dy * C + dx * dy * D + 32) >> 6
