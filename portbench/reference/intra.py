"""Intra prediction kernels (NumPy reference backend).

Reference: h264bsd_intra_prediction.c — Intra16x16 modes :999-1158, chroma
modes :1159-1386, Intra4x4 modes :1492+, neighbour pel gathering
h264bsdGetNeighbourPels :544. Prediction always reads *pre-deblock*
reconstructed samples of the current picture (the in-loop filter runs
after the whole picture, h264bsd_decoder.c:461).
"""

from __future__ import annotations

import numpy as np


def _dc(vals_up, vals_left, avail_up, avail_left, size):
    if avail_up and avail_left:
        return (int(vals_up.sum()) + int(vals_left.sum()) + size) // (2 * size)
    if avail_up:
        return (int(vals_up.sum()) + size // 2) // size
    if avail_left:
        return (int(vals_left.sum()) + size // 2) // size
    return 128


def intra16x16(mode: int, up: np.ndarray, left: np.ndarray, upleft: int,
               avail_up: bool, avail_left: bool) -> np.ndarray:
    """16x16 luma prediction. up/left: int arrays of 16 neighbour pels."""
    p = np.empty((16, 16), np.int32)
    if mode == 0:    # vertical
        p[:] = up[None, :]
    elif mode == 1:  # horizontal
        p[:] = left[:, None]
    elif mode == 2:  # DC
        p[:] = _dc(up, left, avail_up, avail_left, 16)
    else:            # plane
        xs = np.arange(8, dtype=np.int32)
        h = int(((xs + 1) * (up[8 + xs].astype(np.int64) -
                             np.concatenate(([upleft], up[:7]))[7 - xs])).sum())
        v = int(((xs + 1) * (left[8 + xs].astype(np.int64) -
                             np.concatenate(([upleft], left[:7]))[7 - xs])).sum())
        b = (5 * h + 32) >> 6
        c = (5 * v + 32) >> 6
        a = 16 * (int(up[15]) + int(left[15]))
        y, x = np.mgrid[0:16, 0:16]
        p = np.clip((a + b * (x - 7) + c * (y - 7) + 16) >> 5, 0, 255)
    return p.astype(np.int32)


def intra_chroma(mode: int, up: np.ndarray, left: np.ndarray, upleft: int,
                 avail_up: bool, avail_left: bool) -> np.ndarray:
    """8x8 chroma prediction (one component)."""
    p = np.empty((8, 8), np.int32)
    if mode == 0:    # DC, per 4x4 sub-block with corner rules
        for cy in range(2):
            for cx in range(2):
                u = up[cx * 4:cx * 4 + 4]
                l = left[cy * 4:cy * 4 + 4]
                if cx == 0 and cy == 0 or (cx == 1 and cy == 1):
                    d = _dc(u, l, avail_up, avail_left, 4)
                elif cx == 1:  # top-right: prefer up
                    if avail_up:
                        d = (int(u.sum()) + 2) >> 2
                    elif avail_left:
                        d = (int(l.sum()) + 2) >> 2
                    else:
                        d = 128
                else:          # bottom-left: prefer left
                    if avail_left:
                        d = (int(l.sum()) + 2) >> 2
                    elif avail_up:
                        d = (int(u.sum()) + 2) >> 2
                    else:
                        d = 128
                p[cy * 4:cy * 4 + 4, cx * 4:cx * 4 + 4] = d
    elif mode == 1:  # horizontal
        p[:] = left[:, None]
    elif mode == 2:  # vertical
        p[:] = up[None, :]
    else:            # plane
        xs = np.arange(4, dtype=np.int32)
        h = int(((xs + 1) * (up[4 + xs].astype(np.int64) -
                             np.concatenate(([upleft], up[:3]))[3 - xs])).sum())
        v = int(((xs + 1) * (left[4 + xs].astype(np.int64) -
                             np.concatenate(([upleft], left[:3]))[3 - xs])).sum())
        b = (17 * h + 16) >> 5
        c = (17 * v + 16) >> 5
        a = 16 * (int(up[7]) + int(left[7]))
        y, x = np.mgrid[0:8, 0:8]
        p = np.clip((a + b * (x - 3) + c * (y - 3) + 16) >> 5, 0, 255)
    return p.astype(np.int32)


def intra4x4(mode: int, up: np.ndarray, left: np.ndarray, upleft: int,
             avail_up: bool, avail_left: bool) -> np.ndarray:
    """4x4 luma prediction. up: 8 pels (indices 4..7 = up-right, already
    substituted with up[3] when up-right unavailable)."""
    u = up.astype(np.int32)
    l = left.astype(np.int32)
    z = int(upleft)
    p = np.empty((4, 4), np.int32)
    if mode == 0:    # vertical
        p[:] = u[None, :4]
    elif mode == 1:  # horizontal
        p[:] = l[:4, None]
    elif mode == 2:  # DC
        p[:] = _dc(u[:4], l[:4], avail_up, avail_left, 4)
    elif mode == 3:  # diagonal down-left
        for y in range(4):
            for x in range(4):
                i = x + y
                if i == 6:
                    p[y, x] = (u[6] + 3 * u[7] + 2) >> 2
                else:
                    p[y, x] = (u[i] + 2 * u[i + 1] + u[i + 2] + 2) >> 2
    elif mode == 4:  # diagonal down-right
        for y in range(4):
            for x in range(4):
                if x > y:
                    i = x - y
                    a = z if i == 1 else u[i - 2]
                    p[y, x] = (a + 2 * u[i - 1] + u[i] + 2) >> 2
                elif x < y:
                    i = y - x
                    a = z if i == 1 else l[i - 2]
                    p[y, x] = (a + 2 * l[i - 1] + l[i] + 2) >> 2
                else:
                    p[y, x] = (u[0] + 2 * z + l[0] + 2) >> 2
    elif mode == 5:  # vertical-right (spec 8.3.1.2.6)
        def up_(i):
            return z if i < 0 else int(u[i])

        def left_(i):
            return z if i < 0 else int(l[i])
        for y in range(4):
            for x in range(4):
                zv = 2 * x - y
                if zv >= 0 and zv % 2 == 0:
                    i = x - (y >> 1)
                    p[y, x] = (up_(i - 1) + up_(i) + 1) >> 1
                elif zv >= 0:
                    i = x - (y >> 1)
                    p[y, x] = (up_(i - 2) + 2 * up_(i - 1) + up_(i) + 2) >> 2
                elif zv == -1:
                    p[y, x] = (left_(0) + 2 * z + up_(0) + 2) >> 2
                else:
                    p[y, x] = (left_(y - 2 * x - 1) + 2 * left_(y - 2 * x - 2)
                               + left_(y - 2 * x - 3) + 2) >> 2
    elif mode == 6:  # horizontal-down (spec 8.3.1.2.7)
        def up_(i):
            return z if i < 0 else int(u[i])

        def left_(i):
            return z if i < 0 else int(l[i])
        for y in range(4):
            for x in range(4):
                zh = 2 * y - x
                if zh >= 0 and zh % 2 == 0:
                    i = y - (x >> 1)
                    p[y, x] = (left_(i - 1) + left_(i) + 1) >> 1
                elif zh >= 0:
                    i = y - (x >> 1)
                    p[y, x] = (left_(i - 2) + 2 * left_(i - 1)
                               + left_(i) + 2) >> 2
                elif zh == -1:
                    p[y, x] = (up_(0) + 2 * z + left_(0) + 2) >> 2
                else:
                    p[y, x] = (up_(x - 2 * y - 1) + 2 * up_(x - 2 * y - 2)
                               + up_(x - 2 * y - 3) + 2) >> 2
    elif mode == 7:  # vertical-left
        for y in range(4):
            for x in range(4):
                i = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (u[i] + u[i + 1] + 1) >> 1
                else:
                    p[y, x] = (u[i] + 2 * u[i + 1] + u[i + 2] + 2) >> 2
    else:            # mode 8: horizontal-up
        for y in range(4):
            for x in range(4):
                zv = x + 2 * y
                if zv <= 4 and zv % 2 == 0:
                    p[y, x] = (l[y + (x >> 1)] + l[y + (x >> 1) + 1]
                               + 1) >> 1
                elif zv <= 4:
                    p[y, x] = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1]
                               + l[y + (x >> 1) + 2] + 2) >> 2
                elif zv == 5:
                    p[y, x] = (l[2] + 3 * l[3] + 2) >> 2
                else:
                    p[y, x] = l[3]
    return p
