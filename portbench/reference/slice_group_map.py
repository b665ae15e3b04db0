"""Slice group map construction — all 7 FMO map types (spec 8.2.2;
reference: h264bsd_slice_group_map.c:120-503, next-address walk
h264bsd_util.c:219 h264bsdNextMbAddress).

frame_mbs_only streams: map units == macroblocks.
"""

from __future__ import annotations

import numpy as np

from .params import Pps, Sps


def build_slice_group_map(sps: Sps, pps: Pps,
                          slice_group_change_cycle: int = 0) -> np.ndarray:
    """Returns int32 array [pic_size_mbs] of slice group ids."""
    w, h = sps.width_mbs, sps.height_mbs
    n = w * h
    g = pps.num_slice_groups
    out = np.zeros(n, np.int32)
    if g == 1:
        return out
    t = pps.slice_group_map_type

    if t == 0:  # interleaved
        i = 0
        while i < n:
            for grp in range(g):
                run = pps.run_length[grp]
                for _ in range(run):
                    if i >= n:
                        break
                    out[i] = grp
                    i += 1
                if i >= n:
                    break
        return out

    if t == 1:  # dispersed
        idx = np.arange(n)
        out = ((idx % w) + (((idx // w) * g) // 2)) % g
        return out.astype(np.int32)

    if t == 2:  # foreground + background
        out[:] = g - 1
        for grp in range(g - 2, -1, -1):
            tl, br = pps.top_left[grp], pps.bottom_right[grp]
            y0, x0 = tl // w, tl % w
            y1, x1 = br // w, br % w
            if x0 > x1 or y0 > y1:
                continue
            grid = out.reshape(h, w)
            grid[y0:y1 + 1, x0:x1 + 1] = grp
        return out

    rate = pps.slice_group_change_rate
    units0 = min(slice_group_change_cycle * rate, n)

    if t == 3:  # box-out (spec 8.2.2.4)
        out[:] = 1
        grid = out.reshape(h, w)
        cdf = 1 if pps.slice_group_change_direction else 0
        x = (w - cdf) // 2
        y = (h - cdf) // 2
        left, top, right, bottom = x, y, x, y
        xdir, ydir = cdf - 1, cdf
        k = 0
        while k < units0:
            vacant = grid[y, x] == 1
            if vacant:
                grid[y, x] = 0
                k += 1
            if xdir == -1 and x == left:
                left = max(left - 1, 0)
                x = left
                xdir, ydir = 0, 2 * cdf - 1
            elif xdir == 1 and x == right:
                right = min(right + 1, w - 1)
                x = right
                xdir, ydir = 0, 1 - 2 * cdf
            elif ydir == -1 and y == top:
                top = max(top - 1, 0)
                y = top
                xdir, ydir = 1 - 2 * cdf, 0
            elif ydir == 1 and y == bottom:
                bottom = min(bottom + 1, h - 1)
                y = bottom
                xdir, ydir = 2 * cdf - 1, 0
            else:
                x, y = x + xdir, y + ydir
        return out

    if t == 4:  # raster scan
        out[:] = 1
        if pps.slice_group_change_direction:
            out[n - units0:] = 0
        else:
            out[:units0] = 0
        return out

    if t == 5:  # wipe
        out[:] = 1
        grid = out.reshape(h, w)
        k = units0
        if pps.slice_group_change_direction:
            for x in range(w - 1, -1, -1):
                for y in range(h - 1, -1, -1):
                    if k <= 0:
                        break
                    grid[y, x] = 0
                    k -= 1
        else:
            for x in range(w):
                for y in range(h):
                    if k <= 0:
                        break
                    grid[y, x] = 0
                    k -= 1
        return out

    if t == 6:  # explicit
        m = pps.slice_group_map
        for i in range(n):
            out[i] = m[i] if i < len(m) else 0
        return out

    raise ValueError(f"slice_group_map_type {t}")


def next_mb_address(sg_map: np.ndarray, addr: int) -> int:
    """Next MB address in the same slice group, or -1 (mirrors
    h264bsdNextMbAddress)."""
    grp = sg_map[addr]
    n = len(sg_map)
    for i in range(addr + 1, n):
        if sg_map[i] == grp:
            return i
    return -1
