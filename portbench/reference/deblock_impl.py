"""In-loop deblocking filter, NumPy reference backend — mirrors the
reference exactly (h264bsd_deblocking.c, non-OMXDL variant):

- per-MB raster scan; within each MB, per 4x4-block-row: vertical edges
  left-to-right, then that row's horizontal edges (FilterLuma :1542)
- boundary strengths per luma 4x4 edge (GetBoundaryStrengths :1134,
  EdgeBoundaryStrength :394, InnerBoundaryStrength :331) with the
  16x16/16x8/8x16 coefficient-only fast paths
- alpha/beta/tc0 thresholds from per-edge average QP + per-MB slice
  offsets (GetLumaEdgeThresholds :1381); chroma uses mapped QP_C
- chroma reuses luma bS, one bS per 2-pixel chroma edge (FilterChroma)
"""

from __future__ import annotations

import numpy as np

from .mb_layer import MB_P, PictureData
from .transform import QP_C
from .recon_cpu import Frame

ALPHAS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6, 7, 8, 9,
     10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80,
     90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255], np.int32)
BETAS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3, 3, 3, 3,
     4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14,
     14, 15, 15, 16, 16, 17, 17, 18, 18], np.int32)
TC0 = np.array([
    [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
    [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
    [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 1],
    [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 1], [1, 1, 1],
    [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2], [1, 1, 2],
    [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3], [2, 2, 4], [2, 3, 4],
    [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7], [4, 5, 8],
    [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13], [7, 10, 14], [8, 11, 16],
    [9, 12, 18], [10, 13, 20], [11, 15, 23], [13, 17, 25]], np.int32)

# raster 4x4 block index -> z-order index (mb4x4Index)
RASTER_TO_Z = [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15]


def _clip3(lo, hi, v):
    return max(lo, min(hi, v))


def _clip255(v):
    return max(0, min(255, v))


class _MbView:
    """Per-MB info needed by the filter."""

    __slots__ = ("intra", "tc_z", "mv_z", "ref_z", "qp", "idc", "offA",
                 "offB", "slice_id", "chroma_off")

    def __init__(self, pic: PictureData, addr: int) -> None:
        self.intra = pic.mb_class[addr] != MB_P
        # z-order totalCoeff / mv / refAddr arrays
        tc = pic.total_coeff[addr]
        mv = pic.mv[addr]
        self.tc_z = [0] * 16
        self.mv_z = [(0, 0)] * 16
        for z in range(16):
            from .mb_layer import BLK_ORDER
            bx, by = BLK_ORDER[z]
            self.tc_z[z] = int(tc[by, bx])
            self.mv_z[z] = (int(mv[by, bx, 0]), int(mv[by, bx, 1]))
        rs = pic.ref_slot[addr]
        self.ref_z = [int(rs[0, 0]), int(rs[0, 1]), int(rs[1, 0]),
                      int(rs[1, 1])]
        self.qp = int(pic.qp[addr])
        self.chroma_off = None  # filled by filter_picture_impl
        concealed = getattr(pic, "concealed", None)
        if concealed is not None and concealed[addr]:
            # concealed MBs: qp already 40, offsets 0, filtering enabled
            # (h264bsd_conceal.c ConcealMb :300-308)
            self.idc = 0
            self.offA = 0
            self.offB = 0
            self.slice_id = int(pic.slice_id[addr])
            self.chroma_off = 0
            return
        sp = pic.slice_params[pic.slice_id[addr]]
        self.idc = sp.disable_deblocking_idc
        self.offA = sp.alpha_c0_offset
        self.offB = sp.beta_offset
        self.slice_id = int(pic.slice_id[addr])


def _edge_bs(mb1: _MbView, mb2: _MbView, i1: int, i2: int) -> int:
    if mb1.tc_z[i1] or mb2.tc_z[i2]:
        return 2
    if (mb1.ref_z[i1 >> 2] != mb2.ref_z[i2 >> 2] or
            abs(mb1.mv_z[i1][0] - mb2.mv_z[i2][0]) >= 4 or
            abs(mb1.mv_z[i1][1] - mb2.mv_z[i2][1]) >= 4):
        return 1
    return 0


def _inner_bs(mb: _MbView, i1: int, i2: int) -> int:
    if mb.tc_z[i1] or mb.tc_z[i2]:
        return 2
    if (abs(mb.mv_z[i1][0] - mb.mv_z[i2][0]) >= 4 or
            abs(mb.mv_z[i1][1] - mb.mv_z[i2][1]) >= 4 or
            mb.ref_z[i1 >> 2] != mb.ref_z[i2 >> 2]):
        return 1
    return 0


def _boundary_strengths(mb: _MbView, mb_a, mb_b, flags, pic, addr):
    """Returns (bs_top[16], bs_left[16]) by raster block index, or None if
    all zero."""
    top = [0] * 16
    left = [0] * 16
    nonzero = False
    FT, FL = flags

    # the reference's 16x16/16x8/8x16 coefficient-only fast paths are
    # mathematically identical to the general inner path (equal MVs/refs
    # within a partition give bs 0 from the mv/ref terms), so the general
    # path is used for all inter MBs.
    if FT:
        if mb.intra or mb_b.intra:
            top[0] = top[1] = top[2] = top[3] = 4
            nonzero = True
        else:
            top[0] = _edge_bs(mb, mb_b, 0, 10)
            top[1] = _edge_bs(mb, mb_b, 1, 11)
            top[2] = _edge_bs(mb, mb_b, 4, 14)
            top[3] = _edge_bs(mb, mb_b, 5, 15)
            nonzero = nonzero or any(top[:4])
    if FL:
        if mb.intra or mb_a.intra:
            left[0] = left[4] = left[8] = left[12] = 4
            nonzero = True
        else:
            left[0] = _edge_bs(mb, mb_a, 0, 5)
            left[4] = _edge_bs(mb, mb_a, 2, 7)
            left[8] = _edge_bs(mb, mb_a, 8, 13)
            left[12] = _edge_bs(mb, mb_a, 10, 15)
            nonzero = nonzero or any((left[0], left[4], left[8], left[12]))

    if mb.intra:
        for i in range(4, 16):
            top[i] = 3
        for i in range(16):
            if i % 4:
                left[i] = 3
        nonzero = True
    else:
        Z = RASTER_TO_Z
        for r in range(4, 16):
            top[r] = _inner_bs(mb, Z[r], Z[r - 4])
        for r in range(16):
            if r % 4:
                left[r] = _inner_bs(mb, Z[r], Z[r - 1])
        nonzero = nonzero or any(top[4:]) or \
            any(left[i] for i in range(16) if i % 4)
    return (top, left) if nonzero else None


def _thresholds(qp_this, qp_a, qp_b, offA, offB, has_top, has_left,
                chroma_off=None):
    """[inner, top, left] threshold triples (alpha, beta, tc0row)."""
    def mk(q):
        ia = _clip3(0, 51, q + offA)
        ib = _clip3(0, 51, q + offB)
        return (int(ALPHAS[ia]), int(BETAS[ib]), TC0[ia])

    def cmap(q):
        return int(QP_C[_clip3(0, 51, q + chroma_off)]) \
            if chroma_off is not None else q

    inner = mk(cmap(qp_this))
    topt = inner
    leftt = inner
    if has_top and qp_b != qp_this:
        topt = mk((cmap(qp_this) + cmap(qp_b) + 1) >> 1)
    if has_left and qp_a != qp_this:
        leftt = mk((cmap(qp_this) + cmap(qp_a) + 1) >> 1)
    return inner, topt, leftt


def _filter_ver_luma(pl, y0, x0, bs, th):
    """Vertical edge at column x0, rows y0..y0+3 (pixels p are to the
    left). Mirrors FilterVerLumaEdge :649."""
    alpha, beta, tc0row = th
    if bs < 4:
        tc = int(tc0row[bs - 1])
        tmp = tc
        for y in range(y0, y0 + 4):
            p1, p0 = int(pl[y, x0 - 2]), int(pl[y, x0 - 1])
            q0, q1 = int(pl[y, x0]), int(pl[y, x0 + 1])
            if (abs(p0 - q0) < alpha and abs(p1 - p0) < beta and
                    abs(q1 - q0) < beta):
                p2, q2 = int(pl[y, x0 - 3]), int(pl[y, x0 + 2])
                if abs(p2 - p0) < beta:
                    pl[y, x0 - 2] = p1 + _clip3(
                        -tc, tc, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1)
                    tmp += 1
                if abs(q2 - q0) < beta:
                    pl[y, x0 + 1] = q1 + _clip3(
                        -tc, tc, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1)
                    tmp += 1
                delta = _clip3(-tmp, tmp,
                               (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3)
                pl[y, x0 - 1] = _clip255(p0 + delta)
                pl[y, x0] = _clip255(q0 - delta)
                tmp = tc
    else:
        for y in range(y0, y0 + 4):
            p1, p0 = int(pl[y, x0 - 2]), int(pl[y, x0 - 1])
            q0, q1 = int(pl[y, x0]), int(pl[y, x0 + 1])
            if (abs(p0 - q0) < alpha and abs(p1 - p0) < beta and
                    abs(q1 - q0) < beta):
                strong = abs(p0 - q0) < (alpha >> 2) + 2
                p2, q2 = int(pl[y, x0 - 3]), int(pl[y, x0 + 2])
                if strong and abs(p2 - p0) < beta:
                    t = p1 + p0 + q0
                    p3 = int(pl[y, x0 - 4])
                    pl[y, x0 - 1] = (p2 + 2 * t + q1 + 4) >> 3
                    pl[y, x0 - 2] = (p2 + t + 2) >> 2
                    pl[y, x0 - 3] = (2 * p3 + 3 * p2 + t + 4) >> 3
                else:
                    pl[y, x0 - 1] = (2 * p1 + p0 + q1 + 2) >> 2
                if strong and abs(q2 - q0) < beta:
                    t = p0 + q0 + q1
                    q3 = int(pl[y, x0 + 3])
                    pl[y, x0] = (p1 + 2 * t + q2 + 4) >> 3
                    pl[y, x0 + 1] = (t + q2 + 2) >> 2
                    pl[y, x0 + 2] = (2 * q3 + 3 * q2 + t + 4) >> 3
                else:
                    pl[y, x0] = (2 * q1 + q0 + p1 + 2) >> 2


def _filter_hor_luma(pl, y0, x0, n, bs, th):
    """Horizontal edge at row y0, columns x0..x0+n-1 (p above)."""
    alpha, beta, tc0row = th
    if bs < 4:
        tc = int(tc0row[bs - 1])
        tmp = tc
        for x in range(x0, x0 + n):
            p1, p0 = int(pl[y0 - 2, x]), int(pl[y0 - 1, x])
            q0, q1 = int(pl[y0, x]), int(pl[y0 + 1, x])
            if (abs(p0 - q0) < alpha and abs(p1 - p0) < beta and
                    abs(q1 - q0) < beta):
                p2 = int(pl[y0 - 3, x])
                if abs(p2 - p0) < beta:
                    pl[y0 - 2, x] = p1 + _clip3(
                        -tc, tc, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1)
                    tmp += 1
                q2 = int(pl[y0 + 2, x])
                if abs(q2 - q0) < beta:
                    pl[y0 + 1, x] = q1 + _clip3(
                        -tc, tc, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1)
                    tmp += 1
                delta = _clip3(-tmp, tmp,
                               (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3)
                pl[y0 - 1, x] = _clip255(p0 + delta)
                pl[y0, x] = _clip255(q0 - delta)
                tmp = tc
    else:
        for x in range(x0, x0 + n):
            p1, p0 = int(pl[y0 - 2, x]), int(pl[y0 - 1, x])
            q0, q1 = int(pl[y0, x]), int(pl[y0 + 1, x])
            if (abs(p0 - q0) < alpha and abs(p1 - p0) < beta and
                    abs(q1 - q0) < beta):
                strong = abs(p0 - q0) < (alpha >> 2) + 2
                p2, q2 = int(pl[y0 - 3, x]), int(pl[y0 + 2, x])
                if strong and abs(p2 - p0) < beta:
                    t = p1 + p0 + q0
                    p3 = int(pl[y0 - 4, x])
                    pl[y0 - 1, x] = (p2 + 2 * t + q1 + 4) >> 3
                    pl[y0 - 2, x] = (p2 + t + 2) >> 2
                    pl[y0 - 3, x] = (2 * p3 + 3 * p2 + t + 4) >> 3
                else:
                    pl[y0 - 1, x] = (2 * p1 + p0 + q1 + 2) >> 2
                if strong and abs(q2 - q0) < beta:
                    t = p0 + q0 + q1
                    q3 = int(pl[y0 + 3, x])
                    pl[y0, x] = (p1 + 2 * t + q2 + 4) >> 3
                    pl[y0 + 1, x] = (t + q2 + 2) >> 2
                    pl[y0 + 2, x] = (2 * q3 + 3 * q2 + t + 4) >> 3
                else:
                    pl[y0, x] = (2 * q1 + q0 + p1 + 2) >> 2


def _filter_ver_chroma(pl, y0, x0, bs, th):
    """Vertical chroma edge, 2 pixel rows."""
    alpha, beta, tc0row = th
    for y in (y0, y0 + 1):
        p1, p0 = int(pl[y, x0 - 2]), int(pl[y, x0 - 1])
        q0, q1 = int(pl[y, x0]), int(pl[y, x0 + 1])
        if (abs(p0 - q0) < alpha and abs(p1 - p0) < beta and
                abs(q1 - q0) < beta):
            if bs < 4:
                tc = int(tc0row[bs - 1]) + 1
                delta = _clip3(-tc, tc,
                               (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3)
                pl[y, x0 - 1] = _clip255(p0 + delta)
                pl[y, x0] = _clip255(q0 - delta)
            else:
                pl[y, x0 - 1] = (2 * p1 + p0 + q1 + 2) >> 2
                pl[y, x0] = (2 * q1 + q0 + p1 + 2) >> 2


def _filter_hor_chroma(pl, y0, x0, n, bs, th):
    alpha, beta, tc0row = th
    for x in range(x0, x0 + n):
        p1, p0 = int(pl[y0 - 2, x]), int(pl[y0 - 1, x])
        q0, q1 = int(pl[y0, x]), int(pl[y0 + 1, x])
        if (abs(p0 - q0) < alpha and abs(p1 - p0) < beta and
                abs(q1 - q0) < beta):
            if bs < 4:
                tc = int(tc0row[bs - 1]) + 1
                delta = _clip3(-tc, tc,
                               (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3)
                pl[y0 - 1, x] = _clip255(p0 + delta)
                pl[y0, x] = _clip255(q0 - delta)
            else:
                pl[y0 - 1, x] = (2 * p1 + p0 + q1 + 2) >> 2
                pl[y0, x] = (2 * q1 + q0 + p1 + 2) >> 2


def filter_picture_impl(frame: Frame, pic: PictureData,
                        chroma_qp_offset: int) -> None:
    if getattr(pic, "whole_pic_concealed", False):
        return
    w_mbs, h_mbs = pic.width_mbs, pic.height_mbs
    # int32 working planes (the scalar filters index/write freely)
    y_pl = frame.y.astype(np.int32)
    cb_pl = frame.cb.astype(np.int32)
    cr_pl = frame.cr.astype(np.int32)

    views = {}

    def view(a):
        if a not in views:
            views[a] = _MbView(pic, a)
        return views[a]

    for addr in range(pic.n_mbs):
        if not pic.decoded[addr]:
            continue
        mb = view(addr)
        if mb.idc == 1:
            continue
        mbx, mby = addr % w_mbs, addr // w_mbs
        a_addr = addr - 1 if mbx > 0 else None
        b_addr = addr - w_mbs if mby > 0 else None
        mb_a = view(a_addr) if a_addr is not None and \
            pic.decoded[a_addr] else None
        mb_b = view(b_addr) if b_addr is not None and \
            pic.decoded[b_addr] else None
        FL = mb_a is not None and \
            (mb.idc != 2 or mb_a.slice_id == mb.slice_id)
        FT = mb_b is not None and \
            (mb.idc != 2 or mb_b.slice_id == mb.slice_id)

        res = _boundary_strengths(mb, mb_a, mb_b, (FT, FL), pic, addr)
        if res is None:
            continue
        top, left = res

        # luma thresholds
        inner, topt, leftt = _thresholds(
            mb.qp, mb_a.qp if mb_a else 0, mb_b.qp if mb_b else 0,
            mb.offA, mb.offB, FT, FL)
        px, py = mbx * 16, mby * 16
        for row in range(4):
            y0 = py + row * 4
            for col in range(4):
                r = row * 4 + col
                if left[r]:
                    th = leftt if col == 0 else inner
                    _filter_ver_luma(y_pl, y0, px + col * 4, left[r], th)
            th = topt if row == 0 else inner
            # same-bS fast path is identical math; filter per edge
            for col in range(4):
                r = row * 4 + col
                if top[r]:
                    _filter_hor_luma(y_pl, y0, px + col * 4, 4, top[r], th)

        # chroma (per-MB offset: 0 for concealed MBs)
        mb_coff = mb.chroma_off if mb.chroma_off is not None \
            else chroma_qp_offset
        inner, topt, leftt = _thresholds(
            mb.qp, mb_a.qp if mb_a else 0, mb_b.qp if mb_b else 0,
            mb.offA, mb.offB, FT, FL, chroma_off=mb_coff)
        cx, cy = mbx * 8, mby * 8
        for half in range(2):
            base = half * 8
            y0 = cy + half * 4
            for pl in (cb_pl, cr_pl):
                if left[base + 0]:
                    _filter_ver_chroma(pl, y0, cx, left[base + 0], leftt)
                if left[base + 4]:
                    _filter_ver_chroma(pl, y0 + 2, cx, left[base + 4], leftt)
                if left[base + 2]:
                    _filter_ver_chroma(pl, y0, cx + 4, left[base + 2], inner)
                if left[base + 6]:
                    _filter_ver_chroma(pl, y0 + 2, cx + 4, left[base + 6],
                                       inner)
            th = topt if half == 0 else inner
            for pl in (cb_pl, cr_pl):
                for col in range(4):
                    if top[base + col]:
                        _filter_hor_chroma(pl, y0, cx + col * 2, 2,
                                           top[base + col], th)

    frame.y[:] = np.clip(y_pl, 0, 255).astype(np.uint8)
    frame.cb[:] = np.clip(cb_pl, 0, 255).astype(np.uint8)
    frame.cr[:] = np.clip(cr_pl, 0, 255).astype(np.uint8)
