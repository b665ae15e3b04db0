"""In-loop deblocking: per-MB parameters and the plain wavefront (K3's
plain counterpart).

Twin of ``broadway_tpu.ops.tpu.deblock`` (``boundary_strengths``,
``edge_thresholds``, ``filter_lines_luma/chroma``), of
``wavefront_pallas.deblock_params`` and of ``recon_tpu.deblock_scan``,
over RASTER planes. Order per MB (raster-equivalent, bit-exact with
core/deblock_impl.py and h264bsd_deblocking.c:574): the 4 vertical luma
edges left to right, then the 4 horizontal edges top to bottom; chroma
uses edges 0 and 2 each way with the luma bS. The left MB edge writes
columns 13-15 of the LEFT neighbour and the top edge rows 13-15 of the
UPPER neighbour, so MBs run in x + 2y diagonal order: every MB of one
diagonal is then independent.

Params are plain per-MB tensors, ``P [n, 64] int32``:

  0:16   bS of vertical edge e (column 4e), line block r, at lane 4e + r
  16:32  bS of horizontal edge e (row 4e), column block c, at 16 + 4e + c
  32:47  luma (alpha, beta, tc0[bS 1..3]) for the inner, top, left class
  47:62  chroma, the same

Read-only note on the TPU kernel's packing (``wavefront_pallas.py``,
not edited): the comment above its ``_db_kernel`` describes a 128-lane
P with bS at 0:32 and thresholds at 32:62. That comment is stale. The
code that builds P (``deblock_params``) packs 256 lanes: 0:64 bS of the
vertical edges (lane 16e + line, each bS repeated over its 4 lines),
64:128 bS of the horizontal edges (lane 64 + 16e + column), 128:160
chroma vertical bS and 160:192 chroma horizontal bS (cb and cr halves,
each bS over 2 lines), 192:207 luma (alpha, beta, tc0 x3) x {inner, top,
left} and 207:222 chroma. Here the repetition over lines is left to the
consumer, so 64 lanes hold the same information.
"""

from __future__ import annotations

from typing import Dict

import torch

from .tables import diagonals, tables

I32 = torch.int32
P_BS_V, P_BS_H, P_THR_LUMA, P_THR_CHROMA = 0, 16, 32, 47
THR_INNER, THR_TOP, THR_LEFT = 0, 5, 10
N_PARAMS = 64


def _bs_pair(tc_q, tc_p, mv_q, mv_p, rf_q, rf_p):
    coeff = (tc_q > 0) | (tc_p > 0)
    mvd = ((mv_q[..., 0] - mv_p[..., 0]).abs() >= 4) | \
        ((mv_q[..., 1] - mv_p[..., 1]).abs() >= 4)
    return torch.where(coeff, 2, torch.where(mvd | (rf_q != rf_p), 1, 0))


def boundary_strengths(tc4, mv, ref_blk, intra, FT, FL, w_mbs, h_mbs):
    """bS of every luma edge: (bs_top, bs_left), each [n, 4, 4] int32 in
    raster block coords ([row, col] of the edge's q-side block).

    tc4 [n,4,4] total_coeff, mv [n,4,4,2], ref_blk [n,4,4] (per block;
    the reference id is per 8x8, so its even entries are read), intra
    [n] bool, FT/FL [n] bool."""
    n = w_mbs * h_mbs
    g = lambda a: a.reshape(h_mbs, w_mbs, *a.shape[1:])
    tcg, mvg, intrag = g(tc4), g(mv), g(intra)
    rf = g(ref_blk)[:, :, ::2, ::2]
    rfg = rf.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    inner_top = _bs_pair(tcg[:, :, 1:, :], tcg[:, :, :3, :],
                         mvg[:, :, 1:, :], mvg[:, :, :3, :],
                         rfg[:, :, 1:, :], rfg[:, :, :3, :])
    inner_left = _bs_pair(tcg[:, :, :, 1:], tcg[:, :, :, :3],
                          mvg[:, :, :, 1:], mvg[:, :, :, :3],
                          rfg[:, :, :, 1:], rfg[:, :, :, :3])

    def shifted(a, dim):        # neighbour above (dim 0) / left (dim 1)
        z = torch.zeros_like(a.narrow(dim, 0, 1))
        return torch.cat([z, a.narrow(dim, 0, a.shape[dim] - 1)], dim=dim)

    top = _bs_pair(tcg[:, :, 0, :], shifted(tcg[:, :, 3, :], 0),
                   mvg[:, :, 0, :], shifted(mvg[:, :, 3, :], 0),
                   rfg[:, :, 0, :], shifted(rfg[:, :, 3, :], 0))
    top = torch.where((intrag | shifted(intrag, 0))[..., None], 4, top)
    top = torch.where(g(FT)[..., None], top, 0)
    left = _bs_pair(tcg[:, :, :, 0], shifted(tcg[:, :, :, 3], 1),
                    mvg[:, :, :, 0], shifted(mvg[:, :, :, 3], 1),
                    rfg[:, :, :, 0], shifted(rfg[:, :, :, 3], 1))
    left = torch.where((intrag | shifted(intrag, 1))[..., None], 4, left)
    left = torch.where(g(FL)[..., None], left, 0)
    inner_top = torch.where(intrag[..., None, None], 3, inner_top)
    inner_left = torch.where(intrag[..., None, None], 3, inner_left)
    bs_top = torch.cat([top[:, :, None, :], inner_top], dim=2)
    bs_left = torch.cat([left[:, :, :, None], inner_left], dim=3)
    return bs_top.reshape(n, 4, 4).to(I32), bs_left.reshape(n, 4, 4).to(I32)


def edge_thresholds(qp, qp_a, qp_b, offA, offB, chroma_off=None):
    """(alpha, beta, tc0 [n, 3]) per MB for the inner/top/left edge
    classes; chroma maps QP through QP_C with the per-MB offset."""
    t = tables(qp.device)

    def qmap(q):
        if chroma_off is None:
            return q
        return t["QP_C"][(q + chroma_off).clamp(0, 51).long()]

    def mk(q):
        ia = (q + offA).clamp(0, 51).long()
        ib = (q + offB).clamp(0, 51).long()
        return t["ALPHAS"][ia], t["BETAS"][ib], t["TC0"][ia]

    qm = qmap(qp)
    top = torch.where(qp_b != qp, (qm + qmap(qp_b) + 1) >> 1, qm)
    left = torch.where(qp_a != qp, (qm + qmap(qp_a) + 1) >> 1, qm)
    return {"inner": mk(qm), "top": mk(top), "left": mk(left)}


def deblock_params(arrs: Dict[str, torch.Tensor], w_mbs: int,
                   h_mbs: int) -> torch.Tensor:
    """Whole-picture bS and thresholds -> P [n, 64] int32 (lane map in
    the module docstring)."""
    n = w_mbs * h_mbs
    en = arrs["enable"]
    bs_top, bs_left = boundary_strengths(
        arrs["total_coeff"], arrs["mv"], arrs["ref_blk"], ~arrs["is_inter"],
        arrs["FT"], arrs["FL"], w_mbs, h_mbs)
    bs_top = torch.where(en[:, None, None], bs_top, 0)
    bs_left = torch.where(en[:, None, None], bs_left, 0)
    qp = arrs["qp"]
    qg = qp.reshape(h_mbs, w_mbs)
    qp_a = torch.cat([qg[:, :1], qg[:, :-1]], dim=1).reshape(n)
    qp_b = torch.cat([qg[:1], qg[:-1]], dim=0).reshape(n)

    def classes(coff):
        th = edge_thresholds(qp, qp_a, qp_b, arrs["offA"], arrs["offB"],
                             chroma_off=coff)
        cols = []
        for cls in ("inner", "top", "left"):
            alpha, beta, tc0 = th[cls]
            cols += [alpha[:, None], beta[:, None], tc0]
        return torch.cat(cols, dim=1).to(I32)              # [n,15]

    P = torch.cat([bs_left.transpose(1, 2).reshape(n, 16),
                   bs_top.reshape(n, 16), classes(None),
                   classes(arrs["chroma_off_mb"]),
                   torch.zeros((n, N_PARAMS - 62), dtype=I32,
                               device=qp.device)], dim=1)
    return P.contiguous()


def filter_luma(p3, p2, p1, p0, q0, q1, q2, q3, bs, alpha, beta, t0, t1,
                t2):
    """Luma edge filter over lines (all int32, broadcastable); tc0 is
    passed per bS (t0/t1/t2 for bS 1/2/3). Returns (p2', p1', p0', q0',
    q1', q2')."""
    gate = (bs > 0) & ((p0 - q0).abs() < alpha) & \
        ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    tc0v = torch.where(bs == 1, t0, torch.where(bs == 2, t1, t2))
    half = (p0 + q0 + 1) >> 1
    p1n = p1 + torch.clamp((p2 + half - (p1 << 1)) >> 1, -tc0v, tc0v)
    q1n = q1 + torch.clamp((q2 + half - (q1 << 1)) >> 1, -tc0v, tc0v)
    tc = tc0v + ap.to(I32) + aq.to(I32)
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0n = (p0 + delta).clamp(0, 255)
    q0n = (q0 - delta).clamp(0, 255)
    strong = (p0 - q0).abs() < ((alpha >> 2) + 2)
    tp = p1 + p0 + q0
    p0s = torch.where(strong & ap, (p2 + 2 * tp + q1 + 4) >> 3,
                      (2 * p1 + p0 + q1 + 2) >> 2)
    p1s = torch.where(strong & ap, (p2 + tp + 2) >> 2, p1)
    p2s = torch.where(strong & ap, (2 * p3 + 3 * p2 + tp + 4) >> 3, p2)
    tq = p0 + q0 + q1
    q0s = torch.where(strong & aq, (p1 + 2 * tq + q2 + 4) >> 3,
                      (2 * q1 + q0 + p1 + 2) >> 2)
    q1s = torch.where(strong & aq, (tq + q2 + 2) >> 2, q1)
    q2s = torch.where(strong & aq, (2 * q3 + 3 * q2 + tq + 4) >> 3, q2)
    is4 = bs == 4
    w = torch.where
    return (w(gate & is4, p2s, p2),
            w(gate, w(is4, p1s, w(ap, p1n, p1)), p1),
            w(gate, w(is4, p0s, p0n), p0),
            w(gate, w(is4, q0s, q0n), q0),
            w(gate, w(is4, q1s, w(aq, q1n, q1)), q1),
            w(gate & is4, q2s, q2))


def filter_chroma(p1, p0, q0, q1, bs, alpha, beta, t0, t1, t2):
    """Chroma edge filter over lines -> (p0', q0')."""
    gate = (bs > 0) & ((p0 - q0).abs() < alpha) & \
        ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)
    tc = torch.where(bs == 1, t0, torch.where(bs == 2, t1, t2)) + 1
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0n = (p0 + delta).clamp(0, 255)
    q0n = (q0 - delta).clamp(0, 255)
    p0s = (2 * p1 + p0 + q1 + 2) >> 2
    q0s = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    return (torch.where(gate, torch.where(is4, p0s, p0n), p0),
            torch.where(gate, torch.where(is4, q0s, q0n), q0))


def _thr(p, base, cls):
    """(alpha, beta, t0, t1, t2) of one class as [m, 1] columns."""
    o = base + cls
    return tuple(p[:, o + k:o + k + 1] for k in range(5))


def _window(own, left, up, size, edge):
    """[m, edge+size, edge+size] window: own at [edge:, edge:], the left
    MB's last `edge` columns and the upper MB's last `edge` rows."""
    m = own.shape[0]
    win = own.new_zeros((m, edge + size, edge + size))
    win[:, edge:, edge:] = own
    win[:, edge:, :edge] = left[:, :, size - edge:]
    win[:, :edge, edge:] = up[:, size - edge:, :]
    return win


def deblock_wavefront_plain(Y: torch.Tensor, C: torch.Tensor,
                            P: torch.Tensor, w_mbs: int, h_mbs: int
                            ) -> None:
    """Deblock in place. Y [H, W] u8, C [2, H/2, W/2] u8, P from
    deblock_params."""
    w, h = w_mbs, h_mbs
    Yv = Y.view(h, 16, w, 16)
    Cv = C.view(2, h, 8, w, 8)
    for ys, xs in diagonals(w, h, Y.device):
        addr = ys * w + xs
        p = P[addr]
        xl = (xs - 1).clamp(min=0)
        yu = (ys - 1).clamp(min=0)
        win = _window(Yv[ys, :, xs, :].to(I32), Yv[ys, :, xl, :].to(I32),
                      Yv[yu, :, xs, :].to(I32), 16, 4)       # [m,20,20]
        for e in range(4):                                  # vertical
            c = 4 + 4 * e
            al, be, t0, t1, t2 = _thr(p, P_THR_LUMA,
                                      THR_LEFT if e == 0 else THR_INNER)
            bs = p[:, P_BS_V + 4 * e:P_BS_V + 4 * e + 4] \
                .repeat_interleave(4, dim=1)                # [m,16]
            px = [win[:, 4:20, c + k] for k in range(-4, 4)]
            out = filter_luma(*px, bs, al, be, t0, t1, t2)
            win[:, 4:20, c - 3:c + 3] = torch.stack(out, dim=2)
        for e in range(4):                                  # horizontal
            r = 4 + 4 * e
            al, be, t0, t1, t2 = _thr(p, P_THR_LUMA,
                                      THR_TOP if e == 0 else THR_INNER)
            bs = p[:, P_BS_H + 4 * e:P_BS_H + 4 * e + 4] \
                .repeat_interleave(4, dim=1)
            px = [win[:, r + k, 4:20] for k in range(-4, 4)]
            out = filter_luma(*px, bs, al, be, t0, t1, t2)
            win[:, r - 3:r + 3, 4:20] = torch.stack(out, dim=1)
        # write back the neighbours' edge strips first, own MB last: at
        # the picture's left/top border the clamped neighbour IS the own
        # MB (its strip went through bS 0 unchanged) and is overwritten
        win = win.to(torch.uint8)
        Yv[ys, :, xl, 13:16] = win[:, 4:20, 1:4]
        Yv[yu, 13:16, xs, :] = win[:, 1:4, 4:20]
        Yv[ys, :, xs, :] = win[:, 4:20, 4:20]

        for pl in range(2):
            Pv = Cv[pl]
            cw = _window(Pv[ys, :, xs, :].to(I32), Pv[ys, :, xl, :].to(I32),
                         Pv[yu, :, xs, :].to(I32), 8, 4)    # [m,12,12]
            for k, cls in enumerate((THR_LEFT, THR_INNER)):
                cc = 4 + 4 * k
                bs = p[:, P_BS_V + 8 * k:P_BS_V + 8 * k + 4] \
                    .repeat_interleave(2, dim=1)            # [m,8]
                px = [cw[:, 4:12, cc + j] for j in range(-2, 2)]
                out = filter_chroma(*px, bs,
                                    *_thr(p, P_THR_CHROMA, cls))
                cw[:, 4:12, cc - 1:cc + 1] = torch.stack(out, dim=2)
            for k, cls in enumerate((THR_TOP, THR_INNER)):
                rr = 4 + 4 * k
                bs = p[:, P_BS_H + 8 * k:P_BS_H + 8 * k + 4] \
                    .repeat_interleave(2, dim=1)
                px = [cw[:, rr + j, 4:12] for j in range(-2, 2)]
                out = filter_chroma(*px, bs,
                                    *_thr(p, P_THR_CHROMA, cls))
                cw[:, rr - 1:rr + 1, 4:12] = torch.stack(out, dim=1)
            cw = cw.to(torch.uint8)
            Pv[ys, :, xl, 5:8] = cw[:, 4:12, 1:4]
            Pv[yu, 5:8, xs, :] = cw[:, 1:4, 4:12]
            Pv[ys, :, xs, :] = cw[:, 4:12, 4:12]
