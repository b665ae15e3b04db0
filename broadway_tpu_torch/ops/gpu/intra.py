"""Intra prediction, plain torch version (K2's plain counterpart).

Twin of ``broadway_tpu.ops.tpu.intra`` (``predict_i4x4_batch``,
``predict_i16_batch``, ``predict_chroma_batch``) and of the wavefront
step ``recon_tpu.decode_picture_impl.intra_step``, but over RASTER
planes: a Python loop over the x + 2y anti-diagonals, torch ops
vectorised over the MBs of one diagonal, results written back in place.
No main-path code runs this on CUDA tensors; the K2 wrapper
(``wavefront_kernels.intra_wavefront``) does on the CPU.
"""

from __future__ import annotations

from typing import Dict

import torch

from ...bitstream.mb_layer import MB_I4x4, MB_I16x16

from .tables import AVUR_CODE, BLK_ORDER, diagonals, tables

I32 = torch.int32

# intra param lanes per MB (int32 [n, 32]), the K2 kernel's P operand:
# 0-3 av_a..av_d, then these
P_IS_I4, P_IS_I16, P_I16_MODE, P_C_MODE, P_INTRA_C, P_I4_MODES = \
    4, 5, 6, 7, 8, 9
N_PARAMS = 32


def _dc(up_sum, left_sum, avail_up, avail_left, n_log2):
    """DC value from edge sums of 2**(n_log2-1) pels each."""
    r = 1 << (n_log2 - 1)
    return torch.where(
        avail_up & avail_left, (up_sum + left_sum + r) >> n_log2,
        torch.where(avail_up, (up_sum + r // 2) >> (n_log2 - 1),
                    torch.where(avail_left, (left_sum + r // 2)
                                >> (n_log2 - 1), 128)))


def predict_i4x4_batch(v: torch.Tensor, mode: torch.Tensor,
                       avail_up: torch.Tensor, avail_left: torch.Tensor
                       ) -> torch.Tensor:
    """v [M, 13] int32 neighbour pels (ul, up0..7, left0..3); mode [M].
    -> [M, 4, 4]."""
    t = tables(v.device)
    taps = v[:, t["I4_IDX"].long()]                       # [M,9,4,4,3]
    lin = (taps * t["I4_COEF"]).sum(-1, dtype=I32)
    pred = (lin + t["I4_RND"]) >> t["I4_SHIFT"]           # [M,9,4,4]
    dc = _dc(v[:, 1:5].sum(-1), v[:, 9:13].sum(-1), avail_up, avail_left, 3)
    pred[:, 2] = dc[:, None, None].to(I32)
    return pred[torch.arange(v.shape[0], device=v.device), mode.long()]


def predict_i16_batch(up, left, ul, mode, avail_up, avail_left):
    """up/left [M, 16], ul [M], mode [M] -> [M, 16, 16]."""
    M = up.shape[0]
    dev = up.device
    vert = up[:, None, :].expand(M, 16, 16)
    hor = left[:, :, None].expand(M, 16, 16)
    dc = _dc(up.sum(-1), left.sum(-1), avail_up, avail_left, 5) \
        .to(I32)[:, None, None].expand(M, 16, 16)
    xs = torch.arange(8, device=dev)
    upext = torch.cat([ul[:, None], up[:, :7]], dim=1)
    lext = torch.cat([ul[:, None], left[:, :7]], dim=1)
    h = ((xs + 1)[None] * (up[:, 8 + xs] - upext[:, 7 - xs])).sum(-1)
    vv = ((xs + 1)[None] * (left[:, 8 + xs] - lext[:, 7 - xs])).sum(-1)
    b = (5 * h + 32) >> 6
    c = (5 * vv + 32) >> 6
    a = 16 * (up[:, 15] + left[:, 15])
    g = torch.arange(16, device=dev) - 7
    plane = ((a[:, None, None] + b[:, None, None] * g[None, None, :]
              + c[:, None, None] * g[None, :, None] + 16) >> 5).clamp(0, 255)
    modes = torch.stack([vert, hor, dc, plane.to(I32)], dim=1)
    return modes[torch.arange(M, device=dev), mode.long()]


def predict_chroma_batch(up, left, ul, mode, avail_up, avail_left):
    """up/left [M, 8], ul [M], mode [M] -> [M, 8, 8]."""
    M = up.shape[0]
    dev = up.device
    us = up.reshape(M, 2, 4).sum(-1)
    ls = left.reshape(M, 2, 4).sum(-1)
    both = avail_up & avail_left
    dc = torch.zeros((M, 8, 8), dtype=I32, device=dev)
    for cy in range(2):
        for cx in range(2):
            if (cx, cy) in ((0, 0), (1, 1)):
                b = (us[:, cx] + ls[:, cy] + 4) >> 3
            elif cx == 1:
                b = (us[:, 1] + 2) >> 2
            else:
                b = (ls[:, 1] + 2) >> 2
            val = torch.where(both, b, torch.where(
                avail_up, (us[:, cx] + 2) >> 2,
                torch.where(avail_left, (ls[:, cy] + 2) >> 2, 128)))
            dc[:, cy * 4:cy * 4 + 4, cx * 4:cx * 4 + 4] = \
                val[:, None, None].to(I32)
    hor = left[:, :, None].expand(M, 8, 8)
    vert = up[:, None, :].expand(M, 8, 8)
    xs = torch.arange(4, device=dev)
    upext = torch.cat([ul[:, None], up[:, :3]], dim=1)
    lext = torch.cat([ul[:, None], left[:, :3]], dim=1)
    h = ((xs + 1)[None] * (up[:, 4 + xs] - upext[:, 3 - xs])).sum(-1)
    vv = ((xs + 1)[None] * (left[:, 4 + xs] - lext[:, 3 - xs])).sum(-1)
    b = (17 * h + 16) >> 5
    c = (17 * vv + 16) >> 5
    a = 16 * (up[:, 7] + left[:, 7])
    g = torch.arange(8, device=dev) - 3
    plane = ((a[:, None, None] + b[:, None, None] * g[None, None, :]
              + c[:, None, None] * g[None, :, None] + 16) >> 5).clamp(0, 255)
    modes = torch.stack([dc, hor, vert, plane.to(I32)], dim=1)
    return modes[torch.arange(M, device=dev), mode.long()]


def intra_params(arrs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-MB intra params [n, 32] int32: lanes 0-3 av_a..av_d, 4 is_i4,
    5 is_i16, 6 i16_mode, 7 chroma_mode, 8 intra chroma, 9:25 the
    Intra4x4 modes in z-order (the TPU kernel's lane map, unpacked)."""
    cls = arrs["mb_class"]
    n = cls.shape[0]
    t = tables(cls.device)
    is_i4 = cls == MB_I4x4
    is_i16 = cls == MB_I16x16
    cols = [arrs[k].to(I32)[:, None] for k in ("av_a", "av_b", "av_c",
                                               "av_d")]
    cols += [is_i4.to(I32)[:, None], is_i16.to(I32)[:, None],
             arrs["i16_mode"].to(I32)[:, None],
             arrs["chroma_mode"].to(I32)[:, None],
             (is_i4 | is_i16).to(I32)[:, None],
             arrs["i4_modes"].reshape(n, 16)[:, t["Z_PERM"].long()]
             .to(I32)]
    P = torch.cat(cols, dim=1)
    return torch.cat([P, P.new_zeros(n, N_PARAMS - P.shape[1])], dim=1) \
        .contiguous()


def intra_wavefront_plain(Y: torch.Tensor, C: torch.Tensor,
                          RY: torch.Tensor, RC: torch.Tensor,
                          P: torch.Tensor, w_mbs: int, h_mbs: int) -> None:
    """Intra reconstruction in place. Y [H, W] u8 and C [2, H/2, W/2] u8
    hold the base planes (inter / I_PCM pixels, 0 at intra MBs); RY
    [n, 16, 16] and RC [n, 2, 8, 8] int32 residuals; P from
    intra_params."""
    w, h = w_mbs, h_mbs
    Yv = Y.view(h, 16, w, 16)
    Cv = C.view(2, h, 8, w, 8)
    for ys, xs in diagonals(w, h, Y.device):
        m = ys.shape[0]
        addr = ys * w + xs
        p = P[addr]
        av_a, av_b, av_c, av_d = (p[:, k] > 0 for k in range(4))
        xl = (xs - 1).clamp(min=0)
        xr = (xs + 1).clamp(max=w - 1)
        yu = (ys - 1).clamp(min=0)
        own = Yv[ys, :, xs, :].to(I32)                   # [m,16,16]
        A = Yv[ys, :, xl, :].to(I32)
        B = Yv[yu, :, xs, :].to(I32)
        Cn = Yv[yu, :, xr, :].to(I32)
        D = Yv[yu, :, xl, :].to(I32)

        up_row = torch.cat([D[:, 15, 15:16], B[:, 15, :], Cn[:, 15, 0:4]],
                           dim=1)                        # [m,21]
        lane0 = torch.arange(21, device=Y.device) == 0
        up_row = torch.where(av_b[:, None] | lane0[None], up_row, 0)
        up_row[:, 0] = torch.where(av_d, up_row[:, 0], 0)
        left_col = torch.where(av_a[:, None], A[:, :, 15], 0)   # [m,16]
        res = RY[addr]

        # ---- Intra4x4: 16 z-order blocks in sequence ------------------
        loc = torch.zeros((m, 17, 25), dtype=I32, device=Y.device)
        loc[:, 0, :21] = up_row
        loc[:, 1:17, 0] = left_col
        for z, (bx, by) in enumerate(BLK_ORDER):
            bx4, by4 = 4 * bx, 4 * by
            code = AVUR_CODE[z]
            ul = loc[:, by4, bx4]
            up8 = loc[:, by4, bx4 + 1:bx4 + 9]
            left4 = loc[:, by4 + 1:by4 + 5, bx4]
            b_av_u = av_b if by == 0 else torch.ones_like(av_b)
            b_av_l = av_a if bx == 0 else torch.ones_like(av_a)
            if code == 0:
                b_av_ur = av_b
            elif code == 1:
                b_av_ur = av_c
            else:
                b_av_ur = torch.full_like(av_b, code == 2)
            ur = torch.where(b_av_ur[:, None], up8[:, 4:8], up8[:, 3:4])
            v = torch.cat([ul[:, None], up8[:, :4], ur, left4], dim=1)
            pred = predict_i4x4_batch(v, p[:, P_I4_MODES + z], b_av_u,
                                      b_av_l)
            blk = (pred + res[:, by4:by4 + 4, bx4:bx4 + 4]).clamp(0, 255)
            loc[:, by4 + 1:by4 + 5, bx4 + 1:bx4 + 5] = blk
        i4_out = loc[:, 1:17, 1:17]

        pred16 = predict_i16_batch(up_row[:, 1:17], left_col, up_row[:, 0],
                                   p[:, P_I16_MODE], av_b, av_a)
        i16_out = (pred16 + res).clamp(0, 255)
        new_y = torch.where((p[:, P_IS_I4] > 0)[:, None, None], i4_out,
                            torch.where((p[:, P_IS_I16] > 0)[:, None, None],
                                        i16_out, own))
        Yv[ys, :, xs, :] = new_y.to(torch.uint8)

        is_ic = (p[:, P_INTRA_C] > 0)[:, None, None]
        for pl in range(2):
            Pv = Cv[pl]
            upc = torch.where(av_b[:, None], Pv[yu, 7, xs, :].to(I32), 0)
            ulc = torch.where(av_d, Pv[yu, 7, xl, 7].to(I32), 0)
            leftc = torch.where(av_a[:, None], Pv[ys, :, xl, 7].to(I32), 0)
            predc = predict_chroma_batch(upc, leftc, ulc, p[:, P_C_MODE],
                                         av_b, av_a)
            outc = (predc + RC[addr, pl]).clamp(0, 255)
            Pv[ys, :, xs, :] = torch.where(
                is_ic, outc, Pv[ys, :, xs, :].to(I32)).to(torch.uint8)
