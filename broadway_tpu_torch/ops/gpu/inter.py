"""Inter prediction, plain torch version (K1's plain counterpart).

Twin of ``broadway_tpu.ops.tpu.inter`` (``mc_luma_blocks``,
``mc_chroma_blocks_il``) and ``recon_tpu.mc_predict_xla``: every 4x4
luma block and its 2x2 chroma blocks predicted in one batched pass.

The reference planes are the port's unpadded uint8 stacks. Each window
coordinate is clamped into the picture, which equals the JAX origin
clip into its PAD-24 edge-replicated planes (core/state.py) and the
reference's h264bsdFillBlock. Shifts and masks (``>>``, ``& 3``,
``& 7``) split the motion vectors: never ``/`` or ``%``, which round
negative vectors the wrong way.
"""

from __future__ import annotations

from typing import Tuple

import torch

I32 = torch.int32


def _tap6(a: torch.Tensor, dim: int) -> torch.Tensor:
    n = a.shape[dim] - 5
    s = lambda i: a.narrow(dim, i, n)
    return s(0) - 5 * s(1) + 20 * s(2) + 20 * s(3) - 5 * s(4) + s(5)


def _clip8(a):
    return a.clamp(0, 255)


def _avg(a, c):
    return (a + c + 1) >> 1


def _windows(plane_stack: torch.Tensor, ridx: torch.Tensor,
             y0: torch.Tensor, x0: torch.Tensor, hw: int, ww: int
             ) -> torch.Tensor:
    """Gather [N, hw, ww] windows at (y0, x0) of stack slot ridx with
    every coordinate clamped into the plane."""
    H, W = plane_stack.shape[-2:]
    dev = plane_stack.device
    rows = (y0[:, None] + torch.arange(hw, device=dev)).clamp(0, H - 1)
    cols = (x0[:, None] + torch.arange(ww, device=dev)).clamp(0, W - 1)
    return plane_stack[ridx.long()[:, None, None], rows.long()[:, :, None],
                       cols.long()[:, None, :]].to(I32)


def mc_luma_blocks(ref_y: torch.Tensor, ridx, px, py, mvx, mvy
                   ) -> torch.Tensor:
    """N 4x4 luma blocks -> [N, 4, 4] int32 in [0, 255].

    ref_y [R, H, W] uint8; ridx/px/py/mvx/mvy [N] int32."""
    win = _windows(ref_y, ridx, py + (mvy >> 2) - 2, px + (mvx >> 2) - 2,
                   10, 10)                               # [N,10,10]
    fx = mvx & 3
    fy = mvy & 3
    raw_h = _tap6(win, 2)                                # [N,10,5]
    b = _clip8((raw_h[:, 2:7, :] + 16) >> 5)             # [N,5,5]
    hh = _clip8((_tap6(win[:, :, 2:7], 1) + 16) >> 5)    # [N,5,5]
    # centre half-pel j: from the UNCLIPPED horizontal sums
    jj = _clip8((_tap6(raw_h, 1) + 512) >> 10)           # [N,5,5]
    g = win[:, 2:7, 2:7]
    g00, g01, g10 = g[:, :4, :4], g[:, :4, 1:5], g[:, 1:5, :4]
    b0, b1 = b[:, :4, :4], b[:, 1:5, :4]
    h0, h1 = hh[:, :4, :4], hh[:, :4, 1:5]
    j0 = jj[:, :4, :4]
    cand = torch.stack([
        g00, _avg(g00, b0), b0, _avg(g01, b0),
        _avg(g00, h0), _avg(b0, h0), _avg(j0, b0), _avg(b0, h1),
        h0, _avg(j0, h0), j0, _avg(j0, h1),
        _avg(g10, h0), _avg(b1, h0), _avg(j0, b1), _avg(b1, h1),
    ], dim=1)                                            # [N,16,4,4]
    case = (fy * 4 + fx).long()
    return cand[torch.arange(case.shape[0], device=case.device), case]


def mc_chroma_blocks(ref_c: torch.Tensor, ridx, px, py, mvx, mvy
                     ) -> torch.Tensor:
    """N 2x2 chroma block pairs -> [N, 2, 2, 2] int32 (plane, row, col).

    ref_c [R, 2, Hc, Wc] uint8; px/py chroma-plane block positions."""
    N = ridx.shape[0]
    out = []
    for p in range(2):
        win = _windows(ref_c[:, p], ridx, py + (mvy >> 3), px + (mvx >> 3),
                       3, 3)                             # [N,3,3]
        dx = (mvx & 7)[:, None, None]
        dy = (mvy & 7)[:, None, None]
        A, B = win[:, :2, :2], win[:, :2, 1:3]
        C, D = win[:, 1:3, :2], win[:, 1:3, 1:3]
        out.append(((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B
                    + (8 - dx) * dy * C + dx * dy * D + 32) >> 6)
    return torch.stack(out, dim=1).reshape(N, 2, 2, 2)


def mc_predict_plain(ref_y: torch.Tensor, ref_c: torch.Tensor,
                     mv: torch.Tensor, ref_blk: torch.Tensor, w_mbs: int,
                     h_mbs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain whole-picture MC; same contract as the K1 wrapper
    (``mc_kernel.mc_predict``): pred_y [n, 16, 16] uint8 and pred_c
    [n, 8, 16] uint8 with lane 2k = cb column k, 2k+1 = cr column k, and 0
    in every 4x4 block (and its 2x2 chroma blocks) whose ref_blk < 0."""
    n = mv.shape[0]
    dev = mv.device
    R = ref_y.shape[0]
    mb = torch.arange(n, device=dev, dtype=I32)
    pxv = (mb % w_mbs) * 16
    pyv = (mb // w_mbs) * 16
    bx = torch.arange(4, device=dev, dtype=I32)[None, None, :]
    by = torch.arange(4, device=dev, dtype=I32)[None, :, None]
    bpx = (pxv[:, None, None] + bx * 4).expand(n, 4, 4).reshape(-1)
    bpy = (pyv[:, None, None] + by * 4).expand(n, 4, 4).reshape(-1)
    mvx = mv[..., 0].reshape(-1)
    mvy = mv[..., 1].reshape(-1)
    # ref_blk is -1 on intra MBs: such a block predicts nothing. Its
    # window is gathered from slot 0 all the same (one batched pass) and
    # the result zeroed.
    used = (ref_blk.reshape(-1) >= 0)[:, None, None]
    ridx = ref_blk.reshape(-1).clamp(0, R - 1)

    pred_y = mc_luma_blocks(ref_y, ridx, bpx, bpy, mvx, mvy) * used
    pred_y = pred_y.reshape(n, 4, 4, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)
    cpx = ((pxv // 2)[:, None, None] + bx * 2).expand(n, 4, 4).reshape(-1)
    cpy = ((pyv // 2)[:, None, None] + by * 2).expand(n, 4, 4).reshape(-1)
    pc = mc_chroma_blocks(ref_c, ridx, cpx, cpy, mvx, mvy) \
        * used[..., None]                                   # [n*16,p,r,c]
    # -> [n, by, r, bx, c, p] -> [n, 8 rows, 16 lanes (2*col + plane)]
    pred_c = pc.reshape(n, 4, 4, 2, 2, 2).permute(0, 1, 4, 2, 5, 3) \
        .reshape(n, 8, 16)
    return pred_y.to(torch.uint8).contiguous(), \
        pred_c.to(torch.uint8).contiguous()
