"""Picture reconstruction — NumPy reference backend.

Orchestrates residual (dequant+IDCT), intra prediction, inter MC, and
I_PCM writes over a whole picture (reference:
h264bsd_macroblock_layer.c:964 h264bsdDecodeMacroblock, ProcessResidual
:1343; image writes h264bsd_image.c:80/171).

MBs are processed in ascending address order; intra prediction reads only
lower-address same-slice MBs so this matches bitstream decode order for
every slice-group configuration. This module is the bit-exactness oracle
for the torch backend (core/recon.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..bitstream.mb_layer import (MB_I4x4, MB_I16x16, MB_IPCM, MB_P,
                                  PictureData)
from ..ops import inter as ops_inter
from ..ops import intra as ops_intra
from ..ops import transform as ops_t

# 4x4 blocks with no up-right neighbour *within* the MB (z-order decode)
_NO_UPRIGHT = {(1, 1), (3, 1), (1, 3), (3, 2), (3, 3)}


class Frame:
    """One decoded picture: planar YUV420, uint8."""

    __slots__ = ("y", "cb", "cr")

    def __init__(self, width: int, height: int) -> None:
        self.y = np.zeros((height, width), np.uint8)
        self.cb = np.zeros((height // 2, width // 2), np.uint8)
        self.cr = np.zeros((height // 2, width // 2), np.uint8)

    def tobytes(self) -> bytes:
        return (self.y.tobytes() + self.cb.tobytes() + self.cr.tobytes())


def _mb_residuals(pic: PictureData, addr: int, chroma_qp_offset: int):
    """Residual [16,16] luma + 2x [8,8] chroma int32 for one MB."""
    qp = int(pic.qp[addr])
    is_i16 = pic.mb_class[addr] == MB_I16x16
    cbp = int(pic.cbp[addr])

    luma = np.zeros((16, 16), np.int32)
    any_luma = cbp & 15 or is_i16
    if any_luma:
        coeffs = pic.luma_coeffs[addr].reshape(16, 16)
        qps = np.full(16, qp, np.int32)
        if is_i16:
            dc = ops_t.luma_dc_transform(pic.luma_dc[addr][None], qps[:1])[0]
            res = ops_t.dequant_idct(coeffs, qps, dc=dc.reshape(16))
        else:
            res = ops_t.dequant_idct(coeffs, qps)
            # zero out blocks without coefficients (cbp gating)
            for by in range(4):
                for bx in range(4):
                    blk8 = (by // 2) * 2 + (bx // 2)
                    if not (cbp & (1 << blk8)):
                        res[by * 4 + bx] = 0
        for by in range(4):
            for bx in range(4):
                luma[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = res[by * 4 + bx]

    chroma = np.zeros((2, 8, 8), np.int32)
    cbp_c = cbp >> 4
    if cbp_c:
        qpc = int(ops_t.QP_C[min(max(qp + chroma_qp_offset, 0), 51)])
        qps = np.full(8, qpc, np.int32)
        dc = ops_t.chroma_dc_transform(pic.chroma_dc[addr], qps[:2])
        coeffs = pic.chroma_ac[addr].reshape(8, 16)
        res = ops_t.dequant_idct(coeffs, qps, dc=dc.reshape(8))
        for comp in range(2):
            for cy in range(2):
                for cx in range(2):
                    chroma[comp, cy * 4:cy * 4 + 4, cx * 4:cx * 4 + 4] = \
                        res[comp * 4 + cy * 2 + cx]
    return luma, chroma


def _intra_avail(pic: PictureData, addr: int, constrained: bool):
    """(left, up, upleft, upright) MB availability for intra prediction
    (same slice; constrained_intra_pred excludes inter MBs)."""
    w = pic.width_mbs

    def ok(n):
        if n is None or not pic.decoded[n]:
            return False
        if pic.slice_id[n] != pic.slice_id[addr]:
            return False
        if constrained and pic.mb_class[n] == MB_P:
            return False
        return True

    x, y = addr % w, addr // w
    a = addr - 1 if x > 0 else None
    b = addr - w if y > 0 else None
    d = addr - w - 1 if (x > 0 and y > 0) else None
    c = addr - w + 1 if (y > 0 and x + 1 < w) else None
    return ok(a), ok(b), ok(d), ok(c)


def reconstruct_picture(pic: PictureData, chroma_qp_offset: int,
                        constrained_intra: bool,
                        ref_frames: Dict[int, Frame],
                        width: int, height: int,
                        frame: Frame = None) -> Frame:
    if frame is None:
        frame = Frame(width, height)
    y_pl, cb_pl, cr_pl = frame.y, frame.cb, frame.cr
    w_mbs = pic.width_mbs

    for addr in range(pic.n_mbs):
        if not pic.decoded[addr]:
            continue
        mbx, mby = addr % w_mbs, addr // w_mbs
        px, py = mbx * 16, mby * 16
        cx, cy = mbx * 8, mby * 8
        cls = pic.mb_class[addr]

        if cls == MB_IPCM:
            raw = pic.ipcm[addr]
            y_pl[py:py + 16, px:px + 16] = raw[:256].reshape(16, 16)
            cb_pl[cy:cy + 8, cx:cx + 8] = raw[256:320].reshape(8, 8)
            cr_pl[cy:cy + 8, cx:cx + 8] = raw[320:384].reshape(8, 8)
            continue

        luma_res, chroma_res = _mb_residuals(pic, addr, chroma_qp_offset)

        if cls == MB_P:
            pred_y = np.zeros((16, 16), np.int32)
            pred_cb = np.zeros((8, 8), np.int32)
            pred_cr = np.zeros((8, 8), np.int32)
            # one MC call per 4x4 block (correct for any partitioning;
            # larger-block fast paths are a backend optimization)
            done = np.zeros((4, 4), bool)
            for by in range(4):
                for bx in range(4):
                    if done[by, bx]:
                        continue
                    mv = pic.mv[addr, by, bx]
                    slot = int(pic.ref_slot[addr, by // 2, bx // 2])
                    # merge equal-mv/slot runs? keep per-4x4 for clarity
                    ref = ref_frames[slot]
                    bpx, bpy = px + bx * 4, py + by * 4
                    pred_y[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = \
                        ops_inter.mc_luma(ref.y, bpx, bpy,
                                          int(mv[0]), int(mv[1]), 4, 4)
                    pred_cb[by * 2:by * 2 + 2, bx * 2:bx * 2 + 2] = \
                        ops_inter.mc_chroma(ref.cb, cx + bx * 2, cy + by * 2,
                                            int(mv[0]), int(mv[1]), 2, 2)
                    pred_cr[by * 2:by * 2 + 2, bx * 2:bx * 2 + 2] = \
                        ops_inter.mc_chroma(ref.cr, cx + bx * 2, cy + by * 2,
                                            int(mv[0]), int(mv[1]), 2, 2)
            y_pl[py:py + 16, px:px + 16] = np.clip(pred_y + luma_res, 0, 255)
            cb_pl[cy:cy + 8, cx:cx + 8] = np.clip(pred_cb + chroma_res[0],
                                                  0, 255)
            cr_pl[cy:cy + 8, cx:cx + 8] = np.clip(pred_cr + chroma_res[1],
                                                  0, 255)
            continue

        # intra MBs
        av_l, av_u, av_ul, av_ur = _intra_avail(pic, addr, constrained_intra)

        if cls == MB_I16x16:
            up = y_pl[py - 1, px:px + 16].astype(np.int32) if av_u \
                else np.zeros(16, np.int32)
            left = y_pl[py:py + 16, px - 1].astype(np.int32) if av_l \
                else np.zeros(16, np.int32)
            ul = int(y_pl[py - 1, px - 1]) if av_ul else 0
            pred = ops_intra.intra16x16(int(pic.i16_mode[addr]), up, left,
                                        ul, av_u, av_l)
            y_pl[py:py + 16, px:px + 16] = np.clip(pred + luma_res, 0, 255)
        else:  # I4x4: per-block z-order with evolving frame state
            from ..bitstream.mb_layer import BLK_ORDER
            for blk in range(16):
                bx, by = BLK_ORDER[blk]
                bpx, bpy = px + bx * 4, py + by * 4
                b_av_u = av_u if by == 0 else True
                b_av_l = av_l if bx == 0 else True
                if bx == 0 and by == 0:
                    b_av_ul = av_ul
                elif bx == 0:
                    b_av_ul = av_l
                elif by == 0:
                    b_av_ul = av_u
                else:
                    b_av_ul = True
                if by == 0:
                    b_av_ur = (av_u if bx < 3 else av_ur)
                else:
                    b_av_ur = (bx, by) not in _NO_UPRIGHT
                up8 = np.zeros(8, np.int32)
                left4 = np.zeros(4, np.int32)
                ul = 0
                if b_av_u:
                    up8[:4] = y_pl[bpy - 1, bpx:bpx + 4]
                    if b_av_ur and bpx + 8 <= width:
                        up8[4:] = y_pl[bpy - 1, bpx + 4:bpx + 8]
                    else:
                        up8[4:] = up8[3]
                if b_av_l:
                    left4[:] = y_pl[bpy:bpy + 4, bpx - 1]
                if b_av_ul:
                    ul = int(y_pl[bpy - 1, bpx - 1])
                mode = int(pic.i4_modes[addr, by, bx])
                pred = ops_intra.intra4x4(mode, up8, left4, ul,
                                          b_av_u, b_av_l)
                res = luma_res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
                y_pl[bpy:bpy + 4, bpx:bpx + 4] = np.clip(pred + res, 0, 255)

        # intra chroma
        up = cb_pl[cy - 1, cx:cx + 8].astype(np.int32) if av_u \
            else np.zeros(8, np.int32)
        left = cb_pl[cy:cy + 8, cx - 1].astype(np.int32) if av_l \
            else np.zeros(8, np.int32)
        ul = int(cb_pl[cy - 1, cx - 1]) if av_ul else 0
        mode = int(pic.chroma_mode[addr])
        pred = ops_intra.intra_chroma(mode, up, left, ul, av_u, av_l)
        cb_pl[cy:cy + 8, cx:cx + 8] = np.clip(pred + chroma_res[0], 0, 255)
        up = cr_pl[cy - 1, cx:cx + 8].astype(np.int32) if av_u \
            else np.zeros(8, np.int32)
        left = cr_pl[cy:cy + 8, cx - 1].astype(np.int32) if av_l \
            else np.zeros(8, np.int32)
        ul = int(cr_pl[cy - 1, cx - 1]) if av_ul else 0
        pred = ops_intra.intra_chroma(mode, up, left, ul, av_u, av_l)
        cr_pl[cy:cy + 8, cx:cx + 8] = np.clip(pred + chroma_res[1], 0, 255)

    return frame
