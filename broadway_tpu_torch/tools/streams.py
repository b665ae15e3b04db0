"""Named test-stream scenarios built on the syntax encoder (h264enc.py).

Each generator returns (annexb_bytes, info dict). The reference decoder
(build/oracle/dectest) defines golden YUV output for every scenario; the
TPU decoder must match bit-exactly (reference test strategy: golden-output
comparison, Decoder/src/DecTestBench.c:442).
"""

from __future__ import annotations

import dataclasses
import random
from typing import List

from .h264enc import (PpsConfig, SliceConfig, SpsConfig, write_pps,
                     write_slice, write_sps)


def _pcm_mb(rng, addr):
    return {
        "kind": "ipcm",
        "addr": addr,
        "luma": bytes(rng.randrange(256) for _ in range(256)),
        "cb": bytes(rng.randrange(256) for _ in range(64)),
        "cr": bytes(rng.randrange(256) for _ in range(64)),
    }


def ipcm_stream(width_mbs=4, height_mbs=3, n_frames=3, seed=7,
                deblock=False):
    """All-I_PCM IDR frames: exercises NAL/SPS/PPS/slice/MB plumbing and
    raw sample writes without prediction or residuals."""
    rng = random.Random(seed)
    sps = SpsConfig(width_mbs=width_mbs, height_mbs=height_mbs, poc_type=2,
                    num_ref_frames=1)
    pps = PpsConfig()
    out = [write_sps(sps), write_pps(pps)]
    n_mbs = width_mbs * height_mbs
    for f in range(n_frames):
        cfg = SliceConfig(
            slice_type="I", idr=True, idr_pic_id=f, frame_num=0,
            sps=sps, pps=pps,
            disable_deblocking_idc=1 if not deblock else 0)
        mbs = [_pcm_mb(rng, a) for a in range(n_mbs)]
        out.append(write_slice(cfg, mbs))
    info = {"width": width_mbs * 16, "height": height_mbs * 16,
            "n_frames": n_frames, "sps": sps, "pps": pps}
    return b"".join(out), info


from .cavlc_enc import BLK_INDEX, BLK_ORDER  # noqa: E402


class IntraModeTracker:
    """Tracks per-4x4-block intra prediction modes across a slice to
    (a) compute legal mode sets per block availability and (b) derive the
    most-probable mode so the generator can emit prev_intra4x4_pred_mode
    flags (spec 8.3.1.1)."""

    def __init__(self, width_mbs, height_mbs):
        self.w = width_mbs
        self.h = height_mbs
        # mode per 4x4 block in block coords; -1 = not intra4x4-coded
        self.modes = [[-1] * (4 * width_mbs) for _ in range(4 * height_mbs)]
        # MB availability per address: True once coded in this slice
        self.mb_coded = [False] * (width_mbs * height_mbs)
        self.mb_i4x4 = [False] * (width_mbs * height_mbs)

    def _mb_avail(self, addr):
        return addr >= 0 and self.mb_coded[addr]

    def block_avail(self, addr, blk):
        """(up_avail, left_avail) for luma 4x4 block `blk` of MB `addr`."""
        bx, by = BLK_ORDER[blk]
        mbx, mby = addr % self.w, addr // self.w
        gx, gy = mbx * 4 + bx, mby * 4 + by
        if by == 0:
            up = mby > 0 and self._mb_avail(addr - self.w)
        else:
            up = True
        if bx == 0:
            left = mbx > 0 and self._mb_avail(addr - 1)
        else:
            left = True
        return up, left, gx, gy

    def legal_modes(self, addr, blk):
        up, left, _, _ = self.block_avail(addr, blk)
        legal = [2]
        if up:
            legal += [0, 3, 7]
        if left:
            legal += [1, 8]
        if up and left:
            # modes 4,5,6 need the up-left pel: available iff both up and
            # left MB-rows exist; up-left corner handled by h264bsd via
            # neighbouring MB D. Require the D MB too for border blocks.
            bx, by = BLK_ORDER[blk]
            mbx, mby = addr % self.w, addr // self.w
            if bx == 0 and by == 0:
                dd = mbx > 0 and mby > 0 and self._mb_avail(addr - self.w - 1)
            elif bx == 0:
                dd = mbx > 0 and self._mb_avail(addr - 1)
            elif by == 0:
                dd = mby > 0 and self._mb_avail(addr - self.w)
            else:
                dd = True
            if dd:
                legal += [4, 5, 6]
        return legal

    def most_probable(self, addr, blk):
        bx, by = BLK_ORDER[blk]
        mbx, mby = addr % self.w, addr // self.w
        gx, gy = mbx * 4 + bx, mby * 4 + by
        # neighbour A: left block, B: up block
        if gx == 0 or (bx == 0 and not self._mb_avail(addr - 1)):
            ma = None
        else:
            ma = self.modes[gy][gx - 1]
        if gy == 0 or (by == 0 and not self._mb_avail(addr - self.w)):
            mb = None
        else:
            mb = self.modes[gy - 1][gx]
        if ma is None or mb is None:
            return 2
        ma = 2 if ma < 0 else ma
        mb = 2 if mb < 0 else mb
        return min(ma, mb)

    def legal_chroma_modes(self, addr):
        mbx, mby = addr % self.w, addr // self.w
        up = mby > 0 and self._mb_avail(addr - self.w)
        left = mbx > 0 and self._mb_avail(addr - 1)
        legal = [0]                     # DC always
        if left:
            legal.append(1)
        if up:
            legal.append(2)
        if up and left and self._mb_avail(addr - self.w - 1):
            legal.append(3)
        return legal

    def set_mode(self, addr, blk, mode):
        bx, by = BLK_ORDER[blk]
        mbx, mby = addr % self.w, addr // self.w
        self.modes[mby * 4 + by][mbx * 4 + bx] = mode

    def mark_mb(self, addr, i4x4=False):
        self.mb_coded[addr] = True
        self.mb_i4x4[addr] = i4x4

    def random_i4x4_mb(self, rng, addr, cbp=0, residual=None):
        """Pick legal random modes for all 16 blocks; returns the mb dict."""
        modes_syntax = []
        for blk in range(16):
            legal = self.legal_modes(addr, blk)
            mp = self.most_probable(addr, blk)
            if rng.random() < 0.3 and mp in legal:
                mode = mp
                modes_syntax.append((1, 0))
            else:
                mode = rng.choice(legal)
                if mode == mp:
                    modes_syntax.append((1, 0))
                else:
                    rem = mode if mode < mp else mode - 1
                    modes_syntax.append((0, rem))
            self.set_mode(addr, blk, mode)
        chroma_mode = rng.choice(self.legal_chroma_modes(addr))
        self.mark_mb(addr, i4x4=True)
        return {"kind": "i4x4", "addr": addr, "modes": modes_syntax,
                "chroma_mode": chroma_mode, "cbp": cbp, "residual": residual}


def _rand_coeffs(rng, n, density=0.4, pool=(1, -1, 2, -3, 5, -8, 15, -25)):
    """Random scan-order coefficient list of length n."""
    return [rng.choice(pool) if rng.random() < density else 0
            for _ in range(n)]


def _residual_in_range(rd, kind, qp, chroma_qp_offset=0):
    """Check the reference's [-512,511] IDCT output rule
    (h264bsd_transform.c:94) using our own transform kernels."""
    import numpy as np
    from ..ops import transform as T
    qpa = np.array([qp], np.int32)
    if kind == "i16":
        dcs = T.luma_dc_transform(
            np.array([(rd.luma_dc or [0] * 16)], np.int32), qpa)[0].reshape(16)
        for blk in range(16):
            coeffs = np.zeros(16, np.int32)
            ac = rd.luma.get(blk)
            if ac:
                coeffs[1:16] = ac
            # DC order: dcs raster index = by*4+bx; blk is z-order
            from .cavlc_enc import BLK_ORDER
            bx, by = BLK_ORDER[blk]
            r = T.dequant_idct(coeffs[None], qpa,
                               dc=np.array([dcs[by * 4 + bx]], np.int32))
            if r.min() < -512 or r.max() > 511:
                return False
    else:
        for blk, ac in rd.luma.items():
            r = T.dequant_idct(np.array([ac + [0] * (16 - len(ac))],
                                        np.int32), qpa)
            if r.min() < -512 or r.max() > 511:
                return False
    qpc = int(T.QP_C[min(max(qp + chroma_qp_offset, 0), 51)])
    qpca = np.array([qpc], np.int32)
    for comp in range(2):
        dcin = rd.chroma_dc.get(comp)
        dcs = T.chroma_dc_transform(
            np.array([dcin + [0] * (4 - len(dcin)) if dcin else [0] * 4],
                     np.int32), qpca)[0]
        for blk in range(4):
            coeffs = np.zeros(16, np.int32)
            ac = rd.chroma_ac.get((comp, blk))
            if ac:
                coeffs[1:16] = ac
            r = T.dequant_idct(coeffs[None], qpca,
                               dc=np.array([dcs[blk]], np.int32))
            if r.min() < -512 or r.max() > 511:
                return False
    return True


def _rand_residual(rng, kind, cbp, cbp_chroma, qp=28, chroma_qp_offset=0,
                   ladder_start=0):
    """ResidualData for an MB, guaranteed within the reference's IDCT
    range rules. kind: 'i4x4'|'i16'|'inter'. ladder_start > 0 begins at
    a sparser coefficient profile (realistic-content density)."""
    from .cavlc_enc import ResidualData
    ladder = [((1, -1, 2, -3, 5, -8, 15, -25), 0.4, 0.5),
              ((1, -1, 2, -3, 5, -8, 15, -25), 0.4, 0.5),
              ((1, -1, 2, -2, 4, -4), 0.35, 0.4),
              ((1, -1, 2, -2, 4, -4), 0.35, 0.4),
              ((1, -1, 2, -2), 0.3, 0.3),
              ((1, -1, 2, -2), 0.3, 0.3),
              ((1, -1), 0.2, 0.2),
              ((1, -1), 0.15, 0.15),
              ((1, -1), 0.08, 0.08),
              ((1, -1), 0.04, 0.04)]
    for pool, density, dc_density in ladder[ladder_start:]:
        rd = ResidualData()
        if kind == "i16":
            rd.luma_dc = _rand_coeffs(rng, 16, dc_density, pool)
            nluma = 15
        else:
            nluma = 16
        rd.luma = {}
        for blk8 in range(4):
            if cbp & (1 << blk8):
                for sub in range(4):
                    blk = blk8 * 4 + sub
                    if rng.random() < 0.8:
                        rd.luma[blk] = _rand_coeffs(rng, nluma, density, pool)
        if cbp_chroma:
            for comp in range(2):
                rd.chroma_dc[comp] = _rand_coeffs(rng, 4, dc_density, pool)
        if cbp_chroma == 2:
            for comp in range(2):
                for blk in range(4):
                    if rng.random() < 0.7:
                        rd.chroma_ac[(comp, blk)] = _rand_coeffs(
                            rng, 15, density, pool)
        if _residual_in_range(rd, kind, qp, chroma_qp_offset):
            return rd
    return ResidualData()  # empty residual always passes


def _i16_legal_modes(tracker, addr):
    w = tracker.w
    mbx, mby = addr % w, addr // w
    up = mby > 0 and tracker._mb_avail(addr - w)
    left = mbx > 0 and tracker._mb_avail(addr - 1)
    legal = [2]
    if up:
        legal.append(0)
    if left:
        legal.append(1)
    if up and left and tracker._mb_avail(addr - w - 1):
        legal.append(3)
    return legal


def intra_mixed_stream(width_mbs=5, height_mbs=4, n_frames=3, seed=21,
                       deblock=False, qp=28):
    """I frames mixing I_PCM / Intra4x4 / Intra16x16 with CAVLC residuals,
    random CBPs and mb_qp_delta — exercises the full intra + transform
    path."""
    rng = random.Random(seed)
    sps = SpsConfig(width_mbs=width_mbs, height_mbs=height_mbs, poc_type=2)
    pps = PpsConfig(pic_init_qp=qp)
    out = [write_sps(sps), write_pps(pps)]
    n_mbs = width_mbs * height_mbs
    for f in range(n_frames):
        cur_qp = qp
        cfg = SliceConfig(slice_type="I", idr=True, idr_pic_id=f,
                          sps=sps, pps=pps, slice_qp=qp, pic_init_qp=qp,
                          disable_deblocking_idc=1 if not deblock else 0)
        tracker = IntraModeTracker(width_mbs, height_mbs)
        mbs = []
        for a in range(n_mbs):
            kind = rng.choices(["ipcm", "i4x4", "i16"],
                               weights=[1, 3, 3])[0]
            if kind == "ipcm":
                mbs.append(_pcm_mb(rng, a))
                tracker.mark_mb(a)
                continue
            if kind == "i16":
                mode = rng.choice(_i16_legal_modes(tracker, a))
                cbp_luma = rng.choice([0, 1])
                cbp_chroma = rng.randrange(3)
                qd = rng.choice([0, 0, 0, 1, -1, 2, -3])
                if not (0 <= cur_qp + qd <= 51):
                    qd = 0
                cur_qp += qd
                rd = _rand_residual(rng, "i16", 15 if cbp_luma else 0,
                                    cbp_chroma, qp=cur_qp)
                mbs.append({"kind": "i16", "addr": a, "pred_mode": mode,
                            "cbp_luma": cbp_luma, "cbp_chroma": cbp_chroma,
                            "chroma_mode": rng.choice(
                                tracker.legal_chroma_modes(a)),
                            "qp_delta": qd, "residual": rd})
                tracker.mark_mb(a)
                continue
            # i4x4 with residuals
            cbp_luma = rng.randrange(16)
            cbp_chroma = rng.randrange(3)
            cbp = cbp_luma | (cbp_chroma << 4)
            mb = tracker.random_i4x4_mb(rng, a, cbp=cbp)
            if cbp:
                qd = rng.choice([0, 0, 1, -1])
                if not (0 <= cur_qp + qd <= 51):
                    qd = 0
                cur_qp += qd
                mb["qp_delta"] = qd
                mb["residual"] = _rand_residual(rng, "i4x4", cbp_luma,
                                                cbp_chroma, qp=cur_qp)
            mbs.append(mb)
        out.append(write_slice(cfg, mbs))
    info = {"width": width_mbs * 16, "height": height_mbs * 16,
            "n_frames": n_frames}
    return b"".join(out), info


def inter_stream(width_mbs=5, height_mbs=4, n_frames=6, seed=77, qp=28,
                 num_ref_frames=1, deblock=False, mvd_range=40,
                 p8x8=True, intra_in_p=True, multi_ref_idx=False,
                 log2_max_frame_num=5):
    """IDR + P frames exercising P_Skip, 16x16/16x8/8x16/8x8 partitions
    with sub-partitions, quarter-pel MVs (incl. out-of-picture for edge
    extension), inter residuals, multi-reference, and intra MBs inside
    P slices."""
    rng = random.Random(seed)
    sps = SpsConfig(width_mbs=width_mbs, height_mbs=height_mbs, poc_type=2,
                    num_ref_frames=num_ref_frames,
                    log2_max_frame_num=log2_max_frame_num)
    pps = PpsConfig(pic_init_qp=qp)
    out = [write_sps(sps), write_pps(pps)]
    n_mbs = width_mbs * height_mbs

    def mvd(scale=1):
        return (rng.randint(-mvd_range, mvd_range) * scale,
                rng.randint(-mvd_range, mvd_range) * scale)

    for f in range(n_frames):
        is_idr = f == 0
        num_active = min(num_ref_frames, f) if not is_idr else 0
        num_active = max(num_active, 1)
        cfg = SliceConfig(
            slice_type="I" if is_idr else "P",
            idr=is_idr, idr_pic_id=0,
            frame_num=f % (1 << log2_max_frame_num),
            sps=sps, pps=pps, slice_qp=qp, pic_init_qp=qp,
            num_ref_idx_override=(num_active
                                  if not is_idr and num_active > 1 else None),
            disable_deblocking_idc=1 if not deblock else 0)
        tracker = IntraModeTracker(width_mbs, height_mbs)
        mbs = []
        cur_qp = qp
        for a in range(n_mbs):
            if is_idr:
                if a % 4 == 0:
                    mbs.append(_pcm_mb(rng, a))
                    tracker.mark_mb(a)
                else:
                    cbp_luma = rng.randrange(16)
                    cbp_chroma = rng.randrange(3)
                    cbp = cbp_luma | (cbp_chroma << 4)
                    mb = tracker.random_i4x4_mb(rng, a, cbp=cbp)
                    if cbp:
                        mb["qp_delta"] = 0
                        mb["residual"] = _rand_residual(
                            rng, "i4x4", cbp_luma, cbp_chroma, qp=cur_qp)
                    mbs.append(mb)
                continue
            kinds = ["skip", "p16x16", "pNxM"]
            weights = [3, 4, 2]
            if p8x8:
                kinds.append("p8x8")
                weights.append(2)
            if intra_in_p:
                kinds += ["i4x4", "ipcm"]
                weights += [1, 0.5]
            kind = rng.choices(kinds, weights=weights)[0]

            def pick_ref():
                return rng.randrange(num_active) if multi_ref_idx else 0

            if kind == "skip":
                mbs.append({"kind": "skip", "addr": a})
                tracker.mark_mb(a)
                continue
            if kind == "ipcm":
                mb = _pcm_mb(rng, a)
                mb["p_slice"] = True
                mbs.append(mb)
                tracker.mark_mb(a)
                continue
            if kind == "i4x4":
                cbp_luma = rng.randrange(16)
                cbp_chroma = rng.randrange(3)
                cbp = cbp_luma | (cbp_chroma << 4)
                mb = tracker.random_i4x4_mb(rng, a, cbp=cbp)
                mb["p_slice"] = True
                if cbp:
                    mb["qp_delta"] = 0
                    mb["residual"] = _rand_residual(
                        rng, "i4x4", cbp_luma, cbp_chroma, qp=cur_qp)
                mbs.append(mb)
                continue
            cbp = rng.choice([0, 0, rng.randrange(48)])
            rd = None
            if cbp:
                rd = _rand_residual(rng, "inter", cbp & 15, cbp >> 4,
                                    qp=cur_qp)
            if kind == "p16x16":
                mbs.append({"kind": "p16x16", "addr": a,
                            "ref_idx": pick_ref(), "num_ref": num_active,
                            "mvd": mvd(), "cbp": cbp, "residual": rd,
                            "qp_delta": 0})
            elif kind == "pNxM":
                mbs.append({"kind": "pNxM", "addr": a,
                            "mb_type": rng.choice([1, 2]),
                            "ref_idx": [pick_ref(), pick_ref()],
                            "num_ref": num_active,
                            "mvds": [mvd(), mvd()], "cbp": cbp,
                            "residual": rd, "qp_delta": 0})
            else:
                sub_types = [rng.randrange(4) for _ in range(4)]
                from .h264enc import SliceConfig as _SC  # noqa
                from . import cavlc_enc
                nparts = {0: 1, 1: 2, 2: 2, 3: 4}
                mvds = [[mvd() for _ in range(nparts[st])]
                        for st in sub_types]
                mbs.append({"kind": "p8x8", "addr": a,
                            "mb_type": rng.choice([3, 3, 3, 4]),
                            "sub_types": sub_types,
                            "ref_idx": [pick_ref() for _ in range(4)],
                            "num_ref": num_active,
                            "mvds": mvds, "cbp": cbp, "residual": rd,
                            "qp_delta": 0})
            tracker.mark_mb(a)
        out.append(write_slice(cfg, mbs))
    info = {"width": width_mbs * 16, "height": height_mbs * 16,
            "n_frames": n_frames}
    return b"".join(out), info


def _mixed_mb_list(rng, tracker, addrs, qp, is_p=False, num_active=1,
                   mvd_range=24, chroma_qp_offset=0):
    """Random MB payloads for the given addresses (decode order)."""
    mbs = []
    for a in addrs:
        if is_p:
            kind = rng.choices(["skip", "p16x16", "pNxM", "p8x8", "i4x4"],
                               weights=[2, 3, 2, 2, 1])[0]
        else:
            kind = rng.choices(["ipcm", "i4x4", "i16"], weights=[1, 3, 3])[0]
        if kind == "skip":
            mbs.append({"kind": "skip", "addr": a})
            tracker.mark_mb(a)
            continue
        if kind == "ipcm":
            mb = _pcm_mb(rng, a)
            if is_p:
                mb["p_slice"] = True
            mbs.append(mb)
            tracker.mark_mb(a)
            continue
        if kind == "i4x4":
            cbp_luma = rng.randrange(16)
            cbp_chroma = rng.randrange(3)
            cbp = cbp_luma | (cbp_chroma << 4)
            mb = tracker.random_i4x4_mb(rng, a, cbp=cbp)
            if is_p:
                mb["p_slice"] = True
            if cbp:
                mb["qp_delta"] = 0
                mb["residual"] = _rand_residual(
                    rng, "i4x4", cbp_luma, cbp_chroma, qp=qp,
                    chroma_qp_offset=chroma_qp_offset)
            mbs.append(mb)
            continue
        if kind == "i16":
            mode = rng.choice(_i16_legal_modes(tracker, a))
            cbp_luma = rng.choice([0, 1])
            cbp_chroma = rng.randrange(3)
            rd = _rand_residual(rng, "i16", 15 if cbp_luma else 0,
                                cbp_chroma, qp=qp,
                                chroma_qp_offset=chroma_qp_offset)
            mbs.append({"kind": "i16", "addr": a, "pred_mode": mode,
                        "cbp_luma": cbp_luma, "cbp_chroma": cbp_chroma,
                        "chroma_mode": rng.choice(
                            tracker.legal_chroma_modes(a)),
                        "qp_delta": 0, "residual": rd})
            tracker.mark_mb(a)
            continue

        def mvd():
            return (rng.randint(-mvd_range, mvd_range),
                    rng.randint(-mvd_range, mvd_range))
        cbp = rng.choice([0, rng.randrange(48)])
        rd = _rand_residual(rng, "inter", cbp & 15, cbp >> 4, qp=qp,
                            chroma_qp_offset=chroma_qp_offset) \
            if cbp else None
        if kind == "p16x16":
            mbs.append({"kind": "p16x16", "addr": a,
                        "ref_idx": rng.randrange(num_active),
                        "num_ref": num_active, "mvd": mvd(), "cbp": cbp,
                        "residual": rd, "qp_delta": 0})
        elif kind == "pNxM":
            mbs.append({"kind": "pNxM", "addr": a,
                        "mb_type": rng.choice([1, 2]),
                        "ref_idx": [rng.randrange(num_active)
                                    for _ in range(2)],
                        "num_ref": num_active, "mvds": [mvd(), mvd()],
                        "cbp": cbp, "residual": rd, "qp_delta": 0})
        else:
            sub_types = [rng.randrange(4) for _ in range(4)]
            nparts = {0: 1, 1: 2, 2: 2, 3: 4}
            mbs.append({"kind": "p8x8", "addr": a, "mb_type": 3,
                        "sub_types": sub_types,
                        "ref_idx": [rng.randrange(num_active)
                                    for _ in range(4)],
                        "num_ref": num_active,
                        "mvds": [[mvd() for _ in range(nparts[st])]
                                 for st in sub_types],
                        "cbp": cbp, "residual": rd, "qp_delta": 0})
        tracker.mark_mb(a)
    return mbs


def multislice_stream(width_mbs=5, height_mbs=4, n_frames=4, seed=201,
                      n_slices=3, deblock_idc=0, alpha_off=0, beta_off=0,
                      qp=28, chroma_qp_offset=0, vary_slice_qp=True):
    """Pictures split into several slices: exercises slice-boundary
    availability (intra/nC/MV), per-slice QP/deblock params, and
    disable_deblocking_filter_idc==2 cross-slice gating."""
    rng = random.Random(seed)
    sps = SpsConfig(width_mbs=width_mbs, height_mbs=height_mbs, poc_type=2,
                    num_ref_frames=1)
    pps = PpsConfig(pic_init_qp=qp, chroma_qp_index_offset=chroma_qp_offset)
    out = [write_sps(sps), write_pps(pps)]
    n_mbs = width_mbs * height_mbs
    for f in range(n_frames):
        is_idr = f == 0
        # random slice partition (contiguous, raster)
        cuts = sorted(rng.sample(range(1, n_mbs), n_slices - 1)) \
            if n_slices > 1 else []
        bounds = [0] + cuts + [n_mbs]
        for s in range(len(bounds) - 1):
            addrs = list(range(bounds[s], bounds[s + 1]))
            sqp = qp + (rng.randint(-4, 4) if vary_slice_qp else 0)
            sqp = min(max(sqp, 0), 51)
            tracker = IntraModeTracker(width_mbs, height_mbs)
            # only same-slice MBs available to the generator's predictors
            cfg = SliceConfig(
                slice_type="I" if is_idr else "P",
                first_mb=addrs[0], idr=is_idr, idr_pic_id=0,
                frame_num=f % 32, sps=sps, pps=pps, slice_qp=sqp,
                pic_init_qp=qp,
                disable_deblocking_idc=deblock_idc,
                slice_alpha_c0_offset=alpha_off,
                slice_beta_offset=beta_off)
            mbs = _mixed_mb_list(rng, tracker, addrs, sqp, is_p=not is_idr,
                                 chroma_qp_offset=chroma_qp_offset)
            out.append(write_slice(cfg, mbs))
    info = {"width": width_mbs * 16, "height": height_mbs * 16,
            "n_frames": n_frames}
    return b"".join(out), info


def redundant_stream(width_mbs=4, height_mbs=3, n_frames=4, seed=701,
                     qp=28, drop_primary_of=()):
    """P pictures followed by a redundant copy slice
    (redundant_pic_cnt=1, all-skip). Frames listed in drop_primary_of
    have their PRIMARY slice omitted, leaving the redundant slice as the
    decodable fallback (h264bsd_slice_data.c:133-139 semantics)."""
    rng = random.Random(seed)
    sps = SpsConfig(width_mbs=width_mbs, height_mbs=height_mbs, poc_type=2,
                    num_ref_frames=1)
    pps = PpsConfig(pic_init_qp=qp, redundant_pic_cnt_present=True)
    out = [write_sps(sps), write_pps(pps)]
    n_mbs = width_mbs * height_mbs
    for f in range(n_frames):
        is_idr = f == 0
        tracker = IntraModeTracker(width_mbs, height_mbs)
        cfg = SliceConfig(
            slice_type="I" if is_idr else "P", idr=is_idr, idr_pic_id=0,
            frame_num=f % 32, sps=sps, pps=pps, slice_qp=qp,
            pic_init_qp=qp, disable_deblocking_idc=0)
        if f not in drop_primary_of:
            mbs = _mixed_mb_list(rng, tracker, list(range(n_mbs)), qp,
                                 is_p=not is_idr)
            out.append(write_slice(cfg, mbs))
        if not is_idr:
            rcfg = dataclasses.replace(cfg, redundant_pic_cnt=1)
            skips = [{"kind": "skip", "addr": a} for a in range(n_mbs)]
            out.append(write_slice(rcfg, skips))
    info = {"width": width_mbs * 16, "height": height_mbs * 16,
            "n_frames": n_frames}
    return b"".join(out), info


def fmo_stream(map_type=1, width_mbs=4, height_mbs=4, n_frames=3, seed=301,
               n_groups=2, qp=28, deblock=True, change_rate=3,
               change_direction=False):
    """FMO slice-group streams, one slice per group per picture."""
    import numpy as np
    import sys as _s
    from ..bitstream.params import Pps as _Pps, Sps as _Sps
    from ..bitstream.slice_group_map import build_slice_group_map

    rng = random.Random(seed)
    n_mbs = width_mbs * height_mbs
    sps = SpsConfig(width_mbs=width_mbs, height_mbs=height_mbs, poc_type=2)
    kw = {}
    if map_type == 0:
        kw["run_length"] = [rng.randint(1, max(1, n_mbs // n_groups))
                            for _ in range(n_groups)]
    elif map_type == 2:
        tls, brs = [], []
        for g in range(n_groups - 1):
            y0, x0 = rng.randrange(height_mbs // 2), rng.randrange(width_mbs // 2)
            y1 = rng.randrange(y0, height_mbs)
            x1 = rng.randrange(x0, width_mbs)
            tls.append(y0 * width_mbs + x0)
            brs.append(y1 * width_mbs + x1)
        kw["top_left"] = tls
        kw["bottom_right"] = brs
    elif map_type in (3, 4, 5):
        kw["slice_group_change_rate"] = change_rate
        kw["slice_group_change_direction"] = change_direction
        n_groups = 2
    elif map_type == 6:
        kw["explicit_map"] = [rng.randrange(n_groups) for _ in range(n_mbs)]
    pps = PpsConfig(pic_init_qp=qp, num_slice_groups=n_groups,
                    slice_group_map_type=map_type, **kw)
    out = [write_sps(sps), write_pps(pps)]

    # mirror decoder-side map computation
    dsps = _Sps()
    dsps.width_mbs, dsps.height_mbs = width_mbs, height_mbs
    dpps = _Pps()
    dpps.num_slice_groups = n_groups
    dpps.slice_group_map_type = map_type
    dpps.run_length = tuple(kw.get("run_length", ()))
    dpps.top_left = tuple(kw.get("top_left", ()))
    dpps.bottom_right = tuple(kw.get("bottom_right", ()))
    dpps.slice_group_change_rate = kw.get("slice_group_change_rate", 1)
    dpps.slice_group_change_direction = kw.get("slice_group_change_direction",
                                               False)
    dpps.slice_group_map = tuple(kw["explicit_map"]) \
        if map_type == 6 else None

    for f in range(n_frames):
        is_idr = f == 0
        change_cycle = 0
        if map_type in (3, 4, 5):
            max_cycle = (n_mbs + change_rate - 1) // change_rate
            change_cycle = rng.randint(0, max_cycle)
        sg_map = build_slice_group_map(dsps, dpps, change_cycle)
        for g in range(n_groups):
            addrs = [a for a in range(n_mbs) if sg_map[a] == g]
            if not addrs:
                continue
            tracker = IntraModeTracker(width_mbs, height_mbs)
            cfg = SliceConfig(
                slice_type="I" if is_idr else "P",
                first_mb=addrs[0], idr=is_idr, idr_pic_id=0,
                frame_num=f % 32, sps=sps, pps=pps, slice_qp=qp,
                pic_init_qp=qp,
                disable_deblocking_idc=0 if deblock else 1,
                slice_group_change_cycle=change_cycle)
            mbs = _mixed_mb_list(rng, tracker, addrs, qp, is_p=not is_idr)
            out.append(write_slice(cfg, mbs))
    info = {"width": width_mbs * 16, "height": height_mbs * 16,
            "n_frames": n_frames}
    return b"".join(out), info


def poc_reorder_stream(poc_type=0, width_mbs=3, height_mbs=3, seed=401,
                       qp=28, n_gops=2, gop_len=5, non_ref_every=0,
                       log2_max_frame_num=4, log2_max_poc_lsb=4,
                       mmco_forget=False, deblock=True, num_ref_frames=2):
    """Streams exercising POC types, display reordering (out-of-order POC),
    non-reference pictures, mid-stream IDRs, frame_num wrap, and MMCO1."""
    rng = random.Random(seed)
    sps = SpsConfig(width_mbs=width_mbs, height_mbs=height_mbs,
                    poc_type=poc_type, num_ref_frames=num_ref_frames,
                    log2_max_frame_num=log2_max_frame_num,
                    log2_max_poc_lsb=log2_max_poc_lsb,
                    offsets_for_ref_frame=(2, 4) if poc_type == 1 else (),
                    offset_for_non_ref_pic=-1 if poc_type == 1 else 0)
    pps = PpsConfig(pic_init_qp=qp)
    out = [write_sps(sps), write_pps(pps)]
    max_fn = 1 << log2_max_frame_num
    max_lsb = 1 << log2_max_poc_lsb

    for g in range(n_gops):
        frame_num = 0
        poc = 0
        n_refs_in_dpb = 0
        for f in range(gop_len):
            is_idr = f == 0
            non_ref = (non_ref_every and not is_idr and
                       f % non_ref_every == 0)
            num_active = max(min(num_ref_frames, n_refs_in_dpb), 1)
            # POC grows by 2 per frame; occasionally jumps to exercise
            # reorder paths (poc_lsb wraps via modulo)
            if not is_idr:
                poc += rng.choice([2, 2, 4])
            mmco = None
            if (mmco_forget and not is_idr and not non_ref and
                    n_refs_in_dpb >= 2 and rng.random() < 0.5):
                # MMCO1: forget the oldest short-term ref
                mmco = [(1, rng.randrange(1, 2)), ]
                # encode: op sequence (ue pairs). write_slice writes raw
                # ue values of each tuple; MMCO1 = (1, diff_minus1)
            cfg = SliceConfig(
                slice_type="I" if is_idr else "P",
                idr=is_idr, idr_pic_id=g % 4,
                frame_num=frame_num % max_fn,
                poc_lsb=poc % max_lsb,
                delta_poc_0=rng.choice([0, 0, 1, -1]) if poc_type == 1
                else 0,
                sps=sps, pps=pps, slice_qp=qp, pic_init_qp=qp,
                num_ref_idx_override=(num_active if num_active > 1
                                      else None) if not is_idr else None,
                disable_deblocking_idc=0 if deblock else 1,
                nal_ref_idc=0 if non_ref else 3,
                adaptive_ref_pic_marking=mmco)
            tracker = IntraModeTracker(width_mbs, height_mbs)
            mbs = _mixed_mb_list(rng, tracker,
                                 list(range(width_mbs * height_mbs)), qp,
                                 is_p=not is_idr, num_active=num_active,
                                 mvd_range=16)
            out.append(write_slice(cfg, mbs))
            if not non_ref:
                frame_num += 1
                if is_idr:
                    n_refs_in_dpb = 1
                else:
                    if mmco:
                        pass  # one removed, one added
                    else:
                        n_refs_in_dpb = min(n_refs_in_dpb + 1,
                                            num_ref_frames)
    info = {"width": width_mbs * 16, "height": height_mbs * 16}
    return b"".join(out), info


def cropped_stream(width_mbs=4, height_mbs=3, crop=(4, 6, 2, 8), seed=501,
                   n_frames=2, qp=30):
    """Frame cropping window in the SPS (DecTestBench -C mode)."""
    rng = random.Random(seed)
    sps = SpsConfig(width_mbs=width_mbs, height_mbs=height_mbs, poc_type=2,
                    crop=crop)
    pps = PpsConfig(pic_init_qp=qp)
    out = [write_sps(sps), write_pps(pps)]
    for f in range(n_frames):
        cfg = SliceConfig(slice_type="I", idr=True, idr_pic_id=f,
                          sps=sps, pps=pps, slice_qp=qp, pic_init_qp=qp,
                          disable_deblocking_idc=0)
        tracker = IntraModeTracker(width_mbs, height_mbs)
        mbs = _mixed_mb_list(rng, tracker,
                             list(range(width_mbs * height_mbs)), qp)
        out.append(write_slice(cfg, mbs))
    info = {"width": width_mbs * 16, "height": height_mbs * 16,
            "crop": crop, "n_frames": n_frames}
    return b"".join(out), info


def gaps_stream(width_mbs=3, height_mbs=3, seed=601, qp=28,
                n_frames=7, drop=(2, 4)):
    """gaps_in_frame_num_value_allowed: frame_num jumps -> decoder must
    synthesize non-existing frames; later P frames may reference them
    (error->concealment path)."""
    rng = random.Random(seed)
    sps = SpsConfig(width_mbs=width_mbs, height_mbs=height_mbs, poc_type=2,
                    num_ref_frames=3, gaps_allowed=True)
    pps = PpsConfig(pic_init_qp=qp)
    out = [write_sps(sps), write_pps(pps)]
    fn = 0
    for f in range(n_frames):
        if f in drop:
            fn += 1  # skipped frame -> gap in frame_num
            continue
        is_idr = f == 0
        cfg = SliceConfig(slice_type="I" if is_idr else "P",
                          idr=is_idr, frame_num=fn % 32,
                          sps=sps, pps=pps, slice_qp=qp, pic_init_qp=qp,
                          disable_deblocking_idc=0)
        tracker = IntraModeTracker(width_mbs, height_mbs)
        mbs = _mixed_mb_list(rng, tracker,
                             list(range(width_mbs * height_mbs)), qp,
                             is_p=not is_idr, num_active=1, mvd_range=10)
        out.append(write_slice(cfg, mbs))
        fn += 1
    return b"".join(out), {}


def long_term_stream(width_mbs=3, height_mbs=3, seed=611, qp=28):
    """Long-term reference workflow: IDR, mark a P frame long-term via
    MMCO4+MMCO6, later reference it via ref list reordering (op 2), and
    finally unmark with MMCO2."""
    rng = random.Random(seed)
    sps = SpsConfig(width_mbs=width_mbs, height_mbs=height_mbs, poc_type=2,
                    num_ref_frames=3)
    pps = PpsConfig(pic_init_qp=qp)
    out = [write_sps(sps), write_pps(pps)]
    n_mbs = width_mbs * height_mbs

    def frame(f, is_idr, num_active=1, mmco=None, reorder=None,
              override=None):
        cfg = SliceConfig(
            slice_type="I" if is_idr else "P", idr=is_idr,
            frame_num=f % 32, sps=sps, pps=pps, slice_qp=qp,
            pic_init_qp=qp, disable_deblocking_idc=0,
            adaptive_ref_pic_marking=mmco, reorder_l0=reorder,
            num_ref_idx_override=override)
        tracker = IntraModeTracker(width_mbs, height_mbs)
        mbs = _mixed_mb_list(rng, tracker, list(range(n_mbs)), qp,
                             is_p=not is_idr, num_active=num_active,
                             mvd_range=10)
        out.append(write_slice(cfg, mbs))

    frame(0, True)
    # P1: set maxLongTermFrameIdx=0 (op4 val=1), mark self long-term idx 0
    frame(1, False, mmco=[(4, 1), (6, 0)])
    frame(2, False, num_active=2, override=2)
    frame(3, False, num_active=2, override=2)
    # P4: explicitly pick the long-term pic (op 2, long_term_pic_num 0)
    frame(4, False, num_active=2, override=2, reorder=[(2, 0)])
    # P5: remove the long-term ref with MMCO2
    frame(5, False, num_active=2, override=2, mmco=[(2, 0)])
    frame(6, False, num_active=2, override=2)
    return b"".join(out), {}


def realistic_stream(width_mbs=120, height_mbs=68, n_frames=16, seed=4242,
                     qp=30, n_slices=8, num_ref_frames=3, gop=300,
                     skip_frac=0.55, coded_cbp_frac=0.35,
                     mvd_small=24, mvd_big=200, big_frac=0.03):
    """Realistic-statistics bench content: GOP of IDR + P frames,
    band-aligned multi-slice pictures with cross-slice deblocking
    (idc 0), multi-reference prediction, mostly-skip/uniform-MV P MBs
    with sparse residuals (real 1080p video is a few hundred KB/s of
    syntax, not dense random coefficients), plus a tail of high-motion
    out-of-picture MVs and sub-partitioned MBs.

    This is the defensible performance workload: the
    dense synthetic `inter_stream` overstates entropy/upload cost by an
    order of magnitude versus x264-like output."""
    rng = random.Random(seed)
    sps = SpsConfig(width_mbs=width_mbs, height_mbs=height_mbs, poc_type=2,
                    num_ref_frames=num_ref_frames, log2_max_frame_num=8)
    pps = PpsConfig(pic_init_qp=qp)
    out = [write_sps(sps), write_pps(pps)]
    n_mbs = width_mbs * height_mbs
    hb = -(-height_mbs // n_slices)       # rows per slice (last shorter)
    rows = [(b * hb, min((b + 1) * hb, height_mbs))
            for b in range(n_slices) if b * hb < height_mbs]

    def small_mvd():
        return (rng.randint(-mvd_small, mvd_small),
                rng.randint(-mvd_small, mvd_small))

    def big_mvd():
        return (rng.randint(-mvd_big, mvd_big),
                rng.randint(-mvd_big, mvd_big))

    for f in range(n_frames):
        is_idr = f % gop == 0
        num_active = max(min(num_ref_frames, f % gop), 1)
        for (r0, r1) in rows:
            first = r0 * width_mbs
            addrs = list(range(first, r1 * width_mbs))
            tracker = IntraModeTracker(width_mbs, height_mbs)
            cfg = SliceConfig(
                slice_type="I" if is_idr else "P",
                first_mb=first, idr=is_idr, idr_pic_id=f % 16,
                frame_num=(f % gop) % 256, sps=sps, pps=pps,
                slice_qp=qp, pic_init_qp=qp,
                num_ref_idx_override=(num_active if not is_idr
                                      and num_active > 1 else None),
                disable_deblocking_idc=0)
            mbs = []
            for a in addrs:
                if is_idr:
                    # I frame: mostly I16x16 (flat content), some I4x4
                    if rng.random() < 0.25:
                        cbp_luma = rng.randrange(16)
                        cbp_chroma = rng.randrange(3)
                        cbp = cbp_luma | (cbp_chroma << 4)
                        mb = tracker.random_i4x4_mb(rng, a, cbp=cbp)
                        if cbp:
                            mb["qp_delta"] = 0
                            mb["residual"] = _rand_residual(
                                rng, "i4x4", cbp_luma, cbp_chroma, qp=qp,
                                ladder_start=5)
                        mbs.append(mb)
                    else:
                        mode = rng.choice(_i16_legal_modes(tracker, a))
                        cbp_chroma = rng.randrange(2)
                        rd = _rand_residual(rng, "i16", 0, cbp_chroma,
                                            qp=qp, ladder_start=5)
                        mbs.append({"kind": "i16", "addr": a,
                                    "pred_mode": mode, "cbp_luma": 0,
                                    "cbp_chroma": cbp_chroma,
                                    "chroma_mode": rng.choice(
                                        tracker.legal_chroma_modes(a)),
                                    "qp_delta": 0, "residual": rd})
                        tracker.mark_mb(a)
                    continue
                r = rng.random()
                if r < skip_frac:
                    mbs.append({"kind": "skip", "addr": a})
                    tracker.mark_mb(a)
                    continue
                coded = rng.random() < coded_cbp_frac
                cbp = rng.randrange(1, 48) if coded else 0
                rd = _rand_residual(rng, "inter", cbp & 15, cbp >> 4,
                                    qp=qp, ladder_start=6) if cbp else None
                mv = big_mvd() if rng.random() < big_frac else small_mvd()
                if r < skip_frac + 0.32:            # uniform 16x16
                    ref = (rng.randrange(num_active)
                           if rng.random() < 0.15 else 0)
                    mbs.append({"kind": "p16x16", "addr": a,
                                "ref_idx": ref, "num_ref": num_active,
                                "mvd": mv, "cbp": cbp, "residual": rd,
                                "qp_delta": 0})
                elif r < skip_frac + 0.40:          # 16x8 / 8x16
                    mbs.append({"kind": "pNxM", "addr": a,
                                "mb_type": rng.choice([1, 2]),
                                "ref_idx": [0, rng.randrange(num_active)],
                                "num_ref": num_active,
                                "mvds": [mv, small_mvd()], "cbp": cbp,
                                "residual": rd, "qp_delta": 0})
                elif r < skip_frac + 0.43:          # 8x8 sub-partitions
                    sub_types = [rng.randrange(4) for _ in range(4)]
                    nparts = {0: 1, 1: 2, 2: 2, 3: 4}
                    mbs.append({"kind": "p8x8", "addr": a, "mb_type": 3,
                                "sub_types": sub_types,
                                "ref_idx": [0, 0, 0,
                                            rng.randrange(num_active)],
                                "num_ref": num_active,
                                "mvds": [[small_mvd()
                                          for _ in range(nparts[st])]
                                         for st in sub_types],
                                "cbp": cbp, "residual": rd,
                                "qp_delta": 0})
                else:                               # intra refresh
                    cbp_luma = rng.randrange(16)
                    cbp_chroma = rng.randrange(3)
                    icbp = cbp_luma | (cbp_chroma << 4)
                    mb = tracker.random_i4x4_mb(rng, a, cbp=icbp)
                    mb["p_slice"] = True
                    if icbp:
                        mb["qp_delta"] = 0
                        mb["residual"] = _rand_residual(
                            rng, "i4x4", cbp_luma, cbp_chroma, qp=qp,
                            ladder_start=5)
                    mbs.append(mb)
                    continue
                tracker.mark_mb(a)
            out.append(write_slice(cfg, mbs))
    info = {"width": width_mbs * 16, "height": height_mbs * 16,
            "n_frames": n_frames, "n_slices": n_slices}
    return b"".join(out), info
