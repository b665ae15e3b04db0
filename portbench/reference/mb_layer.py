"""Macroblock-layer parsing: syntax -> dense per-picture tensors.

Reference: h264bsd_macroblock_layer.c:133 h264bsdDecodeMacroblockLayer,
DecodeMbPred :353, DecodeSubMbPred :441, DecodeResidual :508,
DetermineNc :807; MV prediction: h264bsd_inter_prediction.c:499-917
(MvPrediction16x16/16x8/8x16/8x8, GetInterNeighbour :968,
GetPredictionMv :1004, MedianFilter :925).

Design note (TPU-first): this host stage resolves every sequential
dependency of the bitstream — CAVLC nC contexts, intra-mode prediction,
and motion-vector median prediction — so the device kernels receive fully
materialized per-MB tensors (final modes, final quarter-pel MVs, scan-order
coefficients) and run data-parallel over macroblocks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .bitreader import BitReader, StreamError
from .cavlc import decode_residual_block
from .cavlc_tables import CODENUM_TO_CBP_INTER, CODENUM_TO_CBP_INTRA

# MB classes in PictureData.mb_class
MB_UNDECODED = 0
MB_I4x4 = 1
MB_I16x16 = 2
MB_IPCM = 3
MB_P = 4          # any inter MB, including P_Skip

# 4x4 luma block decode (z) order -> (bx, by)
BLK_ORDER = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
             (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3)]


class PictureData:
    """Dense per-picture tensors produced by the front-end (the IR consumed
    by the pixel backend). All per-block spatial arrays use raster block
    coordinates within the MB ([by][bx])."""

    def __init__(self, width_mbs: int, height_mbs: int) -> None:
        n = width_mbs * height_mbs
        self.width_mbs = width_mbs
        self.height_mbs = height_mbs
        self.n_mbs = n
        self.mb_class = np.zeros(n, np.int32)
        self.skip = np.zeros(n, bool)
        self.qp = np.zeros(n, np.int32)
        self.cbp = np.zeros(n, np.int32)              # luma 0..3 | chroma<<4
        self.i16_mode = np.zeros(n, np.int32)
        self.chroma_mode = np.zeros(n, np.int32)
        self.i4_modes = np.zeros((n, 4, 4), np.int32)  # final modes, [by][bx]
        self.luma_coeffs = np.zeros((n, 4, 4, 16), np.int32)  # scan order
        self.luma_dc = np.zeros((n, 16), np.int32)
        self.chroma_dc = np.zeros((n, 2, 4), np.int32)
        self.chroma_ac = np.zeros((n, 2, 2, 2, 16), np.int32)  # [comp][cy][cx]
        self.total_coeff = np.zeros((n, 4, 4), np.int32)
        self.chroma_total_coeff = np.zeros((n, 2, 2, 2), np.int32)
        self.mv = np.zeros((n, 4, 4, 2), np.int32)     # quarter-pel, [by][bx]
        self.ref_idx = np.full((n, 2, 2), -1, np.int32)   # per 8x8
        self.ref_slot = np.full((n, 2, 2), -1, np.int32)  # DPB buffer index
        self.ipcm = np.zeros((n, 384), np.uint8)
        self.slice_id = np.full(n, -1, np.int32)
        self.decoded = np.zeros(n, bool)
        # per-slice parameter lists, indexed by slice_id
        self.slice_params: List["SliceParams"] = []


@dataclasses.dataclass
class SliceParams:
    slice_type: int
    disable_deblocking_idc: int
    alpha_c0_offset: int
    beta_offset: int
    ref_slots: List[int]      # l0 ref list -> DPB frame-store index


@dataclasses.dataclass
class _MbPred:
    """Parsed prediction syntax before MV reconstruction."""
    mb_type: int = 0                  # P: 0..4
    sub_types: Optional[List[int]] = None
    ref_idx: Optional[List[int]] = None      # per partition / 8x8
    mvd: Optional[List[List[tuple]]] = None  # per partition -> sub-part mvds


class MbParser:
    """Parses macroblock layers for one picture, maintaining the neighbour
    state (nC contexts, intra-mode grid, MV grid) across slices."""

    def __init__(self, pic: PictureData, constrained_intra: bool) -> None:
        self.pic = pic
        self.w = pic.width_mbs
        self.h = pic.height_mbs
        self.constrained_intra = constrained_intra
        W, H = 4 * self.w, 4 * self.h
        # global 4x4-block grids
        self.mv_grid = np.zeros((H, W, 2), np.int32)
        self.ref_grid = np.full((H, W), -1, np.int32)
        self.tc_grid = np.zeros((H, W), np.int32)        # luma totalCoeff
        self.ctc_grid = np.zeros((2, 2 * self.h, 2 * self.w), np.int32)
        self.i4_grid = np.full((H, W), -1, np.int32)     # intra 4x4 modes
        self.cur_filled = np.zeros((4, 4), bool)         # within current MB

    # ------------------------------------------------------------------
    # availability helpers
    # ------------------------------------------------------------------

    def _mb_avail(self, addr: int, cur_addr: int) -> bool:
        pic = self.pic
        return (addr is not None and
                pic.decoded[addr] and
                pic.slice_id[addr] == pic.slice_id[cur_addr])

    def mb_neighbors(self, addr: int):
        """(A, B, C, D) MB addresses or None (picture-geometry only)."""
        x, y = addr % self.w, addr // self.w
        a = addr - 1 if x > 0 else None
        b = addr - self.w if y > 0 else None
        c = addr - self.w + 1 if (y > 0 and x + 1 < self.w) else None
        d = addr - self.w - 1 if (y > 0 and x > 0) else None
        return a, b, c, d

    # ------------------------------------------------------------------
    # nC derivation (spec 9.2.1 / DetermineNc)
    # ------------------------------------------------------------------

    def _luma_nc(self, addr: int, blk: int) -> int:
        bx, by = BLK_ORDER[blk]
        x0, y0 = (addr % self.w) * 4, (addr // self.w) * 4
        na = nb = None
        # left
        if bx > 0:
            na = self.tc_grid[y0 + by, x0 + bx - 1]
        else:
            la = addr - 1 if addr % self.w else None
            if la is not None and self._mb_avail(la, addr):
                na = self.tc_grid[y0 + by, x0 - 1]
        # up
        if by > 0:
            nb = self.tc_grid[y0 + by - 1, x0 + bx]
        else:
            ua = addr - self.w if addr >= self.w else None
            if ua is not None and self._mb_avail(ua, addr):
                nb = self.tc_grid[y0 - 1, x0 + bx]
        if na is not None and nb is not None:
            return (int(na) + int(nb) + 1) >> 1
        if na is not None:
            return int(na)
        if nb is not None:
            return int(nb)
        return 0

    def _chroma_nc(self, addr: int, comp: int, blk: int) -> int:
        bx, by = blk % 2, blk // 2
        x0, y0 = (addr % self.w) * 2, (addr // self.w) * 2
        g = self.ctc_grid[comp]
        na = nb = None
        if bx > 0:
            na = g[y0 + by, x0 + bx - 1]
        else:
            la = addr - 1 if addr % self.w else None
            if la is not None and self._mb_avail(la, addr):
                na = g[y0 + by, x0 - 1]
        if by > 0:
            nb = g[y0 + by - 1, x0 + bx]
        else:
            ua = addr - self.w if addr >= self.w else None
            if ua is not None and self._mb_avail(ua, addr):
                nb = g[y0 - 1, x0 + bx]
        if na is not None and nb is not None:
            return (int(na) + int(nb) + 1) >> 1
        if na is not None:
            return int(na)
        if nb is not None:
            return int(nb)
        return 0

    # ------------------------------------------------------------------
    # intra 4x4 mode prediction (spec 8.3.1.1)
    # ------------------------------------------------------------------

    def _i4_neighbor_mode(self, addr: int, gx: int, gy: int,
                          cross_addr) -> Optional[int]:
        """Mode of neighbour 4x4 block at grid (gx,gy); None if the block's
        MB is unavailable. Non-I4x4 MBs (and inter with constrained intra
        handled by caller) give DC (2)."""
        if gx < 0 or gy < 0:
            return None
        naddr = (gy // 4) * self.w + (gx // 4)
        if naddr != addr and not self._mb_avail(naddr, addr):
            return None
        pic = self.pic
        cls = pic.mb_class[naddr]
        if cls == MB_I4x4:
            m = self.i4_grid[gy, gx]
            return int(m) if m >= 0 else 2
        if cls == MB_UNDECODED:
            return None
        if cls == MB_P and self.constrained_intra:
            return None
        return 2

    def predict_i4_mode(self, addr: int, blk: int) -> int:
        bx, by = BLK_ORDER[blk]
        x0, y0 = (addr % self.w) * 4, (addr // self.w) * 4
        gx, gy = x0 + bx, y0 + by
        ma = self._i4_neighbor_mode(addr, gx - 1, gy, addr)
        mb = self._i4_neighbor_mode(addr, gx, gy - 1, addr)
        if ma is None or mb is None:
            return 2
        return min(ma, mb)

    # ------------------------------------------------------------------
    # inter neighbour fetch (GetInterNeighbour semantics)
    # ------------------------------------------------------------------

    def _inter_neighbor(self, addr: int, gx: int, gy: int):
        """Returns (available, ref_idx, mv) for the 4x4 block at global
        grid coords; mirrors GetInterNeighbour: available = MB exists in
        same slice; intra MB -> ref=-1, mv=0."""
        if gx < 0 or gy < 0 or gx >= 4 * self.w or gy >= 4 * self.h:
            return False, -1, (0, 0)
        naddr = (gy // 4) * self.w + (gx // 4)
        if naddr == addr:
            # within current MB: available (already-decoded partition)
            if not self.cur_filled[gy % 4, gx % 4]:
                return False, -1, (0, 0)
            return (True, int(self.ref_grid[gy, gx]),
                    (int(self.mv_grid[gy, gx, 0]),
                     int(self.mv_grid[gy, gx, 1])))
        if not self._mb_avail(naddr, addr):
            return False, -1, (0, 0)
        if self.pic.mb_class[naddr] != MB_P or self.pic.skip[naddr]:
            pass  # skip MBs are inter: their mv/ref are valid in the grid
        if self.pic.mb_class[naddr] != MB_P:
            return True, -1, (0, 0)  # intra neighbour
        return (True, int(self.ref_grid[gy, gx]),
                (int(self.mv_grid[gy, gx, 0]),
                 int(self.mv_grid[gy, gx, 1])))

    @staticmethod
    def _median(a: int, b: int, c: int) -> int:
        return max(min(a, b), min(max(a, b), c))

    def _prediction_mv(self, A, B, C, ref: int):
        """GetPredictionMv: A/B/C are (avail, ref, (mvx,mvy))."""
        if B[0] or C[0] or not A[0]:
            is_match = [n[0] and n[1] == ref for n in (A, B, C)]
            if sum(is_match) != 1:
                return (self._median(A[2][0], B[2][0], C[2][0]),
                        self._median(A[2][1], B[2][1], C[2][1]))
            for n, m in zip((A, B, C), is_match):
                if m:
                    return n[2]
        return A[2]


CBP_INTRA = CODENUM_TO_CBP_INTRA
CBP_INTER = CODENUM_TO_CBP_INTER


def _parse_intra_pred(r: BitReader, parser: MbParser, addr: int,
                      pic: PictureData) -> None:
    """intra4x4 pred modes + chroma mode for an I_4x4 MB."""
    x0, y0 = (addr % parser.w) * 4, (addr // parser.w) * 4
    for blk in range(16):
        pred = parser.predict_i4_mode(addr, blk)
        if r.flag():
            mode = pred
        else:
            rem = r.u(3)
            mode = rem if rem < pred else rem + 1
        bx, by = BLK_ORDER[blk]
        pic.i4_modes[addr, by, bx] = mode
        parser.i4_grid[y0 + by, x0 + bx] = mode
    pic.chroma_mode[addr] = r.ue()
    if pic.chroma_mode[addr] > 3:
        raise StreamError("intra_chroma_pred_mode out of range")


def _parse_residual(r: BitReader, parser: MbParser, addr: int,
                    pic: PictureData, cbp: int, is_i16: bool) -> None:
    x0, y0 = (addr % parser.w) * 4, (addr // parser.w) * 4
    if is_i16:
        nc = parser._luma_nc(addr, 0)
        pic.luma_dc[addr] = decode_residual_block(r, nc, 16)
    max_c = 15 if is_i16 else 16
    for blk8 in range(4):
        for sub in range(4):
            blk = blk8 * 4 + sub
            bx, by = BLK_ORDER[blk]
            if cbp & (1 << blk8):
                nc = parser._luma_nc(addr, blk)
                coeffs = decode_residual_block(r, nc, max_c)
                if is_i16:
                    # store AC at scan positions 1..15
                    pic.luma_coeffs[addr, by, bx, 1:16] = coeffs
                    tc = sum(1 for c in coeffs if c)
                else:
                    pic.luma_coeffs[addr, by, bx] = coeffs
                    tc = sum(1 for c in coeffs if c)
                pic.total_coeff[addr, by, bx] = tc
                parser.tc_grid[y0 + by, x0 + bx] = tc
            else:
                pic.total_coeff[addr, by, bx] = 0
                parser.tc_grid[y0 + by, x0 + bx] = 0

    cx0, cy0 = (addr % parser.w) * 2, (addr // parser.w) * 2
    cbp_chroma = cbp >> 4
    if cbp_chroma:
        for comp in range(2):
            pic.chroma_dc[addr, comp] = decode_residual_block(r, -1, 4)
    for comp in range(2):
        for blk in range(4):
            bx, by = blk % 2, blk // 2
            if cbp_chroma == 2:
                nc = parser._chroma_nc(addr, comp, blk)
                coeffs = decode_residual_block(r, nc, 15)
                pic.chroma_ac[addr, comp, by, bx, 1:16] = coeffs
                tc = sum(1 for c in coeffs if c)
            else:
                tc = 0
            pic.chroma_total_coeff[addr, comp, by, bx] = tc
            parser.ctc_grid[comp, cy0 + by, cx0 + bx] = tc


def _mark_mb_grids(parser: MbParser, addr: int, tc_value: int) -> None:
    """Set whole-MB totalCoeff grids (I_PCM: 16, skip: 0)."""
    x0, y0 = (addr % parser.w) * 4, (addr // parser.w) * 4
    parser.tc_grid[y0:y0 + 4, x0:x0 + 4] = tc_value
    cx0, cy0 = (addr % parser.w) * 2, (addr // parser.w) * 2
    parser.ctc_grid[:, cy0:cy0 + 2, cx0:cx0 + 2] = tc_value


def _set_partition_motion(parser: MbParser, addr: int, bx: int, by: int,
                          w4: int, h4: int, mv, ref: int) -> None:
    """Write final MV/ref into the grids + PictureData for a partition at
    block coords (bx,by), size (w4,h4) in 4x4 units."""
    pic = parser.pic
    x0, y0 = (addr % parser.w) * 4, (addr // parser.w) * 4
    parser.mv_grid[y0 + by:y0 + by + h4, x0 + bx:x0 + bx + w4] = mv
    parser.ref_grid[y0 + by:y0 + by + h4, x0 + bx:x0 + bx + w4] = ref
    parser.cur_filled[by:by + h4, bx:bx + w4] = True
    pic.mv[addr, by:by + h4, bx:bx + w4] = mv
    pic.ref_idx[addr, by // 2, bx // 2] = ref


MV_RANGE_ERR = "motion vector out of range"


def _check_mv(mv) -> None:
    if not (-8192 <= mv[0] <= 8191):
        raise StreamError(MV_RANGE_ERR)
    if not (-2048 <= mv[1] <= 2047):
        raise StreamError(MV_RANGE_ERR)


def _inter_neighbors_for(parser: MbParser, addr: int, bx: int, by: int,
                         w4: int):
    """(A, B, C) inter neighbours for a partition with top-left at block
    (bx,by) and width w4; C falls back to D when unavailable."""
    x0, y0 = (addr % parser.w) * 4, (addr // parser.w) * 4
    gx, gy = x0 + bx, y0 + by
    A = parser._inter_neighbor(addr, gx - 1, gy)
    B = parser._inter_neighbor(addr, gx, gy - 1)
    C = parser._inter_neighbor(addr, gx + w4, gy - 1)
    if not C[0]:
        C = parser._inter_neighbor(addr, gx - 1, gy - 1)
    return A, B, C


def parse_p_skip(parser: MbParser, addr: int, ref_slot0: int) -> None:
    """Derive P_Skip motion (MvPrediction16x16 skip path)."""
    pic = parser.pic
    parser.cur_filled[:] = False
    pic.mb_class[addr] = MB_P
    pic.skip[addr] = True
    if ref_slot0 < 0:
        raise StreamError("reference picture missing (P_Skip)")
    x0, y0 = (addr % parser.w) * 4, (addr // parser.w) * 4
    gx, gy = x0, y0
    A = parser._inter_neighbor(addr, gx - 1, gy)
    B = parser._inter_neighbor(addr, gx, gy - 1)
    if (not A[0] or not B[0] or
            (A[1] == 0 and A[2] == (0, 0)) or
            (B[1] == 0 and B[2] == (0, 0))):
        mv = (0, 0)
    else:
        C = parser._inter_neighbor(addr, gx + 4, gy - 1)
        if not C[0]:
            C = parser._inter_neighbor(addr, gx - 1, gy - 1)
        mv = parser._prediction_mv(A, B, C, 0)
    _set_partition_motion(parser, addr, 0, 0, 4, 4, mv, 0)
    pic.ref_idx[addr] = 0
    pic.ref_slot[addr] = ref_slot0
    _mark_mb_grids(parser, addr, 0)
    pic.qp[addr] = -1  # filled by caller with current slice qp
    pic.decoded[addr] = True


# sub_mb_type -> (sub partitions as (bx,by,w4,h4) within the 8x8)
SUB_PARTS = {
    0: [(0, 0, 2, 2)],
    1: [(0, 0, 2, 1), (0, 1, 2, 1)],
    2: [(0, 0, 1, 2), (1, 0, 1, 2)],
    3: [(0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)],
}


def parse_macroblock(r: BitReader, parser: MbParser, addr: int,
                     slice_type: int, qp: int, num_ref: int,
                     ref_slots: List[int], chroma_qp_offset: int) -> int:
    """Parse one macroblock_layer(); returns updated slice QP."""
    pic = parser.pic
    parser.cur_filled[:] = False
    mb_type = r.ue()
    is_p = slice_type == 0
    if is_p:
        if mb_type >= 5:
            intra_type = mb_type - 5
        else:
            return _parse_inter_mb(r, parser, addr, mb_type, qp, num_ref,
                                   ref_slots, chroma_qp_offset)
    else:
        if mb_type > 25:
            raise StreamError("I-slice mb_type out of range")
        intra_type = mb_type

    if intra_type > 25:
        raise StreamError("mb_type out of range")

    if intra_type == 25:  # I_PCM
        pic.mb_class[addr] = MB_IPCM
        r.align()
        pic.ipcm[addr] = np.frombuffer(r.read_bytes(384), np.uint8)
        _mark_mb_grids(parser, addr, 16)
        pic.total_coeff[addr] = 16
        pic.chroma_total_coeff[addr] = 16
        pic.qp[addr] = 0  # I_PCM: qpY inferred 0 (h264bsd_macroblock_layer.c:1003)
        pic.decoded[addr] = True
        return qp

    if intra_type == 0:  # I_4x4
        pic.mb_class[addr] = MB_I4x4
        _parse_intra_pred(r, parser, addr, pic)
        cbp_code = r.ue()
        if cbp_code > 47:
            raise StreamError("coded_block_pattern out of range")
        cbp = CBP_INTRA[cbp_code]
        pic.cbp[addr] = cbp
        if cbp:
            qp = _apply_qp_delta(r, qp)
        pic.qp[addr] = qp
        _parse_residual(r, parser, addr, pic, cbp, is_i16=False)
        pic.decoded[addr] = True
        return qp

    # I_16x16
    k = intra_type - 1
    pic.mb_class[addr] = MB_I16x16
    pic.i16_mode[addr] = k % 4
    cbp = (15 if k >= 12 else 0) | (((k // 4) % 3) << 4)
    pic.cbp[addr] = cbp
    pic.chroma_mode[addr] = r.ue()
    if pic.chroma_mode[addr] > 3:
        raise StreamError("intra_chroma_pred_mode out of range")
    qp = _apply_qp_delta(r, qp)
    pic.qp[addr] = qp
    _parse_residual(r, parser, addr, pic, cbp, is_i16=True)
    pic.decoded[addr] = True
    return qp


def _apply_qp_delta(r: BitReader, qp: int) -> int:
    d = r.se()
    if not (-26 <= d <= 25):
        raise StreamError("mb_qp_delta out of range")
    qp = qp + d
    if qp < 0:
        qp += 52
    elif qp > 51:
        qp -= 52
    return qp


def _parse_inter_mb(r: BitReader, parser: MbParser, addr: int, mb_type: int,
                    qp: int, num_ref: int, ref_slots: List[int],
                    chroma_qp_offset: int) -> int:
    pic = parser.pic
    if mb_type > 4:
        raise StreamError("P mb_type out of range")
    pic.mb_class[addr] = MB_P

    if mb_type in (0, 1, 2):
        n_parts = 1 if mb_type == 0 else 2
        refs, mvds = [], []
        for _ in range(n_parts):
            ref = r.te(num_ref) if num_ref > 1 else 0
            if ref >= num_ref:
                raise StreamError("ref_idx out of range")
            refs.append(ref)
        for _ in range(n_parts):
            mvds.append((r.se(), r.se()))

        for rr in refs:
            if ref_slots[rr] < 0:
                raise StreamError("reference picture missing")
        if mb_type == 0:
            A, B, C = _inter_neighbors_for(parser, addr, 0, 0, 4)
            mvp = parser._prediction_mv(A, B, C, refs[0])
            mv = (mvds[0][0] + mvp[0], mvds[0][1] + mvp[1])
            _check_mv(mv)
            _set_partition_motion(parser, addr, 0, 0, 4, 4, mv, refs[0])
            for cy in range(2):
                for cx in range(2):
                    pic.ref_slot[addr, cy, cx] = ref_slots[refs[0]]
        elif mb_type == 1:  # 16x8: upper then lower
            geoms = [(0, 0, 4, 2), (0, 2, 4, 2)]
            for i, (bx, by, w4, h4) in enumerate(geoms):
                ref = refs[i]
                x0 = (addr % parser.w) * 4
                y0 = (addr // parser.w) * 4
                if i == 0:
                    B = parser._inter_neighbor(addr, x0, y0 - 1)
                    if B[0] and B[1] == ref:
                        mvp = B[2]
                    else:
                        A, B2, C = _inter_neighbors_for(parser, addr, 0, 0, 4)
                        mvp = parser._prediction_mv(A, B2, C, ref)
                else:
                    A = parser._inter_neighbor(addr, x0 - 1, y0 + 2)
                    if A[0] and A[1] == ref:
                        mvp = A[2]
                    else:
                        B = parser._inter_neighbor(addr, x0, y0 + 1)
                        C = parser._inter_neighbor(addr, x0 - 1, y0 + 1)
                        mvp = parser._prediction_mv(A, B, C, ref)
                mv = (mvds[i][0] + mvp[0], mvds[i][1] + mvp[1])
                _check_mv(mv)
                _set_partition_motion(parser, addr, bx, by, w4, h4, mv, ref)
                pic.ref_slot[addr, by // 2, 0] = ref_slots[ref]
                pic.ref_slot[addr, by // 2, 1] = ref_slots[ref]
        else:  # 8x16: left then right
            geoms = [(0, 0, 2, 4), (2, 0, 2, 4)]
            for i, (bx, by, w4, h4) in enumerate(geoms):
                ref = refs[i]
                x0 = (addr % parser.w) * 4
                y0 = (addr // parser.w) * 4
                if i == 0:
                    A = parser._inter_neighbor(addr, x0 - 1, y0)
                    if A[0] and A[1] == ref:
                        mvp = A[2]
                    else:
                        A2, B, C = _inter_neighbors_for(parser, addr, 0, 0, 2)
                        mvp = parser._prediction_mv(A2, B, C, ref)
                else:
                    C = parser._inter_neighbor(addr, x0 + 4, y0 - 1)
                    if not C[0]:
                        C = parser._inter_neighbor(addr, x0 + 1, y0 - 1)
                    if C[0] and C[1] == ref:
                        mvp = C[2]
                    else:
                        A, B, C2 = _inter_neighbors_for(parser, addr, 2, 0, 2)
                        mvp = parser._prediction_mv(A, B, C2, ref)
                mv = (mvds[i][0] + mvp[0], mvds[i][1] + mvp[1])
                _check_mv(mv)
                _set_partition_motion(parser, addr, bx, by, w4, h4, mv, ref)
                pic.ref_slot[addr, 0, bx // 2] = ref_slots[ref]
                pic.ref_slot[addr, 1, bx // 2] = ref_slots[ref]
    else:
        # P_8x8 / P_8x8ref0
        sub_types = []
        for _ in range(4):
            st = r.ue()
            if st > 3:
                raise StreamError("sub_mb_type out of range")
            sub_types.append(st)
        refs = []
        for _ in range(4):
            if mb_type == 4:
                refs.append(0)
            else:
                ref = r.te(num_ref) if num_ref > 1 else 0
                if ref >= num_ref:
                    raise StreamError("ref_idx out of range")
                refs.append(ref)
        for rr in refs:
            if ref_slots[rr] < 0:
                raise StreamError("reference picture missing")
        mvds = []
        for p in range(4):
            mvds.append([(r.se(), r.se())
                         for _ in range(len(SUB_PARTS[sub_types[p]]))])
        for p in range(4):
            px, py = (p % 2) * 2, (p // 2) * 2
            ref = refs[p]
            for sp, (sbx, sby, w4, h4) in enumerate(SUB_PARTS[sub_types[p]]):
                bx, by = px + sbx, py + sby
                A, B, C = _inter_neighbors_for(parser, addr, bx, by, w4)
                mvp = parser._prediction_mv(A, B, C, ref)
                mv = (mvds[p][sp][0] + mvp[0], mvds[p][sp][1] + mvp[1])
                _check_mv(mv)
                _set_partition_motion(parser, addr, bx, by, w4, h4, mv, ref)
            pic.ref_slot[addr, py // 2, px // 2] = ref_slots[ref]

    cbp_code = r.ue()
    if cbp_code > 47:
        raise StreamError("coded_block_pattern out of range")
    cbp = CBP_INTER[cbp_code]
    pic.cbp[addr] = cbp
    if cbp:
        qp = _apply_qp_delta(r, qp)
    pic.qp[addr] = qp
    _parse_residual(r, parser, addr, pic, cbp, is_i16=False)
    pic.decoded[addr] = True
    return qp
