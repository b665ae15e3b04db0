"""Slice header parsing (reference: h264bsd_slice_header.c:97
h264bsdDecodeSliceHeader) plus the peek-parsers used for access-unit
boundary detection (h264bsd_slice_header.c:732-1401 h264bsdCheckX family).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .bitreader import BitReader, StreamError
from .params import Pps, Sps

P_SLICE = 0
I_SLICE = 2


@dataclasses.dataclass
class RefPicListMod:
    op: int        # 0: subtract pic_num diff, 1: add, 2: long-term
    value: int     # abs_diff_pic_num_minus1 or long_term_pic_num


@dataclasses.dataclass
class MmcoOp:
    op: int
    val1: int = 0
    val2: int = 0


@dataclasses.dataclass
class SliceHeader:
    first_mb: int = 0
    slice_type: int = I_SLICE          # normalized to 0 (P) / 2 (I)
    slice_type_raw: int = 2
    pps_id: int = 0
    frame_num: int = 0
    idr: bool = False
    idr_pic_id: int = 0
    poc_lsb: int = 0
    delta_poc_bottom: int = 0
    delta_poc_0: int = 0
    num_ref_idx_l0: int = 1
    ref_list_mods: Optional[List[RefPicListMod]] = None
    # dec_ref_pic_marking
    no_output_of_prior_pics: bool = False
    long_term_reference: bool = False
    adaptive_ref_pic_marking: bool = False
    mmco: List[MmcoOp] = dataclasses.field(default_factory=list)
    slice_qp: int = 26
    disable_deblocking_idc: int = 0
    alpha_c0_offset: int = 0           # actual offset (2x coded value)
    beta_offset: int = 0
    slice_group_change_cycle: int = 0
    nal_ref_idc: int = 0
    redundant_pic_cnt: int = 0


def _ceil_log2(x: int) -> int:
    return max(1, (x - 1).bit_length()) if x > 1 else 1


def parse_slice_header(r: BitReader, nal_type: int, nal_ref_idc: int,
                       sps: Sps, pps: Pps) -> SliceHeader:
    h = SliceHeader()
    h.nal_ref_idc = nal_ref_idc
    h.idr = nal_type == 5
    h.first_mb = r.ue()
    if h.first_mb >= sps.pic_size_mbs:
        raise StreamError("first_mb_in_slice out of range")
    h.slice_type_raw = r.ue()
    st = h.slice_type_raw
    if st not in (0, 2, 5, 7):
        raise StreamError(f"unsupported slice_type {st} (Baseline: I/P)")
    h.slice_type = st % 5
    if h.idr and h.slice_type != I_SLICE:
        raise StreamError("IDR picture with non-I slice")
    h.pps_id = r.ue()
    h.frame_num = r.u((sps.max_frame_num - 1).bit_length())
    if h.idr and h.frame_num != 0:
        raise StreamError("IDR frame_num != 0")
    if h.idr:
        h.idr_pic_id = r.ue()
        if h.idr_pic_id > 65535:
            raise StreamError("idr_pic_id out of range")
    if sps.poc_type == 0:
        h.poc_lsb = r.u((sps.max_pic_order_cnt_lsb - 1).bit_length())
        if pps.pic_order_present:
            h.delta_poc_bottom = r.se()
    elif sps.poc_type == 1 and not sps.delta_pic_order_always_zero:
        h.delta_poc_0 = r.se()
        if pps.pic_order_present:
            r.se()  # delta_pic_order_cnt[1], unused for frames
    if pps.redundant_pic_cnt_present:
        redundant = r.ue()
        if redundant > 127:
            raise StreamError("redundant_pic_cnt out of range")
        # redundant slices are legal: the caller skips them when the
        # primary picture is (partially) decoded, or decodes them as the
        # fallback when the primary was lost entirely — the subset of
        # h264bsd_slice_data.c:133-139 / h264bsd_decoder.c:318 fallback
        # behavior expressible in the dense-tensor IR
        h.redundant_pic_cnt = redundant
    h.num_ref_idx_l0 = pps.num_ref_idx_l0
    if h.slice_type == P_SLICE:
        if r.flag():  # num_ref_idx_active_override
            h.num_ref_idx_l0 = r.ue() + 1
            if h.num_ref_idx_l0 > 16:
                raise StreamError("num_ref_idx_l0 out of range")
        # ref_pic_list_reordering
        if r.flag():
            h.ref_list_mods = []
            while True:
                op = r.ue()
                if op == 3:
                    break
                if op > 3 or len(h.ref_list_mods) >= 17:
                    raise StreamError("invalid reordering op")
                h.ref_list_mods.append(RefPicListMod(op, r.ue()))
    if nal_ref_idc:
        if h.idr:
            h.no_output_of_prior_pics = r.flag()
            h.long_term_reference = r.flag()
        else:
            h.adaptive_ref_pic_marking = r.flag()
            if h.adaptive_ref_pic_marking:
                while True:
                    op = r.ue()
                    if op == 0:
                        break
                    if op > 6:
                        raise StreamError("invalid MMCO op")
                    m = MmcoOp(op)
                    if op in (1, 3):
                        m.val1 = r.ue()
                    if op == 2:
                        m.val1 = r.ue()
                    if op in (3, 6):
                        m.val2 = r.ue()
                    if op == 4:
                        m.val1 = r.ue()
                    h.mmco.append(m)
                    if len(h.mmco) > 35:
                        raise StreamError("too many MMCO ops")
    h.slice_qp = pps.pic_init_qp + r.se()
    if not (0 <= h.slice_qp <= 51):
        raise StreamError("slice_qp out of range")
    if pps.deblocking_filter_control_present:
        h.disable_deblocking_idc = r.ue()
        if h.disable_deblocking_idc > 2:
            raise StreamError("disable_deblocking_filter_idc out of range")
        if h.disable_deblocking_idc != 1:
            a = r.se()
            b = r.se()
            if not (-6 <= a <= 6 and -6 <= b <= 6):
                raise StreamError("deblock offsets out of range")
            h.alpha_c0_offset = 2 * a
            h.beta_offset = 2 * b
    if pps.num_slice_groups > 1 and pps.slice_group_map_type in (3, 4, 5):
        pic_size = sps.pic_size_mbs
        rate = pps.slice_group_change_rate
        groups = (pic_size + rate - 1) // rate + 1
        nbits = (groups - 1).bit_length() if groups > 1 else 1
        h.slice_group_change_cycle = r.u(nbits)
    return h


def peek_slice_ids(rbsp: bytes, sps_by_pps) -> Optional[dict]:
    """Light peek-parse of (first_mb, pps_id, frame_num, idr_pic_id,
    poc_lsb, delta_poc...) for AU boundary checks without touching decoder
    state (mirrors h264bsdCheckAccessUnitBoundary's use of the CheckX
    family, h264bsd_storage.c:632)."""
    try:
        r = BitReader(rbsp)
        first_mb = r.ue()
        slice_type = r.ue()
        pps_id = r.ue()
        pair = sps_by_pps(pps_id)
        if pair is None:
            return None
        sps, pps = pair
        out = {"first_mb": first_mb, "slice_type": slice_type,
               "pps_id": pps_id}
        out["frame_num"] = r.u((sps.max_frame_num - 1).bit_length())
        return out
    except StreamError:
        return None
