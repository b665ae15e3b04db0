"""Picture order count — types 0/1/2 incl. MMCO5 interaction
(reference: h264bsd_pic_order_cnt.c:79 h264bsdDecodePicOrderCnt)."""

from __future__ import annotations

import dataclasses

from .params import Sps
from .slice_header import SliceHeader


@dataclasses.dataclass
class PocState:
    prev_poc_msb: int = 0
    prev_poc_lsb: int = 0
    prev_frame_num: int = 0
    prev_frame_num_offset: int = 0
    contains_mmco5: bool = False


def decode_poc(sps: Sps, h: SliceHeader, state: PocState,
               nal_ref_idc: int, cur_mmco5: bool = False) -> int:
    """Compute POC for the current picture and update `state`.
    `cur_mmco5`: current slice header carries an MMCO5 op (resets the
    stored prev values per spec 8.2.1)."""
    if sps.poc_type == 0:
        max_lsb = sps.max_pic_order_cnt_lsb
        if h.idr:
            prev_msb = prev_lsb = 0
        else:
            prev_msb = state.prev_poc_msb
            prev_lsb = state.prev_poc_lsb
        lsb = h.poc_lsb
        if lsb < prev_lsb and (prev_lsb - lsb) >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and (lsb - prev_lsb) > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        poc = msb + lsb
        if nal_ref_idc:
            if cur_mmco5:
                state.prev_poc_msb = 0
                state.prev_poc_lsb = 0
            else:
                state.prev_poc_msb = msb
                state.prev_poc_lsb = lsb
        return poc

    if sps.poc_type == 1:
        if h.idr:
            frame_num_offset = 0
        elif state.prev_frame_num > h.frame_num:
            frame_num_offset = state.prev_frame_num_offset + sps.max_frame_num
        else:
            frame_num_offset = state.prev_frame_num_offset
        abs_frame_num = frame_num_offset + h.frame_num
        if nal_ref_idc == 0 and abs_frame_num > 0:
            abs_frame_num -= 1
        n = len(sps.offsets_for_ref_frame)
        expected = 0
        if abs_frame_num > 0 and n > 0:
            cycle_sum = sum(sps.offsets_for_ref_frame)
            num_cycles = (abs_frame_num - 1) // n
            in_cycle = (abs_frame_num - 1) % n
            expected = num_cycles * cycle_sum + \
                sum(sps.offsets_for_ref_frame[: in_cycle + 1])
        if nal_ref_idc == 0:
            expected += sps.offset_for_non_ref_pic
        poc = expected + h.delta_poc_0
        if cur_mmco5:
            state.prev_frame_num_offset = 0
            state.prev_frame_num = 0
        else:
            state.prev_frame_num_offset = frame_num_offset
            state.prev_frame_num = h.frame_num
        return poc

    # type 2
    if h.idr:
        frame_num_offset = 0
        poc = 0
    else:
        if state.prev_frame_num > h.frame_num:
            frame_num_offset = state.prev_frame_num_offset + sps.max_frame_num
        else:
            frame_num_offset = state.prev_frame_num_offset
        tmp = frame_num_offset + h.frame_num
        poc = 2 * tmp if nal_ref_idc else 2 * tmp - 1
    if cur_mmco5:
        state.prev_frame_num_offset = 0
        state.prev_frame_num = 0
    else:
        state.prev_frame_num_offset = frame_num_offset
        state.prev_frame_num = h.frame_num
    return poc
