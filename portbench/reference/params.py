"""SPS / PPS / VUI parsing (reference: h264bsd_seq_param_set.c:83,
h264bsd_pic_param_set.c:89, h264bsd_vui.c:80).

Baseline-decodable subset: CAVLC only, frame coding only, no weighted
prediction, I/P slices. Unsupported features raise StreamError like the
reference returns HANTRO_NOK.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .bitreader import BitReader, StreamError

MAX_NUM_REF_PICS = 16
MAX_NUM_SLICE_GROUPS = 8
MAX_NUM_SEQ_PARAM_SETS = 32
MAX_NUM_PIC_PARAM_SETS = 256

# level_idc -> (MaxDPB bytes, MaxFrameSize mbs); mirrors the reference's
# Annex A table A-1 handling (h264bsd_seq_param_set.c:383 GetDpbSize),
# including the level-5.0 corrigendum value.
_LEVEL_LIMITS = {
    10: (152064, 99),
    11: (345600, 396),
    12: (912384, 396),
    13: (912384, 396),
    20: (912384, 396),
    21: (1824768, 792),
    22: (3110400, 1620),
    30: (3110400, 1620),
    31: (6912000, 3600),
    32: (7864320, 5120),
    40: (12582912, 8192),
    41: (12582912, 8192),
    42: (34816 * 384, 8704),
    50: (42393600, 22080),
    51: (70778880, 36864),
}


@dataclasses.dataclass
class Hrd:
    cpb_cnt: int = 1
    bit_rate_scale: int = 0
    cpb_size_scale: int = 0
    bit_rate_value: Tuple[int, ...] = ()
    cpb_size_value: Tuple[int, ...] = ()
    cbr_flag: Tuple[bool, ...] = ()
    initial_cpb_removal_delay_length: int = 24
    cpb_removal_delay_length: int = 24
    dpb_output_delay_length: int = 24
    time_offset_length: int = 24


@dataclasses.dataclass
class Vui:
    aspect_ratio_idc: int = 0
    sar_width: int = 0
    sar_height: int = 0
    overscan_appropriate: Optional[bool] = None
    video_format: int = 5
    video_full_range: bool = False
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    chroma_loc_top: int = 0
    chroma_loc_bottom: int = 0
    timing_info_present: bool = False
    num_units_in_tick: int = 0
    time_scale: int = 0
    fixed_frame_rate: bool = False
    nal_hrd: Optional[Hrd] = None
    vcl_hrd: Optional[Hrd] = None
    low_delay_hrd: bool = False
    pic_struct_present: bool = False
    bitstream_restriction: bool = False
    motion_vectors_over_pic_boundaries: bool = True
    max_bytes_per_pic_denom: int = 2
    max_bits_per_mb_denom: int = 1
    log2_max_mv_length_horizontal: int = 16
    log2_max_mv_length_vertical: int = 16
    num_reorder_frames: int = 0
    max_dec_frame_buffering: int = 0


def _parse_hrd(r: BitReader) -> Hrd:
    h = Hrd()
    h.cpb_cnt = r.ue() + 1
    if h.cpb_cnt > 32:
        raise StreamError("invalid cpb_cnt")
    h.bit_rate_scale = r.u(4)
    h.cpb_size_scale = r.u(4)
    brv, csv, cbr = [], [], []
    for _ in range(h.cpb_cnt):
        brv.append(r.ue() + 1)
        csv.append(r.ue() + 1)
        cbr.append(r.flag())
    h.bit_rate_value = tuple(brv)
    h.cpb_size_value = tuple(csv)
    h.cbr_flag = tuple(cbr)
    h.initial_cpb_removal_delay_length = r.u(5) + 1
    h.cpb_removal_delay_length = r.u(5) + 1
    h.dpb_output_delay_length = r.u(5) + 1
    h.time_offset_length = r.u(5)
    return h


def _parse_vui(r: BitReader) -> Vui:
    v = Vui()
    if r.flag():  # aspect_ratio_info_present
        v.aspect_ratio_idc = r.u(8)
        if v.aspect_ratio_idc == 255:  # extended SAR
            v.sar_width = r.u(16)
            v.sar_height = r.u(16)
    if r.flag():  # overscan_info_present
        v.overscan_appropriate = r.flag()
    if r.flag():  # video_signal_type_present
        v.video_format = r.u(3)
        v.video_full_range = r.flag()
        if r.flag():  # colour_description_present
            v.colour_primaries = r.u(8)
            v.transfer_characteristics = r.u(8)
            v.matrix_coefficients = r.u(8)
    if r.flag():  # chroma_loc_info_present
        v.chroma_loc_top = r.ue()
        v.chroma_loc_bottom = r.ue()
    v.timing_info_present = r.flag()
    if v.timing_info_present:
        v.num_units_in_tick = r.u(32)
        v.time_scale = r.u(32)
        v.fixed_frame_rate = r.flag()
    nal_hrd_present = r.flag()
    if nal_hrd_present:
        v.nal_hrd = _parse_hrd(r)
    vcl_hrd_present = r.flag()
    if vcl_hrd_present:
        v.vcl_hrd = _parse_hrd(r)
    if nal_hrd_present or vcl_hrd_present:
        v.low_delay_hrd = r.flag()
    v.pic_struct_present = r.flag()
    v.bitstream_restriction = r.flag()
    if v.bitstream_restriction:
        v.motion_vectors_over_pic_boundaries = r.flag()
        v.max_bytes_per_pic_denom = r.ue()
        v.max_bits_per_mb_denom = r.ue()
        v.log2_max_mv_length_horizontal = r.ue()
        v.log2_max_mv_length_vertical = r.ue()
        v.num_reorder_frames = r.ue()
        v.max_dec_frame_buffering = r.ue()
    return v


@dataclasses.dataclass
class Sps:
    profile_idc: int = 66
    level_idc: int = 30
    sps_id: int = 0
    max_frame_num: int = 256
    poc_type: int = 0
    max_pic_order_cnt_lsb: int = 0
    delta_pic_order_always_zero: bool = False
    offset_for_non_ref_pic: int = 0
    offset_for_top_to_bottom_field: int = 0
    offsets_for_ref_frame: Tuple[int, ...] = ()
    num_ref_frames: int = 0
    gaps_in_frame_num_allowed: bool = False
    width_mbs: int = 0
    height_mbs: int = 0
    crop: Optional[Tuple[int, int, int, int]] = None  # l, r, t, b (px)
    vui: Optional[Vui] = None
    mono_chrome: bool = False

    @property
    def pic_size_mbs(self) -> int:
        return self.width_mbs * self.height_mbs

    @property
    def width(self) -> int:
        return 16 * self.width_mbs

    @property
    def height(self) -> int:
        return 16 * self.height_mbs

    def dpb_size(self) -> int:
        """Frame buffers required by the level (Annex A table A-1),
        capped at 16. For unknown levels or over-level picture sizes the
        reference warns and falls back to num_ref_frames
        (h264bsd_seq_param_set.c:306-313) — mirror that."""
        lim = _LEVEL_LIMITS.get(self.level_idc)
        if lim is not None:
            max_dpb_bytes, max_mbs = lim
            if self.pic_size_mbs <= max_mbs:
                v = min(max_dpb_bytes // (self.pic_size_mbs * 384), 16)
                if self.num_ref_frames <= v:
                    return v
        return max(self.num_ref_frames, 1)


def parse_sps(r: BitReader) -> Sps:
    s = Sps()
    s.profile_idc = r.u(8)
    r.u(8)  # constraint flags + reserved
    s.level_idc = r.u(8)
    s.sps_id = r.ue()
    if s.sps_id >= MAX_NUM_SEQ_PARAM_SETS:
        raise StreamError("sps_id out of range")
    s.max_frame_num = 1 << (r.ue() + 4)
    if s.max_frame_num > (1 << 16):
        raise StreamError("log2_max_frame_num out of range")
    s.poc_type = r.ue()
    if s.poc_type > 2:
        raise StreamError("pic_order_cnt_type out of range")
    if s.poc_type == 0:
        s.max_pic_order_cnt_lsb = 1 << (r.ue() + 4)
        if s.max_pic_order_cnt_lsb > (1 << 16):
            raise StreamError("log2_max_poc_lsb out of range")
    elif s.poc_type == 1:
        s.delta_pic_order_always_zero = r.flag()
        s.offset_for_non_ref_pic = r.se()
        s.offset_for_top_to_bottom_field = r.se()
        n = r.ue()
        if n > 255:
            raise StreamError("num_ref_frames_in_pic_order_cnt_cycle")
        s.offsets_for_ref_frame = tuple(r.se() for _ in range(n))
    s.num_ref_frames = r.ue()
    if s.num_ref_frames > MAX_NUM_REF_PICS:
        raise StreamError("num_ref_frames out of range")
    s.gaps_in_frame_num_allowed = r.flag()
    s.width_mbs = r.ue() + 1
    s.height_mbs = r.ue() + 1
    if not r.flag():  # frame_mbs_only_flag
        raise StreamError("interlaced coding not supported (Baseline)")
    r.flag()  # direct_8x8_inference_flag
    if r.flag():  # frame_cropping_flag
        left, right, top, bottom = r.ue(), r.ue(), r.ue(), r.ue()
        s.crop = (2 * left, 2 * right, 2 * top, 2 * bottom)
        if (s.crop[0] + s.crop[1] >= s.width or
                s.crop[2] + s.crop[3] >= s.height):
            raise StreamError("invalid cropping window")
    if r.flag():  # vui_parameters_present
        s.vui = _parse_vui(r)
    return s


@dataclasses.dataclass
class Pps:
    pps_id: int = 0
    sps_id: int = 0
    pic_order_present: bool = False
    num_slice_groups: int = 1
    slice_group_map_type: int = 0
    run_length: Tuple[int, ...] = ()
    top_left: Tuple[int, ...] = ()
    bottom_right: Tuple[int, ...] = ()
    slice_group_change_direction: bool = False
    slice_group_change_rate: int = 1
    slice_group_map: Optional[Tuple[int, ...]] = None  # explicit, type 6
    num_ref_idx_l0: int = 1
    pic_init_qp: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present: bool = False
    constrained_intra_pred: bool = False
    redundant_pic_cnt_present: bool = False


def parse_pps(r: BitReader) -> Pps:
    p = Pps()
    p.pps_id = r.ue()
    if p.pps_id >= MAX_NUM_PIC_PARAM_SETS:
        raise StreamError("pps_id out of range")
    p.sps_id = r.ue()
    if p.sps_id >= MAX_NUM_SEQ_PARAM_SETS:
        raise StreamError("sps_id out of range")
    if r.flag():  # entropy_coding_mode_flag
        raise StreamError("CABAC not supported (Baseline)")
    p.pic_order_present = r.flag()
    p.num_slice_groups = r.ue() + 1
    if p.num_slice_groups > MAX_NUM_SLICE_GROUPS:
        raise StreamError("num_slice_groups out of range")
    if p.num_slice_groups > 1:
        p.slice_group_map_type = r.ue()
        t = p.slice_group_map_type
        if t > 6:
            raise StreamError("slice_group_map_type out of range")
        if t == 0:
            p.run_length = tuple(r.ue() + 1 for _ in range(p.num_slice_groups))
        elif t == 2:
            tl, br = [], []
            for _ in range(p.num_slice_groups - 1):
                tl.append(r.ue())
                br.append(r.ue())
            p.top_left = tuple(tl)
            p.bottom_right = tuple(br)
        elif t in (3, 4, 5):
            p.slice_group_change_direction = r.flag()
            p.slice_group_change_rate = r.ue() + 1
        elif t == 6:
            n = r.ue() + 1
            nbits = (p.num_slice_groups - 1).bit_length()
            nbits = max(nbits, 1)
            p.slice_group_map = tuple(r.u(nbits) for _ in range(n))
    p.num_ref_idx_l0 = r.ue() + 1
    if p.num_ref_idx_l0 > 32:
        raise StreamError("num_ref_idx_l0 out of range")
    num_ref_idx_l1 = r.ue() + 1
    if num_ref_idx_l1 > 32:
        raise StreamError("num_ref_idx_l1 out of range")
    if r.flag():  # weighted_pred_flag
        raise StreamError("weighted prediction not supported (Baseline)")
    if r.u(2):  # weighted_bipred_idc
        raise StreamError("weighted biprediction not supported")
    p.pic_init_qp = r.se() + 26
    if not (0 <= p.pic_init_qp <= 51):
        raise StreamError("pic_init_qp out of range")
    pic_init_qs = r.se() + 26
    if not (0 <= pic_init_qs <= 51):
        raise StreamError("pic_init_qs out of range")
    p.chroma_qp_index_offset = r.se()
    if not (-12 <= p.chroma_qp_index_offset <= 12):
        raise StreamError("chroma_qp_index_offset out of range")
    p.deblocking_filter_control_present = r.flag()
    p.constrained_intra_pred = r.flag()
    p.redundant_pic_cnt_present = r.flag()
    return p
