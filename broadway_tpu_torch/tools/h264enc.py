"""Test-vector generator: a pure-Python H.264 Baseline-profile *syntax
encoder* (Annex-B byte streams, CAVLC entropy only).

This is test apparatus, not a production encoder: it emits syntactically
valid streams exercising specific decoder paths (I_PCM, intra prediction,
CAVLC residuals, quarter-pel MC, multi-slice, FMO, ...). The reference C
decoder (built by tools/build_oracle.sh, mirroring
the reference decoder's DecTestBench.c) defines the golden YUV output
for every generated stream; the TPU decoder must match it bit-exactly.

The reference repository ships no clips (Player/*.mp4 are absent large
blobs), and no ffmpeg/x264 exists in this image, so streams are produced
here from scratch per the recipe in reference README.markdown:35
(CAVLC, no B-frames, no weighted prediction).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


class BitWriter:
    """MSB-first bit accumulator producing an RBSP (no emulation bytes)."""

    def __init__(self) -> None:
        self._bits: List[int] = []

    def u(self, n: int, val: int) -> None:
        assert 0 <= val < (1 << n), (n, val)
        for i in range(n - 1, -1, -1):
            self._bits.append((val >> i) & 1)

    def flag(self, val) -> None:
        self.u(1, 1 if val else 0)

    def ue(self, val: int) -> None:
        """Unsigned Exp-Golomb."""
        assert val >= 0
        code = val + 1
        nbits = code.bit_length()
        self.u(nbits - 1, 0)
        self.u(nbits, code)

    def se(self, val: int) -> None:
        """Signed Exp-Golomb (spec 9.1.1)."""
        if val <= 0:
            self.ue(-2 * val)
        else:
            self.ue(2 * val - 1)

    def te(self, val: int, value_range: int) -> None:
        """Truncated Exp-Golomb: `value_range` = number of possible values;
        the 1-bit inverted form applies when only 0/1 are possible
        (spec 9.1.1; h264bsd_vlc.c h264bsdDecodeExpGolombTruncated)."""
        if value_range == 2:
            self.u(1, 1 - val)
        else:
            self.ue(val)

    def byte_align_zero(self) -> None:
        while len(self._bits) % 8:
            self._bits.append(0)

    def bytes_raw(self, data: bytes) -> None:
        assert len(self._bits) % 8 == 0
        for b in data:
            self.u(8, b)

    @property
    def bitpos(self) -> int:
        return len(self._bits)

    def rbsp_trailing_bits(self) -> None:
        self._bits.append(1)
        self.byte_align_zero()

    def rbsp(self) -> bytes:
        assert len(self._bits) % 8 == 0, "call rbsp_trailing_bits() first"
        out = bytearray()
        for i in range(0, len(self._bits), 8):
            v = 0
            for b in self._bits[i : i + 8]:
                v = (v << 1) | b
            out.append(v)
        return bytes(out)


def escape_rbsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention 0x03 bytes (spec 7.4.1.1)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal_unit(nal_ref_idc: int, nal_type: int, rbsp: bytes,
             long_start: bool = True) -> bytes:
    header = bytes([(nal_ref_idc << 5) | nal_type])
    start = b"\x00\x00\x00\x01" if long_start else b"\x00\x00\x01"
    return start + header + escape_rbsp(rbsp)


# ---------------------------------------------------------------------------
# Parameter sets
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpsConfig:
    sps_id: int = 0
    level_idc: int = 40
    log2_max_frame_num: int = 5
    poc_type: int = 2
    log2_max_poc_lsb: int = 6          # used when poc_type == 0
    delta_always_zero: bool = False    # poc_type == 1
    offset_for_non_ref_pic: int = 0
    offsets_for_ref_frame: tuple = ()
    num_ref_frames: int = 1
    gaps_allowed: bool = False
    width_mbs: int = 4
    height_mbs: int = 4
    crop: Optional[tuple] = None        # (left, right, top, bottom) in pixels


def write_sps(c: SpsConfig) -> bytes:
    w = BitWriter()
    w.u(8, 66)              # profile_idc: Baseline
    w.flag(1)               # constraint_set0
    w.flag(0); w.flag(0)    # constraint_set1/2
    w.u(5, 0)               # reserved
    w.u(8, c.level_idc)
    w.ue(c.sps_id)
    w.ue(c.log2_max_frame_num - 4)
    w.ue(c.poc_type)
    if c.poc_type == 0:
        w.ue(c.log2_max_poc_lsb - 4)
    elif c.poc_type == 1:
        w.flag(c.delta_always_zero)
        w.se(c.offset_for_non_ref_pic)
        w.se(0)             # offset_for_top_to_bottom_field
        w.ue(len(c.offsets_for_ref_frame))
        for o in c.offsets_for_ref_frame:
            w.se(o)
    w.ue(c.num_ref_frames)
    w.flag(c.gaps_allowed)
    w.ue(c.width_mbs - 1)
    w.ue(c.height_mbs - 1)
    w.flag(1)               # frame_mbs_only_flag
    w.flag(1)               # direct_8x8_inference_flag
    if c.crop:
        w.flag(1)
        for v in c.crop:
            w.ue(v // 2)    # units of 2 pixels for 4:2:0
    else:
        w.flag(0)
    w.flag(0)               # vui_parameters_present_flag
    w.rbsp_trailing_bits()
    return nal_unit(3, 7, w.rbsp())


@dataclasses.dataclass
class PpsConfig:
    pps_id: int = 0
    sps_id: int = 0
    pic_order_present: bool = False
    num_slice_groups: int = 1
    slice_group_map_type: int = 0
    slice_group_change_rate: int = 1    # map types 3..5
    run_length: Optional[Sequence[int]] = None          # map type 0
    top_left: Optional[Sequence[int]] = None            # map type 2
    bottom_right: Optional[Sequence[int]] = None
    slice_group_change_direction: bool = False
    explicit_map: Optional[Sequence[int]] = None        # map type 6
    num_ref_idx_l0: int = 1
    pic_init_qp: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present: bool = True
    constrained_intra_pred: bool = False
    redundant_pic_cnt_present: bool = False


def write_pps(c: PpsConfig) -> bytes:
    w = BitWriter()
    w.ue(c.pps_id)
    w.ue(c.sps_id)
    w.flag(0)               # entropy_coding_mode_flag: CAVLC
    w.flag(c.pic_order_present)
    w.ue(c.num_slice_groups - 1)
    if c.num_slice_groups > 1:
        w.ue(c.slice_group_map_type)
        t = c.slice_group_map_type
        if t == 0:
            for r in c.run_length:
                w.ue(r - 1)
        elif t == 2:
            for tl, br in zip(c.top_left, c.bottom_right):
                w.ue(tl)
                w.ue(br)
        elif t in (3, 4, 5):
            w.flag(c.slice_group_change_direction)
            w.ue(c.slice_group_change_rate - 1)
        elif t == 6:
            w.ue(len(c.explicit_map) - 1)
            nbits = max(1, (c.num_slice_groups - 1).bit_length())
            for g in c.explicit_map:
                w.u(nbits, g)
    w.ue(c.num_ref_idx_l0 - 1)
    w.ue(0)                 # num_ref_idx_l1_active_minus1
    w.flag(0)               # weighted_pred_flag
    w.u(2, 0)               # weighted_bipred_idc
    w.se(c.pic_init_qp - 26)
    w.se(0)                 # pic_init_qs_minus26
    w.se(c.chroma_qp_index_offset)
    w.flag(c.deblocking_filter_control_present)
    w.flag(c.constrained_intra_pred)
    w.flag(c.redundant_pic_cnt_present)
    w.rbsp_trailing_bits()
    return nal_unit(3, 8, w.rbsp())


# ---------------------------------------------------------------------------
# Slice + macroblock syntax
# ---------------------------------------------------------------------------

# Macroblock payload descriptors consumed by write_slice(). Each MB is a dict:
#   {"kind": "ipcm", "luma": bytes(256), "cb": bytes(64), "cr": bytes(64)}
#   {"kind": "i4x4", "modes": [(use_most_probable, rem_mode) x16],
#    "chroma_mode": m, "cbp": n, "residual": ResidualData|None, "qp_delta": d}
#   {"kind": "i16", "pred_mode": 0..3, "cbp_luma": 0|15, "cbp_chroma": 0..2,
#    "residual": ResidualData, "chroma_mode": m, "qp_delta": d}
#   {"kind": "p16x16", "ref_idx": r, "mvd": (dx, dy), "cbp": n,
#    "residual": ResidualData|None, "qp_delta": d}
#   {"kind": "p8x8", "sub_types": [0..3]*4, "ref_idx": [r]*4,
#    "mvds": [[(dx,dy) per sub-part] x4], "cbp": n, "residual": ..., ...}
#   {"kind": "skip"}   (P slices only)

# Mapped Exp-Golomb codeNum for coded_block_pattern (spec table 9-4) —
# shared with the decoder.
from ..bitstream.cavlc_tables import (  # noqa: E402
    CBP_TO_CODENUM_INTER, CBP_TO_CODENUM_INTRA)


def _write_mb_i4x4(w: BitWriter, mb: dict) -> None:
    for use_mp, rem in mb["modes"]:
        w.flag(use_mp)
        if not use_mp:
            w.u(3, rem)
    w.ue(mb["chroma_mode"])  # intra_chroma_pred_mode


def _write_residual_luma_ac_i16(w: BitWriter, mb: dict, ctx: "CavlcContext",
                                mb_addr: int) -> None:
    raise NotImplementedError


@dataclasses.dataclass
class SliceConfig:
    slice_type: str = "I"        # "I" or "P"
    first_mb: int = 0
    pps_id: int = 0
    frame_num: int = 0
    idr: bool = True
    idr_pic_id: int = 0
    poc_lsb: int = 0             # written when sps.poc_type == 0
    delta_poc_0: int = 0         # poc_type 1 without delta_always_zero
    num_ref_idx_override: Optional[int] = None
    slice_qp: int = 26
    pic_init_qp: int = 26
    disable_deblocking_idc: int = 1   # 0 on, 1 off, 2 no-cross-slice
    slice_alpha_c0_offset: int = 0    # [-6, 6], written when idc != 1
    slice_beta_offset: int = 0
    # dec_ref_pic_marking for non-IDR reference slices:
    adaptive_ref_pic_marking: Optional[List[tuple]] = None  # [(mmco, args...)]
    # ref_pic_list_reordering commands: [(op, value)], op in (0, 1, 2)
    reorder_l0: Optional[List[tuple]] = None
    slice_group_change_cycle: Optional[int] = None
    redundant_pic_cnt: int = 0   # written when pps.redundant_pic_cnt_present
    sps: SpsConfig = dataclasses.field(default_factory=SpsConfig)
    pps: PpsConfig = dataclasses.field(default_factory=PpsConfig)
    nal_ref_idc: int = 3


def write_slice(cfg: SliceConfig, mbs: List[dict]) -> bytes:
    """Write one slice NAL: header + macroblock data for `mbs`."""
    from .cavlc_enc import CavlcContext, write_residual_mb  # local import

    w = BitWriter()
    w.ue(cfg.first_mb)
    stype = {"P": 0, "I": 2}[cfg.slice_type]
    w.ue(stype + 5)  # +5 variant: all slices in picture have this type
    w.ue(cfg.pps_id)
    w.u(cfg.sps.log2_max_frame_num, cfg.frame_num)
    if cfg.idr:
        w.ue(cfg.idr_pic_id)
    if cfg.sps.poc_type == 0:
        w.u(cfg.sps.log2_max_poc_lsb, cfg.poc_lsb)
        if cfg.pps.pic_order_present:
            w.se(0)  # delta_pic_order_cnt_bottom
    elif cfg.sps.poc_type == 1 and not cfg.sps.delta_always_zero:
        w.se(cfg.delta_poc_0)
        if cfg.pps.pic_order_present:
            w.se(0)  # delta_pic_order_cnt[1]
    if cfg.pps.redundant_pic_cnt_present:
        w.ue(cfg.redundant_pic_cnt)
    if cfg.slice_type == "P":
        if cfg.num_ref_idx_override is not None:
            w.flag(1)
            w.ue(cfg.num_ref_idx_override - 1)
        else:
            w.flag(0)
        # ref_pic_list_reordering
        if cfg.reorder_l0:
            w.flag(1)
            for op, val in cfg.reorder_l0:
                w.ue(op)
                if op in (0, 1):
                    w.ue(val)   # abs_diff_pic_num_minus1
                elif op == 2:
                    w.ue(val)   # long_term_pic_num
            w.ue(3)             # end of reordering
        else:
            w.flag(0)
    if cfg.nal_ref_idc:
        if cfg.idr:
            w.flag(0)  # no_output_of_prior_pics_flag
            w.flag(0)  # long_term_reference_flag
        else:
            if cfg.adaptive_ref_pic_marking is not None:
                w.flag(1)
                for cmd in cfg.adaptive_ref_pic_marking:
                    for v in cmd:
                        w.ue(v)
                w.ue(0)  # mmco end
            else:
                w.flag(0)
    w.se(cfg.slice_qp - cfg.pic_init_qp)
    if cfg.pps.deblocking_filter_control_present:
        w.ue(cfg.disable_deblocking_idc)
        if cfg.disable_deblocking_idc != 1:
            w.se(cfg.slice_alpha_c0_offset // 2)
            w.se(cfg.slice_beta_offset // 2)
    if cfg.pps.num_slice_groups > 1 and cfg.pps.slice_group_map_type in (3, 4, 5):
        pic_size = cfg.sps.width_mbs * cfg.sps.height_mbs
        rate = cfg.pps.slice_group_change_rate
        nbits = max(1, (pic_size // rate + (1 if pic_size % rate else 0))
                    .bit_length())
        w.u(nbits, cfg.slice_group_change_cycle or 0)

    # --- slice data ---
    ctx = CavlcContext(cfg.sps.width_mbs, cfg.sps.height_mbs)
    qp = cfg.slice_qp
    skip_run = 0
    is_p = cfg.slice_type == "P"
    for mb in mbs:
        if mb["kind"] == "skip":
            assert is_p
            skip_run += 1
            ctx.mark_skip(mb["addr"])
            continue
        if is_p:
            w.ue(skip_run)
            skip_run = 0
        qp = _write_mb(w, mb, ctx, qp)
    # trailing skip_run only when the slice ends in skipped MBs — a run
    # after the final regular MB is rejected by the reference
    # (h264bsd_slice_data.c:213 "Next mb address")
    if is_p and skip_run:
        w.ue(skip_run)
    w.rbsp_trailing_bits()
    nal_type = 5 if cfg.idr else 1
    return nal_unit(cfg.nal_ref_idc, nal_type, w.rbsp())


def _write_mb(w: BitWriter, mb: dict, ctx, qp: int) -> int:
    """Write one macroblock_layer(); returns updated QP."""
    from .cavlc_enc import write_residual_mb

    kind = mb["kind"]
    addr = mb["addr"]
    is_p_slice = mb.get("p_slice", kind in ("p16x16", "p8x8", "pNxM"))
    i_offset = 5 if is_p_slice else 0  # intra types offset in P slices

    if kind == "ipcm":
        w.ue(25 + i_offset)
        w.byte_align_zero()
        w.bytes_raw(mb["luma"])
        w.bytes_raw(mb["cb"])
        w.bytes_raw(mb["cr"])
        ctx.mark_ipcm(addr)
        return qp

    if kind == "i4x4":
        w.ue(0 + i_offset)
        _write_mb_i4x4(w, mb)
        cbp = mb["cbp"]
        w.ue(CBP_TO_CODENUM_INTRA[cbp])
        if cbp:
            w.se(mb.get("qp_delta", 0))
            qp += mb.get("qp_delta", 0)
            write_residual_mb(w, ctx, addr, kind="i4x4", cbp=cbp,
                              residual=mb["residual"])
        else:
            ctx.mark_no_residual(addr)
        return qp

    if kind == "i16":
        cbp_l = 15 if mb["cbp_luma"] else 0
        mb_type = 1 + mb["pred_mode"] + 4 * mb["cbp_chroma"] + \
            12 * (1 if cbp_l else 0)
        w.ue(mb_type + i_offset)
        w.ue(mb["chroma_mode"])
        w.se(mb.get("qp_delta", 0))
        qp += mb.get("qp_delta", 0)
        write_residual_mb(w, ctx, addr, kind="i16",
                          cbp=cbp_l | (mb["cbp_chroma"] << 4),
                          residual=mb["residual"])
        return qp

    if kind == "p16x16":
        w.ue(0)
        if mb["num_ref"] > 1:
            w.te(mb.get("ref_idx", 0), mb["num_ref"])
        w.se(mb["mvd"][0])
        w.se(mb["mvd"][1])
        cbp = mb["cbp"]
        w.ue(CBP_TO_CODENUM_INTER[cbp])
        if cbp:
            w.se(mb.get("qp_delta", 0))
            qp += mb.get("qp_delta", 0)
            write_residual_mb(w, ctx, addr, kind="inter", cbp=cbp,
                              residual=mb["residual"])
        else:
            ctx.mark_no_residual(addr)
        return qp

    if kind == "pNxM":
        # P_L0_16x8 (mb_type 1) or P_L0_8x16 (mb_type 2): two partitions.
        w.ue(mb["mb_type"])
        if mb["num_ref"] > 1:
            for r in mb["ref_idx"]:
                w.te(r, mb["num_ref"])
        for dx, dy in mb["mvds"]:
            w.se(dx)
            w.se(dy)
        cbp = mb["cbp"]
        w.ue(CBP_TO_CODENUM_INTER[cbp])
        if cbp:
            w.se(mb.get("qp_delta", 0))
            qp += mb.get("qp_delta", 0)
            write_residual_mb(w, ctx, addr, kind="inter", cbp=cbp,
                              residual=mb["residual"])
        else:
            ctx.mark_no_residual(addr)
        return qp

    if kind == "p8x8":
        w.ue(mb.get("mb_type", 3))  # 3 = P_8x8, 4 = P_8x8ref0
        for st in mb["sub_types"]:
            w.ue(st)
        if mb.get("mb_type", 3) != 4 and mb["num_ref"] > 1:
            for r in mb["ref_idx"]:
                w.te(r, mb["num_ref"])
        for part_mvds in mb["mvds"]:
            for dx, dy in part_mvds:
                w.se(dx)
                w.se(dy)
        cbp = mb["cbp"]
        w.ue(CBP_TO_CODENUM_INTER[cbp])
        if cbp:
            w.se(mb.get("qp_delta", 0))
            qp += mb.get("qp_delta", 0)
            write_residual_mb(w, ctx, addr, kind="inter", cbp=cbp,
                              residual=mb["residual"])
        else:
            ctx.mark_no_residual(addr)
        return qp

    raise ValueError(kind)
