"""SEI (Supplemental Enhancement Information) message parser.

Reference: the reference decoder's h264bsd_sei.c
(h264bsdDecodeSeiMessage :178; per-message decoders for buffering
period :229, picture timing :282, pan-scan rect :426, filler :500,
user data registered/unregistered :516/:562, recovery point :601,
dec-ref-pic-marking repetition :647, spare picture :701, scene info
:805, sub-sequence info/layer/characteristics :878-:1024, full-frame
freeze/release/snapshot :1030-:1111, progressive-refinement segment
:1117-:1186, motion-constrained slice group set :1192, reserved
:1245). NOTE: the reference's compiled build omits this file
(make.py source list) and skips SEI NALs at the top level
("SEI MESSAGE, NOT DECODED", h264bsd_decoder.c:480-482) — decode
behavior is unaffected by SEI either way. This module ports the parse
capability of the source tree: messages come back as dataclasses for
application use (HRD timing, recovery points, user data); malformed
payloads raise StreamError like every other parser here.

An SEI NAL carries a sequence of messages, each with ff-byte-escaped
payload type and size (D.1); unrecognized types are preserved as raw
payload bytes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .bitreader import BitReader, StreamError


@dataclasses.dataclass
class BufferingPeriod:
    seq_parameter_set_id: int
    # (initial_cpb_removal_delay, initial_cpb_removal_delay_offset)
    # per CPB, for each HRD that is present in the SPS VUI
    nal_cpb: Tuple[Tuple[int, int], ...] = ()
    vcl_cpb: Tuple[Tuple[int, int], ...] = ()


@dataclasses.dataclass
class ClockTimestamp:
    ct_type: int
    nuit_field_based: bool
    counting_type: int
    full_timestamp: bool
    discontinuity: bool
    cnt_dropped: bool
    n_frames: int
    seconds: int = 0
    minutes: int = 0
    hours: int = 0
    time_offset: int = 0


@dataclasses.dataclass
class PicTiming:
    cpb_removal_delay: int = 0
    dpb_output_delay: int = 0
    pic_struct: Optional[int] = None
    timestamps: Tuple[ClockTimestamp, ...] = ()


@dataclasses.dataclass
class PanScanRect:
    rect_id: int
    cancel: bool
    # (left, right, top, bottom) offsets per rect
    rects: Tuple[Tuple[int, int, int, int], ...] = ()
    repetition_period: int = 0


@dataclasses.dataclass
class UserDataRegistered:
    country_code: int
    country_code_extension: int
    payload: bytes


@dataclasses.dataclass
class UserDataUnregistered:
    uuid: bytes
    payload: bytes


@dataclasses.dataclass
class RecoveryPoint:
    recovery_frame_cnt: int
    exact_match: bool
    broken_link: bool
    changing_slice_group_idc: int


@dataclasses.dataclass
class SceneInfo:
    info_present: bool
    scene_id: int = 0
    transition_type: int = 0
    second_scene_id: int = 0


@dataclasses.dataclass
class RawSei:
    """Unparsed / reserved payload kept verbatim."""
    payload_type: int
    payload: bytes


# D.1.1 payloadType values
BUFFERING_PERIOD = 0
PIC_TIMING = 1
PAN_SCAN_RECT = 2
FILLER_PAYLOAD = 3
USER_DATA_REGISTERED = 4
USER_DATA_UNREGISTERED = 5
RECOVERY_POINT = 6
DEC_REF_PIC_MARKING_REPETITION = 7
SCENE_INFO = 9

# pic_struct -> NumClockTS (Table D-1)
_NUM_CLOCK_TS = (1, 1, 1, 2, 2, 3, 3, 2, 3)


def _parse_buffering_period(r: BitReader, sps_store) -> BufferingPeriod:
    sps_id = r.ue()
    if sps_id > 31:
        raise StreamError("buffering_period: bad sps id")
    out = BufferingPeriod(seq_parameter_set_id=sps_id)
    sps = (sps_store or {}).get(sps_id)
    vui = getattr(sps, "vui", None) if sps is not None else None
    for attr, hrd in (("nal_cpb", getattr(vui, "nal_hrd", None)),
                      ("vcl_cpb", getattr(vui, "vcl_hrd", None))):
        if hrd is None:
            continue
        n = hrd.initial_cpb_removal_delay_length
        pairs = []
        for _ in range(hrd.cpb_cnt):
            pairs.append((r.u(n), r.u(n)))
        setattr(out, attr, tuple(pairs))
    return out


def _parse_clock_ts(r: BitReader, time_offset_length: int) \
        -> ClockTimestamp:
    ts = ClockTimestamp(
        ct_type=r.u(2), nuit_field_based=r.flag(), counting_type=r.u(5),
        full_timestamp=r.flag(), discontinuity=r.flag(),
        cnt_dropped=r.flag(), n_frames=r.u(8))
    if ts.full_timestamp:
        ts.seconds = r.u(6)
        ts.minutes = r.u(6)
        ts.hours = r.u(5)
    else:
        if r.flag():                    # seconds_flag
            ts.seconds = r.u(6)
            if r.flag():                # minutes_flag
                ts.minutes = r.u(6)
                if r.flag():            # hours_flag
                    ts.hours = r.u(5)
    if time_offset_length:
        # i(v): two's-complement signed
        v = r.u(time_offset_length)
        half = 1 << (time_offset_length - 1)
        ts.time_offset = v - (1 << time_offset_length) if v >= half else v
    return ts


def _parse_pic_timing(r: BitReader, sps_store) -> PicTiming:
    out = PicTiming()
    # needs the ACTIVE sps; like the reference (:282) we use the most
    # recently stored one with HRD/pic_struct info when available
    vui = None
    for sps in reversed(list((sps_store or {}).values())):
        if getattr(sps, "vui", None) is not None:
            vui = sps.vui
            break
    hrd = None
    if vui is not None:
        hrd = vui.nal_hrd or vui.vcl_hrd
    if hrd is not None:
        out.cpb_removal_delay = r.u(hrd.cpb_removal_delay_length)
        out.dpb_output_delay = r.u(hrd.dpb_output_delay_length)
    if vui is not None and vui.pic_struct_present:
        ps = r.u(4)
        if ps > 8:
            raise StreamError("pic_timing: bad pic_struct")
        out.pic_struct = ps
        tol = hrd.time_offset_length if hrd is not None else 24
        stamps = []
        for _ in range(_NUM_CLOCK_TS[ps]):
            if r.flag():                # clock_timestamp_flag
                stamps.append(_parse_clock_ts(r, tol))
        out.timestamps = tuple(stamps)
    return out


def _parse_pan_scan(r: BitReader) -> PanScanRect:
    out = PanScanRect(rect_id=r.ue(), cancel=False)
    out.cancel = r.flag()
    if not out.cancel:
        cnt = r.ue() + 1
        if cnt > 3:
            raise StreamError("pan_scan_rect: bad cnt")
        rects = []
        for _ in range(cnt):
            rects.append((r.se(), r.se(), r.se(), r.se()))
        out.rects = tuple(rects)
        out.repetition_period = r.ue()
    return out


def _parse_recovery_point(r: BitReader) -> RecoveryPoint:
    return RecoveryPoint(
        recovery_frame_cnt=r.ue(), exact_match=r.flag(),
        broken_link=r.flag(), changing_slice_group_idc=r.u(2))


def _parse_scene_info(r: BitReader) -> SceneInfo:
    out = SceneInfo(info_present=r.flag())
    if out.info_present:
        out.scene_id = r.ue()
        out.transition_type = r.ue()
        if out.transition_type > 3:
            out.second_scene_id = r.ue()
    return out


def parse_sei_rbsp(rbsp: bytes, sps_store=None) -> List[object]:
    """Parse one SEI NAL's RBSP into a list of message dataclasses
    (h264bsdDecodeSeiMessage loop, h264bsd_sei.c:178: repeated
    ff-escaped type/size, then rbsp trailing bits)."""
    out: List[object] = []
    pos = 0
    n = len(rbsp)
    while pos < n:
        if rbsp[pos] == 0x80 and pos == n - 1:
            break                        # rbsp_stop_one_bit
        ptype = 0
        while pos < n and rbsp[pos] == 0xFF:
            ptype += 255
            pos += 1
        if pos >= n:
            raise StreamError("SEI: truncated payload type")
        ptype += rbsp[pos]
        pos += 1
        psize = 0
        while pos < n and rbsp[pos] == 0xFF:
            psize += 255
            pos += 1
        if pos >= n:
            raise StreamError("SEI: truncated payload size")
        psize += rbsp[pos]
        pos += 1
        if pos + psize > n:
            raise StreamError("SEI: payload overruns NAL")
        payload = rbsp[pos:pos + psize]
        pos += psize
        r = BitReader(payload)
        try:
            if ptype == BUFFERING_PERIOD:
                out.append(_parse_buffering_period(r, sps_store))
            elif ptype == PIC_TIMING:
                out.append(_parse_pic_timing(r, sps_store))
            elif ptype == PAN_SCAN_RECT:
                out.append(_parse_pan_scan(r))
            elif ptype == FILLER_PAYLOAD:
                out.append(RawSei(ptype, payload))
            elif ptype == USER_DATA_REGISTERED:
                cc = payload[0] if payload else 0
                ext = 0
                off = 1
                if cc == 0xFF and len(payload) > 1:
                    ext = payload[1]
                    off = 2
                out.append(UserDataRegistered(cc, ext, payload[off:]))
            elif ptype == USER_DATA_UNREGISTERED:
                if psize < 16:
                    raise StreamError("SEI: short uuid")
                out.append(UserDataUnregistered(payload[:16],
                                                payload[16:]))
            elif ptype == RECOVERY_POINT:
                out.append(_parse_recovery_point(r))
            elif ptype == SCENE_INFO:
                out.append(_parse_scene_info(r))
            else:
                out.append(RawSei(ptype, payload))
        except StreamError:
            raise
        except Exception as e:           # defensive: malformed payload
            raise StreamError(f"SEI payload {ptype}: {e}") from e
    return out
