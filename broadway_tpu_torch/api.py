"""Public decoder API of the port — mirror of the reference's stable L3
contract (inc/H264SwDecApi.h: H264SwDecInit :124, H264SwDecDecode :338,
H264SwDecNextPicture :524, H264SwDecGetInfo :204, H264SwDecRelease :279;
return enum H264SwDecApi.h:53-67), in Pythonic form.

The Decode() buffer-consume loop mirrors H264SwDecApi.c:391-463: a call
consumes NAL units from the input buffer until a picture or headers event,
returning how many bytes were consumed so the caller re-feeds the rest.

Counterpart of ``broadway_tpu/api.py`` (the same classes, calls, return
values and trace lines), on the port's own ``core.decoder.Decoder``:
where that one takes ``backend="cpu"|"tpu"``, this one takes
``device="cuda"|"cpu"``, "cuda" by default, and raises when there is no
card.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from .bitstream import bitreader as br
from .bitstream.bitreader import NalUnit, StreamError
from .core.decoder import Decoder as _Core


class DecRet(enum.Enum):
    OK = 0
    STRM_PROCESSED = 1
    PIC_RDY = 2
    PIC_RDY_BUFF_NOT_EMPTY = 3
    HDRS_RDY = 4
    HDRS_RDY_BUFF_NOT_EMPTY = 5
    PARAM_ERR = -1
    STRM_ERR = -4
    EVALUATION_LIMIT_EXCEEDED = -8   # H264SwDecApi.c:74-76


@dataclasses.dataclass
class DecInput:
    stream: bytes
    pic_id: int = 0


@dataclasses.dataclass
class DecPicture:
    pic_id: int
    is_idr: bool
    nbr_of_err_mbs: int
    width: int
    height: int
    crop: Optional[tuple]
    frame: object                  # TorchFrame, resident on the device

    @property
    def output_picture(self) -> bytes:
        """The picture as raw YUV420 bytes. The frame stays on its
        device until this (or the frame's host planes) is first read."""
        return self.frame.tobytes()


@dataclasses.dataclass
class DecInfo:
    pic_width: int
    pic_height: int
    video_range: int
    matrix_coefficients: int
    profile: int
    cropping_flag: bool
    crop_params: Optional[tuple]
    sar_width: int = 0
    sar_height: int = 0


class H264Decoder:
    """Instance API: the H264SwDec equivalent, decoding on `device`."""

    API_VERSION = (2, 3)   # mirrors H264SwDecGetAPIVersion (v2.3)

    def __init__(self, no_output_reordering: bool = False,
                 device="cuda", evaluation_limit: int = 0,
                 trace=None, streaming: bool = False,
                 parallel_slices: int = None) -> None:
        """device: "cuda" (the hand-written kernels; raises without a
        card) or "cpu" (their plain versions).
        evaluation_limit: picture cap after which decode() returns
        EVALUATION_LIMIT_EXCEEDED (the reference's H264DEC_EVALUATION
        build, 500 frames, H264SwDecApi.c:74-76); 0 = unlimited.
        trace: optional callable(str) receiving API-call trace lines
        (the reference's H264SwDecTrace hook, H264SwDecApi.c:67-72).
        streaming: decode() buffers may end mid-NAL (e.g. network
        chunks); the trailing unterminated NAL — whose end is
        unknowable until the next start code — is carried internally
        across calls and decoded when completed (or at flush). The
        reference treats end-of-buffer as end-of-NAL
        (h264bsd_byte_stream.c:162-166), so its callers must feed whole
        NALs; this mode lifts that restriction."""
        if parallel_slices is None:
            # on the card: overlap host slice parsing with device work
            parallel_slices = 8 if torch.device(device).type == "cuda" \
                else 0
        self._core = _Core(device=device,
                           no_reordering=no_output_reordering,
                           parallel_slices=parallel_slices)
        self._pending = []     # drained display-order outputs
        self._pic_id = 0
        self._eval_limit = evaluation_limit
        self._pic_count = 0
        self._trace = trace
        self._streaming = streaming
        self._carry = b""

    def _trc(self, msg: str) -> None:
        if self._trace is not None:
            self._trace(msg)

    # ------------------------------------------------------------------
    def decode(self, data: bytes, pic_id: int = 0,
               nal_unit_stream: bool = False,
               intra_conceal_from_ref: bool = False):
        """Consume NALs from `data`; returns (DecRet, bytes_consumed).

        Stops at picture / headers boundaries like the reference so the
        caller can interleave next_picture() calls.

        intra_conceal_from_ref mirrors the reference's per-Decode-call
        intraConcealmentMethod (H264SwDecApi.h:82-83): conceal errors in
        intra pictures from the previous reference picture instead of
        gray DC interpolation.
        """
        self._trc(f"H264SwDecDecode# dataLen {len(data)} picId {pic_id}")
        if not data:
            return DecRet.PARAM_ERR, 0
        if self._eval_limit and self._pic_count >= self._eval_limit:
            return DecRet.EVALUATION_LIMIT_EXCEEDED, 0
        self._core.intra_conceal_from_ref = intra_conceal_from_ref
        self._pic_id = pic_id
        if self._streaming and not nal_unit_stream:
            consumed_in = len(data)
            data = self._carry + data
            self._carry = b""
            # hold back the trailing NAL: its end is unknowable until
            # the next start code arrives in a later call
            cut = data.rfind(b"\x00\x00\x01")
            if cut >= 0:
                while cut > 0 and data[cut - 1] == 0:
                    cut -= 1
            if cut <= 0:
                self._carry = data
                return DecRet.STRM_PROCESSED, consumed_in
            tail = data[cut:]
            ret, used = self._decode_nals(data[:cut])
            # anything not yet processed stays buffered internally
            self._carry = data[used:cut] + tail
            return ret, consumed_in
        return self._decode_nals(data, nal_unit_stream)

    def _decode_nals(self, data: bytes, nal_unit_stream: bool = False):
        if not data:
            return DecRet.STRM_PROCESSED, 0
        if nal_unit_stream:
            nals = [(0, data)]
            end = len(data)
        else:
            nals = list(br.split_nal_units(data))
            end = len(data)
        if not nals:
            return DecRet.STRM_PROCESSED, len(data)

        had_headers = self._core.headers_ready
        for i, (off, payload) in enumerate(nals):
            if i + 1 < len(nals):
                nxt = nals[i + 1][0] - 3
                while nxt > 0 and data[nxt - 1] == 0:
                    nxt -= 1
                consumed_to = nxt
            else:
                consumed_to = end
            try:
                nal = NalUnit(payload)
            except StreamError:
                continue
            n_out_before = len(self._core.outputs)
            n_pic_before = self._core.pic_number
            try:
                self._core.decode_nal(nal)
            except StreamError:
                # reference maps stream errors to H264SWDEC_STRM_ERROR and
                # continues on next call
                return DecRet.STRM_ERR, max(consumed_to, 0)
            if (self._core.pic_number > n_pic_before
                    or len(self._core.outputs) > n_out_before):
                self._pic_count += self._core.pic_number - n_pic_before
                self._trc(f"H264SwDecDecode# PIC_RDY pic {self._pic_count}")
                self._drain()
                more = consumed_to < end
                return (DecRet.PIC_RDY_BUFF_NOT_EMPTY if more
                        else DecRet.PIC_RDY), consumed_to
            if not had_headers and self._core.headers_ready:
                if consumed_to < end:
                    return DecRet.HDRS_RDY_BUFF_NOT_EMPTY, consumed_to
                return DecRet.HDRS_RDY, consumed_to
        self._drain()
        return DecRet.STRM_PROCESSED, end

    def _drain(self) -> None:
        out, self._core.outputs = self._core.outputs, []
        for o in out:
            self._pending.append(o)

    # ------------------------------------------------------------------
    def next_picture(self, flush: bool = False) -> Optional[DecPicture]:
        """Display-order output; flush=True drains buffered pictures at
        end of stream (H264SwDecNextPicture semantics)."""
        self._trc(f"H264SwDecNextPicture# flush {int(flush)}")
        if flush and self._carry:
            # end of stream: the carried tail NAL is now complete
            tail, self._carry = self._carry, b""
            while tail:
                _, used = self._decode_nals(tail)
                self._drain()
                if used <= 0:
                    break
                tail = tail[used:]
        if flush and not self._pending:
            self._core.flush()
            self._drain()
        if not self._pending:
            return None
        o = self._pending.pop(0)
        return DecPicture(
            pic_id=o.pic_id, is_idr=o.is_idr, nbr_of_err_mbs=o.num_err_mbs,
            width=o.width, height=o.height, crop=o.crop, frame=o.frame)

    # ------------------------------------------------------------------
    def get_info(self) -> Optional[DecInfo]:
        sps = self._core.sps
        if sps is None:
            # mirror reference: GetInfo before headers -> error/None
            for s in self._core.sps_store.values():
                sps = s
                break
        if sps is None:
            return None
        vui = sps.vui
        return DecInfo(
            pic_width=sps.width, pic_height=sps.height,
            video_range=int(vui.video_full_range) if vui else 0,
            matrix_coefficients=vui.matrix_coefficients if vui else 2,
            profile=sps.profile_idc,
            cropping_flag=sps.crop is not None,
            crop_params=sps.crop,
            sar_width=vui.sar_width if vui else 0,
            sar_height=vui.sar_height if vui else 0)

    def release(self) -> None:
        if self._core is not None:
            self._core.close()
        self._core = None
        self._pending = []
