"""Per-picture front-end: drives slice-data parsing over all slices of an
access unit, producing a complete PictureData tensor bundle.

Reference: h264bsd_slice_data.c:85 h264bsdDecodeSliceData (MB loop
:130-223, skip-run handling :148, SetMbParams :257).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .bitreader import BitReader, StreamError
from .mb_layer import (MB_P, MbParser, PictureData, SliceParams,
                       parse_macroblock, parse_p_skip)
from .params import Pps, Sps
from .slice_group_map import next_mb_address
from .slice_header import P_SLICE, SliceHeader


class SliceDataError(StreamError):
    """Raised mid-slice; carries the last successfully decoded MB address
    (I slices; mirrors pStorage->slice->lastMbAddr) for corruption
    marking + concealment."""

    def __init__(self, msg: str, last_mb_addr: int = 0) -> None:
        super().__init__(msg)
        self.last_mb_addr = last_mb_addr


def decode_slice_data(r: BitReader, pic: PictureData, parser: MbParser,
                      header: SliceHeader, sps: Sps, pps: Pps,
                      sg_map: np.ndarray, slice_id: int,
                      ref_slots: List[int]) -> int:
    """Parse the slice_data() of one slice into `pic`. Returns the number
    of MBs decoded by this slice."""
    pic.slice_params.append(SliceParams(
        slice_type=header.slice_type,
        disable_deblocking_idc=header.disable_deblocking_idc,
        alpha_c0_offset=header.alpha_c0_offset,
        beta_offset=header.beta_offset,
        ref_slots=list(ref_slots)))
    assert len(pic.slice_params) == slice_id + 1

    addr = header.first_mb
    qp = header.slice_qp
    is_p = header.slice_type == P_SLICE
    num_ref = header.num_ref_idx_l0
    n_decoded = 0
    skip_run = 0
    prev_skipped = False
    last_mb_addr = 0

    ref_slot0 = ref_slots[0] if ref_slots else -1

    # loop structure mirrors h264bsdDecodeSliceData :130-223 exactly:
    # skip_run is read once at the start of a run; the MB following a run
    # is parsed without a new skip_run; data left with no next address in
    # the slice group is an error.
    try:
        while True:
            if addr < 0:
                raise StreamError("slice overruns picture")
            if pic.decoded[addr]:
                raise StreamError("MB decoded twice")
            if is_p and not prev_skipped:
                skip_run = r.ue()
                if skip_run > pic.n_mbs - addr:
                    raise StreamError("invalid mb_skip_run")
                if skip_run:
                    prev_skipped = True
            pic.slice_id[addr] = slice_id
            if skip_run:
                parse_p_skip(parser, addr, ref_slot0)
                pic.qp[addr] = qp
                skip_run -= 1
            else:
                prev_skipped = False
                qp = parse_macroblock(r, parser, addr, header.slice_type,
                                      qp, num_ref, ref_slots,
                                      pps.chroma_qp_index_offset)
            n_decoded += 1
            if not is_p:
                last_mb_addr = addr
            more = r.more_rbsp_data() or skip_run > 0
            addr = next_mb_address(sg_map, addr)
            if more and addr < 0:
                raise StreamError("next mb address")
            if not more:
                break
    except StreamError as e:
        raise SliceDataError(str(e), last_mb_addr) from e
    return n_decoded
