"""The plain reference decoder: a straightforward H.264 Baseline decode
of an Annex-B stream in Python and NumPy, picture by picture.

The modules beside this one are frozen copies of the port's readable
front end (bitreader, cavlc, cavlc_tables, frontend, mb_layer, params,
slice_group_map, slice_header), its NumPy reconstruction (recon_cpu,
inter, intra, transform), its in-loop deblocking (deblock_impl) and its
frame state (dpb, poc), with their imports made local to this folder.
Nothing here imports the port, the JAX package or JAX, and nothing takes
a table, a weight or a frame from them: the reference reads the stream
bytes and nothing else.

It is strict: the benchmark's streams are error free, so a slice that
fails to parse raises instead of being concealed. A picture starts at a
slice whose first macroblock is 0 (the streams carry no arbitrary slice
order and no redundant slices).
"""

from __future__ import annotations

import hashlib
from typing import Iterator, List

from . import bitreader as br
from .bitreader import BitReader, NalUnit
from .deblock_impl import filter_picture_impl
from .dpb import Dpb
from .frontend import decode_slice_data
from .mb_layer import MB_P, MbParser, PictureData
from .params import parse_pps, parse_sps
from .poc import PocState, decode_poc
from .recon_cpu import Frame, reconstruct_picture
from .slice_group_map import build_slice_group_map
from .slice_header import P_SLICE, parse_slice_header


def md5(frame: Frame) -> str:
    """md5 of a picture's bytes: Y, then Cb, then Cr, row by row."""
    return hashlib.md5(frame.tobytes()).hexdigest()


class _Picture:
    def __init__(self, header, sps, pps) -> None:
        self.header, self.sps, self.pps = header, sps, pps
        self.data = PictureData(sps.width_mbs, sps.height_mbs)
        self.parser = MbParser(self.data, pps.constrained_intra_pred)
        self.slices = 0


class ReferenceDecoder:
    """One stream's state: parameter sets, the DPB and the POC. With
    `reconstruct` False it only parses (``mb_classes``), and its frames
    are None."""

    def __init__(self, reconstruct: bool = True) -> None:
        self.reconstruct = reconstruct
        self.sps_store, self.pps_store = {}, {}
        self.sps = None
        self.dpb = None
        self.poc = PocState()
        self.pic = None
        self.pic_number = 0
        self.mb_classes = []     # per picture decoded: intra, inter, skip

    def nal(self, nal: NalUnit) -> List[Frame]:
        """Decode one NAL unit; returns the frames it puts out, in order."""
        t = nal.nal_type
        if t == br.NAL_SPS:
            s = parse_sps(BitReader(nal.rbsp))
            self.sps_store[s.sps_id] = s
            return []
        if t == br.NAL_PPS:
            p = parse_pps(BitReader(nal.rbsp))
            self.pps_store[p.pps_id] = p
            return []
        if t not in (br.NAL_SLICE, br.NAL_SLICE_IDR):
            return []
        r = BitReader(nal.rbsp)
        pos = r.pos
        first_mb = r.ue()
        r.ue()
        pps = self.pps_store[r.ue()]
        r.pos = pos
        sps = self.sps_store[pps.sps_id]
        out = []
        if first_mb == 0:
            out = self._finish()
            if sps is not self.sps:
                if self.dpb is not None:
                    self.dpb.flush()
                    out += self._drain()
                self.dpb = Dpb(sps.dpb_size(), max(sps.num_ref_frames, 1),
                               sps.max_frame_num, False)
                self.poc = PocState()
                self.sps = sps
        header = parse_slice_header(r, t, nal.ref_idc, sps, pps)
        if first_mb == 0:
            if not header.idr:
                self.dpb.check_gaps_in_frame_num(
                    header.frame_num, sps.gaps_in_frame_num_allowed)
            self.dpb.allocate_picture()
            self.pic = _Picture(header, sps, pps)
        pic = self.pic
        ref_slots = []
        if header.slice_type == P_SLICE:
            self.dpb.init_ref_pic_list()
            self.dpb.reorder_ref_pic_list(header.ref_list_mods,
                                          header.frame_num,
                                          header.num_ref_idx_l0)
            ref_slots = [self.dpb.list[i].slot
                         for i in range(header.num_ref_idx_l0)]
        sg_map = build_slice_group_map(sps, pps,
                                       header.slice_group_change_cycle)
        decode_slice_data(r, pic.data, pic.parser, header, sps, pps, sg_map,
                          pic.slices, ref_slots)
        pic.slices += 1
        if int(pic.data.decoded.sum()) == pic.data.n_mbs:
            out += self._finish()
        return out

    def _finish(self) -> List[Frame]:
        """Reconstruct, deblock and store the picture under way."""
        pic, self.pic = self.pic, None
        if pic is None:
            return []
        h, sps, pps = pic.header, pic.sps, pic.pps
        if int(pic.data.decoded.sum()) != pic.data.n_mbs:
            raise ValueError(f"picture {self.pic_number} is incomplete")
        inter = pic.data.mb_class == MB_P
        self.mb_classes.append({
            "intra": int((~inter).sum()),
            "inter": int((inter & ~pic.data.skip).sum()),
            "skip": int((inter & pic.data.skip).sum())})
        frame = None
        if self.reconstruct:
            refs = {p.slot: p.frame for p in self.dpb.buffer
                    if p.frame is not None}
            frame = reconstruct_picture(
                pic.data, pps.chroma_qp_index_offset,
                pps.constrained_intra_pred, refs, sps.width, sps.height)
            if not all(sp.disable_deblocking_idc == 1
                       for sp in pic.data.slice_params):
                filter_picture_impl(frame, pic.data,
                                    pps.chroma_qp_index_offset)
        mmco5 = any(m.op == 5 for m in h.mmco)
        poc = decode_poc(sps, h, self.poc, h.nal_ref_idc, mmco5)
        if mmco5:
            poc = 0
        cur = self.dpb.current
        cur.frame, cur.width, cur.height, cur.crop = \
            frame, sps.width, sps.height, sps.crop
        self.dpb.mark_decoded_ref_pic(
            is_ref=h.nal_ref_idc != 0, mmco=h.mmco,
            adaptive=h.adaptive_ref_pic_marking, frame_num=h.frame_num,
            poc=poc, is_idr=h.idr,
            no_output_of_prior=h.no_output_of_prior_pics,
            long_term_ref=h.long_term_reference, pic_id=self.pic_number,
            num_err_mbs=0)
        self.pic_number += 1
        if h.nal_ref_idc:
            self.dpb.prev_ref_frame_num = h.frame_num
        return self._drain()

    def _drain(self) -> List[Frame]:
        return [p.frame for p in self.dpb.drain_outputs()]

    def feed(self, data: bytes) -> List[Frame]:
        """Every NAL unit of `data`, then a flush."""
        out = []
        for nal in nal_units(data):
            out += self.nal(nal)
        return out + self.flush()

    def flush(self) -> List[Frame]:
        out = self._finish()
        if self.dpb is not None:
            self.dpb.flush()
            out += self._drain()
        return out


def nal_units(data: bytes) -> Iterator[NalUnit]:
    for _, payload in br.split_nal_units(data):
        yield NalUnit(payload)


def decode_annexb(data: bytes, max_pictures: int = None) -> List[Frame]:
    """Every picture of an Annex-B stream in output order; with
    `max_pictures`, the stream's first pictures in decoding order only
    (the rest are not decoded: each of those is put out once the DPB is
    flushed)."""
    dec = ReferenceDecoder()
    out = []
    for nal in nal_units(data):
        if max_pictures is not None and dec.pic_number >= max_pictures \
                and nal.nal_type in (br.NAL_SLICE, br.NAL_SLICE_IDR):
            break
        out += dec.nal(nal)
    return out + dec.flush()
