"""Decode engine top control: NAL dispatch, parameter-set storage and
activation, access-unit boundary detection, picture lifecycle, DPB/POC,
and picture reconstruction on a torch device.

Reference: h264bsd_decoder.c:162 h264bsdDecode, h264bsd_storage.c
(h264bsdStoreSeqParamSet :128, StorePicParamSet :211, ActivateParamSets
:298, CheckAccessUnitBoundary :632).

This is the port's own host engine, the counterpart of
``broadway_tpu/core/decoder.py`` (same stages, same method names), and it
imports nothing of that package:
  Stage A  bitstream front end  -> dense per-MB tensors (bitstream/,
           native parser in csrc/frontend.cpp)
  Stage B  pixel backend        -> whole-picture reconstruction: the v2
           packed buffer goes to `device` and core/recon.py rebuilds the
           picture there ("cuda": the hand-written kernels, "cpu": their
           plain versions); recon="numpy" runs core/recon_cpu.py on the
           host instead, the reference inside the port
  Stage C  frame state          -> DPB / POC / output ordering (core/)
The JAX package's async upload pump, frame groups and compile cache have
no counterpart here.
"""

from __future__ import annotations

import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..bitstream import bitreader as br
from ..bitstream import native as nat
from ..bitstream.bitreader import BitReader, NalUnit, StreamError
from ..bitstream.frontend import SliceDataError, decode_slice_data
from ..bitstream.mb_layer import MbParser, PictureData
from ..bitstream.params import Hrd, Pps, Sps, Vui, parse_pps, parse_sps
from ..bitstream.sei import parse_sei_rbsp
from ..bitstream.slice_group_map import build_slice_group_map
from ..bitstream.slice_header import (I_SLICE, P_SLICE, SliceHeader,
                                      parse_slice_header)
from . import deblock as deblock_mod
from . import packed as PK
from .conceal import conceal_picture, mark_slice_corrupted
from .dpb import Dpb, DpbPicture
from .poc import PocState, decode_poc
from .recon import TorchFrame, decode_picture_packed2, update_stack_slot
from .recon_cpu import Frame, reconstruct_picture


@dataclasses.dataclass
class OutputPicture:
    frame: Frame
    is_idr: bool
    pic_id: int
    num_err_mbs: int
    width: int
    height: int
    crop: Optional[tuple]


# recon_strategy return sentinel: picture consumed, no frame produced
# (collectors/analysis). Returning None instead DECLINES the picture ->
# the built-in backend reconstructs it.
SKIP_RECON = object()


class _AubState:
    """Previous-NAL syntax values for AU boundary detection."""

    def __init__(self) -> None:
        self.first_call = True
        self.prev_frame_num = -1
        self.prev_idr_pic_id = -1
        self.prev_poc_lsb = -1
        self.prev_delta_poc_bottom = 0
        self.prev_delta_poc = [0, 0]
        self.prev_nal_ref_idc = -1
        self.prev_nal_type = -1


# dataclass fields that hold another dataclass (for _adopt)
_NESTED = {(Sps, "vui"): Vui, (Vui, "nal_hrd"): Hrd, (Vui, "vcl_hrd"): Hrd}


def _adopt(cls, obj):
    """`obj` as an instance of this package's `cls`: itself if it is one,
    else a new one filled field by field from a look-alike (the same
    class of another package, or a plain dict). This is how a snapshot
    taken by the JAX package's decoder is loaded without keeping any of
    its objects."""
    if obj is None or type(obj) is cls:
        return obj
    get = obj.__getitem__ if isinstance(obj, dict) else \
        (lambda k: getattr(obj, k))
    if not dataclasses.is_dataclass(cls):
        new = cls()
        for k in vars(new):
            setattr(new, k, copy.deepcopy(get(k)))
        return new
    kw = {}
    for f in dataclasses.fields(cls):
        sub = _NESTED.get((cls, f.name))
        v = get(f.name)
        kw[f.name] = _adopt(sub, v) if sub else copy.deepcopy(v)
    return cls(**kw)


class Decoder:
    """Single-stream H.264 Baseline decode engine reconstructing on
    `device` ("cuda" runs the hand-written kernels, "cpu" their plain
    versions)."""

    def __init__(self, device="cuda", parallel_slices: int = 0,
                 no_reordering: bool = False, frontend: str = "native",
                 recon: str = "torch", recon_strategy=None) -> None:
        # frontend: "native" (the C++ parser of csrc/frontend.cpp; built
        # at first use, and a failed build raises) or "python" (the
        # readable parser of bitstream/, only on request).
        # parallel_slices: >1 = parse a picture's slices concurrently on
        # a thread pool (the native parser releases the GIL). Slice
        # parsing is deferred to the picture boundary, like the
        # reference's AU-boundary end-of-pic test.
        # recon: "torch" reconstructs on `device` (core/recon.py);
        # "numpy" on the host with core/recon_cpu.py, whatever `device`
        # says: the reference that the torch path is held against.
        # recon_strategy: optional callable(decoder, pic) -> frame that
        # replaces the pixel backend for error-free pictures (tools that
        # only need the parsed tensors return SKIP_RECON). DPB/POC/output
        # bookkeeping is unchanged; only the reconstruction is delegated.
        if frontend not in ("native", "python"):
            raise ValueError(f"unknown frontend {frontend!r}")
        if recon not in ("torch", "numpy"):
            raise ValueError(f"unknown recon {recon!r}")
        device = torch.device(device)
        if recon == "torch":
            if device.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {device}")
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("Decoder(device='cuda'): CUDA is not "
                                   "available")
        self.device = device
        self.recon = recon
        self.frontend = frontend
        if self.frontend == "native":
            nat.load()          # a missing compiler shows here, loudly
        self.parallel_slices = parallel_slices
        self.recon_strategy = recon_strategy
        self._deferred = []
        self._executor = None
        if parallel_slices > 1 and self.frontend == "native":
            self._executor = ThreadPoolExecutor(parallel_slices)
        self._dstack_key = None
        self._stack_y = self._stack_c = None
        self._pack2_scratch = None
        self.sps_store: Dict[int, Sps] = {}
        self.pps_store: Dict[int, Pps] = {}
        self.active_sps_id: Optional[int] = None
        self.active_pps_id: Optional[int] = None
        self.sps: Optional[Sps] = None
        self.pps: Optional[Pps] = None
        self.no_reordering = no_reordering
        self.dpb: Optional[Dpb] = None
        self.poc_state = PocState()
        self.aub = _AubState()
        self.outputs: List[OutputPicture] = []
        # parsed SEI messages in stream order (bitstream/sei.py)
        self.sei_messages: List[object] = []
        # current picture state
        self.pic: Optional[PictureData] = None
        self.parser: Optional[MbParser] = None
        self.pic_header: Optional[SliceHeader] = None
        self.n_decoded_mbs = 0
        self.slice_count = 0
        self.pic_number = 0
        self.headers_ready = False
        # per-Decode-call concealment policy (H264SwDecApi.h:82-83
        # intraConcealmentMethod): conceal intra pictures from the
        # previous reference instead of gray
        self.intra_conceal_from_ref = False
        # picture of the current AU finished -> later redundant slices
        # are unnecessary (h264bsd_decoder.c:275/475 skipRedundantSlices)
        self.skip_redundant = False

    # ------------------------------------------------------------------
    def decode_annexb(self, data: bytes, flush: bool = True
                      ) -> List[OutputPicture]:
        """Decode a whole Annex-B stream; returns display-order outputs."""
        for _, payload in br.split_nal_units(data):
            try:
                nal = NalUnit(payload)
            except StreamError:
                continue
            self.decode_nal(nal)
        if flush:
            self.flush()
        out, self.outputs = self.outputs, []
        return out

    def flush(self) -> None:
        if self.pic is not None and self._deferred:
            self._run_deferred()
            if self.n_decoded_mbs >= self.pic.n_mbs:
                self._finish_picture(concealed=False)
        if self.pic is not None:
            # INCOMPLETE picture pending at end of stream: the reference
            # drops it — concealment triggers only when the NEXT access
            # unit arrives (h264bsd_decoder.c:236-276), and at EOS
            # DecTestBench just drains the DPB (DecTestBench.c:424), so
            # an errored final picture never reaches the output.
            self.pic, self.pic_header = None, None
            if self.dpb is not None:
                self.dpb.current = None
        if self.dpb is not None:
            self.dpb.flush()
            self._drain()

    def _submit_slice(self, args) -> None:
        """Start parsing one slice on the pool NOW (the native call
        releases the GIL; slices write disjoint MB ranges). Parses run
        while the host keeps scanning NALs / packing earlier pictures —
        the host-side frame pipeline (reference analogue: worker decode
        off the feed thread, Player.js:140-185)."""
        pic, parser, sps, pps = self.pic, self.parser, self.sps, self.pps

        def one():
            rbsp, pos, header, sg_map, slice_id, ref_slots = args
            try:
                nat.decode_slice_data_native(
                    rbsp, pos, pic, parser, header, sps,
                    pps, sg_map, slice_id, ref_slots,
                    append_params=False)
                return None
            except SliceDataError as e:
                return (header, sg_map, slice_id, e)

        self._deferred.append(self._executor.submit(one))

    def _run_deferred(self) -> None:
        """Collect this picture's in-flight slice parses."""
        work, self._deferred = self._deferred, []
        for fut in work:
            res = fut.result()
            if res is not None:
                header, sg_map, slice_id, e = res
                mark_slice_corrupted(self.pic, header.first_mb, sg_map,
                                     slice_id, e.last_mb_addr,
                                     self.sps.width_mbs)
        self.n_decoded_mbs = int(self.pic.decoded.sum())

    # ------------------------------------------------------------------
    def decode_nal(self, nal: NalUnit) -> None:
        t = nal.nal_type
        if t == br.NAL_SPS:
            s = parse_sps(BitReader(nal.rbsp))
            # re-storing a bit-identical SPS keeps the existing object
            # (repeated in-band headers must not look like a sequence
            # change); a CHANGED SPS under the same id replaces it and
            # forces re-activation at the next IDR
            # (h264bsdCompareSeqParamSets, h264bsd_storage.c:128)
            old = self.sps_store.get(s.sps_id)
            if old is None or old != s:
                self.sps_store[s.sps_id] = s
            return
        if t == br.NAL_PPS:
            p = parse_pps(BitReader(nal.rbsp))
            self.pps_store[p.pps_id] = p
            return
        if t in (br.NAL_SLICE, br.NAL_SLICE_IDR):
            self._decode_slice_nal(nal)
            return
        if t == br.NAL_SEI:
            # decode is unaffected by SEI (the reference build skips
            # them outright, h264bsd_decoder.c:480); we additionally
            # parse the messages for application use (recovery points,
            # HRD timing, user data — bitstream/sei.py), tolerating
            # malformed payloads the way the reference tolerates the
            # whole NAL
            try:
                self.sei_messages.extend(
                    parse_sei_rbsp(nal.rbsp, self.sps_store))
            except StreamError:
                pass
            return
        if t in (br.NAL_AUD, br.NAL_END_OF_SEQ,
                 br.NAL_END_OF_STREAM, br.NAL_FILLER):
            return  # skipped, like the reference (h264bsd_decoder.c:480)
        # unknown NAL types are skipped

    # ------------------------------------------------------------------
    def _check_au_boundary(self, nal: NalUnit, r: BitReader) -> bool:
        """Peek-parse slice header ids; returns True if this slice starts
        a new access unit (mirrors h264bsdCheckAccessUnitBoundary)."""
        a = self.aub
        new_au = False
        if a.first_call:
            new_au = True
            a.first_call = False
        pos = r.pos
        r.ue()  # first_mb
        r.ue()  # slice_type
        pps_id = r.ue()
        pps = self.pps_store.get(pps_id)
        if pps is None:
            raise StreamError("slice refers to missing PPS")
        sps = self.sps_store.get(pps.sps_id)
        if sps is None:
            raise StreamError("slice refers to missing SPS")
        if (a.prev_nal_ref_idc != nal.ref_idc and
                (a.prev_nal_ref_idc == 0 or nal.ref_idc == 0)):
            new_au = True
        idr = nal.nal_type == br.NAL_SLICE_IDR
        prev_idr = a.prev_nal_type == br.NAL_SLICE_IDR
        if idr != prev_idr:
            new_au = True
        frame_num = r.u((sps.max_frame_num - 1).bit_length())
        if a.prev_frame_num != frame_num:
            a.prev_frame_num = frame_num
            new_au = True
        if idr:
            idr_pic_id = r.ue()
            if prev_idr and a.prev_idr_pic_id != idr_pic_id:
                new_au = True
            a.prev_idr_pic_id = idr_pic_id
        if sps.poc_type == 0:
            lsb = r.u((sps.max_pic_order_cnt_lsb - 1).bit_length())
            if a.prev_poc_lsb != lsb:
                a.prev_poc_lsb = lsb
                new_au = True
            if pps.pic_order_present:
                d = r.se()
                if a.prev_delta_poc_bottom != d:
                    a.prev_delta_poc_bottom = d
                    new_au = True
        elif sps.poc_type == 1 and not sps.delta_pic_order_always_zero:
            d0 = r.se()
            if a.prev_delta_poc[0] != d0:
                a.prev_delta_poc[0] = d0
                new_au = True
            if pps.pic_order_present:
                d1 = r.se()
                if a.prev_delta_poc[1] != d1:
                    a.prev_delta_poc[1] = d1
                    new_au = True
        a.prev_nal_ref_idc = nal.ref_idc
        a.prev_nal_type = nal.nal_type
        r.pos = pos
        return new_au

    # ------------------------------------------------------------------
    def _activate(self, pps_id: int, is_idr: bool) -> None:
        pps = self.pps_store.get(pps_id)
        if pps is None:
            raise StreamError("activation of missing PPS")
        sps = self.sps_store.get(pps.sps_id)
        if sps is None:
            raise StreamError("activation of missing SPS")
        if self.active_sps_id != sps.sps_id or self.sps is not sps:
            # id switch OR content redefinition under the same id
            if self.sps is not None and not is_idr:
                raise StreamError("SPS change on non-IDR picture")
            # emit the previous sequence's buffered pictures before the
            # DPB is re-allocated (the reference outputs prior pics at
            # the IDR boundary: h264bsd_decoder.c:369-399 prior-pics
            # flush; SoftAVC drains output before reconfiguring ports)
            if getattr(self, "dpb", None) is not None:
                self.dpb.flush()
                self._drain()
            # (re)allocate DPB for the new sequence
            self.dpb = Dpb(sps.dpb_size(), max(sps.num_ref_frames, 1),
                           sps.max_frame_num, self.no_reordering)
            self.poc_state = PocState()
            self.active_sps_id = sps.sps_id
            self.headers_ready = True
        self.active_pps_id = pps_id
        self.sps = sps
        self.pps = pps

    # ------------------------------------------------------------------
    def _decode_slice_nal(self, nal: NalUnit) -> None:
        nal_rbsp = nal.rbsp
        r = BitReader(nal.rbsp)
        new_au = self._check_au_boundary(nal, r)
        if new_au:
            self.skip_redundant = False
            if self.pic is not None:
                if self._deferred:
                    self._run_deferred()
                self._finish_picture(concealed=True)

        # activation happens on the first slice of the picture
        pos = r.pos
        r.ue()
        r.ue()
        pps_id = r.ue()
        r.pos = pos
        if self.pic is None:
            self._activate(pps_id, nal.nal_type == br.NAL_SLICE_IDR)
        elif pps_id != self.active_pps_id:
            self._activate(pps_id, nal.nal_type == br.NAL_SLICE_IDR)

        header = parse_slice_header(r, nal.nal_type, nal.ref_idc,
                                    self.sps, self.pps)

        if header.redundant_pic_cnt and (self.pic is not None
                                         or self.skip_redundant):
            # primary picture present (or already finished) in this AU
            # -> redundant slice is not needed (h264bsd_decoder.c:319
            # skipRedundantSlices / slice_data decoded-flag dedup). Only
            # when the primary was lost entirely does the redundant
            # slice decode below as the fallback picture.
            return

        if self.pic is None:
            self._start_picture(header)

        # reference picture list for this slice
        ref_slots: List[int] = []
        if header.slice_type == P_SLICE:
            self.dpb.init_ref_pic_list()
            self.dpb.reorder_ref_pic_list(header.ref_list_mods,
                                          header.frame_num,
                                          header.num_ref_idx_l0)
            for i in range(header.num_ref_idx_l0):
                p = self.dpb.list[i]
                if p is None:
                    raise StreamError("ref list shorter than active refs")
                # non-existing (frame-gap) refs: any MB using them errors
                # like the reference's NULL refAddr (concealment path)
                ref_slots.append(-2 if p.non_existing else p.slot)

        sg_map = build_slice_group_map(self.sps, self.pps,
                                       header.slice_group_change_cycle)
        slice_id = self.slice_count
        self.slice_count += 1
        self.last_header = header
        try:
            if self.frontend == "native" and self._executor is not None:
                nat.append_slice_params(self.pic, header, slice_id,
                                        ref_slots)
                self._submit_slice((nal_rbsp, r.pos, header, sg_map,
                                    slice_id, ref_slots))
                return        # collected at the picture boundary
            elif self.frontend == "native":
                nat.decode_slice_data_native(nal_rbsp, r.pos, self.pic,
                                             self.parser, header, self.sps,
                                             self.pps, sg_map, slice_id,
                                             ref_slots)
            else:
                decode_slice_data(r, self.pic, self.parser, header,
                                  self.sps, self.pps, sg_map, slice_id,
                                  ref_slots)
        except SliceDataError as e:
            # corrupt slice: un-decode its MBs; concealment happens when
            # the picture boundary is detected (h264bsd_decoder.c:236-276)
            mark_slice_corrupted(self.pic, header.first_mb, sg_map,
                                 slice_id, e.last_mb_addr,
                                 self.sps.width_mbs)
            self.pic_has_errors = True
        self.n_decoded_mbs = int(self.pic.decoded.sum())

        if self.n_decoded_mbs >= self.pic.n_mbs:
            self._finish_picture(concealed=False)

    # ------------------------------------------------------------------
    def _start_picture(self, header: SliceHeader) -> None:
        sps = self.sps
        self.pic = PictureData(sps.width_mbs, sps.height_mbs)
        self.parser = MbParser(self.pic, self.pps.constrained_intra_pred)
        self.pic_header = header
        self.n_decoded_mbs = 0
        self.slice_count = 0
        if not header.idr:
            self.dpb.check_gaps_in_frame_num(
                header.frame_num, sps.gaps_in_frame_num_allowed)
        self.dpb.allocate_picture()

    def _finish_picture(self, concealed: bool) -> None:
        pic, header = self.pic, self.pic_header
        sps, pps = self.sps, self.pps
        self.pic, self.pic_header = None, None
        self.skip_redundant = True

        num_err = pic.n_mbs - int(pic.decoded.sum())
        frame = None
        skipped = False
        if num_err:
            frame = self._reconstruct_concealed(pic, num_err)
            num_err = int(pic.concealed.sum())
        elif self.recon_strategy is not None:
            # SKIP_RECON = picture consumed, no frame produced
            frame = self.recon_strategy(self, pic)
            if frame is SKIP_RECON:
                frame, skipped = None, True
        if frame is not None or skipped:
            pass
        elif self.recon == "torch":
            frame = self._reconstruct_torch(pic)
        else:
            frame = self._reconstruct_numpy(pic)

        cur_mmco5 = any(m.op == 5 for m in header.mmco)
        poc = decode_poc(sps, header, self.poc_state, header.nal_ref_idc,
                         cur_mmco5)
        if cur_mmco5:
            poc = 0

        self.dpb.current.frame = frame
        self.dpb.current.width = sps.width
        self.dpb.current.height = sps.height
        self.dpb.current.crop = sps.crop
        self.dpb.mark_decoded_ref_pic(
            is_ref=header.nal_ref_idc != 0,
            mmco=header.mmco,
            adaptive=header.adaptive_ref_pic_marking,
            frame_num=header.frame_num,
            poc=poc,
            is_idr=header.idr,
            no_output_of_prior=header.no_output_of_prior_pics,
            long_term_ref=header.long_term_reference,
            pic_id=self.pic_number,
            num_err_mbs=num_err)
        self.pic_number += 1
        self.dpb.prev_ref_frame_num = header.frame_num \
            if header.nal_ref_idc else self.dpb.prev_ref_frame_num
        self._drain()

    # ------------------------------------------------------------------
    # Stage B
    def _reconstruct_numpy(self, pic: PictureData) -> Frame:
        """NumPy reference backend: recon_cpu + in-loop deblocking."""
        sps, pps = self.sps, self.pps
        ref_frames = {p.slot: p.frame for p in self.dpb.buffer
                      if p.frame is not None}
        frame = reconstruct_picture(pic, pps.chroma_qp_index_offset,
                                    pps.constrained_intra_pred,
                                    ref_frames, sps.width, sps.height)
        deblock_mod.filter_picture(frame, pic, pps.chroma_qp_index_offset)
        return frame

    def _cpu_frame(self, f):
        """A frame of either backend as a host Frame."""
        if f is None or isinstance(f, Frame):
            return f
        nf = Frame.__new__(Frame)
        nf.y = np.asarray(f.y).astype(np.uint8)
        nf.cb = np.asarray(f.cb).astype(np.uint8)
        nf.cr = np.asarray(f.cr).astype(np.uint8)
        return nf

    def close(self) -> None:
        """Release the slice pool's worker threads. The decoder is
        unusable for further decode calls after this."""
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def _reconstruct_concealed(self, pic: PictureData, num_err: int):
        """Error path: host reconstruction of the decoded MBs, then
        concealment + deblocking (h264bsdConceal semantics). On the torch
        path the concealed frame then goes into the current stack slot,
        so later P pictures predict from it and not from a stale slot."""
        sps, pps = self.sps, self.pps
        ref_frames = {p.slot: self._cpu_frame(p.frame)
                      for p in self.dpb.buffer
                      if p.frame is not None}
        frame = reconstruct_picture(pic, pps.chroma_qp_index_offset,
                                    pps.constrained_intra_pred, ref_frames,
                                    sps.width, sps.height)
        # lowest-index reference for whole/inter concealment; the
        # reference's list is freshly initialized for every slice
        # (h264bsd_decoder.c:256/445), so rebuild it here
        self.dpb.init_ref_pic_list()
        ref0 = None
        for i in range(16):
            f = self.dpb.ref_frame(i)
            if f is not None:
                ref0 = self._cpu_frame(f)
                break
        stype = self.last_header.slice_type if \
            getattr(self, "last_header", None) else I_SLICE
        conceal_picture(pic, frame, stype, ref0,
                        self.intra_conceal_from_ref)
        deblock_mod.filter_picture(frame, pic, pps.chroma_qp_index_offset)
        if self.recon == "torch":
            self._ensure_stacks()
            frame = self._upload_frame_slot(self.dpb.current.slot, frame)
        return frame

    def _upload_frame_slot(self, slot: int, frame) -> TorchFrame:
        """Write a frame (host planes or a TorchFrame) into stack slot
        `slot`; returns it as a TorchFrame."""
        if not isinstance(frame, TorchFrame):
            frame = TorchFrame.from_planes(frame.y, frame.cb, frame.cr,
                                           self.device)
        update_stack_slot(self._stack_y, self._stack_c, slot, frame)
        return frame

    def _ensure_stacks(self) -> None:
        """(Re)create the reference-plane stacks for the active sequence
        (R = dpb_size + 1 slots), seeding them from any DPB frames
        already present (load_state / concealed-first-picture paths)."""
        sps = self.sps
        R = self.dpb.dpb_size + 1
        key = (sps.width_mbs, sps.height_mbs, R)
        if self._dstack_key == key:
            return
        H, W = sps.height, sps.width
        self._stack_y = torch.zeros((R, H, W), dtype=torch.uint8,
                                    device=self.device)
        self._stack_c = torch.zeros((R, 2, H // 2, W // 2),
                                    dtype=torch.uint8, device=self.device)
        self._dstack_key = key
        for p in self.dpb.buffer:
            if p.frame is not None and not p.non_existing \
                    and p is not self.dpb.current:
                self._upload_frame_slot(p.slot, p.frame)

    def _reconstruct_torch(self, pic: PictureData) -> TorchFrame:
        """Pack (native v2 packer; raises if its library cannot be built),
        upload, reconstruct on the device, write the DPB slot."""
        sps, pps = self.sps, self.pps
        lay = PK.get_packed_layout_v2(sps.width_mbs, sps.height_mbs)
        if self._pack2_scratch is None or self._pack2_scratch.lay is not lay:
            self._pack2_scratch = PK.PackScratchV2(lay)
        res = PK.pack_picture_v2(pic, lay, self._pack2_scratch)
        if res is None:
            raise NotImplementedError(
                "picture does not fit the packed-v2 format (more than 1024 "
                "slices); the v1 fallback is not ported yet, see "
                "ROADMAP.md")
        self._ensure_stacks()
        buf, bk = res
        dbuf = torch.from_numpy(buf).to(self.device)
        return decode_picture_packed2(
            dbuf, self._stack_y, self._stack_c, self.dpb.current.slot, lay,
            bk, constrained_intra=pps.constrained_intra_pred,
            chroma_qp_offset=pps.chroma_qp_index_offset)

    def _drain(self) -> None:
        for p in self.dpb.drain_outputs():
            self.outputs.append(OutputPicture(
                frame=p.frame, is_idr=p.is_idr, pic_id=p.pic_id,
                num_err_mbs=p.num_err_mbs,
                width=p.width or self.sps.width,
                height=p.height or self.sps.height,
                crop=p.crop if p.crop is not None else self.sps.crop))

    # ------------------------------------------------------------------
    # Checkpoint / resume: decoder state = parameter-set
    # stores + DPB frames + POC state at a picture boundary. IDR frames
    # are the natural resume points (DPB flush semantics), but any
    # inter-picture boundary checkpoint restores exactly.
    def save_state(self) -> dict:
        """Snapshot the decode state (host-resident, pickle-able)."""
        def planes(f):
            if f is None:
                return None
            return (np.asarray(f.y).astype(np.uint8),
                    np.asarray(f.cb).astype(np.uint8),
                    np.asarray(f.cr).astype(np.uint8))

        st = {
            "sps_store": copy.deepcopy(self.sps_store),
            "pps_store": copy.deepcopy(self.pps_store),
            "active": (self.active_sps_id, self.active_pps_id),
            "poc_state": copy.deepcopy(self.poc_state),
            "aub": copy.deepcopy(self.aub),
            "pic_number": self.pic_number,
            "headers_ready": self.headers_ready,
            "dpb": None,
        }
        d = self.dpb
        if d is not None:
            pics = []
            for p in d.buffer:
                f = {k: getattr(p, k) for k in
                     ("status", "frame_num", "pic_num", "poc",
                      "to_be_displayed", "is_idr", "pic_id",
                      "num_err_mbs", "non_existing", "slot")}
                f["planes"] = planes(p.frame)
                pics.append(f)
            idx = {id(p): i for i, p in enumerate(d.buffer)}
            st["dpb"] = {
                "ctor": (d.dpb_size, d.max_ref_frames, d.max_frame_num,
                         d.no_reordering),
                "fullness": d.fullness,
                "num_ref_frames": d.num_ref_frames,
                "prev_ref_frame_num": d.prev_ref_frame_num,
                "last_contains_mmco5": d.last_contains_mmco5,
                "max_long_term_frame_idx": d.max_long_term_frame_idx,
                "buffer": pics,
                "out": [idx[id(p)] for p in d.out],
                "current": idx.get(id(d.current), None),
            }
        return st

    def load_state(self, st: dict) -> None:
        """Restore a save_state() snapshot, also one taken by the JAX
        package's decoder: parameter sets and POC/AU state are adopted
        into this package's classes, planes become this backend's frames,
        and the device stacks are rebuilt from them when the next picture
        starts."""
        self.sps_store = {k: _adopt(Sps, v)
                          for k, v in st["sps_store"].items()}
        self.pps_store = {k: _adopt(Pps, v)
                          for k, v in st["pps_store"].items()}
        self.active_sps_id, self.active_pps_id = st["active"]
        self.sps = (self.sps_store.get(self.active_sps_id)
                    if self.active_sps_id is not None else None)
        self.pps = (self.pps_store.get(self.active_pps_id)
                    if self.active_pps_id is not None else None)
        self.poc_state = _adopt(PocState, st["poc_state"])
        self.aub = _adopt(_AubState, st["aub"])
        self.pic_number = st["pic_number"]
        self.headers_ready = st["headers_ready"]
        self.outputs = []
        self.pic = self.pic_header = None
        self._dstack_key = None       # device stacks rebuilt on demand
        sd = st["dpb"]
        if sd is None:
            self.dpb = None
            return
        dpb_size, max_ref, max_fn, no_reorder = sd["ctor"]
        d = Dpb.__new__(Dpb)
        d.max_ref_frames = max_ref
        d.dpb_size = dpb_size
        d.max_frame_num = max_fn
        d.no_reordering = no_reorder
        d.fullness = sd["fullness"]
        d.num_ref_frames = sd["num_ref_frames"]
        d.prev_ref_frame_num = sd["prev_ref_frame_num"]
        d.last_contains_mmco5 = sd["last_contains_mmco5"]
        d.max_long_term_frame_idx = sd["max_long_term_frame_idx"]
        d.buffer = []
        for f in sd["buffer"]:
            p = DpbPicture(**{k: v for k, v in f.items()
                              if k != "planes"})
            if f["planes"] is not None:
                y, cb, cr = f["planes"]
                if self.recon == "torch":
                    p.frame = TorchFrame.from_planes(y, cb, cr, self.device)
                else:
                    fr = Frame.__new__(Frame)
                    fr.y, fr.cb, fr.cr = y, cb, cr
                    p.frame = fr
            d.buffer.append(p)
        if any(p.slot < 0 for p in d.buffer):   # pre-slot checkpoints
            for i, p in enumerate(d.buffer):
                p.slot = i
        d.list = [None] * 33
        d.out = [d.buffer[i] for i in sd["out"]]
        d.current = (d.buffer[sd["current"]]
                     if sd["current"] is not None else None)
        self.dpb = d
