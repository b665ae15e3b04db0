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
  Stage B  pixel backend        -> whole-picture reconstruction: the
           packed buffer (v2; v1 when v2 declines the picture; or the
           unpacked per-MB arrays) goes to `device` and core/recon.py
           rebuilds the picture there ("cuda": the hand-written kernels, "cpu": their
           plain versions); recon="numpy" runs core/recon_cpu.py on the
           host instead, the reference inside the port
  Stage C  frame state          -> DPB / POC / output ordering (core/)
On a card the per-picture step of a picture is one CUDA graph per key
(a v2 buffer, a v1 buffer, or the unpacked arrays), as it is one jit
call per static key in the JAX package, and a frame
group (``group_frames=G``) is one graph of G pictures (core/graphs.py);
group frames are lazy. The graphs are captured on reference stacks leased
from a process-wide pool, so they outlive a decoder as the jit cache
does. The dispatch pump (``async_pump``) runs the upload and the
per-picture step of each v2 picture on one worker thread, in submission
order, beside the feed thread's parse of the next picture.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import weakref
from concurrent import futures
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
from . import graphs as GR
from . import packed as PK
from . import spans as SP
from .conceal import conceal_picture, mark_slice_corrupted
from .dpb import Dpb, DpbPicture
from .graphs import GroupGraphs, StackSet
from .poc import PocState, decode_poc
from .recon import (LazyTorchFrame, TorchFrame, decode_picture_packed2,
                    host_picture_arrays, update_stack_slot)
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


@dataclasses.dataclass
class _Pending:
    """A v2 picture queued for its frame group."""
    buf: np.ndarray
    bk: tuple
    slot: int
    frame: LazyTorchFrame
    cfg: tuple          # (layout, constrained_intra, chroma_qp_offset)


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
                 recon: str = "torch", recon_strategy=None,
                 pack: str = "v2", group_frames: int = 0,
                 prefetch_outputs: bool = False,
                 async_pump: Optional[bool] = None) -> None:
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
        # pack: how a picture travels to `device` on the torch path. "v2"
        # the compact packed buffer (and v1 for a picture v2 declines:
        # more than 1024 slices); "v1" the dense packed buffer; "none" the
        # unpacked per-MB arrays, assembled in NumPy with no native packer.
        # recon_strategy: optional callable(decoder, pic) -> frame that
        # replaces the pixel backend for error-free pictures (tools that
        # only need the parsed tensors return SKIP_RECON; None declines
        # the picture to the built-in backend). DPB/POC/output
        # bookkeeping is unchanged; only the reconstruction is delegated.
        # A strategy whose frames are references writes them into the
        # device stacks itself (``reference_stacks``); it takes no frame
        # groups, whose pending pictures it would not see.
        # group_frames: G > 1 queues the v2 pictures of the torch path and
        # runs G at a time (core.recon.decode_pictures_packed_group; on
        # "cuda" one captured CUDA graph per key, core/graphs.py); their
        # frames are LazyTorchFrames that force the pending group on first
        # access. 0 (the default, as in the JAX package) or 1: one step per
        # picture (on "cuda" one graph per key, captured at the key's
        # second picture).
        # prefetch_outputs: start each output frame's device-to-host copy
        # (TorchFrame.start_fetch) as soon as it reaches display order.
        # async_pump: run the upload and the per-picture step of each v2
        # picture on one worker thread ("bw-pump"), in submission order,
        # while this (the feed) thread parses the next picture: the upload
        # from pageable memory waits for the card, and the enqueue of the
        # step's ops is host work the parse can overlap (the native parser
        # and packer release the GIL). The frames are LazyTorchFrames that
        # drain the pump on first access. None (the default) is the JAX
        # package's default for its device backend: on for a "cuda" torch
        # decoder without frame groups or a recon_strategy, else off. A
        # failed step raises at the next submit or sync point and on its
        # frame's access, and every later one too: it is never dropped.
        if frontend not in ("native", "python"):
            raise ValueError(f"unknown frontend {frontend!r}")
        if recon not in ("torch", "numpy"):
            raise ValueError(f"unknown recon {recon!r}")
        if pack not in ("v2", "v1", "none"):
            raise ValueError(f"unknown pack {pack!r}")
        if not isinstance(group_frames, int) or group_frames < 0:
            raise ValueError(f"group_frames must be an int >= 0, got "
                             f"{group_frames!r}")
        if recon_strategy is not None and group_frames > 0:
            raise ValueError("a recon_strategy takes no frame groups "
                             "(group_frames must be 0)")
        device = torch.device(device)
        if async_pump is None:
            async_pump = (device.type == "cuda" and recon == "torch" and
                          group_frames <= 1 and recon_strategy is None)
        elif async_pump and (recon != "torch" or group_frames > 1 or
                             recon_strategy is not None):
            raise ValueError("the pump runs the torch path's per-picture "
                             "step: async_pump=True takes recon='torch', "
                             "no frame groups and no recon_strategy")
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
            self._executor = ThreadPoolExecutor(
                parallel_slices, thread_name_prefix="bw-slice")
        # the reference stacks, leased from core.graphs.STACK_POOL with the
        # graphs captured on them and K2/K3's progress counters for the
        # eager steps (this decoder's own: decoders on other threads never
        # share them); _give_back returns them, also if the decoder is
        # dropped without close()
        self._stacks: Optional[StackSet] = None
        self._give_back = None
        # the pool's tag for the sets this decoder leases: only decoders
        # with the same tag share sets, and with them the graphs of their
        # keys (a recon_strategy's ``stack_affinity``, e.g. the band
        # slicer's; each of parallel/slices.py's lockstep streams its own)
        self.stack_affinity = getattr(recon_strategy, "stack_affinity", None)
        self.pack = pack
        self._pack2_scratch = None
        self._pack_scratch = None
        self.group_frames = group_frames
        self.prefetch_outputs = prefetch_outputs
        self._group_pend: List[_Pending] = []
        self._group_lock = threading.Lock()
        self.async_pump = bool(async_pump)
        self._pump = None                  # the worker, made at first use
        self._pump_pend: List[futures.Future] = []
        self._pump_lock = threading.Lock()
        self._pump_failed: Optional[BaseException] = None
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
        self._flush_group()
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
            SP.end("slice.queued", queued)
            rbsp, pos, header, sg_map, slice_id, ref_slots = args
            t0 = SP.begin()
            try:
                nat.decode_slice_data_native(
                    rbsp, pos, pic, parser, header, sps,
                    pps, sg_map, slice_id, ref_slots,
                    append_params=False)
                return None
            except SliceDataError as e:
                return (header, sg_map, slice_id, e)
            finally:
                SP.end("slice.parse", t0)

        queued = SP.begin()
        self._deferred.append(self._executor.submit(one))

    def _run_deferred(self) -> None:
        """Collect this picture's in-flight slice parses."""
        t0 = SP.begin()
        work, self._deferred = self._deferred, []
        for fut in work:
            res = fut.result()
            if res is not None:
                header, sg_map, slice_id, e = res
                mark_slice_corrupted(self.pic, header.first_mb, sg_map,
                                     slice_id, e.last_mb_addr,
                                     self.sps.width_mbs)
        self.n_decoded_mbs = int(self.pic.decoded.sum())
        SP.end("front.pool_wait", t0)

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
        t0 = SP.begin()
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
            SP.end("front.header", t0)
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
        SP.end("front.header", t0)
        try:
            if self.frontend == "native" and self._executor is not None:
                t0 = SP.begin()
                nat.append_slice_params(self.pic, header, slice_id,
                                        ref_slots)
                self._submit_slice((nal_rbsp, r.pos, header, sg_map,
                                    slice_id, ref_slots))
                SP.end("front.submit", t0)
                return        # collected at the picture boundary
            t0 = SP.begin()
            if self.frontend == "native":
                nat.decode_slice_data_native(nal_rbsp, r.pos, self.pic,
                                             self.parser, header, self.sps,
                                             self.pps, sg_map, slice_id,
                                             ref_slots)
            else:
                decode_slice_data(r, self.pic, self.parser, header,
                                  self.sps, self.pps, sg_map, slice_id,
                                  ref_slots)
            SP.end("front.parse", t0)
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
        t0 = SP.begin()
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
        SP.end("front.start_picture", t0)

    def _finish_picture(self, concealed: bool) -> None:
        t0 = SP.begin()
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
        SP.end("front.finish", t0)

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
        """Drain the pump and run the pending frame group, then release
        the pump's and the slice pool's worker threads and give the
        reference stacks back to the pool (also when the drain raises a
        failed step's error). The decoder is unusable for further decode
        calls after this."""
        try:
            self._flush_group()
        finally:
            if self._pump is not None:
                self._pump.shutdown(wait=True)
                self._pump = None
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None
            self._return_stacks()

    def trace_snapshot(self) -> dict:
        """The port's spans and counters (``core/spans.py``): ``{"counters":
        {name: count}, "spans": [[name, thread name, start ns, end ns],
        ...]}``, times on ``time.time_ns()``. The counters count since
        recording began; the spans are those that ended since the previous
        call, which this call removes. The recorder is the process's, not
        this decoder's: in a process with several decoders their spans and
        counters come back together, to whichever calls. Recording begins
        with the process's first call and stays on."""
        return SP.RECORDER.snapshot()

    @property
    def stack_set(self) -> Optional[StackSet]:
        """The leased stack set (None while none is leased)."""
        return self._stacks

    @property
    def group_graphs(self) -> Optional[GroupGraphs]:
        """The graphs of the leased stacks (None while none are leased)."""
        return None if self._stacks is None else self._stacks.graphs

    def _picture_step(self, stacks: StackSet, buf: np.ndarray, slot: int,
                      lay: PK.PackedLayoutV2, bk: tuple, ci: bool, co: int
                      ) -> TorchFrame:
        """The per-picture step of one v2 picture on `stacks`, on this
        thread's stream. On a card the graph of its key
        (``GroupGraphs.step``: replayed, or captured at the key's second
        picture); a key's first picture there, and every picture on the
        CPU, runs the eager step."""
        stacks.note_stream()
        return GR.graph_or_eager(
            stacks.graphs, stacks.device, lay.w, lay.h,
            lambda: stacks.graphs.step(buf, slot, stacks.stack_y,
                                       stacks.stack_c, lay, bk, ci, co),
            lambda: decode_picture_packed2(
                torch.from_numpy(buf).to(self.device), stacks.stack_y,
                stacks.stack_c, slot, lay, bk, ci, co,
                workspace=stacks.progress))

    def _v1_step(self, stacks: StackSet, buf: np.ndarray, slot: int,
                 lay: PK.PackedLayout, kb: int, ci: bool, co: int
                 ) -> TorchFrame:
        """The per-picture step of one v1 picture (buf u8 [size] on the
        host) under ``_picture_step``'s policy: on a card the graph of its
        key (layout, kb, ci, co, stacks); the same body eagerly for a
        key's first picture there and on the CPU (``graphs.v1_step``)."""
        stacks.note_stream()
        return GR.v1_step(stacks, buf, slot, lay, kb, ci, co)

    def _arrays_step(self, stacks: StackSet, arrs: Dict[str, np.ndarray],
                     slot: int, co: int) -> TorchFrame:
        """The per-picture step of one picture's unpacked arrays
        (``host_picture_arrays``) under ``_picture_step``'s policy: on a
        card the graph of its key (the arrays' layout, their whole_conceal
        flag, the geometry, co, stacks), whose input is the arrays
        flattened into one buffer; the same body eagerly for a key's first
        picture there and on the CPU (``graphs.unpacked_step``)."""
        stacks.note_stream()
        return GR.unpacked_step(stacks, arrs, slot, stacks.stack_y,
                                stacks.stack_c, co)

    def _pump_picture(self, buf: np.ndarray, bk: tuple,
                      lay: PK.PackedLayoutV2, ci: bool, co: int
                      ) -> LazyTorchFrame:
        """Queue the upload and the per-picture step of a v2 picture on the
        pump. The stacks and the slot are taken now, on the feed thread;
        the job runs on the worker under this decoder's card and on the
        stream that is current here now (both are per thread: without them
        a cuda:1 decoder's job would launch on card 0), and captures or
        replays its key's graph there."""
        stacks = self._stacks
        slot = self.dpb.current.slot
        dev = stacks.device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" \
            else None

        frame = LazyTorchFrame(self._pump_flush)

        def step() -> None:
            # the frame is set on the card and stream too: a start_fetch
            # it runs then records its event on that stream
            with contextlib.ExitStack() as on_card:
                if stream is not None:
                    on_card.enter_context(torch.cuda.device(dev))
                    on_card.enter_context(torch.cuda.stream(stream))
                frame._set(self._picture_step(stacks, buf, slot, lay, bk,
                                              ci, co))

        t0 = SP.begin()
        with self._pump_lock:
            self._pump_reap(wait=False)
            if self._pump is None:
                self._pump = ThreadPoolExecutor(
                    1, thread_name_prefix="bw-pump")
            self._pump_pend.append(self._pump.submit(
                self._pump_run, step, frame, SP.begin()))
        SP.end("pump.submit", t0)
        return frame

    def _pump_run(self, step, frame: LazyTorchFrame, queued: int) -> None:
        """One job on the pump worker (`queued`: the start of its time in
        the queue, taken at its submit). The first failure is kept: the
        jobs queued behind it do not run (their references would be
        stale), and every frame of theirs raises it."""
        SP.end("pump.queued", queued)
        t0 = SP.begin()
        try:
            if self._pump_failed is not None:
                raise RuntimeError("not decoded: an earlier picture's step "
                                   "failed") from self._pump_failed
            step()
        except BaseException as e:
            if self._pump_failed is None:
                self._pump_failed = e
            frame._fail(e)
            raise
        finally:
            SP.end("pump.job", t0)

    def _pump_reap(self, wait: bool) -> None:
        """Forget the finished jobs (all of them after waiting for them
        when `wait`); raise the first failed job's error. Under
        _pump_lock."""
        pend = self._pump_pend
        if wait:
            futures.wait(pend)
        self._pump_pend = [f for f in pend if not f.done()]
        if self._pump_failed is not None:
            raise self._pump_failed

    def _pump_flush(self) -> None:
        """Drain the dispatch pump: after this no worker job touches the
        device stacks, so the feed thread may read or rebuild them."""
        t0 = SP.begin()
        with self._pump_lock:
            self._pump_reap(wait=True)
        SP.end("pump.drain", t0)

    def _flush_group(self) -> None:
        """Drain the pump, then run the pending frame group and give its
        lazy frames their planes (nothing to do when none is pending). This
        is the one sync point before any host access to the device stacks:
        every path that reads or rebuilds them, or writes a picture into
        them that is not the pump's or the group's, calls it first. One
        pending picture takes the per-picture step; 2..G the group step (a
        graph of that size)."""
        self._pump_flush()
        with self._group_lock:
            pend, self._group_pend = self._group_pend, []
            if not pend:
                return
            lay, ci, co = pend[0].cfg
            stacks = self._stacks
            if len(pend) == 1:
                p = pend[0]
                p.frame._set(self._picture_step(stacks, p.buf, p.slot, lay,
                                                p.bk, ci, co))
                return
            BK = tuple(max(p.bk[j] for p in pend) for j in range(3))
            bufs = np.stack([PK.expand_buf_v2(p.buf, lay, p.bk, BK)
                             for p in pend])
            stacks.note_stream()
            yuvs = stacks.graphs.run(bufs, [p.slot for p in pend],
                                     stacks.stack_y, stacks.stack_c, lay, BK,
                                     ci, co)
            for p, yuv in zip(pend, yuvs):
                p.frame._set(TorchFrame(yuv, 16 * lay.w, 16 * lay.h))

    def _reconstruct_concealed(self, pic: PictureData, num_err: int):
        """Error path: host reconstruction of the decoded MBs, then
        concealment + deblocking (h264bsdConceal semantics). On the torch
        path the concealed frame then goes into the current stack slot,
        so later P pictures predict from it and not from a stale slot."""
        self._flush_group()       # the references must be current
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
        stacks = self._stacks
        stacks.note_stream()
        update_stack_slot(stacks.stack_y, stacks.stack_c, slot, frame)
        return frame

    def _ensure_stacks(self) -> None:
        """Lease the reference-plane stacks for the active sequence (R =
        dpb_size + 1 slots) from the process's pool (core/graphs.py:
        zeroed, with the graphs captured on them), giving back the
        previous ones first; seed them from any DPB frames already present
        (load_state / concealed-first-picture paths)."""
        sps = self.sps
        R = self.dpb.dpb_size + 1
        if self._stacks is not None and \
                self._stacks.geometry == (sps.width, sps.height, R):
            return
        self._flush_group()       # the old stacks' work runs first
        self._return_stacks()
        pool = GR.STACK_POOL
        self._stacks = pool.lease(self.device, sps.width, sps.height, R,
                                  affinity=self.stack_affinity)
        self._give_back = weakref.finalize(self, pool.release, self._stacks)
        self._give_back.atexit = False
        for p in self.dpb.buffer:
            if p.frame is not None and not p.non_existing \
                    and p is not self.dpb.current:
                self._upload_frame_slot(p.slot, p.frame)

    def _return_stacks(self) -> None:
        """Give the leased stacks back to the pool (none leased: nothing
        to do). Their frames stay valid: no frame is a view of them."""
        if self._give_back is not None:
            self._give_back()
        self._stacks = self._give_back = None

    def reference_stacks(self):
        """For a recon_strategy on the torch path: (stack_y [R, H, W],
        stack_c [R, 2, H/2, W/2], slot) on `device`, the reference-plane
        stacks of the active sequence and the stack slot of the picture
        being decoded. A strategy that returns a frame writes its planes
        into that slot (``core.recon.update_stack_slot``): the decoder
        writes the slot only for the pictures it reconstructs itself."""
        self._flush_group()
        self._ensure_stacks()
        stacks = self._stacks
        stacks.note_stream()
        return stacks.stack_y, stacks.stack_c, self.dpb.current.slot

    def _reconstruct_torch(self, pic: PictureData) -> TorchFrame:
        """Pack and upload as `pack` says, reconstruct on the device,
        write the DPB slot. The order is the JAX decoder's: v2; v1 when
        v2 declines the picture; the unpacked arrays only on request. The
        native packers raise if their library cannot be built."""
        sps, pps = self.sps, self.pps
        w, h = sps.width_mbs, sps.height_mbs
        self._ensure_stacks()
        own = self._stacks
        slot = self.dpb.current.slot
        ci, co = pps.constrained_intra_pred, pps.chroma_qp_index_offset
        if self.pack == "v2":
            lay = PK.get_packed_layout_v2(w, h)
            if self._pack2_scratch is None or \
                    self._pack2_scratch.lay is not lay:
                self._pack2_scratch = PK.PackScratchV2(lay)
            t0 = SP.begin()
            res = PK.pack_picture_v2(pic, lay, self._pack2_scratch)
            SP.end("front.pack", t0)
            if res is not None:
                buf, bk = res
                if self.group_frames > 1:
                    return self._queue_group(buf, bk, lay, ci, co)
                if self.async_pump:
                    return self._pump_picture(buf, bk, lay, ci, co)
                return self._picture_step(own, buf, slot, lay, bk, ci, co)
        # a v1 or unpacked picture writes the stacks after the pump's jobs
        # and the pending group, on this thread
        self._flush_group()
        if self.pack != "none":
            lay = PK.get_packed_layout(w, h)
            if self._pack_scratch is None or \
                    self._pack_scratch.lay is not lay:
                self._pack_scratch = PK.PackScratch(lay)
            t0 = SP.begin()
            buf, kb = PK.pack_picture(pic, lay, self._pack_scratch)
            SP.end("front.pack", t0)
            return self._v1_step(own, buf, slot, lay, kb, ci, co)
        return self._arrays_step(own, host_picture_arrays(pic, co, ci), slot,
                                 co)

    def _queue_group(self, buf: np.ndarray, bk: tuple,
                     lay: PK.PackedLayoutV2, ci: bool, co: int
                     ) -> LazyTorchFrame:
        """Queue a v2 picture for the frame group; the group runs once it
        holds group_frames pictures (or at the next sync point). The
        pictures of one group share the unpack's parameters: a picture
        whose parameter set differs runs the pending group first."""
        cfg = (lay, ci, co)
        if self._group_pend and self._group_pend[0].cfg != cfg:
            self._flush_group()
        frame = LazyTorchFrame(self._flush_group)
        self._group_pend.append(
            _Pending(buf, bk, self.dpb.current.slot, frame, cfg))
        if len(self._group_pend) >= self.group_frames:
            self._flush_group()
        return frame

    def _drain(self) -> None:
        for p in self.dpb.drain_outputs():
            if self.prefetch_outputs and p.frame is not None:
                start = getattr(p.frame, "start_fetch", None)
                if start is not None:
                    start()
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
        self._flush_group()

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
        and the device stacks are leased again and rebuilt from them when
        the next picture starts."""
        self._flush_group()     # frames handed out keep their pictures
        self._return_stacks()
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
