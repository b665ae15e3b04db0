"""Whole-picture reconstruction on the device (torch twin of
``broadway_tpu.core.recon_tpu``'s ``decode_picture_impl`` with
``wf="pallas"``, ``update_stack_slot``, ``decode_picture_packed2``,
``decode_picture_packed`` (v1), ``decode_pictures_packed_batch``,
``decode_pictures_packed_group``, the frames ``TpuFrame`` /
``LazyTpuFrame`` and the host-side ``host_picture_arrays``).

Dataflow per picture:
  1. residual dequant + IDCT over raster MB space (ops/gpu/residual.py)
  2. motion compensation, K1 (ops/gpu/mc_kernel.py)
  3. base assembly: inter (pred + res) and I_PCM pixels into raster
     uint8 planes, 0 at intra MBs
  4. intra wavefront, K2, in place (ops/gpu/wavefront_kernels.py)
  5. deblock parameters, then the deblock wavefront, K3, in place
The planes stay raster throughout: no diagonal-major packing.

The reference-plane stacks are unpadded uint8 (core/state.py); the
picture's planes are written into its DPB slot after decode.

A batch (``decode_picture(..., batch=B)``) is B pictures of one geometry,
one per stream of a lockstep decode, with the pictures one after the other
on the MB axis of every per-MB array: each stage runs once for all of
them, and K1, K2 and K3 are one launch each. A frame group
(``decode_pictures_packed_group``) is G consecutive pictures of ONE
stream: G steps in a row, the body that core/graphs.py captures.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.gpu import mc_kernel as K1
from ..ops.gpu import wavefront_kernels as KW
from ..ops.gpu.deblock import deblock_params
from ..ops.gpu.intra import intra_params
from ..ops.gpu.residual import residual_stage
from ..bitstream.mb_layer import MB_I16x16, MB_IPCM, MB_P, PictureData
from .packed import PackedLayout, PackedLayoutV2, unpack_arrs, unpack_arrs_v2

U8 = torch.uint8


class TorchFrame:
    """A decoded picture. The device copy is one uint8 YUV buffer
    (``yuv``) with plane views ``dev_y``, ``dev_cb``, ``dev_cr``; the
    host planes ``y``, ``cb``, ``cr`` (numpy uint8, what the shared host
    code reads) are fetched on first access, all three in one copy, or
    by a copy that ``start_fetch`` began earlier."""

    __slots__ = ("yuv", "dev_y", "dev_cb", "dev_cr", "_host", "_fetching")

    def __init__(self, yuv: torch.Tensor, width: int, height: int) -> None:
        n_y = width * height
        n_c = n_y // 4
        self.yuv = yuv
        self.dev_y = yuv[:n_y].view(height, width)
        self.dev_cb = yuv[n_y:n_y + n_c].view(height // 2, width // 2)
        self.dev_cr = yuv[n_y + n_c:].view(height // 2, width // 2)
        self._host = None
        self._fetching = None

    @classmethod
    def from_planes(cls, y, cb, cr, device) -> "TorchFrame":
        """Frame from three host planes (numpy, values 0..255)."""
        yuv = np.concatenate([np.asarray(p, np.uint8).reshape(-1)
                              for p in (y, cb, cr)])
        h, w = np.shape(y)
        return cls(torch.from_numpy(yuv).to(device), w, h)

    def start_fetch(self) -> None:
        """Begin the device-to-host copy of the YUV without blocking, so
        that delivery overlaps the next pictures' decode (the counterpart
        of ``TpuFrame.start_fetch``): an event on the producing (current)
        stream, then on a side stream a copy into pinned host memory;
        ``y`` / ``tobytes`` then wait for that copy instead of making a
        blocking one. Nothing to do for a frame on the CPU, or one whose
        copy is done or under way."""
        if self.yuv.device.type != "cuda" or self._host is not None or \
                self._fetching is not None:
            return
        dev = self.yuv.device
        produced = torch.cuda.current_stream(dev).record_event()
        side = torch.cuda.Stream(device=dev)
        host = torch.empty(self.yuv.shape, dtype=U8, pin_memory=True)
        with torch.cuda.stream(side):
            side.wait_event(produced)
            host.copy_(self.yuv, non_blocking=True)
            # the buffer must outlive the copy even if the frame goes first
            self.yuv.record_stream(side)
            self._fetching = (host, side.record_event())

    def _fetch(self):
        if self._host is None:
            if self._fetching is not None:
                host, copied = self._fetching
                copied.synchronize()
                buf = host.numpy()
            else:
                buf = self.yuv.cpu().numpy()
            h, w = self.dev_y.shape
            n_y, n_c = h * w, h * w // 4
            self._host = (buf, buf[:n_y].reshape(h, w),
                          buf[n_y:n_y + n_c].reshape(h // 2, w // 2),
                          buf[n_y + n_c:].reshape(h // 2, w // 2))
        return self._host

    @property
    def y(self) -> np.ndarray:
        return self._fetch()[1]

    @property
    def cb(self) -> np.ndarray:
        return self._fetch()[2]

    @property
    def cr(self) -> np.ndarray:
        return self._fetch()[3]

    def tobytes(self) -> bytes:
        return self._fetch()[0].tobytes()


class LazyTorchFrame:
    """A frame of a pending frame group (``Decoder(group_frames=G)``) or of
    a picture queued on the dispatch pump (``Decoder(async_pump=True)``;
    the counterpart of ``LazyTpuFrame``): it gets its ``TorchFrame`` when
    the group or the pump's job runs, and the first access to anything of
    it forces that (``force``, the decoder's flush or pump drain). A
    ``start_fetch`` before then is remembered and begins once the frame is
    set; it does not force the group (that would cut every group to one
    picture under prefetch). ``_set`` (or ``_fail``, when the job raised)
    and ``start_fetch`` may run on two threads, so they share a lock. A
    frame whose job failed raises that error on every access."""

    __slots__ = ("_force", "_frame", "_error", "_want_fetch", "_lock")

    def __init__(self, force) -> None:
        self._force = force
        self._frame = None
        self._error = None
        self._want_fetch = False
        self._lock = threading.Lock()

    def _set(self, frame: TorchFrame) -> None:
        with self._lock:
            self._frame = frame
            # the frame no longer needs its decoder: holding the decoder's
            # flush would keep it (stacks, graphs) alive as long as the frame
            self._force = None
            want = self._want_fetch
        if want:
            frame.start_fetch()

    def _fail(self, error: BaseException) -> None:
        """The job that was to set this frame raised `error`."""
        with self._lock:
            self._error = error
            self._force = None

    def _ensure(self) -> TorchFrame:
        force = self._force       # None once set: read before the frame
        if self._frame is None and self._error is None:
            force()
        if self._error is not None:
            raise RuntimeError("this picture was not decoded: its step "
                               "failed") from self._error
        return self._frame

    def start_fetch(self) -> None:
        with self._lock:
            frame = self._frame
            if frame is None:
                self._want_fetch = True
        if frame is not None:
            frame.start_fetch()

    @property
    def yuv(self) -> torch.Tensor:
        return self._ensure().yuv

    @property
    def dev_y(self) -> torch.Tensor:
        return self._ensure().dev_y

    @property
    def dev_cb(self) -> torch.Tensor:
        return self._ensure().dev_cb

    @property
    def dev_cr(self) -> torch.Tensor:
        return self._ensure().dev_cr

    @property
    def y(self) -> np.ndarray:
        return self._ensure().y

    @property
    def cb(self) -> np.ndarray:
        return self._ensure().cb

    @property
    def cr(self) -> np.ndarray:
        return self._ensure().cr

    def tobytes(self) -> bytes:
        return self._ensure().tobytes()


def host_picture_arrays(pic: PictureData, chroma_qp_offset: int,
                        constrained_intra: bool,
                        band: Tuple[int, int] = None) -> Dict[str, np.ndarray]:
    """The raster per-MB dict of one parsed picture, assembled on the host
    in NumPy (the unpacked path: what the packed buffers carry, without a
    packer). ``state.tables_from_numpy`` moves it to a device and
    ``decode_picture`` consumes it. Unlike the packed paths it also
    serves pictures with undecoded or concealed MBs.

    band=(row0, n_rows): only those MB rows (the band-sharded decode,
    parallel/slices.py). Availability and deblock flags are computed over
    the whole picture before the cut, and the motion vectors stay
    relative to each MB's global position (``decode_picture``'s mb0)."""
    n = pic.n_mbs
    w, h = pic.width_mbs, pic.height_mbs
    cls = pic.mb_class
    grid = lambda a: a.reshape(h, w)
    decg, sidg, clsg = grid(pic.decoded), grid(pic.slice_id), grid(cls)

    def shifted(dy, dx):
        """slices of the current MBs (y, x) and their neighbours at
        (y + dy, x + dx), both inside the picture"""
        ys = slice(max(-dy, 0), h + min(-dy, 0))
        xs = slice(max(-dx, 0), w + min(-dx, 0))
        nys = slice(max(dy, 0), h + min(dy, 0))
        nxs = slice(max(dx, 0), w + min(dx, 0))
        return (ys, xs), (nys, nxs)

    def nb_ok(dy, dx):
        ok = np.zeros((h, w), bool)
        cur, nb = shifted(dy, dx)
        valid = decg[nb] & (sidg[nb] == sidg[cur])
        if constrained_intra:
            valid = valid & (clsg[nb] != MB_P)
        ok[cur] = valid
        return ok.reshape(n)

    # deblock params per MB (concealed MBs: offsets 0, idc 0)
    concealed = getattr(pic, "concealed", None)
    n_sp = len(pic.slice_params)
    sp = np.array([[p.disable_deblocking_idc, p.alpha_c0_offset,
                    p.beta_offset] for p in pic.slice_params] + [[0, 0, 0]],
                  np.int32)
    sidx = np.where(pic.slice_id >= 0, pic.slice_id, n_sp)
    valid = np.ones(n, bool) if concealed is None else ~concealed
    idc, offA, offB = (np.where(valid, sp[sidx, k], 0).astype(np.int32)
                       for k in range(3))
    coff = np.where(valid, chroma_qp_offset, 0).astype(np.int32)
    enable = pic.decoded & (idc != 1)
    idcg = grid(idc)

    def db_nb(dy, dx):
        ok = np.zeros((h, w), bool)
        cur, nb = shifted(dy, dx)
        ok[cur] = decg[nb] & ((idcg[cur] != 2) | (sidg[nb] == sidg[cur]))
        return ok.reshape(n)

    ref_blk = np.repeat(np.repeat(pic.ref_slot, 2, axis=1), 2, axis=2)
    sel = slice(None)
    if band is not None:
        r0, nr = band
        if not (0 <= r0 and 1 <= nr and r0 + nr <= h):
            raise ValueError(f"band {band} outside {h} MB rows")
        sel = slice(r0 * w, (r0 + nr) * w)
    i32 = lambda a: np.ascontiguousarray(a[sel].astype(np.int32))
    cut = lambda a: np.ascontiguousarray(a[sel])
    out = {
        "mb_class": i32(cls),
        "qp": i32(pic.qp),
        "cbp": i32(pic.cbp),
        "is_i16": cut(cls == MB_I16x16),
        "i16_mode": i32(pic.i16_mode),
        "chroma_mode": i32(pic.chroma_mode),
        "i4_modes": i32(pic.i4_modes),
        "luma_coeffs": i32(pic.luma_coeffs),
        "luma_dc": i32(pic.luma_dc),
        "chroma_dc": i32(pic.chroma_dc),
        "chroma_ac": i32(pic.chroma_ac.reshape(n, 2, 2, 2, 16)),
        "total_coeff": i32(pic.total_coeff),
        "mv": i32(pic.mv),
        "ref_blk": i32(ref_blk),
        "ipcm": cut(pic.ipcm),
        "av_a": cut(nb_ok(0, -1)), "av_b": cut(nb_ok(-1, 0)),
        "av_c": cut(nb_ok(-1, 1)), "av_d": cut(nb_ok(-1, -1)),
        "offA": i32(offA), "offB": i32(offB), "chroma_off_mb": i32(coff),
        "FT": cut(enable & db_nb(-1, 0)), "FL": cut(enable & db_nb(0, -1)),
        "enable": cut(enable),
        "is_inter": cut((cls == MB_P) & valid),
        "is_pcm": cut(cls == MB_IPCM),
    }
    out["whole_conceal"] = np.array(getattr(pic, "whole_pic_concealed",
                                            False))
    return out


def _skip_flags(whole_conceal: torch.Tensor, batch, dev):
    """whole_conceal (a scalar, or [B] for a batch; on the host from the
    packed paths, where reading it costs no sync) -> (skip every picture,
    the per-picture int32 [B] flags for K3 on `dev` or None)."""
    if batch is None:
        return bool(whole_conceal), None
    flags = whole_conceal.reshape(-1)
    if flags.shape[0] != batch:
        raise ValueError(f"whole_conceal has {flags.shape[0]} flags for a "
                         f"batch of {batch}")
    if flags.device.type == "cpu":
        if not bool(flags.any()):
            return False, None
        if bool(flags.all()):
            return True, None
    return False, flags.to(device=dev, dtype=torch.int32)


def decode_picture(arrs: Dict[str, torch.Tensor], ref_y: torch.Tensor,
                   ref_c: torch.Tensor, w_mbs: int, h_mbs: int,
                   chroma_qp_offset: int, run_stages: int = 3,
                   batch: int = None, stack_base: torch.Tensor = None,
                   n_ref: int = None, workspace: torch.Tensor = None,
                   mb0: int = 0, ref_h_mbs: int = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reconstruct one picture -> (Y [H, W] u8, C [2, H/2, W/2] u8).

    arrs: the per-MB dict (core/packed.py unpack_arrs_v2 / unpack_arrs,
    or ``host_picture_arrays`` through ``state.tables_from_numpy``)
    on the stacks' device. run_stages as in the JAX pipeline: 0 base
    assembly without MC, 1 with MC, 2 + intra, 3 + deblock.

    batch=B: B pictures of one geometry at once -> (Y [B, H, W], C
    [B, 2, H/2, W/2]); arrs holds them one after the other on the MB axis
    and ``whole_conceal`` [B]; picture b predicts from the n_ref planes
    that start at plane stack_base[b] of ref_y [S, H, W] / ref_c (without a
    table: ref_y [B*R, ...], picture b from b*R), as ``mc_predict``
    takes them. workspace: K2/K3's progress counters, when the caller
    owns them (a captured graph).

    mb0, ref_h_mbs: the picture is a band of h_mbs MB rows whose first MB
    is raster MB mb0 of a picture ref_h_mbs rows high, and the stacks are
    that picture's (the band-sharded decode, parallel/slices.py): K1
    predicts at the global positions; residual, K2 and K3 run on the
    band's own w_mbs x h_mbs grid."""
    B = 1 if batch is None else batch
    N = B * w_mbs * h_mbs
    lead = () if batch is None else (B,)
    dev = ref_y.device
    res_y, res_c = residual_stage(arrs, chroma_qp_offset)

    if run_stages == 0:
        pred_y = torch.zeros((N, 16, 16), dtype=U8, device=dev)
        pred_c = torch.zeros((N, 8, 16), dtype=U8, device=dev)
    else:
        pred_y, pred_c = K1.mc_predict(ref_y, ref_c,
                                       arrs["mv"].contiguous(),
                                       arrs["ref_blk"].contiguous(),
                                       w_mbs, h_mbs, stack_base, n_ref,
                                       mb0, ref_h_mbs)
    # [n, 8, 16] interleaved lanes -> [n, 2, 8, 8]
    pred_c = pred_c.view(N, 8, 8, 2).permute(0, 3, 1, 2)

    pcm = arrs["ipcm"].to(torch.int32)
    is_p = arrs["is_inter"][:, None, None]
    is_pcm = arrs["is_pcm"][:, None, None]
    # predictions are uint8: the sum with the int32 residual is int32
    base_y = torch.where(is_pcm, pcm[:, :256].reshape(N, 16, 16),
                         torch.where(is_p, (pred_y + res_y).clamp(0, 255),
                                     0))
    base_c = torch.where(is_pcm[:, None],
                         pcm[:, 256:384].reshape(N, 2, 8, 8),
                         torch.where(is_p[:, None],
                                     (pred_c + res_c).clamp(0, 255), 0))
    Y = base_y.to(U8).view(B, h_mbs, w_mbs, 16, 16).permute(0, 1, 3, 2, 4) \
        .reshape(lead + (16 * h_mbs, 16 * w_mbs)).contiguous()
    C = base_c.to(U8).view(B, h_mbs, w_mbs, 2, 8, 8) \
        .permute(0, 3, 1, 4, 2, 5) \
        .reshape(lead + (2, 8 * h_mbs, 8 * w_mbs)).contiguous()
    if run_stages <= 1:
        return Y, C

    KW.intra_wavefront(Y, C, res_y, res_c, intra_params(arrs), w_mbs, h_mbs,
                       workspace=workspace)
    if run_stages <= 2:
        return Y, C

    # a wholly concealed picture is not deblocked (the JAX cond); in a
    # batch its rows are idle inside the one K3 launch
    skip_all, skip = _skip_flags(arrs["whole_conceal"], batch, dev)
    if skip_all:
        return Y, C
    KW.deblock_wavefront(Y, C, deblock_params(arrs, w_mbs, h_mbs),
                         w_mbs, h_mbs, skip, workspace=workspace)
    return Y, C


def update_stack_slot(ref_y: torch.Tensor, ref_c: torch.Tensor, slot: int,
                      frame: TorchFrame) -> None:
    """Write one decoded frame into the reference stacks at its DPB
    frame-store slot (in place)."""
    ref_y[slot].copy_(frame.dev_y)
    ref_c[slot, 0].copy_(frame.dev_cb)
    ref_c[slot, 1].copy_(frame.dev_cr)


def decode_arrays_into_slot(arrs: Dict[str, torch.Tensor],
                            ref_y: torch.Tensor, ref_c: torch.Tensor,
                            slot: int, w_mbs: int, h_mbs: int,
                            chroma_qp_offset: int,
                            workspace: torch.Tensor = None) -> TorchFrame:
    """The per-picture step on the per-MB dict itself (an unpacked
    buffer, or ``host_picture_arrays`` moved to the stacks' device): the
    picture's frame out, and its planes written into stack slot `slot`.
    workspace: K2/K3's progress counters when the caller owns them (a
    ``Decoder`` passes its own)."""
    Y, C = decode_picture(arrs, ref_y, ref_c, w_mbs, h_mbs, chroma_qp_offset,
                          workspace=workspace)
    frame = TorchFrame(torch.cat([Y.reshape(-1), C.reshape(-1)]),
                       16 * w_mbs, 16 * h_mbs)
    update_stack_slot(ref_y, ref_c, slot, frame)
    return frame


def decode_picture_packed2(buf: torch.Tensor, ref_y: torch.Tensor,
                           ref_c: torch.Tensor, slot: int,
                           lay: PackedLayoutV2, bk: tuple,
                           constrained_intra: bool, chroma_qp_offset: int,
                           workspace: torch.Tensor = None) -> TorchFrame:
    """The per-picture step: one uploaded v2 buffer in, the picture's
    frame out, and its planes written into stack slot `slot`."""
    arrs = unpack_arrs_v2(buf, lay, bk, constrained_intra, chroma_qp_offset)
    return decode_arrays_into_slot(arrs, ref_y, ref_c, slot, lay.w, lay.h,
                                   chroma_qp_offset, workspace)


def decode_pictures_packed_group(bufs: torch.Tensor, ref_y: torch.Tensor,
                                 ref_c: torch.Tensor, slots: torch.Tensor,
                                 lay: PackedLayoutV2, bk: tuple,
                                 constrained_intra: bool,
                                 chroma_qp_offset: int,
                                 workspace: torch.Tensor = None
                                 ) -> torch.Tensor:
    """The frame-group step: G consecutive pictures of ONE stream, bufs
    [G, size] u8 with one bucket triple (``expand_buf_v2``) on the stacks'
    device, picture g written into DPB slot slots[g] (slots int64 [G] on
    that device) -> the G pictures' YUV, u8 [G, bytes].

    The steps run one after the other: picture g+1's K1 reads the planes
    that picture g wrote, so they cannot be batched. Nothing in here reads
    a host value that depends on the inputs (the slots are indexed on the
    device), so a CUDA graph captures it as it stands (core/graphs.py);
    the CPU runs it eagerly."""
    G = bufs.shape[0]
    dev = ref_y.device
    if bufs.dim() != 2 or bufs.dtype != U8 or bufs.device != dev:
        raise ValueError(f"bufs must be u8 [G, size] on {dev}, got "
                         f"{bufs.dtype} {tuple(bufs.shape)} on {bufs.device}")
    if tuple(slots.shape) != (G,) or slots.dtype != torch.int64 or \
            slots.device != dev:
        raise ValueError(f"slots must be int64 [{G}] on {dev}, got "
                         f"{slots.dtype} {tuple(slots.shape)} on "
                         f"{slots.device}")
    n_y = 256 * lay.n
    yuv = torch.empty((G, n_y + n_y // 2), dtype=U8, device=dev)
    for g in range(G):
        arrs = unpack_arrs_v2(bufs[g], lay, bk, constrained_intra,
                              chroma_qp_offset)
        # K3's skip decision is read on the host (decode_picture): a
        # capture would freeze it, which holds only because no picture of
        # a packed path is wholly concealed
        conceal = arrs["whole_conceal"]
        if conceal.device.type != "cpu" or bool(conceal):
            raise RuntimeError("a frame group holds a wholly concealed "
                               "picture; packed pictures never are")
        Y, C = decode_picture(arrs, ref_y, ref_c, lay.w, lay.h,
                              chroma_qp_offset, workspace=workspace)
        dst = slots[g:g + 1]
        ref_y.index_copy_(0, dst, Y[None])
        ref_c.index_copy_(0, dst, C[None])
        yuv[g, :n_y] = Y.reshape(-1)
        yuv[g, n_y:] = C.reshape(-1)
    return yuv


def decode_picture_packed(buf: torch.Tensor, ref_y: torch.Tensor,
                          ref_c: torch.Tensor, slot: int, lay: PackedLayout,
                          kb: int, constrained_intra: bool,
                          chroma_qp_offset: int,
                          workspace: torch.Tensor = None) -> TorchFrame:
    """The per-picture step on a v1 buffer (the picture v2 declined, or
    ``Decoder(pack="v1")``): as ``decode_picture_packed2``."""
    arrs = unpack_arrs(buf, lay, kb, constrained_intra, chroma_qp_offset)
    return decode_arrays_into_slot(arrs, ref_y, ref_c, slot, lay.w, lay.h,
                                   chroma_qp_offset, workspace)


def decode_pictures_packed_batch(bufs: torch.Tensor, ref_y: torch.Tensor,
                                 ref_c: torch.Tensor, slots: Sequence[int],
                                 lay: PackedLayoutV2, bk: tuple,
                                 constrained_intra: bool,
                                 chroma_qp_offset: int,
                                 streams: Sequence[int] = None
                                 ) -> List[TorchFrame]:
    """The lockstep step: B uploaded v2 buffers of one bucket triple in
    (bufs [B, size], one per stream), B frames out, each stream's planes
    written into slot slots[b] of its own stack.

    ref_y [A, R, H, W] and ref_c [A, R, 2, H/2, W/2] are the stacks of all
    A streams of the group; `streams` names the B of them that take part
    in this round, in the order of bufs (default: all, A == B). The
    others' stacks are neither read nor copied: K1 finds each picture's
    planes through a table of stack bases."""
    A, R = ref_y.shape[:2]
    B = bufs.shape[0]
    streams = list(range(B)) if streams is None else [int(i) for i in streams]
    if len(streams) != B or len(slots) != B or len(set(streams)) != B or \
            not all(0 <= i < A for i in streams):
        raise ValueError(f"{B} buffers, streams {streams} of {A}, slots "
                         f"{list(slots)}")
    if not all(0 <= int(k) < R for k in slots):
        raise ValueError(f"slots {list(slots)} outside 0..{R - 1}")
    if not (ref_y.is_contiguous() and ref_c.is_contiguous()):
        raise ValueError("the reference stacks must be contiguous")
    dev = ref_y.device
    bases = [i * R for i in streams]
    # one small upload per round: the stack bases, and where each picture goes
    tab = torch.tensor([bases, [b + int(k) for b, k in zip(bases, slots)]],
                       dtype=torch.int32).to(dev)
    arrs = unpack_arrs_v2(bufs, lay, bk, constrained_intra, chroma_qp_offset)
    flat_y = ref_y.view((A * R,) + ref_y.shape[2:])
    flat_c = ref_c.view((A * R,) + ref_c.shape[2:])
    Y, C = decode_picture(arrs, flat_y, flat_c, lay.w, lay.h,
                          chroma_qp_offset, batch=B, stack_base=tab[0],
                          n_ref=R)
    dst = tab[1].long()
    flat_y[dst] = Y
    flat_c[dst] = C
    yuv = torch.cat([Y.reshape(B, -1), C.reshape(B, -1)], dim=1)
    return [TorchFrame(yuv[b], 16 * lay.w, 16 * lay.h) for b in range(B)]
