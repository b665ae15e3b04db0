"""Band-sharded decode: a picture's MB-row bands over a list of devices,
the counterpart of ``broadway_tpu/parallel/slices.py`` (there a JAX
``shard_map`` over a mesh axis "sp"; the reference's multi-worker
sliceMode, Player/Decoder.js:677-727 copySlice).

The mesh is a sequence of ``torch.device``, one per band; a device may
repeat (``make_band_mesh``). Band k reconstructs MB rows [k*hb, (k+1)*hb)
on mesh[k]: K1 at the band's global raster offset against full-height
references (``mc_predict(..., mb0=, ref_h_mbs=)``), K2 and K3 on the
band's own w x hb grid. Then every distinct device of the mesh receives
every band (JAX's ``all_gather``: a copy of each band's planes into the
full plane there) and writes the picture into its reference stacks.
Bands on one device run one after the other on its current stream.

Exactness domain, as in the JAX package: pictures whose slices each lie
in one band (``_bands_aligned``); any other picture is declined, and the
decoder's own per-picture step reconstructs it on mesh[0].
 - idc 1 or 2 (no filtering across slice edges): bands are independent.
 - idc 0: the reference deblocks the picture in raster order across
   slice edges (h264bsd_deblocking.c:574-637), so the deblock is a CHAIN:
   reconstruction runs on every band, then band k deblocks hb + 1 MB rows
   once it has band k-1's final bottom MB row (JAX's ``ppermute``: a
   ``.to(next device)``, ordered by the devices' streams). That ghost row
   carries the up-neighbour metadata with its own deblock flags off, so K3
   filters only row 1's top edge into it; its modified pels then replace
   rows 13-15 of band k-1.

Two upload forms, as in the JAX package: the picture's v2 buffer, sent
once to each distinct device, unpacked there and cut per band; and the
host-array form (``band_host_arrays``, ``band_host_arrays_ghost``) for a
picture v2 declines, or on request (``pack="none"``).

As the JAX package jits its band step per key, a mesh whose bands all
lie on one card runs the band step (``decode_band_picture``,
``decode_band_arrays``: the picture into its stack slot, the slot an
input on the card) as one CUDA graph per key on the decoder's pooled
stack set (``BandSlicer``; core/graphs.py). A mesh over several devices
keeps the eager step: its bands' copies cross cards, which one graph does
not capture.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..bitstream.mb_layer import PictureData
from ..core import decoder as DEC
from ..core import graphs as GR
from ..core import packed as PK
from ..core import recon as RC
from ..core.state import tables_from_numpy
from ..ops.gpu import wavefront_kernels as KW
from ..ops.gpu.deblock import deblock_params
from .streams import LockstepAborted, _LockstepSync, make_dp_mesh


def make_band_mesh(devices="cuda", n_bands: int = 4) -> List[torch.device]:
    """The devices of the n_bands bands: one device (or its name) for all
    of them, or a sequence of n_bands devices, which may repeat
    (``streams.make_dp_mesh`` checks them). Raises for a CUDA device when
    CUDA is not available."""
    if n_bands < 1:
        raise ValueError(f"n_bands {n_bands} < 1")
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n_bands
    mesh = make_dp_mesh(devices)
    if len(mesh) != n_bands:
        raise ValueError(f"{len(mesh)} devices for {n_bands} bands")
    return mesh


def _distinct(mesh: Sequence[torch.device]) -> List[torch.device]:
    return list(dict.fromkeys(mesh))


def band_host_arrays(pic: PictureData, n_bands: int, chroma_qp_offset: int,
                     constrained_intra: bool) -> Dict[str, np.ndarray]:
    """Stacked per-band arrays [n_bands, hb*w, ...] (``whole_conceal``
    [n_bands]), each band from ``host_picture_arrays(band=)``."""
    h = pic.height_mbs
    if h % n_bands:
        raise ValueError(f"{h} MB rows do not divide into {n_bands} bands")
    hb = h // n_bands
    per = [RC.host_picture_arrays(pic, chroma_qp_offset, constrained_intra,
                                  band=(b * hb, hb))
           for b in range(n_bands)]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def band_host_arrays_ghost(pic: PictureData, n_bands: int,
                           chroma_qp_offset: int,
                           constrained_intra: bool) -> Dict[str, np.ndarray]:
    """Stacked per-band arrays with a GHOST MB row first: entry k holds MB
    rows [k*hb - 1, (k+1)*hb) of the picture ((hb+1)*w MBs; band 0's ghost
    row is zeros). The ghost row carries the up-neighbour metadata of the
    band's top deblock edge; its own deblock flags are off, so band k
    never filters band k-1's interior edges again."""
    h, w = pic.height_mbs, pic.width_mbs
    if h % n_bands:
        raise ValueError(f"{h} MB rows do not divide into {n_bands} bands")
    hb = h // n_bands
    full = RC.host_picture_arrays(pic, chroma_qp_offset, constrained_intra)
    out = {}
    for k, v in full.items():
        if k == "whole_conceal":
            out[k] = np.broadcast_to(v, (n_bands,)).copy()
            continue
        bands = []
        for b in range(n_bands):
            lo = b * hb * w
            ghost = v[lo - w:lo] if b > 0 else np.zeros_like(v[:w])
            bands.append(np.concatenate([ghost, v[lo:lo + hb * w]]))
        out[k] = np.stack(bands)
    for k in ("enable", "FT", "FL"):
        out[k][:, :w] = False
    return out


def cut_band(arrs: Dict[str, torch.Tensor], band: int, w: int,
             hb: int) -> Dict[str, torch.Tensor]:
    """Band `band`'s hb*w MBs of a whole-picture per-MB dict (the v2
    unpack, on its device)."""
    nb = hb * w
    return {k: (v if k == "whole_conceal" else v[band * nb:(band + 1) * nb])
            for k, v in arrs.items()}


def cut_band_ghost(arrs: Dict[str, torch.Tensor], band: int, w: int,
                   hb: int) -> Dict[str, torch.Tensor]:
    """The device twin of ``band_host_arrays_ghost`` for one band (JAX's
    ``_cut_band_ghost_v2``): MB rows [band*hb - 1, (band+1)*hb) of a
    whole-picture per-MB dict, band 0's ghost row zeros, the ghost row's
    deblock flags off."""
    nb = hb * w
    out = {}
    for k, v in arrs.items():
        if k == "whole_conceal":
            out[k] = v
            continue
        own = v[band * nb:(band + 1) * nb]
        if band > 0 and k not in ("enable", "FT", "FL"):
            gh = v[band * nb - w:band * nb]
        else:
            gh = torch.zeros_like(v[:w])
        out[k] = torch.cat([gh, own])
    return out


def _bands_aligned(pic: PictureData, n_bands: int) -> bool:
    """True if every slice lies within one MB-row band (the condition for
    reconstructing the bands independently)."""
    h, w = pic.height_mbs, pic.width_mbs
    if h % n_bands:
        return False
    sid = pic.slice_id.reshape(n_bands, (h // n_bands) * w)
    seen = {}
    for b in range(n_bands):
        for s in np.unique(sid[b]).tolist():
            if seen.setdefault(s, b) != b:
                return False
    return True


def comm_volume_2d(w_mbs: int, h_mbs: int, n_bands: int,
                   n_streams: int) -> dict:
    """Bytes each device receives per picture, by grid axis: the band
    gather along a row ("sp"; uint8 planes here, where the JAX package
    counts int32); nothing across rows ("dp": streams are independent)."""
    H, W = h_mbs * 16, w_mbs * 16
    plane = H * W + 2 * (H // 2) * (W // 2)
    return {"sp_bytes_per_pic_per_chip": plane * (n_bands - 1) // n_bands,
            "dp_bytes_per_pic": 0,
            "streams": n_streams, "bands": n_bands}


def decode_bands(bands: Sequence[Dict[str, torch.Tensor]],
                 mesh: Sequence[torch.device], stacks: dict, w_mbs: int,
                 h_mbs: int, chroma_qp_offset: int, cross: bool,
                 workspace: dict = None) -> dict:
    """One band-sharded picture. bands[k]: band k's per-MB dict on mesh[k]
    (with the ghost row first when `cross`, the idc-0 chain); stacks:
    {device: (ref_y, ref_c)} with the full-height references on every
    distinct device. Returns {device: the picture's YUV, u8 [H*W*3/2]}
    (``TorchFrame``'s layout) on every distinct device of the mesh.
    workspace: {device: K2/K3's progress counters there (int32, at least
    hb + 1)}, when the caller owns them (a captured graph owns its own);
    else the wrappers' per-stream counters. The bands of a device run one
    after the other on its current stream, so they share its counters."""
    n = len(mesh)
    ws = workspace or {}
    hb = h_mbs // n
    W, Wc = 16 * w_mbs, 8 * w_mbs
    Hb, Hbc = 16 * hb, 8 * hb
    planes, ghosts = [], [None] * n
    for k, dev in enumerate(mesh):
        arrs = bands[k]
        if cross:
            arrs = {key: (v if key == "whole_conceal" else v[w_mbs:])
                    for key, v in arrs.items()}
        ref_y, ref_c = stacks[dev]
        planes.append(RC.decode_picture(
            arrs, ref_y, ref_c, w_mbs, hb, chroma_qp_offset,
            run_stages=2 if cross else 3, workspace=ws.get(dev),
            mb0=k * hb * w_mbs, ref_h_mbs=h_mbs))
    if cross:
        halo = None
        for k, dev in enumerate(mesh):
            Y, C = planes[k]
            if halo is None:
                gy = torch.zeros((16, W), dtype=Y.dtype, device=dev)
                gc = torch.zeros((2, 8, Wc), dtype=C.dtype, device=dev)
            else:
                gy = halo[0].to(dev, non_blocking=True)
                gc = halo[1].to(dev, non_blocking=True)
            Yg = torch.cat([gy, Y])
            Cg = torch.cat([gc, C], dim=1)
            KW.deblock_wavefront(Yg, Cg,
                                 deblock_params(bands[k], w_mbs, hb + 1),
                                 w_mbs, hb + 1, workspace=ws.get(dev))
            planes[k] = (Yg[16:], Cg[:, 8:])
            ghosts[k] = (Yg[:16], Cg[:, :8])
            halo = (Yg[-16:], Cg[:, -8:])       # band k's final bottom row
    out = {}
    n_y = 256 * w_mbs * h_mbs
    for dev in _distinct(mesh):
        yuv = torch.empty(n_y + n_y // 2, dtype=torch.uint8, device=dev)
        Y = yuv[:n_y].view(16 * h_mbs, W)
        C = yuv[n_y:].view(2, 8 * h_mbs, Wc)
        for k in range(n):
            y, c = planes[k]
            Y[k * Hb:(k + 1) * Hb].copy_(y, non_blocking=True)
            C[:, k * Hbc:(k + 1) * Hbc].copy_(c, non_blocking=True)
            if ghosts[k] is not None and k > 0:
                # band k's filter changed rows 13-15 of band k-1
                Y[k * Hb - 16:k * Hb].copy_(ghosts[k][0], non_blocking=True)
                C[:, k * Hbc - 8:k * Hbc].copy_(ghosts[k][1],
                                                 non_blocking=True)
        out[dev] = yuv
    return out


def _bands_into_slot(bands: Sequence[Dict[str, torch.Tensor]],
                     ref_y: torch.Tensor, ref_c: torch.Tensor,
                     slots: torch.Tensor, w_mbs: int, h_mbs: int,
                     chroma_qp_offset: int, cross: bool,
                     workspace: torch.Tensor) -> torch.Tensor:
    """``decode_bands`` with every band on the stacks' device, then the
    picture into stack slot slots[0] -> its YUV, u8 [1, bytes]."""
    dev = ref_y.device
    yuv = decode_bands(bands, [dev] * len(bands), {dev: (ref_y, ref_c)},
                       w_mbs, h_mbs, chroma_qp_offset, cross,
                       None if workspace is None else {dev: workspace})[dev]
    n_y = 256 * w_mbs * h_mbs
    H, W = 16 * h_mbs, 16 * w_mbs
    return RC.write_slot(yuv[:n_y].view(H, W),
                         yuv[n_y:].view(2, H // 2, W // 2), ref_y, ref_c,
                         slots)


def decode_band_picture(bufs: torch.Tensor, ref_y: torch.Tensor,
                        ref_c: torch.Tensor, slots: torch.Tensor,
                        n_bands: int, cross: bool, lay: PK.PackedLayoutV2,
                        bk: tuple, constrained_intra: bool,
                        chroma_qp_offset: int,
                        workspace: torch.Tensor = None) -> torch.Tensor:
    """The band step of a mesh whose n_bands bands all lie on the stacks'
    device (the body of the JAX package's
    ``decode_picture_sliced_x_v2_impl`` / ``decode_picture_sliced_v2_impl``
    under its jit): bufs u8 [1, size], the picture's v2 buffer, and slots
    int64 [1] on that device -> the picture's YUV, u8 [1, bytes], written
    into stack slot slots[0]. One unpack; each band cut from it
    (``cut_band_ghost`` with the idc-0 chain, `cross`, else ``cut_band``);
    ``decode_bands``. It reads no host value that depends on the inputs,
    so a CUDA graph captures it as it stands (core/graphs.py
    ``PictureGraph``); K1's band offsets are host ints of n_bands, which
    the graph's key holds. workspace: K2/K3's progress counters (int32,
    at least hb + 1)."""
    RC.check_slot_inputs(bufs, slots, ref_y.device)
    w, h = lay.w, lay.h
    whole = PK.unpack_arrs_v2(bufs[0], lay, bk, constrained_intra,
                              chroma_qp_offset)
    RC.require_not_concealed(whole, "a band picture")
    cut = cut_band_ghost if cross else cut_band
    bands = [cut(whole, k, w, h // n_bands) for k in range(n_bands)]
    return _bands_into_slot(bands, ref_y, ref_c, slots, w, h,
                            chroma_qp_offset, cross, workspace)


def decode_band_arrays(bufs: torch.Tensor, ref_y: torch.Tensor,
                       ref_c: torch.Tensor, slots: torch.Tensor,
                       layout: tuple, n_bands: int, cross: bool, w_mbs: int,
                       h_mbs: int, chroma_qp_offset: int,
                       whole_conceal: bool,
                       workspace: torch.Tensor = None) -> torch.Tensor:
    """The band step in the host-array form (the counterpart of the JAX
    package's ``make_sliced_decoder_x`` / ``make_sliced_decoder``): bufs u8
    [1, size], the stacked band arrays (``band_host_arrays``, or
    ``band_host_arrays_ghost`` with `cross`) flattened by
    ``packed.pack_host_arrays`` into `layout`, and slots int64 [1] on the
    stacks' device -> the picture's YUV, u8 [1, bytes], written into
    stack slot slots[0]. Band k's arrays are views of bufs; whole_conceal
    stays a host value (a graph's key holds it), as in ``_band_to``."""
    RC.check_slot_inputs(bufs, slots, ref_y.device)
    stacked = PK.view_host_arrays(bufs[0], layout)
    conceal = torch.tensor(bool(whole_conceal))
    bands = [dict({k: v[b] for k, v in stacked.items()},
                  whole_conceal=conceal) for b in range(n_bands)]
    return _bands_into_slot(bands, ref_y, ref_c, slots, w_mbs, h_mbs,
                            chroma_qp_offset, cross, workspace)


class BandSlicer:
    """The band-sharded reconstruction of one stream, as a decoder's
    ``recon_strategy`` (the decoder runs on mesh[0]): each picture whose
    slices align with the bands is decoded over the mesh and written into
    the reference stacks on every distinct device; any other picture is
    declined (None) to the decoder's own per-picture step.

    A mesh whose bands all lie on one device runs the band step
    (``decode_band_picture``, or ``decode_band_arrays`` in the host-array
    form) as the JAX package jits it: on a card one CUDA graph per key
    (``core.graphs.GroupGraphs.picture``, kind "band" or "band_arrays";
    key: n_bands, cross, the JAX static arguments, the device and the
    stacks), on the decoder's pooled stack set, so the graphs outlive the
    decoder; a key's first picture for the set's owner runs the step
    eagerly, its second is captured and replayed, the rest replay. A
    capture or replay that fails raises. A mesh over more than one device
    keeps the eager step (``decode_bands``, then each device's stacks):
    the decoder's stacks serve mesh[0], and every other distinct device
    keeps a copy, refreshed in full whenever a picture reached the stacks
    without this slicer (a declined or concealed picture) or the stacks
    were made anew.

    stats counts "pictures" (band-sharded), "declined", "cross" (of the
    pictures, those with an idc-0 slice: the chained deblock),
    "host_arrays" (of the pictures, those in the host-array form) and
    "routes" (the pictures by route: "eager", "captured", "replayed" on a
    one-device mesh, all eager on the CPU; "eager_multi_card" on a mesh
    over more than one device).

    Its decoder leases its stacks under the pool tag ``stack_affinity``
    ("band"), apart from decoders of other kinds: a later band decoder of
    the same geometry gets back a set that holds the band graphs."""

    stack_affinity = "band"

    def __init__(self, mesh: Sequence[torch.device], pack: str = "v2",
                 stats: dict = None, cache: dict = None) -> None:
        if pack not in ("v2", "none"):
            raise ValueError(f"unknown pack {pack!r}")
        self.mesh = list(mesh)
        self.n_bands = len(self.mesh)
        self.pack = pack
        self.stats = stats if stats is not None else {}
        for k in ("pictures", "declined", "cross", "host_arrays"):
            self.stats.setdefault(k, 0)
        self.stats.setdefault("routes", dict.fromkeys(
            ("eager", "captured", "replayed", "eager_multi_card"), 0))
        self.cache = cache if cache is not None else {}
        self._mirrors: Dict[torch.device, tuple] = {}
        self._synced = None      # (stacks, next picture number) when fresh
        self._progress: Dict[torch.device, torch.Tensor] = {}

    def _workspace(self, dev: torch.device, rows: int) -> torch.Tensor:
        """This slicer's K2/K3 progress counters on `dev` for its eager
        steps (at least `rows`)."""
        ws = self._progress.get(dev)
        if ws is None or ws.numel() < rows:
            ws = self._progress[dev] = torch.zeros(rows, dtype=torch.int32,
                                                   device=dev)
        return ws

    def _stacks(self, dec) -> tuple:
        sy, sc, slot = dec.reference_stacks()
        stacks = {self.mesh[0]: (sy, sc)}
        fresh = self._synced is not None and self._synced[0] is sy and \
            self._synced[1] == dec.pic_number
        for dev in _distinct(self.mesh)[1:]:
            if not fresh or dev not in self._mirrors:
                self._mirrors[dev] = (sy.to(dev, copy=True),
                                      sc.to(dev, copy=True))
            stacks[dev] = self._mirrors[dev]
        return stacks, slot

    def _scratch(self, lay):
        s = self.cache.get(("v2", lay))
        if s is None:
            s = self.cache[("v2", lay)] = PK.PackScratchV2(lay)
        return s

    def __call__(self, dec, pic: PictureData):
        n = self.n_bands
        if not _bands_aligned(pic, n):
            self.stats["declined"] += 1
            return None
        sps, pps = dec.sps, dec.pps
        w, h = sps.width_mbs, sps.height_mbs
        ci, co = pps.constrained_intra_pred, pps.chroma_qp_index_offset
        cross = any(sp.disable_deblocking_idc == 0 for sp in pic.slice_params)
        res = stacked = lay = None
        if self.pack == "v2":
            lay = PK.get_packed_layout_v2(w, h)
            res = PK.pack_picture_v2(pic, lay, self._scratch(lay))
        if res is None:
            make = band_host_arrays_ghost if cross else band_host_arrays
            stacked = make(pic, n, co, ci)
            self.stats["host_arrays"] += 1
        if len(_distinct(self.mesh)) > 1:
            frame = self._multi_card(dec, w, h, cross, co, res, lay, ci,
                                     stacked)
        elif res is not None:
            buf, bk = res
            frame = self._one_device(
                dec, "band", (n, cross, lay, bk, ci, co), buf, w, h,
                functools.partial(decode_band_picture, n_bands=n,
                                  cross=cross, lay=lay, bk=bk,
                                  constrained_intra=ci, chroma_qp_offset=co))
        else:
            layout = PK.host_arrays_layout(stacked)
            conceal = bool(stacked["whole_conceal"][0])
            frame = self._one_device(
                dec, "band_arrays", (n, cross, layout, w, h, co, conceal),
                PK.pack_host_arrays(stacked, layout), w, h,
                functools.partial(decode_band_arrays, layout=layout,
                                  n_bands=n, cross=cross, w_mbs=w, h_mbs=h,
                                  chroma_qp_offset=co,
                                  whole_conceal=conceal))
        self.stats["pictures"] += 1
        self.stats["cross"] += int(cross)
        return frame

    def _one_device(self, dec, kind: str, args: tuple, buf: np.ndarray,
                    w: int, h: int, body) -> RC.TorchFrame:
        """The band step of a one-device mesh on the decoder's stack set
        (``core.graphs.picture_step``): the graph of its key (kind, args:
        the step's static arguments, which `body` has bound) on a card;
        `body` eagerly for a key's first picture for the set's owner, and
        on the CPU, with this slicer's counters."""
        sy, sc, slot = dec.reference_stacks()
        rows = h // self.n_bands + 1
        graphs = dec.group_graphs
        with graphs.counted(self.stats["routes"]):
            return GR.picture_step(graphs, kind, args, body, buf, slot, sy,
                                   sc, rows,
                                   self._workspace(self.mesh[0], rows))

    def _multi_card(self, dec, w: int, h: int, cross: bool, co: int, res,
                    lay, ci: bool, stacked: dict) -> RC.TorchFrame:
        """The eager band step over a mesh of several devices: the v2
        buffer (res = (buf, bk) of layout lay) sent once to each distinct
        device, unpacked there and cut per band, or else each band's host
        arrays (`stacked`) sent to its device; then ``decode_bands`` and
        the picture into every device's stacks."""
        hb = h // self.n_bands
        stacks, slot = self._stacks(dec)
        if res is not None:
            host = torch.from_numpy(res[0])
            whole = {dev: PK.unpack_arrs_v2(host.to(dev), lay, res[1], ci,
                                            co)
                     for dev in _distinct(self.mesh)}
            cut = cut_band_ghost if cross else cut_band
            bands = [cut(whole[dev], k, w, hb)
                     for k, dev in enumerate(self.mesh)]
        else:
            bands = [_band_to(stacked, k, dev)
                     for k, dev in enumerate(self.mesh)]
        workspace = {dev: self._workspace(dev, hb + 1)
                     for dev in _distinct(self.mesh)}
        frame = None
        for dev, yuv in decode_bands(bands, self.mesh, stacks, w, h, co,
                                     cross, workspace).items():
            f = RC.TorchFrame(yuv, 16 * w, 16 * h)
            RC.update_stack_slot(*stacks[dev], slot, f)
            if dev == self.mesh[0]:
                frame = f
        self.stats["routes"]["eager_multi_card"] += 1
        self._synced = (stacks[self.mesh[0]][0], dec.pic_number + 1)
        return frame


def _band_to(stacked: Dict[str, np.ndarray], k: int,
             dev: torch.device) -> Dict[str, torch.Tensor]:
    """Band k of stacked host arrays on `dev`; ``whole_conceal`` stays on
    the host, where ``decode_picture`` reads it without a sync."""
    arrs = tables_from_numpy({key: v[k] for key, v in stacked.items()
                              if key != "whole_conceal"}, dev)
    arrs["whole_conceal"] = torch.from_numpy(
        np.array(stacked["whole_conceal"][k]))
    return arrs


def decode_stream_sliced(data: bytes, mesh="cuda", n_bands: int = 4,
                         pack: str = "v2", parallel_slices: int = 0,
                         stats: dict = None, cache: dict = None
                         ) -> List[bytes]:
    """Band-sharded decode of an Annex-B stream -> display-order YUV bytes.

    mesh: a device for every band, or one device for all of them
    (``make_band_mesh``; "cuda" by default, "cpu" runs the kernels' plain
    versions). Per picture: slices aligned with the bands and idc 1/2 ->
    independent bands; aligned and idc 0 -> the chained deblock; else
    declined, and the decoder's own per-picture step reconstructs it on
    mesh[0] (never the NumPy path). stats, when given, receives the
    counts of ``BandSlicer``; cache, a dict the caller may share between
    calls, keeps the v2 packer's scratch per layout."""
    mesh = make_band_mesh(mesh, n_bands)
    slicer = BandSlicer(mesh, pack, stats, cache)
    dec = DEC.Decoder(device=mesh[0], group_frames=0, recon_strategy=slicer,
                      parallel_slices=parallel_slices)
    try:
        outs = dec.decode_annexb(data)
    finally:
        dec.close()
    for o in outs:
        o.frame.start_fetch()
    return [o.frame.tobytes() for o in outs]


def decode_streams_sliced_dp(datas: Sequence[bytes], grid=None,
                             n_bands: int = 2, pack: str = "v2",
                             parallel_slices: int = 0,
                             stats: dict = None) -> List[List[bytes]]:
    """N streams in lockstep, stream i band-sharded over row i of an
    [N, n_bands] device grid (the counterpart of the JAX package's 2-D
    dp x sp form, which needs one geometry; nothing crosses rows). Each
    stream parses
    on its own thread with its own ``Decoder`` on grid[i][0]; in each round
    one thread runs every stream's band step in turn (the bands are what
    is sharded, not the streams: K1 / K2 / K3 launch per band and stream).
    A picture of a stream that does not align with the bands is declined
    to that stream's decoder. grid: rows of devices (default: the card
    for every band of every stream). stats, when given, receives "rounds"
    and "streams", the per-stream counts of ``BandSlicer`` (its "routes"
    among them).

    Where JAX runs one 2-D program a round, a row of one card here
    replays S band graphs a round, one per stream (``BandSlicer``): each
    stream has reference stacks of its own, its decoder's pooled set, and
    a graph bakes in the stacks it reads and writes. Stream i's decoder
    leases under the pool tag ("sliced_dp", i) (``Decoder.stack_affinity``),
    so a later call of the same geometry gives each stream back the set
    that holds its graphs, whatever the order of the leases and of other
    decoders'."""
    S = len(datas)
    if grid is None:
        grid = [["cuda"] * n_bands] * S
    if len(grid) != S:
        raise ValueError(f"{len(grid)} grid rows for {S} streams")
    per = [{} for _ in range(S)]
    slicers = [BandSlicer(make_band_mesh(row, n_bands), pack, per[i])
               for i, row in enumerate(grid)]
    sync = _LockstepSync(S)
    staged = [None] * S
    results = [None] * S
    state = {"rounds": 0, "done": []}

    def leader_round() -> None:
        state["rounds"] += 1
        for i in range(S):
            if staged[i] is not None:
                results[i] = slicers[i](*staged[i])
        devs = _distinct(d for s in slicers for d in s.mesh)
        state["done"] = [(d, torch.cuda.current_stream(d).record_event())
                         for d in devs if d.type == "cuda"]

    def make_recon(i: int):
        def recon(dec, pic):
            staged[i] = (dec, pic)
            if sync.arrive_and_wait():
                try:
                    leader_round()
                except BaseException:
                    sync.abort()
                    raise
                finally:
                    for j in range(S):
                        staged[j] = None
                sync.release()
            else:
                for d, ev in state["done"]:
                    torch.cuda.current_stream(d).wait_event(ev)
            return results[i]
        return recon

    outs = [None] * S
    errors = []

    def run(i: int) -> None:
        dec = None
        try:
            dec = DEC.Decoder(device=slicers[i].mesh[0], group_frames=0,
                              recon_strategy=make_recon(i),
                              parallel_slices=parallel_slices)
            dec.stack_affinity = ("sliced_dp", i)
            got = dec.decode_annexb(datas[i])
            sync.leave()
            for o in got:
                o.frame.start_fetch()
            outs[i] = [o.frame.tobytes() for o in got]
        except Exception as e:
            errors.append(e)
            sync.abort()
        finally:
            if dec is not None:
                dec.close()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(S)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next((e for e in errors if not isinstance(e, LockstepAborted)),
                   errors[0])
    if stats is not None:
        stats.update({"rounds": state["rounds"], "streams": per})
    return outs
