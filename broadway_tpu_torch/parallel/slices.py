"""Band-sharded decode: a picture's MB-row bands over a list of devices,
the counterpart of ``broadway_tpu/parallel/slices.py`` (there a JAX
``shard_map`` over a mesh axis "sp"; the reference's multi-worker
sliceMode, Player/Decoder.js:677-727 copySlice).

The mesh is a sequence of ``torch.device``, one per band; a device may
repeat (``make_band_mesh``). Band k reconstructs MB rows [k*hb, (k+1)*hb)
on mesh[k] (``reconstruct_band``, (a)): K1 at the band's global raster
offset against full-height references (``mc_predict(..., mb0=,
ref_h_mbs=)``), K2 and K3 on the band's own w x hb grid. Then every
distinct device of the mesh receives every band (``gather_bands``, (c),
JAX's ``all_gather``: a copy of each band's planes into the full plane
there) and writes the picture into its reference stacks. Bands on one
device run one after the other on its current stream.

Exactness domain, as in the JAX package: pictures whose slices each lie
in one band (``_bands_aligned``); any other picture is declined, and the
decoder's own per-picture step reconstructs it on mesh[0].
 - idc 1 or 2 (no filtering across slice edges): bands are independent.
 - idc 0: the reference deblocks the picture in raster order across
   slice edges (h264bsd_deblocking.c:574-637), so the deblock is a CHAIN
   (``deblock_band``, (b)): reconstruction runs on every band, then band
   k deblocks hb + 1 MB rows once it has band k-1's final bottom MB row
   (JAX's ``ppermute``: a copy from the previous device, ordered after
   its work). That ghost row carries the up-neighbour metadata with its
   own deblock flags off, so K3 filters only row 1's top edge into it;
   its modified pels then replace rows 13-15 of band k-1.

Two upload forms, as in the JAX package: the picture's v2 buffer, sent
once to each distinct device, unpacked there and cut per band; and the
host-array form (``band_host_arrays``, ``band_host_arrays_ghost``) for a
picture v2 declines, or on request (``pack="none"``), flattened into one
buffer and sent the same way (``band_arrays``).

As the JAX package jits its band step per key (``jax.jit(shard_map(...))``
over the mesh), the band step runs as CUDA graphs per key on a card
(``BandSlicer``; core/graphs.py): a mesh whose bands all lie on one card
as one graph (``decode_band_picture``, ``decode_band_arrays``); a mesh
over several cards as a graph per run of bands on one card
(``decode_band_run``: (a) and (b)) and a gather graph per card
(``gather_into_slot``: (c)), the copies between cards peer copies
(ops/gpu/peer.py) ordered by events that the graphs record and wait on.
The eager ``decode_bands`` is built from the same bodies (a), (b), (c).
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
from ..ops.gpu import peer as PEER
from ..ops.gpu import wavefront_kernels as KW
from ..ops.gpu.deblock import deblock_params
from .streams import LockstepAborted, _LockstepSync, make_dp_mesh

# BandSlicer.stats["routes"]: one device's graph routes, then a mesh's
ROUTES = ("eager", "captured", "replayed", "multi_card_eager",
          "multi_card_captured", "multi_card_replayed")


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


def eager_fetch(dst: torch.Tensor, src: torch.Tensor, band: int) -> None:
    """dst <- src, a piece of band `band`'s planes, by ``copy_``: across
    devices the copy orders itself after both devices' current streams.
    The eager routes' fetch; a captured step fetches across cards with
    peer copies ordered by events (core.graphs.MeshGraph)."""
    dst.copy_(src, non_blocking=True)


def reconstruct_band(arrs: Dict[str, torch.Tensor], ref_y: torch.Tensor,
                     ref_c: torch.Tensor, band: int, w_mbs: int, h_mbs: int,
                     n_bands: int, chroma_qp_offset: int, cross: bool,
                     workspace: torch.Tensor = None) -> tuple:
    """(a) Band `band` of a picture h_mbs MB rows high, reconstructed on
    the stacks' device: K1 at the band's raster offset against the
    full-height references, then the residual and K2 over its hb rows,
    and K3 too unless `cross` (the idc-0 chain deblocks in (b)). arrs:
    the band's per-MB dict (with the ghost row first when `cross`) ->
    (Y [16 hb, W], C [2, 8 hb, W/2])."""
    hb = h_mbs // n_bands
    if cross:
        arrs = {key: (v if key == "whole_conceal" else v[w_mbs:])
                for key, v in arrs.items()}
    return RC.decode_picture(arrs, ref_y, ref_c, w_mbs, hb, chroma_qp_offset,
                             run_stages=2 if cross else 3,
                             workspace=workspace, mb0=band * hb * w_mbs,
                             ref_h_mbs=h_mbs)


def deblock_band(arrs: Dict[str, torch.Tensor], Y: torch.Tensor,
                 C: torch.Tensor, halo, band: int, w_mbs: int, hb: int,
                 workspace: torch.Tensor = None, fetch=eager_fetch) -> tuple:
    """(b) One step of the idc-0 chain (JAX's ``chain_step``): band
    `band`'s planes from (a) under a ghost MB row, which is band
    band - 1's final bottom MB row (`halo`: that band's final planes, on
    its device, copied here by `fetch`; zeros for band 0), deblocked by
    K3 over hb + 1 rows -> the band's final planes with the ghost row
    first, (Yg [16 (hb + 1), W], Cg [2, 8 (hb + 1), W/2]). K3 filters
    only the ghost row's bottom edge, rows 13-15 of band - 1's last MB
    row, which ``gather_bands`` takes from here. All that does not need
    the halo comes before its fetch, which waits on the previous band."""
    Yg = torch.empty((16 * (hb + 1), 16 * w_mbs), dtype=Y.dtype,
                     device=Y.device)
    Cg = torch.empty((2, 8 * (hb + 1), 8 * w_mbs), dtype=C.dtype,
                     device=C.device)
    Yg[16:].copy_(Y)
    Cg[:, 8:].copy_(C)
    P = deblock_params(arrs, w_mbs, hb + 1)
    if halo is None:
        Yg[:16].zero_()
        Cg[:, :8].zero_()
    else:
        fetch(Yg[:16], halo[0][-16:], band - 1)
        fetch(Cg[:, :8], halo[1][:, -8:], band - 1)
    KW.deblock_wavefront(Yg, Cg, P, w_mbs, hb + 1, workspace=workspace)
    return Yg, Cg


def band_rows(band: int, n_bands: int, hb: int, cross: bool) -> tuple:
    """(top, lo, hi): band `band`'s final planes start at MB row `top` of
    the picture (one above its own rows with the ghost row), and give the
    picture MB rows [lo, hi); with `cross`, a band's last MB row comes
    from the next band's ghost row, which K3 filtered last."""
    top = band * hb - 1 if cross else band * hb
    last = cross and band < n_bands - 1
    return top, max(top, 0), (band + 1) * hb - int(last)


def gather_bands(finals: Sequence[tuple], device, w_mbs: int, h_mbs: int,
                 cross: bool, fetch=eager_fetch) -> torch.Tensor:
    """(c) The all-gather: every band's final planes (finals[k], from (a),
    or from (b) with `cross`, on band k's device) into one picture on
    `device`, each band's rows by `fetch` -> its YUV, u8 [H*W*3/2]
    (``TorchFrame``'s layout)."""
    n = len(finals)
    hb = h_mbs // n
    n_y = 256 * w_mbs * h_mbs
    yuv = torch.empty(n_y + n_y // 2, dtype=torch.uint8, device=device)
    Y = yuv[:n_y].view(16 * h_mbs, 16 * w_mbs)
    C = yuv[n_y:].view(2, 8 * h_mbs, 8 * w_mbs)
    for k, (Yk, Ck) in enumerate(finals):
        top, lo, hi = band_rows(k, n, hb, cross)
        fetch(Y[16 * lo:16 * hi], Yk[16 * (lo - top):16 * (hi - top)], k)
        fetch(C[:, 8 * lo:8 * hi], Ck[:, 8 * (lo - top):8 * (hi - top)], k)
    return yuv


def decode_bands(bands: Sequence[Dict[str, torch.Tensor]],
                 mesh: Sequence[torch.device], stacks: dict, w_mbs: int,
                 h_mbs: int, chroma_qp_offset: int, cross: bool,
                 workspace: dict = None) -> dict:
    """One band-sharded picture, eagerly: (a) every band on its device,
    (b) the idc-0 chain when `cross`, (c) the gather on every distinct
    device. bands[k]: band k's per-MB dict on mesh[k] (with the ghost row
    first when `cross`); stacks: {device: (ref_y, ref_c)} with the
    full-height references on every distinct device. Returns {device: the
    picture's YUV, u8 [H*W*3/2]} on every distinct device of the mesh.
    workspace: {device: K2/K3's progress counters there (int32, at least
    hb + 1)}, when the caller owns them (a captured graph owns its own);
    else the wrappers' per-stream counters. The bands of a device run one
    after the other on its current stream, so they share its counters."""
    ws = workspace or {}
    n = len(mesh)
    finals = [reconstruct_band(bands[k], *stacks[dev], k, w_mbs, h_mbs, n,
                               chroma_qp_offset, cross, ws.get(dev))
              for k, dev in enumerate(mesh)]
    if cross:
        for k, dev in enumerate(mesh):
            finals[k] = deblock_band(bands[k], *finals[k],
                                     finals[k - 1] if k else None, k, w_mbs,
                                     h_mbs // n, ws.get(dev))
    return {dev: gather_bands(finals, dev, w_mbs, h_mbs, cross)
            for dev in _distinct(mesh)}


def _into_slot(yuv: torch.Tensor, ref_y: torch.Tensor, ref_c: torch.Tensor,
               slots: torch.Tensor) -> torch.Tensor:
    """A picture's YUV into stack slot slots[0] -> the YUV, u8 [1, bytes]."""
    H, W = ref_y.shape[-2:]
    return RC.write_slot(yuv[:H * W].view(H, W),
                         yuv[H * W:].view(2, H // 2, W // 2), ref_y, ref_c,
                         slots)


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
    return _into_slot(yuv, ref_y, ref_c, slots)


def band_arrays(bufs: torch.Tensor, spec: tuple, bands: Sequence[int],
                w_mbs: int, h_mbs: int, n_bands: int, cross: bool
                ) -> Dict[int, Dict[str, torch.Tensor]]:
    """The per-MB dicts of bands `bands` of the picture in bufs u8 [1,
    size], on its device, as ``decode_bands`` takes them. spec ("v2",
    lay, bk, constrained_intra, chroma_qp_offset): a v2 buffer, unpacked
    once and cut per band (``cut_band_ghost`` with `cross`, else
    ``cut_band``); ("arrays", layout, whole_conceal): the stacked band
    arrays flattened by ``packed.pack_host_arrays`` into `layout`, band k's
    arrays views of bufs, whole_conceal a host value (in the graph's key).
    Reads no host value that depends on bufs."""
    hb = h_mbs // n_bands
    if spec[0] == "v2":
        _, lay, bk, ci, co = spec
        whole = PK.unpack_arrs_v2(bufs[0], lay, bk, ci, co)
        RC.require_not_concealed(whole, "a band picture")
        cut = cut_band_ghost if cross else cut_band
        return {k: cut(whole, k, w_mbs, hb) for k in bands}
    _, layout, whole_conceal = spec
    stacked = PK.view_host_arrays(bufs[0], layout)
    conceal = torch.tensor(bool(whole_conceal))
    return {k: dict({key: v[k] for key, v in stacked.items()},
                    whole_conceal=conceal) for k in bands}


def decode_band_run(bufs: torch.Tensor, ref_y: torch.Tensor,
                    ref_c: torch.Tensor, bands: Sequence[int], spec: tuple,
                    n_bands: int, cross: bool, w_mbs: int, h_mbs: int,
                    chroma_qp_offset: int, halo=None,
                    workspace: torch.Tensor = None,
                    fetch=eager_fetch) -> List[tuple]:
    """One card's part of a band-sharded picture before the gather: bands
    `bands` (consecutive, all on the stacks' device) of the picture in
    bufs u8 [1, size] on that device (``band_arrays``'s spec), (a) each
    reconstructed, then with `cross` (b) the chain over them in order,
    the first one's ghost row from `halo` (band bands[0] - 1's final
    planes, on its own card; None for band 0) -> each band's final planes,
    as ``gather_bands`` takes them. The body of a card's band graph
    (core.graphs.MeshGraph): it reads no host value that depends on its
    inputs, and `fetch` is how it reaches another card."""
    arrs = band_arrays(bufs, spec, bands, w_mbs, h_mbs, n_bands, cross)
    finals = [reconstruct_band(arrs[k], ref_y, ref_c, k, w_mbs, h_mbs,
                               n_bands, chroma_qp_offset, cross, workspace)
              for k in bands]
    if cross:
        for i, k in enumerate(bands):
            prev = finals[i - 1] if i else (halo if k else None)
            finals[i] = deblock_band(arrs[k], *finals[i], prev, k, w_mbs,
                                     h_mbs // n_bands, workspace, fetch)
    return finals


def gather_into_slot(finals: Sequence[tuple], ref_y: torch.Tensor,
                     ref_c: torch.Tensor, slots: torch.Tensor, w_mbs: int,
                     h_mbs: int, cross: bool, fetch=eager_fetch
                     ) -> torch.Tensor:
    """(c) on one card: every band's final planes (``decode_band_run``'s,
    from every card) gathered into the picture, written into this card's
    stack slot slots[0] (int64 [1] on the card) -> its YUV, u8 [1,
    bytes]. The body of a card's gather graph (core.graphs.MeshGraph)."""
    yuv = gather_bands(finals, ref_y.device, w_mbs, h_mbs, cross, fetch)
    return _into_slot(yuv, ref_y, ref_c, slots)


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
    arrs = band_arrays(bufs, ("v2", lay, bk, constrained_intra,
                              chroma_qp_offset), range(n_bands), w, h,
                       n_bands, cross)
    return _bands_into_slot([arrs[k] for k in range(n_bands)], ref_y, ref_c,
                            slots, w, h, chroma_qp_offset, cross, workspace)


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
    stays a host value (a graph's key holds it)."""
    RC.check_slot_inputs(bufs, slots, ref_y.device)
    arrs = band_arrays(bufs, ("arrays", layout, whole_conceal),
                       range(n_bands), w_mbs, h_mbs, n_bands, cross)
    return _bands_into_slot([arrs[k] for k in range(n_bands)], ref_y, ref_c,
                            slots, w_mbs, h_mbs, chroma_qp_offset, cross,
                            workspace)


def mesh_runs(mesh: Sequence[torch.device]) -> List[tuple]:
    """The mesh's runs of consecutive bands on one device, in band order:
    [(device, (band, ...)), ...]; one run a device on a mesh of distinct
    devices or of contiguous bands."""
    runs = []
    for k, dev in enumerate(mesh):
        if runs and runs[-1][0] == dev:
            runs[-1] = (dev, runs[-1][1] + (k,))
        else:
            runs.append((dev, (k,)))
    return runs


class BandSlicer:
    """The band-sharded reconstruction of one stream, as a decoder's
    ``recon_strategy`` (the decoder runs on mesh[0]): each picture whose
    slices align with the bands is decoded over the mesh and written into
    the reference stacks on every distinct device; any other picture is
    declined (None) to the decoder's own per-picture step.

    As the JAX package jits its band step per key, the step runs as CUDA
    graphs per key on a card, captured at a key's second picture for the
    set's owner and replayed from then on; a key's first picture runs the
    same bodies eagerly, as does every picture on the CPU. A capture or
    replay that fails raises. The graphs live on the decoder's pooled
    stack set, so they outlive the decoder.
     - A mesh whose bands all lie on one device: the band step
       (``decode_band_picture``, or ``decode_band_arrays`` in the
       host-array form) as one graph (``core.graphs.GroupGraphs.picture``,
       kind "band" or "band_arrays"; key: n_bands, cross, the JAX static
       arguments, the device and the stacks).
     - A mesh over several devices (``core.graphs.MeshGraph``, kind
       "band_mesh"; key: the same, each run of the mesh's devices and
       bands, every device's stacks): a graph per run of consecutive
       bands on one card (``mesh_runs``: one a card on a mesh of distinct
       cards; ``decode_band_run``: (a) and the chain (b), the halo a peer
       copy from the previous card after an event its graph records) and
       a gather graph per card (``gather_into_slot``: (c), every other
       card's bands by peer copies, the picture into that card's stacks).
       Peer access between every pair of its cards is checked and enabled
       here, and its absence raises. The decoder's stacks serve mesh[0];
       every other distinct device has a mirror, a stack set leased from
       the pool beside the decoder's and given back with it, refreshed in
       place (so a graph's addresses hold) whenever a picture reached the
       stacks without this slicer (a declined or concealed picture) or
       the stacks were leased anew.

    stats counts "pictures" (band-sharded), "declined", "cross" (of the
    pictures, those with an idc-0 slice: the chained deblock),
    "host_arrays" (of the pictures, those in the host-array form) and
    "routes" (the pictures by route: "eager", "captured", "replayed" on a
    one-device mesh; "multi_card_eager", "multi_card_captured",
    "multi_card_replayed" on a mesh over several devices; all eager on
    the CPU).

    Its decoder leases its stacks under the pool tag ``stack_affinity``
    ("band"), apart from decoders of other kinds, and the mirrors under
    (its decoder's tag, "mirror"): a later band decoder of the same
    geometry and mesh gets back the sets that hold its band graphs."""

    stack_affinity = "band"

    def __init__(self, mesh: Sequence[torch.device], pack: str = "v2",
                 stats: dict = None, cache: dict = None) -> None:
        if pack not in ("v2", "none"):
            raise ValueError(f"unknown pack {pack!r}")
        self.mesh = list(mesh)
        self.n_bands = len(self.mesh)
        self.pack = pack
        PEER.enable(_distinct(self.mesh))
        self.stats = stats if stats is not None else {}
        for k in ("pictures", "declined", "cross", "host_arrays"):
            self.stats.setdefault(k, 0)
        self.stats.setdefault("routes", dict.fromkeys(ROUTES, 0))
        self.cache = cache if cache is not None else {}
        self._synced = None      # (set, mirrors, next picture) when fresh
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
        """({device: (stack_y, stack_c)} for every distinct device of the
        mesh, the picture's slot): the decoder's stacks for mesh[0], a
        mirror leased beside them (``StackSet.companions``) for every
        other device, refreshed by copies into its own storage unless
        this slicer's last picture left them equal."""
        sy, sc, slot = dec.reference_stacks()
        owner = dec.stack_set
        mirrors = owner.companions
        fresh = self._synced is not None and self._synced[0] is owner and \
            self._synced[1] is mirrors and self._synced[2] == dec.pic_number
        W, H, R = owner.geometry
        stacks = {self.mesh[0]: (sy, sc)}
        for dev in _distinct(self.mesh)[1:]:
            m = mirrors.get(dev)
            if m is None:
                m = mirrors[dev] = GR.STACK_POOL.lease(
                    dev, W, H, R, affinity=(dec.stack_affinity, "mirror"))
                fresh = False
            m.note_stream()
            stacks[dev] = (m.stack_y, m.stack_c)
        if not fresh:
            for dev, (my, mc) in list(stacks.items())[1:]:
                my.copy_(sy)
                mc.copy_(sc)
        self._synced = (owner, mirrors, None)   # fresh again once it steps
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
        res = None
        if self.pack == "v2":
            lay = PK.get_packed_layout_v2(w, h)
            res = PK.pack_picture_v2(pic, lay, self._scratch(lay))
        if res is not None:
            buf, bk = res
            spec = ("v2", lay, bk, ci, co)
        else:
            make = band_host_arrays_ghost if cross else band_host_arrays
            stacked = make(pic, n, co, ci)
            layout = PK.host_arrays_layout(stacked)
            buf = PK.pack_host_arrays(stacked, layout)
            spec = ("arrays", layout, bool(stacked["whole_conceal"][0]))
            self.stats["host_arrays"] += 1
        if len(_distinct(self.mesh)) > 1:
            frame = self._multi_card(dec, spec, buf, w, h, cross, co)
        elif spec[0] == "v2":
            frame = self._one_device(
                dec, "band", (n, cross, lay, bk, ci, co), buf, h,
                functools.partial(decode_band_picture, n_bands=n,
                                  cross=cross, lay=lay, bk=bk,
                                  constrained_intra=ci, chroma_qp_offset=co))
        else:
            frame = self._one_device(
                dec, "band_arrays", (n, cross, layout, w, h, co, spec[2]),
                buf, h,
                functools.partial(decode_band_arrays, layout=layout,
                                  n_bands=n, cross=cross, w_mbs=w, h_mbs=h,
                                  chroma_qp_offset=co,
                                  whole_conceal=spec[2]))
        self.stats["pictures"] += 1
        self.stats["cross"] += int(cross)
        return frame

    def _one_device(self, dec, kind: str, args: tuple, buf: np.ndarray,
                    h: int, body) -> RC.TorchFrame:
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

    def _multi_card(self, dec, spec: tuple, buf: np.ndarray, w: int, h: int,
                    cross: bool, co: int) -> RC.TorchFrame:
        """The band step over a mesh of several devices on the decoder's
        stacks and the mirrors (``core.graphs.mesh_step``): the graphs of
        its key on cards; the same bodies eagerly for a key's first
        picture for the set's owner, and on the CPU, with this slicer's
        counters. buf: the picture's input as ``band_arrays`` takes it
        (spec), u8 [size] on the host, sent once to each device."""
        n = self.n_bands
        stacks, slot = self._stacks(dec)
        rows = h // n + 1
        run = functools.partial(decode_band_run, spec=spec, n_bands=n,
                                cross=cross, w_mbs=w, h_mbs=h,
                                chroma_qp_offset=co)
        gather = functools.partial(gather_into_slot, w_mbs=w, h_mbs=h,
                                   cross=cross)
        graphs = dec.group_graphs
        with graphs.counted(self.stats["routes"], "multi_card_"):
            frame = GR.mesh_step(
                graphs, (spec, n, cross, w, h, co), mesh_runs(self.mesh),
                stacks, buf, slot, rows, run, gather,
                {dev: self._workspace(dev, rows) for dev in stacks})
        owner = dec.stack_set
        self._synced = (owner, owner.companions, dec.pic_number + 1)
        return frame


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
