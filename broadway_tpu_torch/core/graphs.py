"""CUDA graphs of the per-picture, frame-group, lockstep-round and band
steps, and the process-wide pool of reference-stack sets that they are
captured on.

The JAX package runs a picture's whole device step as one jit call
(``recon_tpu.decode_picture_packed2``; ``decode_picture_packed`` for a v1
buffer, ``decode_picture`` for the unpacked arrays), a frame group as
another (``decode_pictures_packed_group``), a lockstep round of B streams
as a third (``decode_pictures_packed_batch``) and a band-sharded picture
as a fourth (``parallel/slices.py``'s ``jax.jit(shard_map(...))``): one
compiled executable per set of static arguments, in a cache that lives
as long as the process. The counterpart here is one CUDA graph per key,
captured from ``core.recon.decode_pictures_packed_group`` (with G = 1 for
one picture: the slot is an input on the card, as the jit's slot is a
traced argument), from ``core.recon.decode_pictures_packed_round`` (a
round: its table of stack bases and destination planes is the input on
the card, so the round's member streams are not in its key) or from a
one-picture body of another form (``PictureGraph``: the v1 and unpacked
steps, and the band step of a one-card mesh), and replayed for every
later picture, group or round of that key: the ~600 x G device
operations go to the card in one launch instead of being enqueued op by
op from Python.

Key: the JAX static arguments (layout, bucket triple, constrained_intra,
chroma_qp_offset), G (a round's B), the device, and the address and shape
of both reference stacks, which the graph has baked in. So that graphs
outlive a ``Decoder`` or a ``decode_streams_lockstep`` call, as the jit
cache does, the stacks come from a pool (``StackPool``; the process's is
``STACK_POOL``): a ``StackSet`` owns its stacks (one stream's, or A
streams' for a lockstep group), K2/K3's progress counters for its eager
steps and the graphs captured on it (``GroupGraphs``, each graph with
counters of its own), and is leased to one decoder or lockstep call at a
time. The next holder of the same key gets it back zeroed, graphs and
all.

When a key is captured:
- one picture (``GroupGraphs.step``; ``picture``, through
  ``picture_step``, for the other forms) or a lockstep round
  (``GroupGraphs.round``): the first picture or round of a key that the
  set's current owner meets runs the eager step (the caller's
  ``decode_picture_packed2`` or ``decode_pictures_packed_batch``; for
  the other forms the graph's own body), which is its real decode and
  the warm-up; the key is
  captured at its second picture or round and replayed from then on, so
  a key met once never pays a capture;
- a frame group (``GroupGraphs.run``): its first group runs the step
  eagerly on the capture stream, for real (its frames are that group's
  output), then the step is captured.
So each picture's kernels run once, eagerly or in a replay, and the
wrappers' ``launches`` (and K2/K3's device counts) count what ran: a
replay adds what its graph recorded (``_build.count_launch``).

A capture is ``CUDAGraph.capture_begin`` / ``capture_end`` on a side
stream under one process-wide lock, then ``instantiate``. It does not
synchronise the card, collect garbage or empty the allocator's cache as
``torch.cuda.graph`` does on entry: the graph's memory comes from the
set's private pool, and nothing it records depends on work outside it.

A capture or a replay that fails raises; no path falls back to the eager
step. On the CPU there is no graph: the steps run eagerly, through the
plain versions.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.gpu import _build
from ..ops.gpu import peer as PEER
from ..ops.gpu import wavefront_kernels as KW
from . import spans as SP
from .packed import PackedLayout, PackedLayoutV2, host_arrays_layout, \
    pack_host_arrays
from .recon import TorchFrame, decode_host_arrays_slots, \
    decode_picture_packed_slots, decode_pictures_packed_group, \
    decode_pictures_packed_round

MAX_GRAPHS = 8          # graphs kept per stack set; the least recently used go
STAGING_DEPTH = 2       # pinned staging buffers per graph, written in turn
MAX_SETS = 4            # free stack sets kept per key; the oldest go

# one capture at a time in the process, so that the reserved bytes before
# and after a capture differ by what that capture added
_capture_lock = threading.Lock()


def runs_eagerly(dev: torch.device) -> bool:
    """Whether the steps on `dev` run eagerly: on the CPU, where there is
    no graph."""
    return dev.type == "cpu"


def graph_or_eager(graphs: "GroupGraphs", dev: torch.device, w_mbs: int,
                   h_mbs: int, graph, eager):
    """One step on `dev`, routed: on a card `graph()` (a ``GroupGraphs``
    call: the YUV of one picture, u8 [bytes], or of a round, u8 [B,
    bytes], from a replay or a capture; or None the first time the set's
    owner meets the key); then, and on the CPU, `eager()` (the step run
    eagerly: its ``TorchFrame``, or a round's list of them), counted as
    the eager route in ``graphs.counts``."""
    if not runs_eagerly(dev):
        yuv = graph()
        if yuv is not None:
            W, H = 16 * w_mbs, 16 * h_mbs
            if yuv.dim() == 1:
                return TorchFrame(yuv, W, H)
            return [TorchFrame(y, W, H) for y in yuv]
    graphs.counts["eager"] += 1
    t0 = SP.begin()
    out = eager()
    SP.end("step.eager", t0)
    return out


def picture_step(graphs: "GroupGraphs", kind: str, args: tuple, body,
                 buf: np.ndarray, slot: int, stack_y: torch.Tensor,
                 stack_c: torch.Tensor, rows: int,
                 workspace: torch.Tensor) -> TorchFrame:
    """One picture's step in another form than v2 (``PictureGraph``: kind
    "v1", "unpacked", "band" or "band_arrays"). body: (bufs u8 [1, size],
    stack_y, stack_c, slots int64 [1], workspace=) -> the picture's YUV u8
    [1, bytes], written into stack slot slots[0]; `args`, its static
    arguments, bound (the graph's key holds them). buf: its input, u8
    [size] on the host; slot: the stack slot it writes. On a card the
    graph of its key (``GroupGraphs.picture``, K2/K3 counters of `rows`);
    a key's first picture there, and every picture on the CPU, runs
    `body` eagerly on the same inputs with `workspace` (at least `rows`
    counters)."""
    dev = stack_y.device
    w_mbs, h_mbs = stack_y.shape[-1] // 16, stack_y.shape[-2] // 16
    return graph_or_eager(
        graphs, dev, w_mbs, h_mbs,
        lambda: graphs.picture(kind, args, buf, slot, stack_y, stack_c,
                               rows, body),
        lambda: TorchFrame(body(
            torch.from_numpy(buf[None]).to(dev), stack_y, stack_c,
            torch.full((1,), slot, dtype=torch.int64, device=dev),
            workspace=workspace)[0], 16 * w_mbs, 16 * h_mbs))


def mesh_step(graphs: "GroupGraphs", args: tuple, runs: Sequence[tuple],
              stacks: dict, buf: np.ndarray, slot: int, rows: int,
              run_body, gather_body, workspace: dict) -> TorchFrame:
    """One picture's band step over a mesh of several devices
    (``MeshGraph``, kind "band_mesh") -> its frame on the first device.
    runs: [(device, (band, ...))], the mesh's runs of consecutive bands on
    one device, in band order; stacks: {device: (stack_y, stack_c)} for
    every distinct device, the first the set's; run_body(bufs, stack_y,
    stack_c, bands, halo=, workspace=, fetch=) -> the bands' final
    planes, and gather_body(finals, stack_y, stack_c, slots, fetch=) ->
    the picture's YUV u8 [1, bytes], written into the slot: the bodies,
    `args` (their static arguments, in the key) bound. buf: the picture's
    input, u8 [size] on the host, sent to every device; slot: the stack
    slot it writes. On cards the graphs of its key (``GroupGraphs.mesh``,
    K2/K3 counters of `rows`); a key's first picture there, and every
    picture on the CPU, runs the bodies eagerly on the same inputs, their
    fetches ``copy_`` (ordered across devices by PyTorch), with
    `workspace` ({device: at least `rows` counters})."""
    dev0 = runs[0][0]
    ref_y = stacks[dev0][0]
    w_mbs, h_mbs = ref_y.shape[-1] // 16, ref_y.shape[-2] // 16

    def eager() -> TorchFrame:
        cards = list(stacks)
        ms = dict.fromkeys(cards, 0.0)
        bufs = {d: torch.from_numpy(buf[None]).to(d) for d in cards}
        finals = {}
        for dev, bands in runs:
            t0 = time.perf_counter()
            finals.update(zip(bands, run_body(
                bufs[dev], *stacks[dev], bands,
                halo=finals.get(bands[0] - 1), workspace=workspace[dev])))
            ms[dev] += time.perf_counter() - t0
        finals = [finals[k] for k in range(len(finals))]
        out = {}
        for d in cards:
            t0 = time.perf_counter()
            out[d] = gather_body(finals, *stacks[d], torch.full(
                (1,), slot, dtype=torch.int64, device=d))
            ms[d] += time.perf_counter() - t0
        graphs.card_ms = {str(d): 1e3 * t for d, t in ms.items()}
        return TorchFrame(out[dev0][0], 16 * w_mbs, 16 * h_mbs)

    return graph_or_eager(
        graphs, dev0, w_mbs, h_mbs,
        lambda: graphs.mesh(args, runs, stacks, buf, slot, rows, run_body,
                            gather_body),
        eager)


def v1_step(s: "StackSet", buf: np.ndarray, slot: int, lay: PackedLayout,
            kb: int, constrained_intra: bool, chroma_qp_offset: int
            ) -> TorchFrame:
    """The per-picture step of one v1 picture (buf u8 [size] on the host;
    its bucket kb, a static argument of the JAX step, in the key) on the
    set's stacks, under ``picture_step``'s routing."""
    args = (lay, kb, constrained_intra, chroma_qp_offset)
    body = functools.partial(decode_picture_packed_slots, lay=lay, kb=kb,
                             constrained_intra=constrained_intra,
                             chroma_qp_offset=chroma_qp_offset)
    return picture_step(s.graphs, "v1", args, body, buf, slot, s.stack_y,
                        s.stack_c, lay.h, s.progress)


def unpacked_step(s: "StackSet", arrs: dict, slot: int,
                  stack_y: torch.Tensor, stack_c: torch.Tensor,
                  chroma_qp_offset: int) -> TorchFrame:
    """The per-picture step of one picture's unpacked arrays
    (``recon.host_picture_arrays``, NumPy) on the stacks stack_y / stack_c
    of the set `s` (its own, or one stream's of a lockstep set), under
    ``picture_step``'s routing. The step's input is the arrays flattened
    into one buffer (``packed.pack_host_arrays``); its key holds their
    layout (an array whose shape changed makes another key) and the
    whole_conceal flag, which decides on the host whether K3 runs."""
    w_mbs, h_mbs = stack_y.shape[-1] // 16, stack_y.shape[-2] // 16
    layout = host_arrays_layout(arrs)
    conceal = bool(arrs["whole_conceal"])
    args = (layout, w_mbs, h_mbs, chroma_qp_offset, conceal)
    body = functools.partial(decode_host_arrays_slots, layout=layout,
                             w_mbs=w_mbs, h_mbs=h_mbs,
                             chroma_qp_offset=chroma_qp_offset,
                             whole_conceal=conceal)
    return picture_step(s.graphs, "unpacked", args, body,
                        pack_host_arrays(arrs, layout), slot, stack_y,
                        stack_c, h_mbs, s.progress)


def _wait_for_upload(events: list, previous: Optional[list] = None) -> None:
    """Wait until the copies out of a staging buffer have completed
    (`events`: recorded after the upload that last wrote it), so that it
    may be written again: each event is queried first and synchronized
    only while its copy is still in flight (the span ``graph.sync``,
    whether or not it blocked). `previous`: the events of the graph's
    last upload, through whichever buffer; None where the graph has one
    buffer, whose last upload `events` is. While recording, count the
    upload (``graph.uploads``), whether a copy out of this buffer was
    still in flight (``graph.sync_blocked``) and, by one query of each of
    `previous` before the wait, whether the last upload was
    (``graph.upload_ahead``)."""
    recording = SP.recording()
    if recording:
        SP.count("graph.uploads")
        if previous is not None and not all(ev.query() for ev in previous):
            SP.count("graph.upload_ahead")
    t0 = SP.begin()
    pending = [ev for ev in events if not ev.query()]
    for ev in pending:
        ev.synchronize()
    SP.end("graph.sync", t0)
    if recording and pending:
        SP.count("graph.sync_blocked")
        if previous is None:
            SP.count("graph.upload_ahead")


class GroupGraph:
    """The group step for one key, captured once and replayed. It owns
    its static inputs (bufs u8 [G, size] and its index, the slots int64
    [G], on the card, fed from a ring of STAGING_DEPTH pinned staging
    buffers, so that an upload waits only for the copies out of the buffer
    it rewrites, made STAGING_DEPTH uploads before), K2/K3's progress
    counters (so that two graphs never share them), and its static output
    (yuv u8 [G, bytes], overwritten by every replay)."""

    kind = "v2"       # what the graph steps: StackPool.stats reports it

    def __init__(self, ref_y: torch.Tensor, ref_c: torch.Tensor, group: int,
                 size: int, lay: PackedLayoutV2, bk: tuple,
                 constrained_intra: bool, chroma_qp_offset: int) -> None:
        self._setup(ref_y, ref_c, group, size, (group,), torch.int64, lay.h,
                    (lay, bk, constrained_intra, chroma_qp_offset))

    def _setup(self, ref_y: torch.Tensor, ref_c: torch.Tensor, group: int,
               size: int, index_shape: tuple, index_dtype: torch.dtype,
               rows: int, args: tuple) -> None:
        dev = ref_y.device
        if runs_eagerly(dev):
            raise ValueError(f"{type(self).__name__} runs on a CUDA device, "
                             f"not {dev}")
        self.ref_y, self.ref_c = ref_y, ref_c
        self.args = args
        self.group = group
        self.bufs = torch.empty((group, size), dtype=torch.uint8, device=dev)
        self.index = torch.zeros(index_shape, dtype=index_dtype, device=dev)
        pin = dev.type == "cuda"
        self._staging = [
            (torch.empty((group, size), dtype=torch.uint8, pin_memory=pin),
             torch.empty(index_shape, dtype=index_dtype, pin_memory=pin))
            for _ in range(STAGING_DEPTH)]
        # per staging buffer: the events after the copies out of it (none
        # before its first upload)
        self._copied = [[] for _ in range(STAGING_DEPTH)]
        self._turn = 0          # the staging buffer the next upload writes
        self.workspace = torch.zeros(rows, dtype=torch.int32, device=dev)
        # captured without instantiating, so that instantiate is timed apart
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.out = None
        self.launches = {}          # wrapper -> its launches in one replay
        self.device_launches = {}   # KW.INTRA / KW.DEBLOCK -> the same
        self.capture_ms = None      # capture + instantiate, host clock
        self.capture_parts = None   # {"enqueue_ms", "instantiate_ms"}
        self.pool_bytes = None      # what the capture added to the pool
        self.replays = 0

    @property
    def device(self) -> torch.device:
        return self.bufs.device

    def _upload(self, bufs: np.ndarray, index) -> None:
        """The buffers and the index (a group's slots, a round's table)
        into the static inputs, by copies on the current stream that do
        not block the host, out of the ring's next staging buffer; a
        staging buffer is rewritten only once the copies out of it have
        completed. Stream order keeps each copy behind the previous
        replay, so the inputs on the card stay one buffer."""
        index = np.asarray(index)
        if tuple(bufs.shape) != tuple(self.bufs.shape) or \
                index.shape != tuple(self.index.shape):
            raise ValueError(f"{tuple(bufs.shape)} buffers and an index of "
                             f"{index.shape} for a graph of "
                             f"{tuple(self.bufs.shape)} and "
                             f"{tuple(self.index.shape)}")
        k = self._turn
        last = self._copied[k - 1]      # the graph's previous upload's
        if last:
            _wait_for_upload(self._copied[k], last)
        host_bufs, host_index = self._staging[k]
        t0 = SP.begin()
        host_bufs.numpy()[...] = bufs
        host_index.numpy()[...] = index
        self.bufs.copy_(host_bufs, non_blocking=True)
        self.index.copy_(host_index, non_blocking=True)
        SP.end("graph.upload", t0)
        self._copied[k] = [torch.cuda.current_stream(
            self.bufs.device).record_event()]
        self._turn = (k + 1) % STAGING_DEPTH

    def _step(self) -> torch.Tensor:
        return decode_pictures_packed_group(
            self.bufs, self.ref_y, self.ref_c, self.index, *self.args,
            workspace=self.workspace)

    def _frames(self):
        """A replay's result: each picture's YUV as a copy of its own."""
        return [self.out[g].clone() for g in range(self.group)]

    def _record(self, stream: torch.cuda.Stream, pool) -> None:
        """Capture the step on `stream` into the memory pool `pool`
        (nothing runs), then instantiate it; keeps the launches it
        recorded, its cost by part and the bytes it added to the pool."""
        dev = self.bufs.device
        t_span = SP.begin()
        with _capture_lock:
            reserved = torch.cuda.memory_reserved(dev)
            KW.take_captured(KW.INTRA)       # nothing left from before
            KW.take_captured(KW.DEBLOCK)
            t0 = time.perf_counter()
            with _build.recorded_launches() as tally, \
                    torch.cuda.stream(stream):
                self.graph.capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                try:
                    self.out = self._step()
                finally:
                    self.graph.capture_end()
            t1 = time.perf_counter()
            self.graph.instantiate()
            t2 = time.perf_counter()
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            self.device_launches = {w: KW.take_captured(w)
                                    for w in (KW.INTRA, KW.DEBLOCK)}
        self.launches = dict(tally)
        self.capture_parts = {"enqueue_ms": 1e3 * (t1 - t0),
                              "instantiate_ms": 1e3 * (t2 - t1)}
        self.capture_ms = 1e3 * (t2 - t0)
        SP.end("graph.capture", t_span)

    def capture(self, bufs: np.ndarray, slots: Sequence[int],
                stream: torch.cuda.Stream, pool) -> torch.Tensor:
        """Decode this group eagerly on `stream` (the warm-up; its yuv
        [G, bytes] is returned), then capture the step on `stream` into
        the memory pool `pool`. Raises if the capture fails."""
        cur = torch.cuda.current_stream(self.bufs.device)
        self._upload(bufs, slots)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            yuv = self._step()
        yuv.record_stream(cur)
        cur.wait_stream(stream)
        self._record(stream, pool)
        return yuv

    def record_and_replay(self, bufs: np.ndarray, index,
                          stream: torch.cuda.Stream, pool):
        """For a key whose warm-up has run (its first picture or round,
        eagerly): upload these buffers and this index, capture the step on
        `stream` into `pool`, and replay it; returns as ``replay``."""
        self._upload(bufs, index)
        self._record(stream, pool)
        return self._launch()

    def replay(self, bufs: np.ndarray, index):
        """Run the captured step on new buffers and a new index; returns
        ``_frames``: copies, since the next replay overwrites the graph's
        output."""
        self._upload(bufs, index)
        return self._launch()

    def _launch(self):
        t0 = SP.begin()
        self.graph.replay()
        for wrapper, n in self.launches.items():
            _build.add_launches(wrapper, n)
        for which, n in self.device_launches.items():
            KW.add_launches(which, n)
        self.replays += 1
        frames = self._frames()
        SP.end("graph.replay", t0)
        return frames


class RoundGraph(GroupGraph):
    """The lockstep round for one key (``decode_pictures_packed_round``),
    captured once and replayed. Its static inputs are bufs u8 [B, size]
    and its index, the round's table int32 [2, B] (stack bases, which K1
    reads where they lie, and destination planes); it has K2/K3 counters
    of its own, int32 [B * h], and a static output yuv u8 [B, bytes]. The
    table carries the round's member streams and slots, so a round of
    other members with the same B and key replays this graph."""

    kind = "round"

    def __init__(self, stack_y: torch.Tensor, stack_c: torch.Tensor,
                 batch: int, size: int, lay: PackedLayoutV2, bk: tuple,
                 constrained_intra: bool, chroma_qp_offset: int) -> None:
        A, R = stack_y.shape[:2]
        self.n_ref = R
        self._setup(stack_y.view((A * R,) + stack_y.shape[2:]),
                    stack_c.view((A * R,) + stack_c.shape[2:]), batch, size,
                    (2, batch), torch.int32, batch * lay.h,
                    (lay, bk, constrained_intra, chroma_qp_offset))

    def _step(self) -> torch.Tensor:
        return decode_pictures_packed_round(
            self.bufs, self.ref_y, self.ref_c, self.index, self.n_ref,
            *self.args, workspace=self.workspace)

    def _frames(self) -> torch.Tensor:
        """A replay's result: one copy of yuv [B, bytes], whose rows are the
        round's frames (the eager round's are rows of one tensor too)."""
        return self.out.clone()


class PictureGraph(GroupGraph):
    """One picture's step in another form than the v2 buffer, captured
    once and replayed: ``kind`` "v1" (a v1 buffer,
    ``recon.decode_picture_packed_slots``), "unpacked" (the per-MB arrays
    flattened into one buffer, ``recon.decode_host_arrays_slots``), "band"
    or "band_arrays" (the band step of a one-card mesh,
    ``parallel.slices.decode_band_picture`` / ``decode_band_arrays``).
    Its static inputs are bufs u8 [1, size] and the slot int64 [1]; it has
    K2/K3 counters of its own, int32 [rows] (h, or a band's hb + 1 rows
    with the ghost row), and a static output yuv u8 [1, bytes]. `body`
    (bufs, ref_y, ref_c, slots, workspace=) -> yuv is the step, its static
    arguments bound: the caller's key holds them."""

    def __init__(self, kind: str, ref_y: torch.Tensor, ref_c: torch.Tensor,
                 size: int, rows: int, body) -> None:
        self.kind = kind
        self.body = body
        self._setup(ref_y, ref_c, 1, size, (1,), torch.int64, rows, ())

    def _step(self) -> torch.Tensor:
        return self.body(self.bufs, self.ref_y, self.ref_c, self.index,
                         workspace=self.workspace)


class MeshGraph:
    """The band step of a mesh over several cards for one key, captured
    once and replayed: the counterpart of the JAX package's
    ``jax.jit(shard_map(...))`` over a mesh of chips. A CUDA graph belongs
    to one card, so the step is a graph per run of consecutive bands on
    one card (``runs``; one a card on a mesh of distinct cards): the
    run's bands reconstructed and, with the idc-0 chain, deblocked, the
    first one's ghost row a peer copy of the previous run's last band
    (JAX's ``ppermute``); and a gather graph per card: every band into
    the picture there, the other cards' by peer copies (JAX's
    ``all_gather``), and the picture into that card's stacks.

    Order across cards is kept by external events inside the graphs: a
    run's graph records ``done[run]`` after its last band is final, and a
    graph that copies from that run waits on it just before the copy (so
    a card's reconstruction never waits on another's chain). A graph's
    wait takes the event's record that the host enqueued last, so the
    host replays every run's graph in band order, then every gather
    graph: each wait's record is already enqueued. Why the gather is a
    graph apart: it waits on every run, and the run graphs of later
    cards would be enqueued after it. Before a replay, each card's stream
    waits on an event that every other card recorded after its previous
    gather (on the host), so no run overwrites the final planes a gather
    of the previous picture still reads.

    Each graph is captured on its card's side stream (``side``: the
    set's, per card), under ``torch.cuda.device(card)``, one at a time in
    band order and under ``_capture_lock``; everything that crosses cards
    exists before the capture that reads it: a run's final planes are
    its graph's outputs, held here, and the copies are ``peer.copy``
    (a cudaMemcpyAsync on the receiver's stream), which allocates
    nothing. Each run has K2/K3 counters of its own (`rows`: hb + 1).
    Static inputs: bufs u8 [1, size] and the slot int64 [1] on every
    card, fed from one pinned staging buffer."""

    kind = "band_mesh"
    group = 1

    def __init__(self, runs: Sequence[tuple], stacks: dict, size: int,
                 rows: int, run_body, gather_body, side) -> None:
        self.runs = [(torch.device(d), tuple(ks)) for d, ks in runs]
        self.cards = list(dict.fromkeys(d for d, _ in self.runs))
        if any(runs_eagerly(d) for d in self.cards):
            raise ValueError("MeshGraph runs on CUDA devices, not "
                             f"{self.cards}")
        self.stacks = {d: stacks[d] for d in self.cards}
        self.run_body, self.gather_body = run_body, gather_body
        self._side = side
        self.bufs = {d: torch.empty((1, size), dtype=torch.uint8, device=d)
                     for d in self.cards}
        self.index = {d: torch.zeros((1,), dtype=torch.int64, device=d)
                      for d in self.cards}
        pin = self.cards[0].type == "cuda"
        self._host_bufs = torch.empty((1, size), dtype=torch.uint8,
                                      pin_memory=pin)
        self._host_index = torch.empty((1,), dtype=torch.int64,
                                       pin_memory=pin)
        self._uploaded = []     # events: the last upload from staging done
        self._gathered = {}     # card -> event after its last gather
        self.workspaces = [torch.zeros(rows, dtype=torch.int32, device=d)
                           for d, _ in self.runs]
        self.done = [torch.cuda.Event(external=True) for _ in self.runs]
        self.run_graphs = [torch.cuda.CUDAGraph(keep_graph=True)
                           for _ in self.runs]
        self.gather_graphs = {d: torch.cuda.CUDAGraph(keep_graph=True)
                              for d in self.cards}
        self._run_of = {k: r for r, (_, ks) in enumerate(self.runs)
                        for k in ks}
        self.finals = None      # each band's final planes (run outputs)
        self.out = None         # {card: yuv u8 [1, bytes]} (gather outputs)
        self.launches = {}
        self.device_launches = {}
        self.capture_ms = None
        self.capture_parts = None
        self.pool_bytes = None
        self.card_pool_bytes = None     # {card: bytes its captures added}
        self.card_capture_ms = None     # {card: enqueue ms of its captures}
        self.card_ms = None     # {card: host ms of its last replay's graphs}
        self.replays = 0

    @property
    def device(self) -> torch.device:
        return self.cards[0]

    def _upload(self, bufs: np.ndarray, index) -> None:
        """The buffer and the slot into every card's static inputs, by
        copies on each card's current stream that do not block the host;
        the staging buffer is rewritten only once the copies out of it
        have completed."""
        index = np.asarray(index)
        if tuple(bufs.shape) != tuple(self._host_bufs.shape) or \
                index.shape != tuple(self._host_index.shape):
            raise ValueError(f"{tuple(bufs.shape)} buffers and an index of "
                             f"{index.shape} for a graph of "
                             f"{tuple(self._host_bufs.shape)} and "
                             f"{tuple(self._host_index.shape)}")
        if self._uploaded:
            _wait_for_upload(self._uploaded)
        t0 = SP.begin()
        self._host_bufs.numpy()[...] = bufs
        self._host_index.numpy()[...] = index
        self._uploaded = []
        for d in self.cards:
            self.bufs[d].copy_(self._host_bufs, non_blocking=True)
            self.index[d].copy_(self._host_index, non_blocking=True)
            self._uploaded.append(torch.cuda.current_stream(d).record_event())
        SP.end("graph.upload", t0)

    def _fetch(self, card: torch.device):
        """The fetch of a capture on `card`: a piece of a band of the same
        card by ``copy_`` (its graph ran before on the card's stream); of
        another card's band by ``peer.copy``, after a wait on the event
        of that band's run (once a run in the capture)."""
        waited = set()

        def fetch(dst: torch.Tensor, src: torch.Tensor, band: int) -> None:
            r = self._run_of[band]
            if self.runs[r][0] == card:
                dst.copy_(src)
                return
            if r not in waited:
                self.done[r].wait(torch.cuda.current_stream(card))
                waited.add(r)
            PEER.copy(dst, src)
        return fetch

    def _capture(self, graph, card: torch.device, body):
        """Capture body() on `card`'s side stream into its pool."""
        stream, pool = self._side(card)
        with torch.cuda.device(card), torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                return body(stream)
            finally:
                graph.capture_end()

    def _record(self) -> None:
        """Capture every run's graph in band order, then every gather
        graph (nothing runs), and instantiate them; keeps the launches
        they recorded, their cost by part and the bytes they added to the
        cards' pools."""
        t_span = SP.begin()
        with _capture_lock:
            reserved = {d: torch.cuda.memory_reserved(d) for d in self.cards}
            KW.take_captured(KW.INTRA)
            KW.take_captured(KW.DEBLOCK)
            enqueue = dict.fromkeys(self.cards, 0.0)
            t0 = time.perf_counter()
            finals = {}
            with _build.recorded_launches() as tally:
                for r, (card, ks) in enumerate(self.runs):
                    def run(stream, r=r, card=card, ks=ks):
                        got = self.run_body(
                            self.bufs[card], *self.stacks[card], ks,
                            halo=finals.get(ks[0] - 1),
                            workspace=self.workspaces[r],
                            fetch=self._fetch(card))
                        self.done[r].record(stream)
                        return got
                    t = time.perf_counter()
                    finals.update(zip(ks, self._capture(self.run_graphs[r],
                                                        card, run)))
                    enqueue[card] += time.perf_counter() - t
                self.finals = [finals[k] for k in range(len(finals))]
                self.out = {}
                for card in self.cards:
                    t = time.perf_counter()
                    self.out[card] = self._capture(
                        self.gather_graphs[card], card,
                        lambda stream, card=card: self.gather_body(
                            self.finals, *self.stacks[card],
                            self.index[card], fetch=self._fetch(card)))
                    enqueue[card] += time.perf_counter() - t
            t1 = time.perf_counter()
            for g in self.run_graphs + list(self.gather_graphs.values()):
                g.instantiate()
            t2 = time.perf_counter()
            self.card_pool_bytes = {
                str(d): torch.cuda.memory_reserved(d) - reserved[d]
                for d in self.cards}
            self.device_launches = {w: KW.take_captured(w)
                                    for w in (KW.INTRA, KW.DEBLOCK)}
        self.pool_bytes = sum(self.card_pool_bytes.values())
        self.launches = dict(tally)
        self.card_capture_ms = {str(d): 1e3 * t for d, t in enqueue.items()}
        self.capture_parts = {"enqueue_ms": 1e3 * (t1 - t0),
                              "instantiate_ms": 1e3 * (t2 - t1)}
        self.capture_ms = 1e3 * (t2 - t0)
        SP.end("graph.capture", t_span)

    def record_and_replay(self, bufs: np.ndarray, index, stream=None,
                          pool=None):
        """For a key whose warm-up has run (its first picture, eagerly):
        upload these inputs, capture every graph (each card's side stream
        and pool: ``side``; `stream` and `pool`, the first card's, are
        those) and replay them; returns as ``replay``."""
        self._upload(bufs, index)
        self._record()
        return self._launch()

    def replay(self, bufs: np.ndarray, index, marks: dict = None):
        """Run the captured step on a new buffer and slot; returns [yuv of
        the first card, a copy: the next replay overwrites the output].
        marks, when given ({card: [torch.cuda.Event]}): two events of each
        card are recorded on its stream, after its runs' graphs and after
        its gather graph (a measurement's)."""
        self._upload(bufs, index)
        return self._launch(marks)

    def _launch(self, marks: dict = None):
        t_span = SP.begin()
        ms = dict.fromkeys(self.cards, 0.0)
        for card in self.cards:
            cur = torch.cuda.current_stream(card)
            for other, ev in self._gathered.items():
                if other != card:
                    cur.wait_event(ev)
        for (card, _), graph in zip(self.runs, self.run_graphs):
            t0 = time.perf_counter()
            with torch.cuda.device(card):
                graph.replay()
            ms[card] += time.perf_counter() - t0
        for card, evs in (marks or {}).items():
            evs[0].record(torch.cuda.current_stream(card))
        for card, graph in self.gather_graphs.items():
            t0 = time.perf_counter()
            with torch.cuda.device(card):
                graph.replay()
            self._gathered[card] = torch.cuda.current_stream(
                card).record_event()
            ms[card] += time.perf_counter() - t0
            if marks:
                marks[card][1].record(torch.cuda.current_stream(card))
        self.card_ms = {str(d): 1e3 * t for d, t in ms.items()}
        for wrapper, n in self.launches.items():
            _build.add_launches(wrapper, n)
        for which, n in self.device_launches.items():
            KW.add_launches(which, n)
        self.replays += 1
        frames = [self.out[self.cards[0]][0].clone()]
        SP.end("graph.replay", t_span)
        return frames


class GroupGraphs:
    """The graphs of one stack set: at most MAX_GRAPHS of them, least
    recently used dropped first, captured on one side stream into one
    memory pool that they share (the set's owner replays them one at a
    time, on its stream). ``met``: the one-picture and round keys that
    the current owner ran eagerly once; ``counts``: its steps by route,
    "eager" (a key's first picture or round, counted by the caller, which
    runs it), "captured" and "replayed" (graphs of one picture in any
    form, of a group or of a round); ``counted`` adds a span's to a
    caller's dict too."""

    def __init__(self) -> None:
        self._graphs = collections.OrderedDict()
        self._sides = {}         # device -> (side stream, memory pool)
        self.met = set()
        self.counts = {}
        # host ms by card of the newest step over a mesh of several cards
        # (``mesh_step``: its eager bodies, or its graphs' replays)
        self.card_ms = {}
        self.new_owner()

    def new_owner(self) -> None:
        """Forget the previous owner's met keys and counts (a lease)."""
        self.met.clear()
        self.counts = {"eager": 0, "captured": 0, "replayed": 0}

    def graphs(self) -> List[GroupGraph]:
        return list(self._graphs.values())

    @contextlib.contextmanager
    def counted(self, into: dict, prefix: str = ""):
        """Add the routes that the steps run inside take (``counts``) to
        `into` as well, each under prefix + its name."""
        before = dict(self.counts)
        try:
            yield
        finally:
            for route, n in self.counts.items():
                into[prefix + route] += n - before[route]

    def clear(self) -> None:
        """Drop every graph."""
        self._graphs.clear()

    @staticmethod
    def _stacks_key(ref_y, ref_c) -> tuple:
        """What a graph's key holds of the stacks it reads and writes."""
        return (ref_y.device, ref_y.data_ptr(), tuple(ref_y.shape),
                ref_c.data_ptr(), tuple(ref_c.shape))

    @classmethod
    def _key(cls, ref_y, ref_c, G: int, lay, bk, constrained_intra,
             chroma_qp_offset) -> tuple:
        return (lay, bk, constrained_intra, chroma_qp_offset, G) + \
            cls._stacks_key(ref_y, ref_c)

    def _get(self, key) -> Optional[GroupGraph]:
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            self.counts["replayed"] += 1
        return graph

    def _side(self, dev: torch.device) -> tuple:
        """(side stream, memory pool) of the set's captures on `dev`."""
        side = self._sides.get(dev)
        if side is None:
            side = self._sides[dev] = (torch.cuda.Stream(device=dev),
                                       torch.cuda.graph_pool_handle())
        return side

    def _keep(self, key, graph: GroupGraph) -> None:
        """A graph whose capture succeeded joins the cache."""
        self._graphs[key] = graph
        self.counts["captured"] += 1
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)

    def run(self, bufs: np.ndarray, slots: Sequence[int],
            ref_y: torch.Tensor, ref_c: torch.Tensor, lay: PackedLayoutV2,
            bk: tuple, constrained_intra: bool, chroma_qp_offset: int
            ) -> List[torch.Tensor]:
        """The group step on bufs u8 [G, size] (host, one bucket triple)
        and the G slots -> each picture's YUV. On the CPU, eagerly; on the
        card, the graph of this key: captured (after the eager warm-up,
        whose output this group gets) or replayed."""
        dev = ref_y.device
        G = bufs.shape[0]
        if runs_eagerly(dev):
            yuv = decode_pictures_packed_group(
                torch.from_numpy(bufs), ref_y, ref_c,
                torch.tensor(list(slots), dtype=torch.int64), lay, bk,
                constrained_intra, chroma_qp_offset)
            return list(yuv)
        args = (lay, bk, constrained_intra, chroma_qp_offset)
        key = self._key(ref_y, ref_c, G, *args)
        graph = self._get(key)
        if graph is not None:
            return graph.replay(bufs, slots)
        graph = GroupGraph(ref_y, ref_c, G, bufs.shape[1], *args)
        yuv = graph.capture(bufs, slots, *self._side(dev))
        self._keep(key, graph)
        return list(yuv)

    def step(self, buf: np.ndarray, slot: int, ref_y: torch.Tensor,
             ref_c: torch.Tensor, lay: PackedLayoutV2, bk: tuple,
             constrained_intra: bool, chroma_qp_offset: int
             ) -> Optional[torch.Tensor]:
        """The per-picture step of one v2 picture (buf u8 [size] on the
        host, its DPB slot) on the card, as the graph of its key: replayed
        when captured; captured and replayed when the current owner met
        the key before. Returns the picture's YUV u8 [bytes], or None the
        first time the owner meets the key: the caller then runs the eager
        step, the key's warm-up."""
        args = (lay, bk, constrained_intra, chroma_qp_offset)
        yuv = self._second_time(
            self._key(ref_y, ref_c, 1, *args), buf[None], [slot],
            lambda: GroupGraph(ref_y, ref_c, 1, buf.size, *args))
        return None if yuv is None else yuv[0]

    def round(self, bufs: np.ndarray, tab: np.ndarray,
              stack_y: torch.Tensor, stack_c: torch.Tensor,
              lay: PackedLayoutV2, bk: tuple, constrained_intra: bool,
              chroma_qp_offset: int) -> Optional[torch.Tensor]:
        """A lockstep round of B v2 pictures (bufs u8 [B, size] on the
        host, one bucket triple; tab int32 [2, B], ``recon.round_table``)
        on the A streams' stacks (stack_y [A, R, H, W], stack_c [A, R, 2,
        H/2, W/2]) on the card, as the graph of its key, which holds B but
        not the member streams: replayed when captured; captured and
        replayed when the current owner met the key before. Returns the
        round's YUV u8 [B, bytes] (a copy of the graph's output), or None
        the first time the owner meets the key: the caller then runs the
        eager round, the key's warm-up."""
        args = (lay, bk, constrained_intra, chroma_qp_offset)
        B = bufs.shape[0]
        return self._second_time(
            ("round",) + self._key(stack_y, stack_c, B, *args), bufs, tab,
            lambda: RoundGraph(stack_y, stack_c, B, bufs.shape[1], *args))

    def picture(self, kind: str, args: tuple, buf: np.ndarray, slot: int,
                stack_y: torch.Tensor, stack_c: torch.Tensor, rows: int,
                body) -> Optional[torch.Tensor]:
        """One picture's step in another form than v2 (``PictureGraph``:
        kind "v1", "unpacked", "band" or "band_arrays") on the card, as
        the graph of its key: the kind, `args` (the step's static
        arguments, which `body` has bound), the device and both stacks'
        address and shape; replayed when captured; captured and replayed
        when the current owner met the key before. buf: the step's input,
        u8 [size] on the host; slot: the stack slot it writes (an input
        of the graph, not of its key); rows: its K2/K3 counters. Returns
        the picture's YUV u8 [bytes], or None the first time the owner
        meets the key: the caller then runs the step eagerly, the key's
        warm-up (``picture_step``)."""
        key = (kind,) + tuple(args) + self._stacks_key(stack_y, stack_c)
        yuv = self._second_time(
            key, buf[None], [slot],
            lambda: PictureGraph(kind, stack_y, stack_c, buf.size, rows,
                                 body))
        return None if yuv is None else yuv[0]

    def mesh(self, args: tuple, runs: Sequence[tuple], stacks: dict,
             buf: np.ndarray, slot: int, rows: int, run_body,
             gather_body) -> Optional[torch.Tensor]:
        """The band step over a mesh of several cards (``MeshGraph``,
        ``mesh_step``'s arguments) as the graphs of its key: `args`, the
        runs (each card and its bands) and every card's stacks' address
        and shape; replayed when captured; captured and replayed when the
        current owner met the key before. Returns the picture's YUV u8
        [bytes] on the first card, or None the first time the owner meets
        the key: the caller then runs the bodies eagerly, the key's
        warm-up."""
        key = ("band_mesh",) + tuple(args) + \
            tuple((d, tuple(ks)) for d, ks in runs) + \
            tuple(self._stacks_key(*stacks[d]) for d in stacks)
        yuv = self._second_time(
            key, buf[None], [slot],
            lambda: MeshGraph(runs, stacks, buf.size, rows, run_body,
                              gather_body, self._side))
        if yuv is None:
            return None
        self.card_ms = self._graphs[key].card_ms
        return yuv[0]

    def _second_time(self, key: tuple, bufs: np.ndarray, index, make):
        """The graph of `key` on these inputs: replayed; or made by
        `make`, captured and replayed when the owner met the key once
        before; or None the first time (the key is then met)."""
        graph = self._get(key)
        if graph is not None:
            return graph.replay(bufs, index)
        if key not in self.met:
            self.met.add(key)
            return None
        graph = make()
        out = graph.record_and_replay(bufs, index,
                                      *self._side(graph.device))
        self._keep(key, graph)
        return out


class StackSet:
    """The reference-plane stacks of one geometry on one device: one
    stream's (stack_y u8 [R, H, W], stack_c u8 [R, 2, H/2, W/2]) or, for a
    lockstep group of A streams, all of theirs (stack_y [A, R, H, W],
    stack_c [A, R, 2, H/2, W/2]; ``streams`` = A); K2/K3's progress
    counters for the eager steps on them (a row of every stream's
    picture), and the graphs captured on them. Leased from a
    ``StackPool`` to one decoder or lockstep call at a time."""

    def __init__(self, device: torch.device, width: int, height: int,
                 R: int, streams: Optional[int] = None,
                 affinity=None) -> None:
        self.device = device
        self.geometry = (width, height, R)
        self.streams = streams
        self.affinity = affinity   # the pool tag of every lease it serves
        lead = () if streams is None else (streams,)
        self.stack_y = torch.zeros(lead + (R, height, width),
                                   dtype=torch.uint8, device=device)
        self.stack_c = torch.zeros(lead + (R, 2, height // 2, width // 2),
                                   dtype=torch.uint8, device=device)
        self.progress = torch.zeros((streams or 1) * (height // 16),
                                    dtype=torch.int32, device=device)
        self.graphs = GroupGraphs()
        # sets on other devices leased beside this one for its owner (a
        # band mesh's mirrors: device -> StackSet), given back with it
        self.companions = {}
        self._used = {}          # the CUDA streams the owner's work ran on
        self._returned = []      # events recorded on them at its return

    @property
    def key(self) -> tuple:
        """What the pool files it under: (device, A or None, tag or None,
        width, height, R)."""
        return (self.device, self.streams, self.affinity) + self.geometry

    def note_stream(self) -> None:
        """Note the stream current on this thread as one that the owner's
        work on these stacks runs on: their return is ordered after it."""
        if self.device.type == "cuda":
            s = torch.cuda.current_stream(self.device)
            self._used[s.cuda_stream] = s

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.stack_y, self.stack_c, self.progress))


class StackPool:
    """Stack sets by (device, A, tag, width, height, R): A None for a
    decoder's set and the number of streams for a lockstep group's, the
    tag the holder's (``lease``'s affinity), so that no set is ever
    handed across them. ``lease`` hands out a set that nobody else holds
    (of its key, the free one returned last, zeroed after its previous
    owner's last work, or a new one); ``release`` takes it back, and
    keeps at most MAX_SETS free sets a key (the oldest go, with their
    graphs)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._free = {}                  # key -> [StackSet], oldest first
        self._leased = weakref.WeakSet()

    def lease(self, device, width: int, height: int, R: int,
              streams: Optional[int] = None, affinity=None) -> StackSet:
        """A set of one stream's stacks, or with `streams` = A the stacks
        of a lockstep group of A streams. affinity: a hashable tag of the
        holder (a kind of decoder, or one stream of several): only the
        holders of the same tag share sets, so the graphs of a set hold
        its holders' keys, whatever the order of other holders' leases
        and returns."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (device, streams, affinity, width, height, R)
        with self._lock:
            free = self._free.get(key)
            s = free.pop() if free else None
        if s is None:
            s = StackSet(device, width, height, R, streams, affinity)
        else:
            if device.type == "cuda":
                cur = torch.cuda.current_stream(device)
                for ev in s._returned:
                    cur.wait_event(ev)
            s._returned = []
            s.stack_y.zero_()
            s.stack_c.zero_()
        s.graphs.new_owner()
        s.note_stream()
        with self._lock:
            self._leased.add(s)
        return s

    def release(self, s: StackSet) -> None:
        """Take back a leased set, and its companions: an event on each
        stream its owner's work ran on orders its next lease after that
        work."""
        companions, s.companions = s.companions, {}
        for c in companions.values():
            self.release(c)
        if s.device.type == "cuda":
            s._returned = [st.record_event() for st in s._used.values()]
        s._used = {}
        with self._lock:
            self._leased.discard(s)
            free = self._free.setdefault(s.key, [])
            free.append(s)
            del free[:-MAX_SETS]

    def clear(self) -> None:
        """Drop every free set and its graphs."""
        with self._lock:
            self._free.clear()

    def stats(self, lockstep: Optional[bool] = None) -> dict:
        """Sets (free and leased), graphs and bytes: the stacks' own, and
        what the graphs' captures added to their pools; each graph's
        capture (kind, G or B, ms by part, pool bytes, replays).
        lockstep: True counts only the lockstep groups' sets, False only
        the decoders', None both."""
        with self._lock:
            leased = list(self._leased)
            sets = leased + [s for free in self._free.values() for s in free]
        if lockstep is not None:
            keep = lambda s: (s.streams is not None) == lockstep
            leased = [s for s in leased if keep(s)]
            sets = [s for s in sets if keep(s)]
        graphs = [g for s in sets for g in s.graphs.graphs()]
        return {"sets": len(sets), "leased": len(leased),
                "stack_bytes": sum(s.nbytes() for s in sets),
                "graphs": len(graphs),
                "graph_pool_bytes": sum(g.pool_bytes or 0 for g in graphs),
                "captures": [{"kind": g.kind, "pictures": g.group,
                              "capture_ms": g.capture_ms,
                              "capture_parts_ms": g.capture_parts,
                              "pool_bytes": g.pool_bytes,
                              "replays": g.replays} for g in graphs]}


STACK_POOL = StackPool()      # the process's: graphs live as long as it
