"""CUDA graphs of the per-picture and frame-group steps, and the
process-wide pool of reference-stack sets that they are captured on.

The JAX package runs a picture's whole device step as one jit call
(``recon_tpu.decode_picture_packed2``) and a frame group as another
(``decode_pictures_packed_group``): one compiled executable per set of
static arguments, in a cache that lives as long as the process. The
counterpart here is one CUDA graph per key, captured from
``core.recon.decode_pictures_packed_group`` (with G = 1 for one picture:
the slot is an input on the card, as the jit's slot is a traced
argument) and replayed for every later picture or group of that key:
the ~600 x G device operations go to the card in one launch instead of
being enqueued op by op from Python.

Key: the JAX static arguments (layout, bucket triple, constrained_intra,
chroma_qp_offset), G, the device, and the address and shape of both
reference stacks, which the graph has baked in. So that graphs outlive a
``Decoder``, as the jit cache does, the stacks come from a pool
(``StackPool``; the process's is ``STACK_POOL``): a ``StackSet`` owns its
stacks, K2/K3's progress counters for its eager steps and the graphs
captured on it (``GroupGraphs``, each graph with counters of its own),
and is leased to one decoder at a time. The next decoder of the same
geometry gets it back zeroed, graphs and all.

When a key is captured:
- one picture (``GroupGraphs.step``): the first picture of a key that
  the set's current owner meets runs the eager step (the caller's
  ``decode_picture_packed2``), which is its real decode and the warm-up;
  the key is captured at its second picture and replayed from then on,
  so a key met once never pays a capture;
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
import threading
import time
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.gpu import _build
from ..ops.gpu import wavefront_kernels as KW
from .packed import PackedLayoutV2
from .recon import decode_pictures_packed_group

MAX_GRAPHS = 8          # graphs kept per stack set; the least recently used go
MAX_SETS = 4            # free stack sets kept per geometry; the oldest go

# one capture at a time in the process, so that the reserved bytes before
# and after a capture differ by what that capture added
_capture_lock = threading.Lock()


def runs_eagerly(dev: torch.device) -> bool:
    """Whether the steps on `dev` run eagerly: on the CPU, where there is
    no graph."""
    return dev.type == "cpu"


class GroupGraph:
    """The group step for one key, captured once and replayed. It owns
    its static inputs (bufs u8 [G, size] and slots int64 [G] on the card,
    fed from pinned staging buffers), K2/K3's progress counters (so that
    two graphs never share them), and its static output (yuv u8 [G,
    bytes], overwritten by every replay)."""

    def __init__(self, ref_y: torch.Tensor, ref_c: torch.Tensor, group: int,
                 size: int, lay: PackedLayoutV2, bk: tuple,
                 constrained_intra: bool, chroma_qp_offset: int) -> None:
        dev = ref_y.device
        if runs_eagerly(dev):
            raise ValueError(f"GroupGraph runs on a CUDA device, not {dev}")
        self.ref_y, self.ref_c = ref_y, ref_c
        self.args = (lay, bk, constrained_intra, chroma_qp_offset)
        self.group = group
        self.bufs = torch.empty((group, size), dtype=torch.uint8, device=dev)
        self.slots = torch.zeros(group, dtype=torch.int64, device=dev)
        pin = dev.type == "cuda"
        self._host_bufs = torch.empty((group, size), dtype=torch.uint8,
                                      pin_memory=pin)
        self._host_slots = torch.empty(group, dtype=torch.int64,
                                       pin_memory=pin)
        self._uploaded = None    # event: the last upload from staging done
        self.workspace = torch.zeros(lay.h, dtype=torch.int32, device=dev)
        # captured without instantiating, so that instantiate is timed apart
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.out = None
        self.launches = {}          # wrapper -> its launches in one replay
        self.device_launches = {}   # KW.INTRA / KW.DEBLOCK -> the same
        self.capture_ms = None      # capture + instantiate, host clock
        self.capture_parts = None   # {"enqueue_ms", "instantiate_ms"}
        self.pool_bytes = None      # what the capture added to the pool
        self.replays = 0

    def _upload(self, bufs: np.ndarray, slots: Sequence[int]) -> None:
        """The group's buffers and slots into the static inputs, by copies
        on the current stream that do not block the host; a staging
        buffer is rewritten only once the copy out of it has completed."""
        if tuple(bufs.shape) != tuple(self.bufs.shape) or \
                len(slots) != self.group:
            raise ValueError(f"{tuple(bufs.shape)} buffers and {len(slots)} "
                             f"slots for a graph of {tuple(self.bufs.shape)}")
        if self._uploaded is not None:
            self._uploaded.synchronize()
        self._host_bufs.numpy()[...] = bufs
        self._host_slots.numpy()[...] = slots
        self.bufs.copy_(self._host_bufs, non_blocking=True)
        self.slots.copy_(self._host_slots, non_blocking=True)
        self._uploaded = torch.cuda.current_stream(
            self.bufs.device).record_event()

    def _step(self) -> torch.Tensor:
        return decode_pictures_packed_group(
            self.bufs, self.ref_y, self.ref_c, self.slots, *self.args,
            workspace=self.workspace)

    def _record(self, stream: torch.cuda.Stream, pool) -> None:
        """Capture the step on `stream` into the memory pool `pool`
        (nothing runs), then instantiate it; keeps the launches it
        recorded, its cost by part and the bytes it added to the pool."""
        dev = self.bufs.device
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

    def record_and_replay(self, bufs: np.ndarray, slots: Sequence[int],
                          stream: torch.cuda.Stream, pool
                          ) -> List[torch.Tensor]:
        """For a key whose warm-up has run (its first picture, eagerly):
        upload this group's buffers and slots, capture the step on
        `stream` into `pool`, and replay it; returns as ``replay``."""
        self._upload(bufs, slots)
        self._record(stream, pool)
        return self._launch()

    def replay(self, bufs: np.ndarray, slots: Sequence[int]
               ) -> List[torch.Tensor]:
        """Run the captured step on new buffers and slots; returns each
        picture's YUV as a copy of its own (the next replay overwrites the
        graph's output)."""
        self._upload(bufs, slots)
        return self._launch()

    def _launch(self) -> List[torch.Tensor]:
        self.graph.replay()
        for wrapper, n in self.launches.items():
            _build.add_launches(wrapper, n)
        for which, n in self.device_launches.items():
            KW.add_launches(which, n)
        self.replays += 1
        return [self.out[g].clone() for g in range(self.group)]


class GroupGraphs:
    """The graphs of one stack set: at most MAX_GRAPHS of them, least
    recently used dropped first, captured on one side stream into one
    memory pool that they share (the set's owner replays them one at a
    time, on its stream). ``met``: the one-picture keys that the current
    owner ran eagerly once; ``counts``: its steps by route, "eager" (a
    key's first picture, counted by the caller, which runs it),
    "captured" and "replayed" (graphs of one picture or of a group)."""

    def __init__(self) -> None:
        self._graphs = collections.OrderedDict()
        self._pool = None
        self._stream = None
        self.met = set()
        self.counts = {}
        self.new_owner()

    def new_owner(self) -> None:
        """Forget the previous owner's met keys and counts (a lease)."""
        self.met.clear()
        self.counts = {"eager": 0, "captured": 0, "replayed": 0}

    def graphs(self) -> List[GroupGraph]:
        return list(self._graphs.values())

    def clear(self) -> None:
        """Drop every graph."""
        self._graphs.clear()

    @staticmethod
    def _key(ref_y, ref_c, G: int, lay, bk, constrained_intra,
             chroma_qp_offset) -> tuple:
        return (lay, bk, constrained_intra, chroma_qp_offset, G,
                ref_y.device, ref_y.data_ptr(), tuple(ref_y.shape),
                ref_c.data_ptr(), tuple(ref_c.shape))

    def _get(self, key) -> Optional[GroupGraph]:
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            self.counts["replayed"] += 1
        return graph

    def _new(self, ref_y, ref_c, G: int, size: int, *args) -> GroupGraph:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device=ref_y.device)
        return GroupGraph(ref_y, ref_c, G, size, *args)

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
        graph = self._new(ref_y, ref_c, G, bufs.shape[1], *args)
        yuv = graph.capture(bufs, slots, self._stream, self._pool)
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
        key = self._key(ref_y, ref_c, 1, *args)
        graph = self._get(key)
        if graph is not None:
            return graph.replay(buf[None], [slot])[0]
        if key not in self.met:
            self.met.add(key)
            return None
        graph = self._new(ref_y, ref_c, 1, buf.size, *args)
        yuv = graph.record_and_replay(buf[None], [slot], self._stream,
                                      self._pool)
        self._keep(key, graph)
        return yuv[0]


class StackSet:
    """The reference-plane stacks of one geometry on one device (stack_y
    u8 [R, H, W], stack_c u8 [R, 2, H/2, W/2]), K2/K3's progress counters
    for the eager steps on them, and the graphs captured on them. Leased
    from a ``StackPool`` to one decoder at a time."""

    def __init__(self, device: torch.device, width: int, height: int,
                 R: int) -> None:
        self.device = device
        self.geometry = (width, height, R)
        self.stack_y = torch.zeros((R, height, width), dtype=torch.uint8,
                                   device=device)
        self.stack_c = torch.zeros((R, 2, height // 2, width // 2),
                                   dtype=torch.uint8, device=device)
        self.progress = torch.zeros(height // 16, dtype=torch.int32,
                                    device=device)
        self.graphs = GroupGraphs()
        self._streams = {}       # the streams the owner's work ran on
        self._returned = []      # events recorded on them at its return

    def note_stream(self) -> None:
        """Note the stream current on this thread as one that the owner's
        work on these stacks runs on: their return is ordered after it."""
        if self.device.type == "cuda":
            s = torch.cuda.current_stream(self.device)
            self._streams[s.cuda_stream] = s

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.stack_y, self.stack_c, self.progress))


class StackPool:
    """Stack sets by (device, width, height, R). ``lease`` hands out a set
    that no other decoder holds (a free one, zeroed after its previous
    owner's last work, or a new one); ``release`` takes it back, and keeps
    at most MAX_SETS free sets a geometry (the oldest go, with their
    graphs)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._free = {}                  # key -> [StackSet], oldest first
        self._leased = weakref.WeakSet()

    def lease(self, device, width: int, height: int, R: int) -> StackSet:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (device, width, height, R)
        with self._lock:
            free = self._free.get(key)
            s = free.pop() if free else None
        if s is None:
            s = StackSet(device, width, height, R)
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
        """Take back a leased set: an event on each stream its owner's
        work ran on orders its next lease after that work."""
        if s.device.type == "cuda":
            s._returned = [st.record_event() for st in s._streams.values()]
        s._streams = {}
        key = (s.device,) + s.geometry
        with self._lock:
            self._leased.discard(s)
            free = self._free.setdefault(key, [])
            free.append(s)
            del free[:-MAX_SETS]

    def clear(self) -> None:
        """Drop every free set and its graphs."""
        with self._lock:
            self._free.clear()

    def stats(self) -> dict:
        """Sets (free and leased), graphs and bytes: the stacks' own, and
        what the graphs' captures added to their pools."""
        with self._lock:
            leased = list(self._leased)
            sets = leased + [s for free in self._free.values() for s in free]
        graphs = [g for s in sets for g in s.graphs.graphs()]
        return {"sets": len(sets), "leased": len(leased),
                "stack_bytes": sum(s.nbytes() for s in sets),
                "graphs": len(graphs),
                "graph_pool_bytes": sum(g.pool_bytes or 0 for g in graphs)}


STACK_POOL = StackPool()      # the process's: graphs live as long as it
