"""CUDA graphs of the frame-group step (``Decoder(group_frames=G)``).

The JAX package runs a frame group as one jit call
(``recon_tpu.decode_pictures_packed_group``): one compiled executable per
set of static arguments. The counterpart here is one CUDA graph per key,
captured from ``core.recon.decode_pictures_packed_group`` and replayed for
every later group of that key: the ~600 x G device operations of G
per-picture steps go to the card in one launch instead of being enqueued
op by op from Python.

Key: the JAX static arguments (layout, bucket triple, constrained_intra,
chroma_qp_offset, G), the device, and the address and shape of both
reference stacks, which the graph has baked in.

The first group of a key runs the step eagerly on the capture stream, for
real: its frames are that group's output. That run is the warm-up, which
builds the lazy constant tables and everything else that has to exist
outside the graph's memory pool. Then the step is captured (nothing runs
while it is captured), and every later group of the key replays it. So
each picture's kernels run once, in the warm-up or in a replay, and the
wrappers' ``launches`` (and K2/K3's device counts) count what ran: a
replay adds what its graph recorded (``_build.count_launch``).

A capture or a replay that fails raises; no path falls back to the eager
step. On the CPU there is no graph: the group step runs eagerly, through
the plain versions.
"""

from __future__ import annotations

import collections
import gc
import threading
import time
from typing import List, Sequence

import numpy as np
import torch

from ..ops.gpu import _build
from ..ops.gpu import wavefront_kernels as KW
from .packed import PackedLayoutV2
from .recon import decode_pictures_packed_group

MAX_GRAPHS = 8          # graphs kept per decoder; the least recently used go

# one capture at a time in the process: a capture synchronises the card
# and empties the allocator's cache, which must not interleave with
# another capture's
_capture_lock = threading.Lock()


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
        if dev.type != "cuda":
            raise ValueError(f"GroupGraph runs on a CUDA device, not {dev}")
        self.ref_y, self.ref_c = ref_y, ref_c
        self.args = (lay, bk, constrained_intra, chroma_qp_offset)
        self.group = group
        self.bufs = torch.empty((group, size), dtype=torch.uint8, device=dev)
        self.slots = torch.zeros(group, dtype=torch.int64, device=dev)
        self._host_bufs = torch.empty((group, size), dtype=torch.uint8,
                                      pin_memory=True)
        self._host_slots = torch.empty(group, dtype=torch.int64,
                                       pin_memory=True)
        self._uploaded = None    # event: the last upload from staging done
        self.workspace = torch.zeros(lay.h, dtype=torch.int32, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        self.out = None
        self.launches = {}          # wrapper -> its launches in one replay
        self.device_launches = {}   # KW.INTRA / KW.DEBLOCK -> the same
        self.capture_ms = None      # capture + instantiate, host clock
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

    def capture(self, bufs: np.ndarray, slots: Sequence[int],
                stream: torch.cuda.Stream, pool) -> torch.Tensor:
        """Decode this group eagerly on `stream` (the warm-up; its yuv
        [G, bytes] is returned), then capture the step on `stream` into
        the memory pool `pool`. Raises if the capture fails."""
        dev = self.bufs.device
        cur = torch.cuda.current_stream(dev)
        self._upload(bufs, slots)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            yuv = self._step()
        yuv.record_stream(cur)
        cur.wait_stream(stream)
        with _capture_lock:
            # torch.cuda.graph does all three again on entry; done here
            # first so that the reserved bytes before and after differ by
            # what the capture added to the pool
            torch.cuda.synchronize(dev)
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            KW.take_captured(KW.INTRA)       # nothing left from before
            KW.take_captured(KW.DEBLOCK)
            t0 = time.perf_counter()
            with _build.recorded_launches() as tally:
                with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.out = self._step()
            self.capture_ms = 1e3 * (time.perf_counter() - t0)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = dict(tally)
        self.device_launches = {w: KW.take_captured(w)
                                for w in (KW.INTRA, KW.DEBLOCK)}
        return yuv

    def replay(self, bufs: np.ndarray, slots: Sequence[int]
               ) -> List[torch.Tensor]:
        """Run the captured step on new buffers and slots; returns each
        picture's YUV as a copy of its own (the next replay overwrites the
        graph's output)."""
        self._upload(bufs, slots)
        self.graph.replay()
        for wrapper, n in self.launches.items():
            _build.add_launches(wrapper, n)
        for which, n in self.device_launches.items():
            KW.add_launches(which, n)
        self.replays += 1
        return [self.out[g].clone() for g in range(self.group)]


class GroupGraphs:
    """One decoder's group graphs: at most MAX_GRAPHS of them, least
    recently used dropped first, captured on one side stream into one
    memory pool that they share (a decoder replays them one at a time, on
    one stream)."""

    def __init__(self) -> None:
        self._graphs = collections.OrderedDict()
        self._pool = None
        self._stream = None

    def graphs(self) -> List[GroupGraph]:
        return list(self._graphs.values())

    def clear(self) -> None:
        """Drop every graph (the stacks they were captured on are gone)."""
        self._graphs.clear()

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
        if dev.type == "cpu":
            yuv = decode_pictures_packed_group(
                torch.from_numpy(bufs), ref_y, ref_c,
                torch.tensor(list(slots), dtype=torch.int64), lay, bk,
                constrained_intra, chroma_qp_offset)
            return list(yuv)
        key = (lay, bk, constrained_intra, chroma_qp_offset, G, dev,
               ref_y.data_ptr(), tuple(ref_y.shape), ref_c.data_ptr(),
               tuple(ref_c.shape))
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            return graph.replay(bufs, slots)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device=dev)
        graph = GroupGraph(ref_y, ref_c, G, bufs.shape[1], lay, bk,
                           constrained_intra, chroma_qp_offset)
        yuv = graph.capture(bufs, slots, self._stream, self._pool)
        self._graphs[key] = graph
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return list(yuv)
