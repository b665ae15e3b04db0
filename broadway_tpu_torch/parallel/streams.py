"""Multi-stream (data-parallel) decode on one device: the port's form of
the reference's multi-instance / multi-player parallelism
(Decoder/src/TestBenchMultipleInstance.c, Player/storyDemo.html's
6-player matrix), counterpart of ``broadway_tpu/parallel/streams.py``.

Several streams of one resolution decode in LOCKSTEP: each stream parses
on its own thread with its own ``Decoder``; the pictures that are ready
form a round, and the round runs through the pixel pipeline as ONE batch
(``core.recon.decode_pictures_packed_batch``): the unpack, residual and
parameter ops once for all of them, K1, K2 and K3 one launch each. On the
TPU the streams share the kernels' lane axis; here they are more CTAs per
launch, and for the two wavefront kernels as many independent hand-off
chains side by side.

As the JAX package jits the round, the card runs it as one CUDA graph per
key (``core.graphs.GroupGraphs.round``: layout, bucket triple, picture
parameters, B and the stacks; the member streams and slots are an input
on the card): a key's first round in a call runs eagerly, its second is
captured, the rest replay. The A streams' stacks are a set leased from
``core.graphs.STACK_POOL`` for the call, so the graphs outlive it and a
later call of the same geometry and A captures nothing. A picture that
the v2 packer declines takes the unpacked step alone on its stream's
stacks, on a card as the unpacked graph of its key under the same policy
(``core.graphs.unpacked_step``).

``make_dp_mesh`` / ``shard_batch`` are the device-list form of the JAX
package's mesh helpers. Not ported, because they serve its compile
service: the chunked device batch after a failed compile and the
interpret-mode switch.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core import decoder as DEC
from ..core import graphs as GR
from ..core import packed as PK
from ..core import recon as RC


def decode_pictures_batch(arrs: Dict[str, torch.Tensor], ref_y: torch.Tensor,
                          ref_c: torch.Tensor, w_mbs: int, h_mbs: int,
                          chroma_qp_offset: int):
    """Batched decode of the unpacked per-MB arrays: arrs [B, n, ...] per
    key (``whole_conceal`` [B]), ref_y [B, R, H, W], ref_c
    [B, R, 2, H/2, W/2] -> (Y [B, H, W], C [B, 2, H/2, W/2]). One pass of
    ``core.recon.decode_picture`` with the streams one after the other on
    the MB axis; the stacks are not written."""
    B, R = ref_y.shape[:2]
    flat = {k: (v.reshape(B) if k == "whole_conceal"
                else v.reshape((-1,) + v.shape[2:])) for k, v in arrs.items()}
    return RC.decode_picture(
        flat, ref_y.reshape((B * R,) + ref_y.shape[2:]),
        ref_c.reshape((B * R,) + ref_c.shape[2:]), w_mbs, h_mbs,
        chroma_qp_offset, batch=B)


class LockstepAborted(RuntimeError):
    """Another stream of the group failed, or a round timed out."""


class _LockstepSync:
    """Dynamic-membership round coordinator for lockstep decode.

    Each round completes when every ACTIVE stream has arrived; streams
    leave when their bitstream ends, so streams with fewer pictures do
    not hold up the rest. The last arrival of a round is elected leader
    (it runs the batched decode) and then releases the round. All waits
    carry a timeout so a wedged stream aborts the group instead of
    hanging forever."""

    def __init__(self, n: int, timeout: float = 300.0) -> None:
        self._cv = threading.Condition()
        self._active = n
        self._arrived = 0
        self._round = 0
        self._leader_claimed = False
        self._aborted = False
        self._timeout = timeout

    def abort(self) -> None:
        with self._cv:
            self._aborted = True
            self._cv.notify_all()

    def leave(self) -> None:
        with self._cv:
            self._active -= 1
            self._cv.notify_all()

    def arrive_and_wait(self) -> bool:
        """Returns True on the thread elected round leader; that
        thread must call release() after publishing results."""
        with self._cv:
            r = self._round
            self._arrived += 1
            self._cv.notify_all()
            deadline = time.monotonic() + self._timeout
            while True:
                if self._aborted:
                    raise LockstepAborted("lockstep aborted")
                if self._round != r:
                    return False
                if self._arrived >= self._active \
                        and not self._leader_claimed:
                    self._leader_claimed = True
                    return True
                if not self._cv.wait(
                        timeout=max(deadline - time.monotonic(), 0.0)):
                    self._aborted = True
                    self._cv.notify_all()
                    raise LockstepAborted(
                        "lockstep round timed out (wedged stream?)")

    def release(self) -> None:
        with self._cv:
            self._arrived = 0
            self._round += 1
            self._leader_claimed = False
            self._cv.notify_all()


def _round_step(stacks: GR.StackSet, bufs: np.ndarray, sub: List[int],
                slots: List[int], lay: PK.PackedLayoutV2, bk: tuple,
                ci: bool, co: int) -> List[RC.TorchFrame]:
    """One batched step of a round (bufs u8 [B, size] on the host, the
    member streams `sub` and their slots) on a lockstep set's stacks. On a
    card the graph of its key (``GroupGraphs.round``: replayed, or captured
    at the key's second round for this holder); a key's first round there,
    and every round on the CPU, runs the eager step."""
    dev = stacks.device
    return GR.graph_or_eager(
        stacks.graphs, dev, lay.w, lay.h,
        lambda: stacks.graphs.round(
            bufs, RC.round_table(sub, slots, *stacks.stack_y.shape[:2]),
            stacks.stack_y, stacks.stack_c, lay, bk, ci, co),
        lambda: RC.decode_pictures_packed_batch(
            torch.from_numpy(bufs).to(dev), stacks.stack_y, stacks.stack_c,
            slots, lay, bk, ci, co, streams=sub,
            workspace=stacks.progress))


class _Staged:
    """One stream's picture, waiting for its round."""

    __slots__ = ("kind", "payload", "bk", "slot", "w", "h", "R", "ci", "co")

    def __init__(self, kind, payload, bk, slot, w, h, R, ci, co) -> None:
        self.kind, self.payload, self.bk = kind, payload, bk
        self.slot, self.w, self.h, self.R = slot, w, h, R
        self.ci, self.co = ci, co


def decode_streams_lockstep(datas: Sequence[bytes], device="cuda",
                            parallel_slices: int = 4, fetch: bool = True,
                            stats: dict = None) -> List[list]:
    """End-to-end lockstep decode of N error-free streams of one
    resolution on ONE device ("cuda" launches the kernels, "cpu" runs
    their plain versions): each picture round batches the active streams'
    packed v2 buffers through one pipeline pass (one upload, one unpack,
    K1 / K2 / K3 one launch each). Returns per-stream display-order frames
    (bytes when fetch=True, else the decoders' output pictures with their
    frames on the device, after one synchronize).

    Picture COUNTS may differ: a stream that ends leaves the lockstep and
    the rest go on at a smaller batch, reading their reference stacks
    where they lie. A picture the v2 packer declines runs that stream
    alone through the unpacked path (``host_picture_arrays``) against its
    own stacks in the same round. An exception in any stream aborts all
    and is re-raised; a picture with lost or damaged MBs raises, because
    its concealed frame would never reach the shared stacks.

    stats, when given, receives "rounds", "batches" (the size of every
    batched step, in order), "fallbacks" (pictures that took the
    unpacked path), "routes" (the batched steps by route: "eager",
    "captured", "replayed"; on the CPU all eager), "fallback_routes"
    (the same for the fallbacks: on a card one graph per stream's stacks
    and key, ``core.graphs.unpacked_step``) and "keys" (the distinct keys
    of the batched steps: B, bucket triple, picture parameters)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("decode_streams_lockstep(device='cuda'): CUDA is "
                           "not available")
    A = len(datas)
    sync = _LockstepSync(A)
    staging: List[_Staged] = [None] * A
    results = [None] * A
    state = {"key": None, "set": None, "done": None}
    count = {"rounds": 0, "batches": [], "fallbacks": 0,
             "routes": {"eager": 0, "captured": 0, "replayed": 0},
             "fallback_routes": {"eager": 0, "captured": 0, "replayed": 0}}
    keys = set()

    def give_back() -> None:
        """Return the lockstep set to the pool."""
        stacks, state["set"] = state["set"], None
        if stacks is not None:
            GR.STACK_POOL.release(stacks)

    def leader_round() -> None:
        act = [i for i in range(A) if staging[i] is not None]
        first = staging[act[0]]
        w, h = first.w, first.h
        if any((staging[i].w, staging[i].h) != (w, h) for i in act):
            raise ValueError("lockstep streams must share one resolution: "
                             f"{sorted({(staging[i].w, staging[i].h) for i in act})}")
        key = (w, h, max(staging[i].R for i in act))
        if state["key"] != key:
            give_back()
            state["set"] = GR.STACK_POOL.lease(dev, 16 * w, 16 * h, key[2],
                                               streams=A)
            state["key"] = key
        stacks = state["set"]
        # the leader changes from round to round: the set's return waits
        # for the work of each
        stacks.note_stream()
        lay = PK.get_packed_layout_v2(w, h)
        count["rounds"] += 1

        # one batched step for the packed pictures that share the two
        # picture-parameter values the unpack takes (all of them, as a rule)
        groups: Dict[tuple, List[int]] = {}
        for i in act:
            if staging[i].kind == "v2":
                groups.setdefault((staging[i].ci, staging[i].co),
                                  []).append(i)
        for (ci, co), sub in groups.items():
            sp = [staging[i] for i in sub]
            BK = tuple(max(s.bk[j] for s in sp) for j in range(3))
            bufs = np.stack([PK.expand_buf_v2(s.payload, lay, s.bk, BK)
                             for s in sp])
            with stacks.graphs.counted(count["routes"]):
                frames = _round_step(stacks, bufs, sub,
                                     [s.slot for s in sp], lay, BK, ci, co)
            count["batches"].append(len(sub))
            keys.add((len(sub), BK, ci, co))
            for i, f in zip(sub, frames):
                results[i] = f
        for i in act:
            # per-stream fallback: a picture the v2 packer declined runs
            # alone, unpacked, against this stream's own stacks
            s = staging[i]
            if s.kind != "raw":
                continue
            # on a card the unpacked graph of its key on the stream's
            # stacks, under the rounds' capture policy
            with stacks.graphs.counted(count["fallback_routes"]):
                results[i] = GR.unpacked_step(
                    stacks, s.payload, s.slot, stacks.stack_y[i],
                    stacks.stack_c[i], s.co)
            count["fallbacks"] += 1
        if dev.type == "cuda":
            # the frames were made on the leader's current stream; whoever
            # reads them from another thread waits on this event first
            state["done"] = torch.cuda.current_stream(dev).record_event()

    def make_recon(i: int):
        scratch = {}

        def recon(dec, pic):
            pps, sps = dec.pps, dec.sps
            w, h = sps.width_mbs, sps.height_mbs
            lay = PK.get_packed_layout_v2(w, h)
            if scratch.get("lay") is not lay:
                scratch["lay"] = lay
                scratch["s"] = PK.PackScratchV2(lay)
            res = PK.pack_picture_v2(pic, lay, scratch["s"])
            common = (dec.dpb.current.slot, w, h, dec.dpb.dpb_size + 1,
                      pps.constrained_intra_pred, pps.chroma_qp_index_offset)
            if res is not None:
                staging[i] = _Staged("v2", res[0], res[1], *common)
            else:
                arrs = RC.host_picture_arrays(
                    pic, pps.chroma_qp_index_offset,
                    pps.constrained_intra_pred)
                staging[i] = _Staged("raw", arrs, None, *common)
            if sync.arrive_and_wait():
                try:
                    leader_round()
                except BaseException:
                    sync.abort()
                    raise
                finally:
                    for j in range(A):
                        staging[j] = None
                sync.release()
            elif state["done"] is not None:
                torch.cuda.current_stream(dev).wait_event(state["done"])
            return results[i]
        return recon

    outs = [None] * A
    errors = []

    def run(i: int) -> None:
        dec = None
        try:
            dec = DEC.Decoder(device=dev, recon_strategy=make_recon(i),
                              parallel_slices=parallel_slices)
            got = dec.decode_annexb(datas[i])
            sync.leave()
            if any(o.num_err_mbs for o in got):
                raise ValueError(f"stream {i} has pictures with lost or "
                                 "damaged MBs; lockstep decodes error-free "
                                 "streams")
            if fetch:
                # every copy starts before the first one is waited for
                for o in got:
                    o.frame.start_fetch()
                outs[i] = [o.frame.tobytes() for o in got]
            else:
                outs[i] = got
        except Exception as e:
            # kept for the caller, who gets it once every stream has stopped
            errors.append(e)
            sync.abort()
        finally:
            if dec is not None:
                dec.close()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(A)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        give_back()
    if errors:
        # the failure itself, not the aborts it caused in the other streams
        raise next((e for e in errors if not isinstance(e, LockstepAborted)),
                   errors[0])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if stats is not None:
        stats.update(count, keys=len(keys))
    return outs


def make_dp_mesh(devices=None) -> List[torch.device]:
    """The devices of a data-parallel axis (the counterpart of the JAX
    package's ``make_dp_mesh``): every CUDA card by default, else the given
    devices (names or ``torch.device``) in order, which may repeat; a CUDA
    device without an index is the current one. Raises for CUDA when it
    is not available."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_dp_mesh(): CUDA is not available")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    mesh = []
    for d in map(torch.device, devices):
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {d}: CUDA is not available")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
        elif d.type != "cpu":
            raise ValueError(f"unsupported device {d}")
        mesh.append(d)
    if not mesh:
        raise ValueError("make_dp_mesh: no devices")
    return mesh


def shard_batch(mesh: Sequence[torch.device], tree):
    """Split the leading axis of every tensor (or array) of `tree` (a dict,
    list or tuple of them, nested) into len(mesh) equal parts, part k on
    mesh[k]: a list of len(mesh) trees (the counterpart of the JAX
    package's ``shard_batch``, which makes one array sharded over "dp")."""
    n = len(mesh)

    def split(x):
        if isinstance(x, dict):
            parts = {k: split(v) for k, v in x.items()}
            return [{k: p[i] for k, p in parts.items()} for i in range(n)]
        if isinstance(x, (list, tuple)):
            parts = [split(v) for v in x]
            return [type(x)(p[i] for p in parts) for i in range(n)]
        t = torch.as_tensor(x)
        if t.dim() == 0 or t.shape[0] % n:
            raise ValueError(f"a leading axis of {tuple(t.shape)[:1]} does "
                             f"not split over {n} devices")
        return [c.to(d) for c, d in zip(t.chunk(n), mesh)]

    return split(tree)
