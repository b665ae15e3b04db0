"""The per-picture step as a CUDA graph per key, on pooled reference
stacks (core/graphs.py: ``GroupGraphs.step``, ``StackPool``), the port's
counterpart of the JAX package's one jit call per picture.

On the CPU:
- the graph's body, the frame-group step with G = 1 (its slot an input
  on the device), equals the per-picture step ``decode_picture_packed2``
  of the port and of the JAX package (XLA path) on the same v2 buffers,
  byte for byte, frames and stacks;
- the stack pool leases a set to one decoder at a time, zeroes it on
  lease, takes it back on close, on a geometry change, on load_state and
  when a decoder is dropped, and keeps its graphs;
- the routing, with a test double in place of ``torch.cuda.CUDAGraph``
  (``FakeGraph``: the capture runs the body and records it, a replay runs
  the record again into the captured tensors): a key's first picture
  runs the eager step, its second is captured, the rest replay, a key
  met once is never captured, and every frame equals the JAX package's
  NumPy decoder; a failed capture or replay raises with no eager step in
  its place; a second decoder over the same stream captures nothing.

The test marked ``cuda`` does the same on the card and skips without one:

    python -m pytest tests/test_torch_step_graph.py -m cuda -q
"""

import collections
import contextlib
import gc
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves

from broadway_tpu.core.decoder import Decoder as BaseDecoder
from broadway_tpu_torch.core import decoder as DEC
from broadway_tpu_torch.core import graphs as GR
from broadway_tpu_torch.core import packed as PK
from broadway_tpu_torch.core import recon as RC
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.core.state import ref_stacks_from_jax
from broadway_tpu_torch.ops.gpu import mc_kernel as K1
from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
from broadway_tpu_torch.tools import streams


def _pps_stream():
    """10 pictures of 4x3 MBs in four runs of one geometry whose chroma QP
    offsets are 0, 4, -3, 0: keys met 4 + 2, 1 and 3 times."""
    return b"".join(
        streams.multislice_stream(width_mbs=4, height_mbs=3, n_frames=n,
                                  seed=s, deblock_idc=0, chroma_qp_offset=c)[0]
        for s, n, c in ((71, 4, 0), (72, 1, 4), (73, 3, -3), (74, 2, 0)))


def _frames(dec, data):
    try:
        return [o.frame.tobytes() for o in dec.decode_annexb(data)]
    finally:
        dec.close()


def _want(data):
    return [o.frame.tobytes()
            for o in BaseDecoder(backend="cpu").decode_annexb(data)]


# ---------------------------------------------------------------- (a) body
@pytest.mark.parametrize("seed", [4101, 4102])
def test_group_of_one_equals_the_picture_step_and_jax(seed):
    """An IDR and P pictures over two references: the G = 1 group step,
    the port's decode_picture_packed2 and the JAX package's (mc="xla",
    wf="xla") give the same YUV and the same stacks from the same v2
    buffers and slots."""
    import jax.numpy as jnp

    from broadway_tpu.core import packed as JPK
    from broadway_tpu.core import recon_tpu as RT
    from broadway_tpu.ops.tpu import mc_pallas as K_mcp

    data = streams.inter_stream(width_mbs=5, height_mbs=4, n_frames=3,
                                seed=seed, deblock=True, mvd_range=40,
                                num_ref_frames=2, multi_ref_idx=True)[0]
    pics = PK.pack_stream(data)
    assert len(pics) == 3
    lay, R = pics[0][2], pics[0][5]
    w, h = lay.w, lay.h
    W, H = 16 * w, 16 * h
    lay_j = JPK.get_packed_layout_v2(w, h)
    steps = {k: jnp.asarray(v) for k, v in RT.step_tables(w, h).items()}
    hy, wy = K_mcp.luma_ext_dims(W, H)
    hc, wc = K_mcp.chroma_ext_dims(W, H)
    jy = jnp.zeros((R, hy, wy), jnp.int32)
    jc = jnp.zeros((R, hc, wc), jnp.int32)
    ey = torch.zeros((R, H, W), dtype=torch.uint8)
    ec = torch.zeros((R, 2, H // 2, W // 2), dtype=torch.uint8)
    gy, gc_ = ey.clone(), ec.clone()
    for k, (buf, bk, _, ci, co, _) in enumerate(pics):
        slot = (2 * k + 1) % R
        eager = RC.decode_picture_packed2(torch.from_numpy(buf), ey, ec, slot,
                                          lay, bk, ci, co).tobytes()
        group = RC.decode_pictures_packed_group(
            torch.from_numpy(buf[None]), gy, gc_,
            torch.tensor([slot], dtype=torch.int64), lay, bk, ci, co)
        *_, yuv, jy, jc = RT.decode_picture_packed2(
            jnp.asarray(buf), jy, jc, slot, steps, lay=lay_j, bk=bk,
            constrained_intra=ci, chroma_qp_offset=co, mc="xla", wf="xla")
        assert bytes(group[0].numpy()) == eager, k
        assert np.asarray(yuv).tobytes() == eager, k
        assert torch.equal(gy, ey) and torch.equal(gc_, ec), k
        sy, sc = ref_stacks_from_jax(np.asarray(jy), np.asarray(jc), W, H)
        assert torch.equal(sy, ey) and torch.equal(sc, ec), k
    assert int(ey.sum()) > 0


# ---------------------------------------------------------------- (b) pool
def test_pool_leases_zeroes_and_takes_back():
    pool = GR.StackPool()
    a = pool.lease("cpu", 64, 48, 3)
    assert a.stack_y.shape == (3, 48, 64) and a.stack_c.shape == (3, 2, 24, 32)
    assert a.progress.shape == (3,)
    a.stack_y.fill_(7)
    a.stack_c.fill_(9)
    b = pool.lease("cpu", 64, 48, 3)          # a is held: another set
    assert b is not a
    assert pool.stats()["leased"] == 2
    pool.release(a)
    a.graphs.met.add("key")
    a.graphs.counts["eager"] = 5
    again = pool.lease("cpu", 64, 48, 3)
    assert again is a
    assert int(a.stack_y.sum()) == 0 and int(a.stack_c.sum()) == 0
    assert a.graphs.met == set() and a.graphs.counts["eager"] == 0
    other = pool.lease("cpu", 64, 48, 4)      # another R: another set
    assert other is not a and other is not b
    st = pool.stats()
    assert (st["sets"], st["leased"], st["graphs"]) == (3, 3, 0)
    assert st["stack_bytes"] == a.nbytes() + b.nbytes() + other.nbytes()
    for s in (a, b, other):
        pool.release(s)
    assert pool.stats()["leased"] == 0
    pool.clear()
    assert pool.stats()["sets"] == 0


def test_pool_keeps_at_most_max_sets_a_geometry(monkeypatch):
    monkeypatch.setattr(GR, "MAX_SETS", 2)
    pool = GR.StackPool()
    sets = [pool.lease("cpu", 32, 32, 2) for _ in range(4)]
    for s in sets:
        pool.release(s)
    assert pool.stats()["sets"] == 2
    # the newest returned come back, newest first
    assert pool.lease("cpu", 32, 32, 2) is sets[3]
    assert pool.lease("cpu", 32, 32, 2) is sets[2]


def test_pool_never_hands_one_set_to_two_holders():
    """Many threads lease and return sets of two geometries, with a short
    switch interval: no set is ever held twice at once."""
    pool = GR.StackPool()
    holder, lock, errors = {}, threading.Lock(), []
    old = sys.getswitchinterval()

    def worker(i):
        try:
            for k in range(150):
                s = pool.lease("cpu", 16, 16, 2 + k % 2)
                with lock:
                    if id(s) in holder:
                        errors.append((i, holder[id(s)]))
                    holder[id(s)] = i
                time.sleep(0)
                with lock:
                    del holder[id(s)]
                pool.release(s)
        except Exception as e:      # kept for the assertion below
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert pool.stats()["leased"] == 0


def test_live_decoders_hold_their_own_sets(monkeypatch):
    pool = GR.StackPool()
    monkeypatch.setattr(GR, "STACK_POOL", pool)
    data = streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3,
                                seed=12, deblock=True)[0]
    want = _want(data)
    one, two = Decoder(device="cpu"), Decoder(device="cpu")
    got_one = [o.frame.tobytes() for o in one.decode_annexb(data)]
    got_two = [o.frame.tobytes() for o in two.decode_annexb(data)]
    assert got_one == want and got_two == want
    assert one._stacks is not two._stacks
    held = one._stacks
    one.close()
    assert one._stacks is None and one.group_graphs is None
    three = Decoder(device="cpu")
    assert [o.frame.tobytes() for o in three.decode_annexb(data)] == want
    assert three._stacks is held
    three.close()
    two.close()
    assert pool.stats()["leased"] == 0


def test_sets_go_back_on_a_new_size_on_load_state_and_when_dropped(
        monkeypatch):
    pool = GR.StackPool()
    monkeypatch.setattr(GR, "STACK_POOL", pool)
    data = (streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=2,
                                 seed=61, deblock=True)[0]
            + streams.inter_stream(width_mbs=6, height_mbs=5, n_frames=2,
                                   seed=62, deblock=True)[0])
    dec = Decoder(device="cpu")
    assert [o.frame.tobytes() for o in dec.decode_annexb(data)] == \
        _want(data)
    st = pool.stats()
    assert (st["sets"], st["leased"]) == (2, 1)     # 4x3 went back
    dec.load_state(dec.save_state())
    assert dec._stacks is None and pool.stats()["leased"] == 0
    dec = Decoder(device="cpu")
    dec.decode_annexb(data)
    assert pool.stats()["leased"] == 1
    del dec
    gc.collect()
    assert pool.stats()["leased"] == 0


# ------------------------------------------------- (c)-(e) the fake card
class _Recorder(TorchDispatchMode):
    """Runs each aten op and keeps (op, args, kwargs, outputs) in order."""

    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


_WRAPPERS = ((K1, "mc_predict"), (KW, "intra_wavefront"),
             (KW, "deblock_wavefront"))


class FakeGraph:
    """``torch.cuda.CUDAGraph`` on the CPU. The capture runs the body and
    records it: its aten ops, and each kernel wrapper as one call (their
    plain versions may branch on values). A replay runs the record again
    and writes each fresh output into the tensor that the capture made,
    as a replay rewrites the graph's own memory. `fail` makes the next
    capture_begin or replay raise."""

    made, fail = [], None

    def __init__(self, keep_graph=False):
        self.ops, self.replays = None, 0
        FakeGraph.made.append(self)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        if FakeGraph.fail == "capture":
            raise RuntimeError("capture failed")
        self._ops = []
        self._saved = [(m, n, getattr(m, n)) for m, n in _WRAPPERS]
        for m, n, fn in self._saved:
            setattr(m, n, self._opaque(fn, self._ops))
        self._mode = _Recorder(self._ops)
        self._mode.__enter__()

    @staticmethod
    def _opaque(fn, ops):
        def call(*args, **kwargs):
            with _disable_current_modes():
                out = fn(*args, **kwargs)
            ops.append((fn, args, kwargs, out))
            return out
        return call

    def capture_end(self):
        self._mode.__exit__(None, None, None)
        for m, n, fn in self._saved:
            setattr(m, n, fn)
        self.ops = self._ops

    def instantiate(self):
        pass

    def replay(self):
        if FakeGraph.fail == "replay":
            raise RuntimeError("replay failed")
        for fn, args, kwargs, out in self.ops:
            new = fn(*args, **kwargs)
            for o, n in zip(tree_leaves(out), tree_leaves(new)):
                if isinstance(o, torch.Tensor) and \
                        o.data_ptr() != n.data_ptr():
                    o.copy_(n)
        self.replays += 1


class _FakeStream:
    cuda_stream = 0

    def __init__(self, device=None):
        pass

    def record_event(self):
        return _FakeEvent()

    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass


class _FakeEvent:
    def query(self):
        return True

    def synchronize(self):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors through the card's routing: GroupGraphs.step runs with
    FakeGraph for torch.cuda.CUDAGraph (and streams, events and the pool
    handle that do nothing), on a stack pool of this test's own. Yields
    the pool."""
    pool = GR.StackPool()
    monkeypatch.setattr(GR, "STACK_POOL", pool)
    monkeypatch.setattr(GR, "runs_eagerly", lambda dev: False)
    monkeypatch.setattr(FakeGraph, "made", [])
    monkeypatch.setattr(FakeGraph, "fail", None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(KW, "take_captured", lambda which: 0)
    monkeypatch.setattr(KW, "add_launches", lambda which, n: None)
    yield pool


def _eager_spy(monkeypatch):
    """Counts the decoder's eager per-picture steps."""
    calls, step = [0], DEC.decode_picture_packed2

    def spy(*a, **k):
        calls[0] += 1
        return step(*a, **k)

    monkeypatch.setattr(DEC, "decode_picture_packed2", spy)
    return calls


@pytest.mark.parametrize("pump", [False, True])
def test_keys_met_twice_are_captured_and_the_rest_replay(fake_card,
                                                         monkeypatch, pump):
    data = _pps_stream()
    pics = PK.pack_stream(data)
    met = collections.Counter((p[1], p[3], p[4]) for p in pics)
    assert sorted(met.values()) == [1, 3, 6]
    eager = _eager_spy(monkeypatch)
    dec = Decoder(device="cpu", async_pump=pump)
    got = [o.frame.tobytes() for o in dec.decode_annexb(data)]
    counts = dict(dec.group_graphs.counts)
    graphs = dec.group_graphs.graphs()
    dec.close()
    assert got == _want(data)
    twice = sum(1 for n in met.values() if n >= 2)
    assert eager[0] == len(met) == counts["eager"] == 3
    assert counts["captured"] == len(FakeGraph.made) == len(graphs) == twice
    # the capture's own picture is its first replay
    assert sum(g.replays for g in FakeGraph.made) == len(pics) - len(met)
    assert counts["replayed"] == len(pics) - len(met) - twice
    assert all(g.group == 1 and g.capture_parts is not None for g in graphs)


@pytest.mark.parametrize("fails", ["capture", "replay"])
@pytest.mark.parametrize("pump", [False, True])
def test_failed_capture_or_replay_raises_without_eager_step(fake_card,
                                                            monkeypatch,
                                                            fails, pump):
    """The first picture runs eagerly; the capture at the second, or the
    replay at the third, raises out of the decoder, and no eager step runs
    in its place."""
    data = streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=4,
                                seed=33, deblock=True)[0]
    eager, step = [0], DEC.decode_picture_packed2

    def spy(*a, **k):
        eager[0] += 1
        FakeGraph.fail = fails      # armed once the warm-up has run
        return step(*a, **k)

    monkeypatch.setattr(DEC, "decode_picture_packed2", spy)
    if fails == "replay":
        record = GR.GroupGraph.record_and_replay

        def captured_then_armed(self, *a, **k):
            FakeGraph.fail = None
            out = record(self, *a, **k)
            FakeGraph.fail = "replay"
            return out

        monkeypatch.setattr(GR.GroupGraph, "record_and_replay",
                            captured_then_armed)
    dec = Decoder(device="cpu", async_pump=pump)
    with pytest.raises(RuntimeError, match=f"{fails} failed"):
        dec.decode_annexb(data)
    assert eager[0] == 1
    if pump:        # the pump keeps the failure: every sync point raises it
        with pytest.raises(RuntimeError, match=f"{fails} failed"):
            dec.close()
    else:
        dec.close()
    assert dec._stacks is None


def test_second_decoder_replays_the_first_ones_graphs(fake_card):
    data = _pps_stream()
    want = _want(data)
    first = Decoder(device="cpu")
    assert _frames(first, data) == want
    made = len(FakeGraph.made)
    assert made == 2
    second = Decoder(device="cpu")
    got = [o.frame.tobytes() for o in second.decode_annexb(data)]
    counts = dict(second.group_graphs.counts)
    second.close()
    assert got == want
    assert len(FakeGraph.made) == made and counts["captured"] == 0
    # the key met once is met once again: eager, as for the first decoder
    assert counts == {"eager": 1, "captured": 0, "replayed": 9}
    assert fake_card.stats()["sets"] == 1


def test_checkpoint_resumes_on_the_graphs(fake_card):
    """save_state after the captures, load_state into a new decoder: the
    resumed decoder replays the same graphs on re-seeded stacks, and the
    frames equal the JAX package's."""
    data = _pps_stream()
    want = _want(data)
    nals = [DEC.NalUnit(p) for _, p in DEC.br.split_nal_units(data)]
    dec = Decoder(device="cpu")
    k = 0
    while dec.pic_number < 7 or dec.pic is not None:
        dec.decode_nal(nals[k])
        k += 1
    st = dec.save_state()
    head = [o.frame.tobytes() for o in dec.outputs]
    dec.close()
    resumed = Decoder(device="cpu")
    resumed.load_state(st)
    for nal in nals[k:]:
        resumed.decode_nal(nal)
    resumed.flush()
    tail = [o.frame.tobytes() for o in resumed.outputs]
    counts = dict(resumed.group_graphs.counts)
    resumed.close()
    assert head + tail == want
    assert counts["captured"] == 0 and counts["replayed"] >= 1


# ---------------------------------------------------------------- the card
@pytest.mark.cuda
def test_default_decoder_replays_on_the_card():
    """Two default decoders in turn over one stream on the card: the
    second captures nothing, every frame equals the NumPy path, and K1,
    K2 and K3 run once a picture, replays counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data = streams.realistic_stream(width_mbs=12, height_mbs=8, n_frames=6,
                                    n_slices=3, seed=5)[0]
    want = _frames(Decoder(device="cpu", recon="numpy"), data)
    GR.STACK_POOL.clear()
    counts = []
    for _ in range(2):
        before = (K1.mc_predict.launches, KW.intra_wavefront.launches,
                  KW.deblock_wavefront.launches)
        dec = Decoder(device="cuda")
        got = [o.frame.tobytes() for o in dec.decode_annexb(data)]
        counts.append(dict(dec.group_graphs.counts))
        dec.close()
        torch.cuda.synchronize()
        after = (K1.mc_predict.launches, KW.intra_wavefront.launches,
                 KW.deblock_wavefront.launches)
        assert got == want
        assert [a - b for a, b in zip(after, before)] == [len(want)] * 3
    assert counts[0]["captured"] >= 1 and counts[1]["captured"] == 0
    assert counts[1]["replayed"] == len(want) - counts[1]["eager"]


@pytest.mark.cuda
def test_staging_ring_runs_ahead_of_the_card():
    """While a hold keeps the card's stream busy, STAGING_DEPTH uploads
    and replays of one per-picture graph return to the host (none waits
    for the copies queued behind the hold); the D + 2 pictures through the
    graph, its capture's among them, equal their eager steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from broadway_tpu_torch.ops.gpu import probe

    dev = torch.device("cuda")
    D = GR.STAGING_DEPTH
    pics = PK.pack_stream(streams.realistic_stream(
        width_mbs=12, height_mbs=8, n_frames=D + 4, n_slices=3,
        seed=7)[0])[1:]                 # D + 3 P pictures: one key
    lay, ci, co, R = pics[0][2], pics[0][3], pics[0][4], pics[0][5]
    BK = tuple(max(p[1][j] for p in pics) for j in range(3))
    bufs = [PK.expand_buf_v2(p[0], lay, p[1], BK) for p in pics]
    slots = [k % R for k in range(len(pics))]
    rng = np.random.RandomState(7)
    sy = torch.from_numpy(rng.randint(0, 256, (R, 16 * lay.h, 16 * lay.w),
                                      dtype=np.uint8)).to(dev)
    sc = torch.from_numpy(rng.randint(0, 256, (R, 2, 8 * lay.h, 8 * lay.w),
                                      dtype=np.uint8)).to(dev)
    ey, ec = sy.clone(), sc.clone()
    want = [RC.decode_picture_packed2(torch.from_numpy(p[0]).to(dev), ey, ec,
                                      s, lay, p[1], ci, co).tobytes()
            for p, s in zip(pics, slots)]
    graphs = GR.GroupGraphs()

    def step(k):
        return graphs.step(bufs[k], slots[k], sy, sc, lay, BK, ci, co)

    assert step(0) is None              # the key's first picture: eager
    got = [RC.decode_picture_packed2(torch.from_numpy(bufs[0]).to(dev), sy,
                                     sc, slots[0], lay, BK, ci, co).tobytes()]
    graph = [step(1)]                   # captured, then replayed
    torch.cuda.synchronize()
    probe.hold_stream(400_000_000, dev)     # some 0.2 s
    held = torch.cuda.current_stream(dev).record_event()
    graph += [step(k) for k in range(2, D + 2)]
    assert not held.query()             # all D returned during the hold
    graph.append(step(D + 2))
    torch.cuda.synchronize()
    got += [bytes(y.cpu().numpy()) for y in graph]
    assert got == want
    assert torch.equal(sy, ey) and torch.equal(sc, ec)
    assert graphs.counts == {"eager": 0, "captured": 1, "replayed": D + 1}
