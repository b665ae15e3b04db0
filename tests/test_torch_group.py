"""Frame groups of the port (``Decoder(group_frames=G)``, the counterpart of
the JAX package's frame-group fast path) and output prefetch
(``prefetch_outputs=True``, ``TorchFrame.start_fetch``).

On the CPU the group step runs eagerly through the kernels' plain
versions: every frame equals the port's NumPy path and the JAX package's
NumPy decoder, byte for byte, through remainder groups, a resolution
change, concealment, a picture forced to v1, lazy frames read early and a
checkpoint taken mid-group; and the port's group path equals the JAX
package's own group path (``backend="tpu", group_frames=4``, JAX on the
CPU) in frames, order and picture ids, as tests/test_group.py runs it.

The tests marked ``cuda`` drive the captured CUDA graphs
(core/graphs.py) and skip without a card:

    python -m pytest tests/test_torch_group.py -m cuda -q
"""

import pickle
import threading

import numpy as np
import pytest
import torch

from broadway_tpu.core.decoder import Decoder as BaseDecoder
from broadway_tpu_torch.bitstream import bitreader as br
from broadway_tpu_torch.core import decoder as DEC
from broadway_tpu_torch.core import graphs as GR
from broadway_tpu_torch.core import packed as PK
from broadway_tpu_torch.core import recon as RC
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.ops.gpu import mc_kernel as K1
from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
from broadway_tpu_torch.tools import streams


def _frames(dec, data):
    return [o.frame.tobytes() for o in dec.decode_annexb(data)]


def _nals(data):
    return [br.NalUnit(p) for _, p in br.split_nal_units(data)]


SCENARIOS = {
    # 5 pictures: groups of G and a remainder (a single one at G = 4)
    "inter_remainder": lambda: streams.inter_stream(
        width_mbs=4, height_mbs=3, n_frames=5, seed=99, deblock=True)[0],
    # the group runs before the stacks are re-keyed for the new size
    "resolution_change": lambda: (
        streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3, seed=61,
                             deblock=True)[0]
        + streams.inter_stream(width_mbs=6, height_mbs=5, n_frames=3,
                               seed=62, deblock=True)[0]),
    # frame-num gaps and concealment: the group runs before the host
    # reads the references
    "gaps_conceal": lambda: streams.gaps_stream(width_mbs=4, height_mbs=3)[0],
    # a new picture parameter set (another chroma QP offset) at the same
    # size: the group runs before a picture that unpacks differently
    "pps_change": lambda: b"".join(
        streams.multislice_stream(width_mbs=4, height_mbs=3, n_frames=3,
                                  seed=s, deblock_idc=0,
                                  chroma_qp_offset=c)[0]
        for s, c in ((71, 0), (72, 4), (73, 4), (74, -3))),
    # out-of-picture vectors over two references
    "wild_mv_multi_ref": lambda: streams.inter_stream(
        width_mbs=11, height_mbs=7, n_frames=6, seed=20260821, deblock=True,
        mvd_range=400, num_ref_frames=2, multi_ref_idx=True)[0],
}


@pytest.mark.parametrize("group", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_group_equals_numpy_and_jax(name, group):
    data = SCENARIOS[name]()
    want = _frames(BaseDecoder(backend="cpu"), data)
    assert want
    assert _frames(Decoder(device="cpu", recon="numpy"), data) == want
    dec = Decoder(device="cpu", group_frames=group)
    outs = dec.decode_annexb(data)
    assert [o.frame.tobytes() for o in outs] == want
    assert dec._group_pend == []
    assert any(isinstance(o.frame, RC.LazyTorchFrame) for o in outs)


def test_group_equals_the_jax_group_path():
    """The JAX package's own frame groups (one jit call for G pictures,
    JAX on the CPU): the same frames, in the same order, with the same
    picture ids."""
    pytest.importorskip("jax")
    data = SCENARIOS["inter_remainder"]()
    want = BaseDecoder(backend="tpu", group_frames=4).decode_annexb(data)
    got = Decoder(device="cpu", group_frames=4).decode_annexb(data)
    assert [(o.pic_id, o.is_idr, o.frame.tobytes()) for o in got] == \
        [(o.pic_id, o.is_idr, o.frame.tobytes()) for o in want]


def test_v1_picture_runs_the_pending_group_first(monkeypatch):
    """A picture that v2 declines takes v1, which writes the stacks: the
    two pictures queued before it run first, as a group of 2."""
    data = SCENARIOS["inter_remainder"]()
    want = _frames(BaseDecoder(backend="cpu"), data)
    order, calls = [], [0]
    v2, v1, run = PK.pack_picture_v2, DEC.Decoder._v1_step, \
        GR.GroupGraphs.run

    def declining(*a, **k):
        calls[0] += 1
        return None if calls[0] == 3 else v2(*a, **k)

    def v1_step(*a, **k):
        order.append("v1")
        return v1(*a, **k)

    def group(self, bufs, *a, **k):
        order.append(f"group of {bufs.shape[0]}")
        return run(self, bufs, *a, **k)

    monkeypatch.setattr(PK, "pack_picture_v2", declining)
    monkeypatch.setattr(DEC.Decoder, "_v1_step", v1_step)
    monkeypatch.setattr(GR.GroupGraphs, "run", group)
    assert _frames(Decoder(device="cpu", group_frames=4), data) == want
    assert order == ["group of 2", "v1", "group of 2"]


def test_group_runs_before_a_pps_seam(monkeypatch):
    """Two streams back to back whose picture parameter sets differ in
    chroma_qp_index_offset, at G = 4: the group holding the first stream's
    2 pictures runs before the second stream's first picture (the JAX
    package would decode a group of 4 across the seam with the first
    picture's offset), and every frame equals the port's NumPy path and
    the JAX package's NumPy decoder."""
    data = (streams.multislice_stream(width_mbs=4, height_mbs=3, n_frames=2,
                                      seed=820, chroma_qp_offset=0)[0]
            + streams.multislice_stream(width_mbs=4, height_mbs=3,
                                        n_frames=3, seed=821,
                                        chroma_qp_offset=-4)[0])
    want = _frames(BaseDecoder(backend="cpu"), data)
    assert len(want) == 5
    assert _frames(Decoder(device="cpu", recon="numpy"), data) == want
    runs, run = [], GR.GroupGraphs.run

    def group(self, bufs, slots, sy, sc, lay, bk, ci, co):
        runs.append((bufs.shape[0], co))
        return run(self, bufs, slots, sy, sc, lay, bk, ci, co)

    monkeypatch.setattr(GR.GroupGraphs, "run", group)
    assert _frames(Decoder(device="cpu", group_frames=4), data) == want
    assert runs == [(2, 0), (3, -4)]


def test_lazy_frame_read_before_its_group_fills():
    data = SCENARIOS["inter_remainder"]()
    want = _frames(BaseDecoder(backend="cpu"), data)
    dec = Decoder(device="cpu", group_frames=4)
    nals = _nals(data)
    k = 0
    while dec.pic_number < 2 or dec.pic is not None:
        dec.decode_nal(nals[k])
        k += 1
    first = next(p.frame for p in dec.dpb.buffer if p.pic_id == 0)
    assert isinstance(first, RC.LazyTorchFrame)
    assert len(dec._group_pend) == 2 and first._frame is None
    first.start_fetch()                 # remembered; the group stays
    assert len(dec._group_pend) == 2 and first._frame is None
    assert first.tobytes() == want[0]   # forces the group of 2
    assert dec._group_pend == [] and first._frame is not None
    for nal in nals[k:]:
        dec.decode_nal(nal)
    dec.flush()
    assert [o.frame.tobytes() for o in dec.outputs] == want


def test_save_state_mid_group_equals_jax():
    """save_state with two pictures of a group of 4 pending runs them
    first: the snapshot's planes equal the JAX package's decoder at the
    same point, and a decoder resumed from it finishes the stream."""
    data = streams.inter_stream(width_mbs=5, height_mbs=4, n_frames=7,
                                seed=4242, num_ref_frames=2,
                                multi_ref_idx=True, deblock=True,
                                mvd_range=80)[0]
    want = _frames(BaseDecoder(backend="cpu"), data)
    nals = _nals(data)
    port, ref = Decoder(device="cpu", group_frames=4), BaseDecoder()
    k = 0
    while port.pic_number < 2 or port.pic is not None:
        port.decode_nal(nals[k])
        ref.decode_nal(nals[k])
        k += 1
    assert len(port._group_pend) == 2
    st, st_ref = port.save_state(), ref.save_state()
    assert port._group_pend == []
    pics = st["dpb"]["buffer"]
    assert len(pics) == len(st_ref["dpb"]["buffer"])
    for p, q in zip(pics, st_ref["dpb"]["buffer"]):
        assert (p["pic_id"], p["slot"], p["poc"]) == \
            (q["pic_id"], q["slot"], q["poc"])
        assert (p["planes"] is None) == (q["planes"] is None)
        if p["planes"] is not None:
            assert all(np.array_equal(a, b)
                       for a, b in zip(p["planes"], q["planes"]))
    resumed = Decoder(device="cpu", group_frames=4)
    resumed.load_state(pickle.loads(pickle.dumps(st)))
    for nal in nals[k:]:
        resumed.decode_nal(nal)
    resumed.flush()
    assert [o.frame.tobytes() for o in port.outputs + resumed.outputs] == \
        want


@pytest.mark.parametrize("group", [0, 2])
def test_prefetch_outputs_on_equals_off(group, monkeypatch):
    """prefetch_outputs starts every output's copy as it reaches display
    order (on the CPU the copy is the frame itself); the bytes do not
    change."""
    data = SCENARIOS["inter_remainder"]()
    off = _frames(Decoder(device="cpu", group_frames=group), data)
    started = []
    for cls in (RC.TorchFrame, RC.LazyTorchFrame):
        orig = cls.start_fetch

        def spy(self, orig=orig):
            started.append(self)
            orig(self)

        monkeypatch.setattr(cls, "start_fetch", spy)
    outs = Decoder(device="cpu", group_frames=group,
                   prefetch_outputs=True).decode_annexb(data)
    assert [o.frame.tobytes() for o in outs] == off
    assert {id(o.frame) for o in outs} <= {id(f) for f in started}
    assert len(outs) == 5


def test_group_step_equals_steps_in_a_row():
    """The group function itself: G pictures through
    decode_pictures_packed_group give the frames and the stacks of G
    per-picture steps, on the CPU."""
    data = SCENARIOS["wild_mv_multi_ref"]()
    pics = PK.pack_stream(data)[:4]
    lay, ci, co, R = pics[0][2], pics[0][3], pics[0][4], pics[0][5]
    BK = tuple(max(p[1][j] for p in pics) for j in range(3))
    bufs = np.stack([PK.expand_buf_v2(p[0], lay, p[1], BK) for p in pics])
    rng = np.random.RandomState(3)
    sy = torch.from_numpy(rng.randint(0, 256, (R, 16 * lay.h, 16 * lay.w),
                                      dtype=np.uint8))
    sc = torch.from_numpy(rng.randint(0, 256, (R, 2, 8 * lay.h, 8 * lay.w),
                                      dtype=np.uint8))
    slots = [2, 0, 1, 2]
    ey, ec = sy.clone(), sc.clone()
    want = [RC.decode_picture_packed2(torch.from_numpy(p[0]), ey, ec, s, lay,
                                      p[1], ci, co).tobytes()
            for p, s in zip(pics, slots)]
    yuv = RC.decode_pictures_packed_group(
        torch.from_numpy(bufs), sy, sc, torch.tensor(slots), lay, BK, ci, co)
    assert [bytes(r.numpy()) for r in yuv] == want
    assert torch.equal(sy, ey) and torch.equal(sc, ec)


def test_group_step_checks_its_operands(monkeypatch):
    pics = PK.pack_stream(SCENARIOS["inter_remainder"]())[:2]
    lay, ci, co, R = pics[0][2], pics[0][3], pics[0][4], pics[0][5]
    BK = tuple(max(p[1][j] for p in pics) for j in range(3))
    bufs = torch.from_numpy(np.stack(
        [PK.expand_buf_v2(p[0], lay, p[1], BK) for p in pics]))
    sy = torch.zeros((R, 16 * lay.h, 16 * lay.w), dtype=torch.uint8)
    sc = torch.zeros((R, 2, 8 * lay.h, 8 * lay.w), dtype=torch.uint8)
    with pytest.raises(ValueError, match="slots"):
        RC.decode_pictures_packed_group(bufs, sy, sc,
                                        torch.tensor([0, 1], dtype=torch.int32),
                                        lay, BK, ci, co)
    with pytest.raises(ValueError, match="slots"):
        RC.decode_pictures_packed_group(bufs, sy, sc, torch.tensor([0]), lay,
                                        BK, ci, co)
    with pytest.raises(ValueError, match="bufs"):
        RC.decode_pictures_packed_group(bufs.int(), sy, sc,
                                        torch.tensor([0, 1]), lay, BK, ci, co)
    # a wholly concealed picture would need K3's skip read on the host
    unpack = RC.unpack_arrs_v2

    def concealed(*a, **k):
        arrs = unpack(*a, **k)
        arrs["whole_conceal"] = torch.tensor(True)
        return arrs

    monkeypatch.setattr(RC, "unpack_arrs_v2", concealed)
    with pytest.raises(RuntimeError, match="concealed"):
        RC.decode_pictures_packed_group(bufs, sy, sc, torch.tensor([0, 1]),
                                        lay, BK, ci, co)


def test_group_body_reads_no_device_value_on_the_host(monkeypatch):
    """What a CUDA graph captures may not read a device value on the host:
    the capture refuses it, and a replay could not repeat it. Under a
    dispatch mode that sees every such read (``_local_scalar_dense``), the
    group step reads only the whole_conceal flags, which live on the host.
    The kernels' plain versions, which read the host but never run on the
    card, are stubbed out."""
    from torch.utils._python_dispatch import TorchDispatchMode

    data = SCENARIOS["wild_mv_multi_ref"]()
    pics = PK.pack_stream(data)[:3]
    lay, ci, co, R = pics[0][2], pics[0][3], pics[0][4], pics[0][5]
    BK = tuple(max(p[1][j] for p in pics) for j in range(3))
    bufs = torch.from_numpy(np.stack(
        [PK.expand_buf_v2(p[0], lay, p[1], BK) for p in pics]))
    sy = torch.zeros((R, 16 * lay.h, 16 * lay.w), dtype=torch.uint8)
    sc = torch.zeros((R, 2, 8 * lay.h, 8 * lay.w), dtype=torch.uint8)
    flags, unpack = [], RC.unpack_arrs_v2

    def unpack_spy(*a, **k):
        arrs = unpack(*a, **k)
        flags.append(arrs["whole_conceal"])
        return arrs

    def mc_stub(ref_y, ref_c, mv, *a):
        n = mv.shape[0]
        return (torch.zeros((n, 16, 16), dtype=torch.uint8),
                torch.zeros((n, 8, 16), dtype=torch.uint8))

    monkeypatch.setattr(RC, "unpack_arrs_v2", unpack_spy)
    monkeypatch.setattr(K1, "mc_predict", mc_stub)
    monkeypatch.setattr(KW, "intra_wavefront", lambda *a, **k: None)
    monkeypatch.setattr(KW, "deblock_wavefront", lambda *a, **k: None)
    reads = []

    class HostReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                reads.append(args[0])
            return func(*args, **(kwargs or {}))

    with HostReads():
        RC.decode_pictures_packed_group(bufs, sy, sc, torch.tensor([0, 1, 2]),
                                        lay, BK, ci, co)
    assert len(flags) == 3 and reads
    assert all(any(r is f for f in flags) for r in reads)


@pytest.mark.parametrize("bad", [-1, 2.0, "4"])
def test_decoder_refuses_bad_group_frames(bad):
    with pytest.raises(ValueError, match="group_frames"):
        Decoder(device="cpu", group_frames=bad)


def test_lazy_frame_fetch_waits_for_its_frame():
    """start_fetch before the frame exists starts the copy when the group
    sets it; after that it goes straight to the frame."""
    class Fake:
        fetched = 0

        def start_fetch(self):
            Fake.fetched += 1

    forced = []
    lazy = RC.LazyTorchFrame(lambda: forced.append(1))
    lazy.start_fetch()
    assert Fake.fetched == 0 and not forced
    frame = Fake()
    lazy._set(frame)
    assert Fake.fetched == 1
    lazy.start_fetch()
    assert Fake.fetched == 2 and lazy._ensure() is frame and not forced


def test_cpu_frame_start_fetch_is_a_no_op():
    f = RC.TorchFrame(torch.arange(96, dtype=torch.uint8), 8, 8)
    f.start_fetch()
    assert f._fetching is None
    assert f.tobytes() == bytes(range(96))


# --------------------------------------------------------------------------
# on the card (marker cuda): the captured graphs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_pictures():
    return PK.pack_stream(streams.realistic_stream(
        width_mbs=12, height_mbs=8, n_frames=6, n_slices=3, seed=5)[0])


def _operands(pics, dev, seed=0):
    lay, ci, co, R = pics[0][2], pics[0][3], pics[0][4], pics[0][5]
    BK = tuple(max(p[1][j] for p in pics) for j in range(3))
    bufs = np.stack([PK.expand_buf_v2(p[0], lay, p[1], BK) for p in pics])
    rng = np.random.RandomState(seed)
    sy = torch.from_numpy(rng.randint(0, 256, (R, 16 * lay.h, 16 * lay.w),
                                      dtype=np.uint8)).to(dev)
    sc = torch.from_numpy(rng.randint(0, 256, (R, 2, 8 * lay.h, 8 * lay.w),
                                      dtype=np.uint8)).to(dev)
    return bufs, sy, sc, lay, BK, ci, co


def _eager(pics, slots, sy, sc):
    """The per-picture step in a row on copies of the stacks -> (frames as
    bytes, the stacks after)."""
    lay, ci, co = pics[0][2], pics[0][3], pics[0][4]
    ey, ec = sy.clone(), sc.clone()
    out = [RC.decode_picture_packed2(torch.from_numpy(p[0]).to(sy.device),
                                     ey, ec, s, lay, p[1], ci, co).tobytes()
           for p, s in zip(pics, slots)]
    return out, ey, ec


@pytest.mark.cuda
@pytest.mark.parametrize("sel", [(1, 2), (0, 1, 2, 3)])
def test_graph_replay_equals_eager_steps(cuda, sel):
    """Two keys (G = 2 with P pictures, G = 4 with the IDR): the capture's
    warm-up and the replay each equal the per-picture steps in a row."""
    pics = [_card_pictures()[i] for i in sel]
    bufs, sy, sc, lay, BK, ci, co = _operands(pics, cuda)
    slots = list(range(len(pics)))
    want, ey, ec = _eager(pics, slots, sy, sc)
    graphs = GR.GroupGraphs()
    y0, c0 = sy.clone(), sc.clone()
    warm = graphs.run(bufs, slots, sy, sc, lay, BK, ci, co)
    assert [bytes(r.cpu().numpy()) for r in warm] == want
    assert torch.equal(sy, ey) and torch.equal(sc, ec)
    sy.copy_(y0)
    sc.copy_(c0)
    replayed = graphs.run(bufs, slots, sy, sc, lay, BK, ci, co)
    torch.cuda.synchronize()
    assert [bytes(r.cpu().numpy()) for r in replayed] == want
    assert torch.equal(sy, ey) and torch.equal(sc, ec)
    (g,) = graphs.graphs()
    assert g.replays == 1 and g.capture_ms > 0


@pytest.mark.cuda
def test_cached_graph_takes_new_buffers_and_slots(cuda):
    pics = _card_pictures()
    a, b = [pics[1], pics[2]], [pics[3], pics[4]]
    BK = tuple(max(p[1][j] for p in pics[1:5]) for j in range(3))
    lay, ci, co = pics[0][2], pics[0][3], pics[0][4]
    _, sy, sc, *_ = _operands(a, cuda, seed=5)
    graphs = GR.GroupGraphs()

    def bufs(ps):
        return np.stack([PK.expand_buf_v2(p[0], lay, p[1], BK) for p in ps])

    graphs.run(bufs(a), [1, 2], sy, sc, lay, BK, ci, co)
    want, ey, ec = _eager(b, [3, 0], sy, sc)
    got = graphs.run(bufs(b), [3, 0], sy, sc, lay, BK, ci, co)
    assert [bytes(r.cpu().numpy()) for r in got] == want
    assert torch.equal(sy, ey) and torch.equal(sc, ec)
    assert [g.replays for g in graphs.graphs()] == [1]


@pytest.mark.cuda
def test_least_recently_used_graph_is_evicted(cuda, monkeypatch):
    monkeypatch.setattr(GR, "MAX_GRAPHS", 2)
    pics = _card_pictures()
    bufs, sy, sc, lay, BK, ci, co = _operands(pics[1:3], cuda)
    graphs = GR.GroupGraphs()
    for c in (co, co + 1, co):            # the third run is a replay
        graphs.run(bufs, [0, 1], sy, sc, lay, BK, ci, c)
    graphs.run(bufs, [0, 1], sy, sc, lay, BK, ci, co + 2)
    kept = graphs.graphs()
    assert [g.args[3] for g in kept] == [co, co + 2]
    assert [g.replays for g in kept] == [1, 0]


@pytest.mark.cuda
def test_two_decoders_replay_on_two_threads(cuda):
    """Each graph owns its progress counters: two decoders replaying at
    once on two threads (each on a stream of its own) give their own
    bytes."""
    datas = [streams.realistic_stream(width_mbs=12, height_mbs=8, n_frames=6,
                                      n_slices=3, seed=s)[0] for s in (5, 6)]
    wants = [_frames(Decoder(device=cuda), d) for d in datas]
    gots, errors = [None, None], []

    def run(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                dec = Decoder(device=cuda, group_frames=2)
                got = []
                for _ in range(3):
                    got.append(_frames(dec, datas[i]))
                gots[i] = got
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for got, want in zip(gots, wants):
        assert got == [want] * 3


@pytest.mark.cuda
def test_replays_count_the_launches_they_ran(cuda):
    pics = _card_pictures()[1:4]
    bufs, sy, sc, lay, BK, ci, co = _operands(pics, cuda)
    wrappers = (K1.mc_predict, KW.intra_wavefront, KW.deblock_wavefront)
    KW.device_launches(KW.INTRA, reset=True)
    KW.device_launches(KW.DEBLOCK, reset=True)
    before = [w.launches for w in wrappers]
    graphs = GR.GroupGraphs()
    graphs.run(bufs, [0, 1, 2], sy, sc, lay, BK, ci, co)   # warm-up: ran
    assert [w.launches - b for w, b in zip(wrappers, before)] == [3, 3, 3]
    assert KW.device_launches(KW.INTRA) == 3
    for k in range(2):
        graphs.run(bufs, [0, 1, 2], sy, sc, lay, BK, ci, co)
        assert [w.launches - b for w, b in zip(wrappers, before)] == \
            [3 * (k + 2)] * 3
        assert KW.device_launches(KW.INTRA) == 3 * (k + 2)
        assert KW.device_launches(KW.DEBLOCK) == 3 * (k + 2)
    (g,) = graphs.graphs()
    assert set(g.launches.values()) == {3}
    assert g.device_launches == {KW.INTRA: 3, KW.DEBLOCK: 3}
