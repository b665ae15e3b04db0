"""The band step over a mesh of several cards (``parallel.slices``
``decode_band_run`` / ``gather_into_slot``, routed by ``core.graphs.
mesh_step`` and captured by ``MeshGraph``): the counterpart of the JAX
package's ``jax.jit(shard_map(...))`` over a mesh of chips, with the
``ppermute`` halos and the ``all_gather`` as peer copies (ops/gpu/peer.py).

On the CPU, where ``cpu`` and ``cpu:0`` are two device objects and so make
a mesh of two "cards" (the plain kernels, no graph), every check byte
equality:
- the per-card bodies, (a) reconstruction, (b) the idc-0 chain and (c) the
  gather into each card's stack slot, equal the eager ``decode_bands``
  picture by picture (frames and every card's stacks), and the band path
  over the mesh equals the JAX package's ``decode_stream_sliced`` over a
  CPU mesh of as many virtual devices; idc 0, idc 2 and an unaligned
  stream, on meshes of 2 bands, of 4 interleaved and of 4 in two runs;
- the routing, with tests/test_torch_step_graph.py's ``FakeGraph`` in
  place of ``torch.cuda.CUDAGraph`` and events that log their records and
  waits: a key's first picture eager, its second captured (a graph per
  run of bands on one card and a gather graph per card), the rest
  replayed; every wait a graph captures is on an event whose record the
  host enqueues before it; a second call captures nothing; a failed
  capture or replay raises with no eager step in its place;
  ``decode_streams_sliced_dp`` over a grid whose rows span two devices;
- the mirror stacks of the other cards keep their storage, which a graph
  has baked in, across a declined picture, and their bytes follow;
- a pair of cards without peer access raises, naming the pair.

The tests marked ``cuda`` need two cards or more and skip otherwise (run
them under ``timeout``: the wavefront kernels wait on each other):

    timeout 900 python -m pytest tests/test_torch_multicard_graph.py -m cuda -q
"""

import collections
import contextlib

import numpy as np
import pytest
import torch

from broadway_tpu_torch.core import graphs as GR
from broadway_tpu_torch.core import packed as TPK
from broadway_tpu_torch.core import recon as TRC
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.ops.gpu import peer as PEER
from broadway_tpu_torch.parallel import slices as SL
from broadway_tpu_torch.tools import streams
from test_torch_band_graph import _band_keys, _routes
from test_torch_step_graph import FakeGraph, fake_card  # noqa: F401

try:        # the reference package; the card's host has no JAX
    import jax
    from jax.sharding import Mesh
    from broadway_tpu.parallel import slices as JSL
except ImportError:
    jax = None

ONE_CARD = dict.fromkeys(("eager", "captured", "replayed"), 0)
# two device objects on the CPU: 2 bands; 4 interleaved (4 runs); 4 in
# two runs of 2
MESHES = {"2": ["cpu", "cpu:0"], "4x": ["cpu", "cpu:0"] * 2,
          "4r": ["cpu", "cpu", "cpu:0", "cpu:0"]}
STREAMS = {
    "idc0": lambda n: streams.banded_stream(width_mbs=6, height_mbs=8,
                                            n_bands=n, n_frames=3,
                                            seed=1500 + n, deblock_idc=0)[0],
    "idc2": lambda n: streams.banded_stream(width_mbs=6, height_mbs=8,
                                            n_bands=n, n_frames=3,
                                            seed=1510 + n, deblock_idc=2)[0],
    # 3 slices over 6 rows: across the bands of 2, and 4 does not divide
    "unaligned": lambda n: streams.multislice_stream(
        width_mbs=4, height_mbs=6, n_frames=2, n_slices=3, seed=1520)[0],
}


def _mesh(name):
    return [torch.device(d) for d in MESHES[name]]


def _frames(dec, data):
    try:
        return [o.frame.tobytes() for o in dec.decode_annexb(data)]
    finally:
        dec.close()


_jax_cache = {}


def _jax_sliced(stream, n):
    """The JAX package's decode_stream_sliced on n virtual CPU devices."""
    if jax is None:
        pytest.skip("needs JAX and the JAX package (the reference)")
    if (stream, n) not in _jax_cache:
        cpus = jax.devices("cpu")
        if len(cpus) < n:
            pytest.skip(f"need {n} virtual cpu devices")
        data = STREAMS[stream](n)
        _jax_cache[stream, n] = (data, JSL.decode_stream_sliced(
            data, Mesh(np.array(cpus[:n]), ("sp",)), n_bands=n))
    return _jax_cache[stream, n]


# ------------------------------------------------------------- the bodies
def _bodies_strategy(mesh, checked):
    """A recon_strategy that decodes each aligned picture twice over the
    mesh, from copies of the decoder's stacks, one set per device: with
    the per-card bodies (``decode_band_run`` per run of the mesh, then
    ``gather_into_slot`` on every device) and with the eager
    ``decode_bands`` + ``update_stack_slot``; both give the same frame on
    every device and the same stacks, which go back into the decoder's."""
    n = len(mesh)
    devs = list(dict.fromkeys(mesh))

    def strategy(dec, pic):
        if not SL._bands_aligned(pic, n):
            return None
        w, h = dec.sps.width_mbs, dec.sps.height_mbs
        ci, co = dec.pps.constrained_intra_pred, dec.pps.chroma_qp_index_offset
        cross = any(sp.disable_deblocking_idc == 0 for sp in pic.slice_params)
        sy, sc, slot = dec.reference_stacks()
        lay = TPK.get_packed_layout_v2(w, h)
        buf, bk = TPK.pack_picture_v2(pic, lay, TPK.PackScratchV2(lay))
        spec = ("v2", lay, bk, ci, co)
        bufs = torch.from_numpy(buf[None])
        mine = {d: (sy.clone(), sc.clone()) for d in devs}
        theirs = {d: (sy.clone(), sc.clone()) for d in devs}
        finals = {}
        for dev, ks in SL.mesh_runs(mesh):
            got = SL.decode_band_run(bufs, *mine[dev], ks, spec, n, cross, w,
                                     h, co, halo=finals.get(ks[0] - 1))
            finals.update(zip(ks, got))
        finals = [finals[k] for k in range(n)]
        whole = TPK.unpack_arrs_v2(bufs[0], lay, bk, ci, co)
        cut = SL.cut_band_ghost if cross else SL.cut_band
        want = SL.decode_bands([cut(whole, k, w, h // n) for k in range(n)],
                               mesh, theirs, w, h, co, cross)
        for d in devs:
            yuv = SL.gather_into_slot(finals, *mine[d], torch.tensor([slot]),
                                      w, h, cross)
            assert torch.equal(yuv[0], want[d])
            TRC.update_stack_slot(*theirs[d], slot,
                                  TRC.TorchFrame(want[d], 16 * w, 16 * h))
            assert all(torch.equal(a, b) for a, b in zip(mine[d], theirs[d]))
        sy.copy_(mine[devs[0]][0])
        sc.copy_(mine[devs[0]][1])
        checked.append(cross)
        return TRC.TorchFrame(want[devs[0]], 16 * w, 16 * h)
    return strategy


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_mesh_bodies_equal_decode_bands_and_jax(stream, mesh):
    """The per-card bodies against the eager decode_bands, picture by
    picture; then decode_stream_sliced over the mesh (the bodies, eager on
    the CPU) against the JAX package over as many virtual devices."""
    n = len(MESHES[mesh])
    data, want = _jax_sliced(stream, n)
    checked = []
    got = _frames(Decoder(device="cpu", recon_strategy=_bodies_strategy(
        _mesh(mesh), checked)), data)
    assert got == want
    aligned = stream != "unaligned"      # its slice 1 spans bands 0 and 1
    assert checked == ([stream == "idc0"] * len(want) if aligned else [])
    st = {}
    assert SL.decode_stream_sliced(data, MESHES[mesh], n, stats=st) == want
    assert st["pictures"] == len(checked)
    assert st["routes"] == dict(ONE_CARD, multi_card_eager=len(checked),
                                multi_card_captured=0, multi_card_replayed=0)


# ------------------------------------------------------- the fake cards
class _FakeEvent:
    """An external event of the fake card: logs its records and waits
    with the capture they fall in (its place in ``captures``), if any."""

    log, captures = [], []

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False, external=False):
        self.external = external

    def _capturing(self):
        live = [g for g in FakeGraph.made
                if g.ops is None and hasattr(g, "_ops")]
        return _FakeEvent.captures.index(live[0]) if live else None

    def record(self, stream=None):
        _FakeEvent.log.append(("record", self, self._capturing()))

    def wait(self, stream=None):
        _FakeEvent.log.append(("wait", self, self._capturing()))

    def synchronize(self):
        pass


@pytest.fixture
def fake_cards(fake_card, monkeypatch):
    """fake_card, with external events that log and a device context that
    does nothing: a mesh of "cpu" and "cpu:0" takes the cards' route."""
    monkeypatch.setattr(_FakeEvent, "log", [])
    monkeypatch.setattr(_FakeEvent, "captures", [])
    begin = FakeGraph.capture_begin

    def capture_begin(self, *a, **k):
        begin(self, *a, **k)
        _FakeEvent.captures.append(self)

    monkeypatch.setattr(FakeGraph, "capture_begin", capture_begin)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    yield fake_card


def _mesh_graphs(pool):
    return [g for free in pool._free.values() for s in free
            for g in s.graphs.graphs()]


def _check_event_order(graphs):
    """Every event that a capture waits on was recorded by a capture made
    before it (the host replays in capture order), each run graph
    records its own event once, and a gather graph waits on every run of
    the other card."""
    order, waits = {}, collections.defaultdict(set)
    for op, ev, at in _FakeEvent.log:
        assert at is not None, f"{op} outside a capture"
        if op == "record":
            assert ev not in order
            order[ev] = at
        else:
            assert ev in order and order[ev] < at
            waits[at].add(ev)
    at = {id(g): k for k, g in enumerate(_FakeEvent.captures)}
    for mg in graphs:
        assert [order[e] for e in mg.done] == \
            [at[id(g)] for g in mg.run_graphs]
        for card, g in mg.gather_graphs.items():
            assert waits[at[id(g)]] == {e for (d, _), e in
                                        zip(mg.runs, mg.done) if d != card}


@pytest.mark.parametrize("pack", ["v2", "none"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_routes_follow_the_policy_and_outlive_the_call(fake_cards,
                                                            mesh, pack):
    """Two decode_stream_sliced calls over the mesh on the (fake) cards:
    a key's first picture eager, its second captured as a graph per run
    and a gather graph per card (waits on records captured before
    them), the rest replayed; the second call, on the same pooled sets
    and mirrors, replays from its first picture of a recurring key."""
    n = len(MESHES[mesh])
    data = streams.banded_stream(width_mbs=6, height_mbs=8, n_bands=n,
                                 n_frames=5, seed=1530 + n, deblock_idc=0)[0]
    keys = _band_keys(data, pack)
    want = _frames(Decoder(device="cpu", recon="numpy"), data)
    routes = []
    for graphs_exist in (False, True):
        st = {}
        assert SL.decode_stream_sliced(data, MESHES[mesh], n, pack=pack,
                                       stats=st) == want
        r = _routes(keys, graphs_exist)
        assert st["routes"] == dict(ONE_CARD, **{
            "multi_card_" + k: v for k, v in r.items()})
        routes.append(st["routes"])
    graphs = _mesh_graphs(fake_cards)
    runs = SL.mesh_runs(_mesh(mesh))
    assert len(graphs) == routes[0]["multi_card_captured"] >= 1
    assert routes[1]["multi_card_captured"] == 0
    assert len(FakeGraph.made) == len(graphs) * (len(runs) + 2)
    for g in graphs:
        assert g.kind == "band_mesh"
        assert len(g.run_graphs) == len(runs)
        assert len(g.gather_graphs) == 2
        assert all(ws.numel() == 8 // n + 1 for ws in g.workspaces)
    _check_event_order(graphs)
    # the decoders' sets and, beside each, the other card's mirror
    assert fake_cards.stats()["sets"] == 2 and \
        fake_cards.stats()["leased"] == 0


@pytest.mark.parametrize("fails", ["capture", "replay"])
def test_failed_mesh_capture_or_replay_raises_without_eager_step(
        fake_cards, monkeypatch, fails):
    """One key for every picture: the capture at the second picture, or
    the replay at the third, raises out of decode_stream_sliced, and no
    eager band step runs in its place (the run body runs once more a run:
    in the capture)."""
    data = streams.banded_stream(width_mbs=12, height_mbs=8, n_bands=2,
                                 n_frames=4, seed=1540, deblock_idc=2)[0]
    assert len(set(_band_keys(data, "v2"))) == 1
    calls, run = [0], SL.decode_band_run

    def spy(*a, **k):
        calls[0] += 1
        if fails == "capture" and calls[0] == 2:
            FakeGraph.fail = "capture"
        return run(*a, **k)

    monkeypatch.setattr(SL, "decode_band_run", spy)
    if fails == "replay":
        record = GR.MeshGraph.record_and_replay

        def captured_then_armed(self, *a, **k):
            out = record(self, *a, **k)
            FakeGraph.fail = "replay"
            return out

        monkeypatch.setattr(GR.MeshGraph, "record_and_replay",
                            captured_then_armed)
    st = {}
    with pytest.raises(RuntimeError, match=f"{fails} failed"):
        SL.decode_stream_sliced(data, MESHES["2"], 2, stats=st)
    assert st["routes"]["multi_card_eager"] == 1
    assert calls[0] == 2 + 2 * (fails == "replay")
    assert fake_cards.stats()["leased"] == 0


def test_sliced_dp_over_rows_of_two_devices(fake_cards):
    """decode_streams_sliced_dp over a [2, 2] grid whose rows are (cpu,
    cpu:0): each stream's band step is a mesh's, routed per stream on its
    own keys; a second call captures nothing."""
    datas = [streams.banded_stream(width_mbs=6, height_mbs=8, n_bands=2,
                                   n_frames=4, seed=1550 + i,
                                   deblock_idc=idc)[0]
             for i, idc in enumerate((0, 2))]
    wants = [_frames(Decoder(device="cpu", recon="numpy"), d) for d in datas]
    keys = [_band_keys(d, "v2") for d in datas]
    for graphs_exist in (False, True):
        st = {}
        assert SL.decode_streams_sliced_dp(datas, [MESHES["2"]] * 2, 2,
                                           stats=st) == wants
        assert [s["routes"] for s in st["streams"]] == [
            dict(ONE_CARD, **{"multi_card_" + k: v for k, v in
                              _routes(kk, graphs_exist).items()})
            for kk in keys]
    assert fake_cards.stats()["sets"] == 4      # two decoders, two mirrors


# ------------------------------------------------------------ the mirrors
def test_mirror_storage_kept_across_declines_on_the_cards(fake_cards,
                                                          monkeypatch):
    """On the (fake) cards, with every other picture declined to the
    decoder's own step: the mirror on cpu:0 keeps one storage for the
    whole stream (the replays' baked addresses), equals the decoder's
    stacks after every refresh, and the frames are the NumPy path's."""
    data = streams.banded_stream(width_mbs=6, height_mbs=8, n_bands=2,
                                 n_frames=7, seed=1560, deblock_idc=0)[0]
    want = _frames(Decoder(device="cpu", recon="numpy"), data)
    aligned, calls = SL._bands_aligned, [0]

    def flaky(pic, n):
        calls[0] += 1
        return calls[0] % 3 != 2 and aligned(pic, n)

    monkeypatch.setattr(SL, "_bands_aligned", flaky)
    ptrs, stacks = set(), SL.BandSlicer._stacks

    def spy(self, dec):
        got = stacks(self, dec)
        (sy, sc), (my, mc) = got[0].values()
        assert torch.equal(sy, my) and torch.equal(sc, mc)
        ptrs.add((my.data_ptr(), mc.data_ptr()))
        return got

    monkeypatch.setattr(SL.BandSlicer, "_stacks", spy)
    st = {}
    assert SL.decode_stream_sliced(data, MESHES["2"], 2, stats=st) == want
    assert st["declined"] == 2 and len(ptrs) == 1
    assert st["routes"]["multi_card_replayed"] >= 1


# ------------------------------------------------------------- peer access
def test_pair_without_peer_access_raises(monkeypatch):
    """A mesh of two cards without peer access between them raises at the
    slicer's construction, naming the pair; no copy goes through the
    host."""
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: (a, b) != (1, 0))
    monkeypatch.setattr(PEER, "_enabled", {(0, 1)})
    mesh = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match=r"cuda:1 cannot access cuda:0"):
        SL.BandSlicer(mesh)


def test_peer_copy_pieces():
    """peer.copy on the CPU: a plain copy; a chroma band cut from a taller
    plane goes as one piece a plane; shapes must agree."""
    src = torch.arange(2 * 6 * 4, dtype=torch.uint8).view(2, 6, 4)
    dst = torch.zeros((2, 10, 4), dtype=torch.uint8)
    PEER.copy(dst[:, 2:5], src[:, 3:6])
    assert torch.equal(dst[:, 2:5], src[:, 3:6])
    assert len(PEER.pieces(dst[:, 2:5], src[:, 3:6])) == 2
    assert len(PEER.pieces(dst[0, :6], src[0])) == 1
    with pytest.raises(ValueError):
        PEER.copy(dst[:, :2], src[:, :3])


# --------------------------------------------------------------- the cards
@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    GR.STACK_POOL.clear()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _card_meshes(cards):
    """4 bands over two cards, interleaved and in two runs, and over four
    distinct cards when there are four."""
    out = {"2x2": cards[:2] * 2, "runs": [cards[0]] * 2 + [cards[1]] * 2}
    if len(cards) >= 4:
        out["4"] = cards[:4]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("idc", [0, 2])
@pytest.mark.parametrize("pack", ["v2", "none"])
def test_mesh_graphs_on_the_cards(cards, idc, pack):
    """The band path over distinct cards (two, and four when there are),
    twice: every frame the single-card decoder's, the picture's halo
    different from picture to picture (a stale halo would show), routes
    as counted on the host (from the third picture on, replays; the
    second call captures nothing), K1 / K2 / K3 once a band."""
    data = streams.banded_stream(width_mbs=12, height_mbs=8, n_bands=4,
                                 n_frames=6, seed=1570 + idc,
                                 deblock_idc=idc)[0]
    want = _frames(Decoder(device=cards[0]), data)
    assert len(set(want)) == len(want)
    keys = _band_keys(data, pack)
    for name, mesh in _card_meshes(cards).items():
        for graphs_exist in (False, True):
            st = {}
            got = SL.decode_stream_sliced(data, mesh, 4, pack=pack, stats=st)
            for d in dict.fromkeys(mesh):
                torch.cuda.synchronize(d)
            assert got == want, name
            r = _routes(keys, graphs_exist)
            assert st["routes"] == dict(ONE_CARD, **{
                "multi_card_" + k: v for k, v in r.items()}), name


@pytest.mark.cuda
def test_mesh_replays_equal_eager_three_times(cards):
    """One key, five pictures over two cards: the eager picture, the
    capture and three replays, each frame byte-equal to the eager band
    step over the same mesh and to the single-card decoder."""
    data = streams.banded_stream(width_mbs=12, height_mbs=8, n_bands=2,
                                 n_frames=5, seed=1580, deblock_idc=0)[0]
    assert len(set(_band_keys(data, "v2"))) == 1
    mesh = cards[:2]
    want = _frames(Decoder(device=cards[0]), data)
    st = {}
    assert SL.decode_stream_sliced(data, mesh, 2, stats=st) == want
    assert st["routes"]["multi_card_replayed"] == 3


@pytest.mark.cuda
def test_peer_access_on_the_cards(cards, monkeypatch):
    """Peer access is on between every pair of the cards once a slicer
    over them exists; a pair without peer access raises, named."""
    SL.BandSlicer(cards)
    assert all((a.index, b.index) in PEER._enabled
               for a in cards for b in cards if a != b)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: False)
    monkeypatch.setattr(PEER, "_enabled", set())
    with pytest.raises(ValueError, match="cuda:0 cannot access cuda:1"):
        SL.BandSlicer(cards[:2])


@pytest.mark.cuda
def test_event_and_copy_across_graphs_on_one_card():
    """The two mechanisms of the mesh graphs, on one card: graph A (its
    own stream and pool) writes a picture-sized buffer from a value and
    records an external event; graph B (another stream and pool) waits on
    the event and ``peer.copy``s A's output. Replayed A then B five times,
    A held back on its stream by a spinning kernel and the value new each
    time: B's copy is always A's newest output, never a stale one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from broadway_tpu_torch.ops.gpu import probe

    dev = torch.device("cuda", torch.cuda.current_device())
    sa, sb = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    val = torch.zeros(1, dtype=torch.uint8, device=dev)
    src = torch.arange(3 << 20, device=dev).to(torch.uint8)
    y = torch.empty_like(src)
    ev = torch.cuda.Event(external=True)
    ga, gb = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    cur = torch.cuda.current_stream(dev)
    sa.wait_stream(cur)
    sb.wait_stream(cur)
    with torch.cuda.stream(sa):
        ga.capture_begin(pool=torch.cuda.graph_pool_handle(),
                         capture_error_mode="thread_local")
        x = src + val
        ev.record(sa)
        ga.capture_end()
    with torch.cuda.stream(sb):
        gb.capture_begin(pool=torch.cuda.graph_pool_handle(),
                         capture_error_mode="thread_local")
        ev.wait(sb)
        PEER.copy(y, x)
        gb.capture_end()
    for k in range(1, 6):
        val.fill_(k)
        sa.wait_stream(cur)
        with torch.cuda.stream(sa):
            probe.hold_stream(2_000_000, dev)      # ~1 ms
            ga.replay()
        with torch.cuda.stream(sb):
            gb.replay()
        cur.wait_stream(sb)
        assert torch.equal(y, src + k), k
