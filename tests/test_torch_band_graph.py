"""The JAX package's last jitted steps as CUDA graphs per key: the band
step of a one-card mesh (``parallel.slices.decode_band_picture`` /
``decode_band_arrays``, the counterparts of ``make_sliced_decoder_x_v2``,
``make_sliced_decoder_v2``, ``make_sliced_decoder_x`` and
``make_sliced_decoder``), the v1 step (``core.recon.
decode_picture_packed_slots``) and the unpacked step
(``decode_host_arrays_slots``), each captured by ``core.graphs.
GroupGraphs.picture`` on pooled stacks.

On the CPU, every check byte equality, at 12x8 MBs in 4 bands of 2 rows
for the band step:
- each body equals its eager step and the JAX package's (the band body
  against ``decode_bands`` + ``update_stack_slot`` and the JAX
  ``decode_stream_sliced``, idc 0 and 2, v2 and host-array forms; the v1
  body against the JAX ``decode_picture_packed``, the unpacked body
  against ``decode_arrays_into_slot`` and the JAX ``decode_picture``); no
  body reads a value derived from its inputs on the host; a key's first
  picture runs the graph's own body eagerly;
- the routing, with tests/test_torch_step_graph.py's ``FakeGraph`` in
  place of ``torch.cuda.CUDAGraph``: a key's first picture eager, its
  second captured, the rest replayed, as counted by packing the stream on
  the host; a second call replays from its first picture of a recurring
  key; a failed capture or replay raises with no eager step in its place;
  ``decode_streams_sliced_dp`` routes per stream and captures nothing on
  its second call, whatever order the streams lease their sets in; the
  pool hands a set back only to a holder of its tag, so a band decoder
  replays after other decoders of its geometry; the unpacked key of a
  wholly concealed picture is not
  the clean picture's; the lockstep's fallback replays; a band decode
  resumed from ``load_state`` replays and gives the JAX bytes.

The tests marked ``cuda`` run the graphs on the card and skip without
one (the band graph first; run them under ``timeout``):

    timeout 600 python -m pytest tests/test_torch_band_graph.py -m cuda -q
"""

import collections
import functools
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from broadway_tpu_torch.core import decoder as TDEC
from broadway_tpu_torch.core import graphs as GR
from broadway_tpu_torch.core import packed as TPK
from broadway_tpu_torch.core import recon as TRC
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.core.state import ref_stacks_from_jax, \
    tables_from_numpy
from broadway_tpu_torch.ops.gpu import mc_kernel as K1
from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
from broadway_tpu_torch.parallel import slices as SL
from broadway_tpu_torch.parallel import streams as LS
from broadway_tpu_torch.tools import streams
from test_torch_step_graph import FakeGraph, fake_card  # noqa: F401

try:        # the reference package; the card's host has no JAX
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from broadway_tpu.core import packed as JPK
    from broadway_tpu.core import recon_tpu as RT
    from broadway_tpu.core.decoder import Decoder as BaseDecoder
    from broadway_tpu.ops.tpu import mc_pallas as K_mcp
    from broadway_tpu.parallel import slices as JSL
except ImportError:
    jax = None

W_MBS, H_MBS, BANDS = 12, 8, 4
# the routes of a mesh over several devices, none on a one-device mesh
NO_MESH = dict.fromkeys(("multi_card_eager", "multi_card_captured",
                         "multi_card_replayed"), 0)


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs JAX and the JAX package (the reference)")


def _band(idc, n_frames=3, seed=1401):
    return streams.banded_stream(width_mbs=W_MBS, height_mbs=H_MBS,
                                 n_bands=BANDS, n_frames=n_frames,
                                 seed=seed + idc, deblock_idc=idc)[0]


_jax_cache = {}


def _jax_sliced(idc):
    """The JAX package's decode_stream_sliced on 4 virtual CPU devices."""
    if idc not in _jax_cache:
        cpus = jax.devices("cpu")
        if len(cpus) < BANDS:
            pytest.skip(f"need {BANDS} virtual cpu devices")
        data = _band(idc)
        mesh = Mesh(np.array(cpus[:BANDS]), ("sp",))
        _jax_cache[idc] = (data, JSL.decode_stream_sliced(data, mesh,
                                                          n_bands=BANDS))
    return _jax_cache[idc]


def _want(data):
    return [o.frame.tobytes()
            for o in BaseDecoder(backend="cpu").decode_annexb(data)]


def _frames(dec, data):
    try:
        return [o.frame.tobytes() for o in dec.decode_annexb(data)]
    finally:
        dec.close()


def _parsed(data):
    """(pic, ci, co, R) of every picture, parsed by the port's decoder."""
    out = []

    def collect(dec, pic):
        out.append((pic, dec.pps.constrained_intra_pred,
                    dec.pps.chroma_qp_index_offset, dec.dpb.dpb_size + 1))
        return TDEC.SKIP_RECON

    Decoder(device="cpu", recon_strategy=collect).decode_annexb(data)
    return out


def _routes(keys, graphs_exist=False):
    """The routes of a call over pictures of these keys: a key's first
    picture eager, its second captured, the rest replayed; with its
    graphs already captured, a key met once eager, the rest replayed."""
    met = collections.Counter(keys)
    if graphs_exist:
        eager, captured = sum(1 for n in met.values() if n == 1), 0
    else:
        eager = len(met)
        captured = sum(1 for n in met.values() if n >= 2)
    return {"eager": eager, "captured": captured,
            "replayed": len(keys) - eager - captured}


def _band_keys(data, pack):
    """Each picture's band key as the host packs it: (bucket triple,
    picture parameters) in the v2 form; one key for every picture of a
    geometry in the host-array form (its layout; no picture concealed)."""
    if pack == "none":
        return [0] * len(_parsed(data))
    return [(p[1], p[3], p[4]) for p in TPK.pack_stream(data)]


# ----------------------------------------------------------------- bodies
def _band_to(stacked, k):
    """Band k of stacked host arrays as tensors, whole_conceal a 0-dim
    tensor on the host."""
    arrs = tables_from_numpy({key: v[k] for key, v in stacked.items()
                              if key != "whole_conceal"})
    arrs["whole_conceal"] = torch.from_numpy(
        np.array(stacked["whole_conceal"][k]))
    return arrs


def _checking_strategy(pack, checked):
    """A recon_strategy that runs each picture's band body on the
    decoder's stacks and holds it against the eager decode_bands +
    update_stack_slot on copies of them, output and stacks."""
    def strategy(dec, pic):
        w, h = dec.sps.width_mbs, dec.sps.height_mbs
        hb = h // BANDS
        ci, co = dec.pps.constrained_intra_pred, dec.pps.chroma_qp_index_offset
        cross = any(sp.disable_deblocking_idc == 0 for sp in pic.slice_params)
        sy, sc, slot = dec.reference_stacks()
        ey, ec = sy.clone(), sc.clone()
        slots = torch.tensor([slot])
        mesh = [torch.device("cpu")] * BANDS
        if pack == "v2":
            lay = TPK.get_packed_layout_v2(w, h)
            buf, bk = TPK.pack_picture_v2(pic, lay, TPK.PackScratchV2(lay))
            whole = TPK.unpack_arrs_v2(torch.from_numpy(buf), lay, bk, ci, co)
            cut = SL.cut_band_ghost if cross else SL.cut_band
            bands = [cut(whole, k, w, hb) for k in range(BANDS)]
            yuv = SL.decode_band_picture(torch.from_numpy(buf[None]), sy, sc,
                                         slots, BANDS, cross, lay, bk, ci, co)
        else:
            make = SL.band_host_arrays_ghost if cross else SL.band_host_arrays
            stacked = make(pic, BANDS, co, ci)
            bands = [_band_to(stacked, k) for k in range(BANDS)]
            layout = TPK.host_arrays_layout(stacked)
            yuv = SL.decode_band_arrays(
                torch.from_numpy(TPK.pack_host_arrays(stacked, layout)[None]),
                sy, sc, slots, layout, BANDS, cross, w, h, co, False)
        want = SL.decode_bands(bands, mesh, {mesh[0]: (ey, ec)}, w, h, co,
                               cross)[mesh[0]]
        TRC.update_stack_slot(ey, ec, slot, TRC.TorchFrame(want, 16 * w,
                                                           16 * h))
        assert torch.equal(yuv[0], want)
        assert torch.equal(sy, ey) and torch.equal(sc, ec)
        checked.append(cross)
        return TRC.TorchFrame(yuv[0], 16 * w, 16 * h)
    return strategy


@pytest.mark.parametrize("pack", ["v2", "none"])
@pytest.mark.parametrize("idc", [0, 2])
def test_band_body_equals_the_eager_band_step_and_jax(idc, pack, jax_ref):
    data, want = _jax_sliced(idc)
    checked = []
    got = _frames(Decoder(device="cpu",
                          recon_strategy=_checking_strategy(pack, checked)),
                  data)
    assert got == want
    assert checked == [idc == 0] * len(want) and len(want) == 3


def _v1_pictures(data):
    """(buf, kb, lay, ci, co, R) of each picture packed in v1."""
    out = []
    for pic, ci, co, R in _parsed(data):
        lay = TPK.get_packed_layout(pic.width_mbs, pic.height_mbs)
        buf, kb = TPK.pack_picture(pic, lay, TPK.PackScratch(lay))
        out.append((buf, kb, lay, ci, co, R))
    return out


def _jax_stacks(R, W, H):
    hy, wy = K_mcp.luma_ext_dims(W, H)
    hc, wc = K_mcp.chroma_ext_dims(W, H)
    return (jnp.zeros((R, hy, wy), jnp.int32),
            jnp.zeros((R, hc, wc), jnp.int32))


@pytest.mark.parametrize("form", ["v1", "unpacked"])
def test_v1_and_unpacked_bodies_equal_the_eager_steps_and_jax(form, jax_ref):
    """An IDR and P pictures over two references: the body (slot on the
    device; on a card's first picture of a key it is the eager step too),
    the JAX package's step (mc="xla", wf="xla") and, for the unpacked
    arrays, the eager whole-picture ``decode_arrays_into_slot`` (the v2
    step's tail) give the same YUV and the same stacks."""
    data = streams.inter_stream(width_mbs=5, height_mbs=4, n_frames=3,
                                seed=1411, deblock=True, mvd_range=40,
                                num_ref_frames=2, multi_ref_idx=True)[0]
    parsed = _parsed(data)
    w, h = parsed[0][0].width_mbs, parsed[0][0].height_mbs
    W, H, R = 16 * w, 16 * h, parsed[0][3]
    steps = {k: jnp.asarray(v) for k, v in RT.step_tables(w, h).items()}
    jy, jc = _jax_stacks(R, W, H)
    ey = torch.zeros((R, H, W), dtype=torch.uint8)
    ec = torch.zeros((R, 2, H // 2, W // 2), dtype=torch.uint8)
    gy, gc_ = ey.clone(), ec.clone()
    v1 = _v1_pictures(data)
    for k, (pic, ci, co, _) in enumerate(parsed):
        slot = (2 * k + 1) % R
        slots = torch.tensor([slot])
        if form == "v1":
            buf, kb, lay = v1[k][:3]
            arrs = TPK.unpack_arrs(torch.from_numpy(buf), lay, kb, ci, co)
            eager = TRC.decode_arrays_into_slot(arrs, ey, ec, slot, w, h, co)
            body = TRC.decode_picture_packed_slots(
                torch.from_numpy(buf[None]), gy, gc_, slots, lay, kb, ci, co)
            y, cb, cr, jy, jc = RT.decode_picture_packed(
                jnp.asarray(buf), jy, jc, slot, steps,
                lay=JPK.get_packed_layout(w, h), kb=kb, constrained_intra=ci,
                chroma_qp_offset=co, mc="xla", wf="xla")
        else:
            arrs = TRC.host_picture_arrays(pic, co, ci)
            eager = TRC.decode_arrays_into_slot(tables_from_numpy(arrs), ey,
                                                ec, slot, w, h, co)
            layout = TPK.host_arrays_layout(arrs)
            body = TRC.decode_host_arrays_slots(
                torch.from_numpy(TPK.pack_host_arrays(arrs, layout)[None]),
                gy, gc_, slots, layout, w, h, co, False)
            y, cb, cr = RT.decode_picture(
                {key: jnp.asarray(v) for key, v in arrs.items()}, jy, jc,
                steps, w_mbs=w, h_mbs=h, chroma_qp_offset=co, mc="xla",
                wf="xla")
            jy, jc = RT.update_stack_slot(jy, jc, slot, y, cb, cr)
        eager = eager.tobytes()
        assert bytes(body[0].numpy()) == eager, k
        assert b"".join(np.asarray(p).astype(np.uint8).tobytes()
                        for p in (y, cb, cr)) == eager, k
        assert torch.equal(gy, ey) and torch.equal(gc_, ec), k
        sy, sc = ref_stacks_from_jax(np.asarray(jy), np.asarray(jc), W, H)
        assert torch.equal(sy, ey) and torch.equal(sc, ec), k
    assert int(ey.sum()) > 0


def test_host_arrays_buffer_round_trips():
    """pack_host_arrays / view_host_arrays: every array back with its
    values and tables_from_numpy's type, at aligned offsets; the layout
    depends on the geometry only (every picture of a stream has one), and
    a shape that is not the layout's is refused."""
    data = streams.inter_stream(width_mbs=5, height_mbs=4, n_frames=3,
                                seed=1412, deblock=True)[0]
    layouts = set()
    for pic, ci, co, _ in _parsed(data):
        arrs = TRC.host_picture_arrays(pic, co, ci)
        layout = TPK.host_arrays_layout(arrs)
        layouts.add(layout)
        views = TPK.view_host_arrays(
            torch.from_numpy(TPK.pack_host_arrays(arrs, layout)), layout)
        want = tables_from_numpy({k: v for k, v in arrs.items()
                                  if k != "whole_conceal"})
        assert sorted(views) == sorted(want)
        for k, v in want.items():
            assert views[k].dtype == v.dtype and torch.equal(views[k], v), k
        assert all(off % 256 == 0 for *_, off in layout[:-1])
    assert len(layouts) == 1
    arrs["qp"] = arrs["qp"][:-1]
    with pytest.raises(ValueError, match="qp"):
        TPK.pack_host_arrays(arrs, layout)


def _body_case(name):
    """(body, its inputs) for one picture of each form. The bodies of a
    mesh over several cards: a run of bands 1 and 2, its halo (band 0's
    final planes) and the gather's final planes all views of the stacks,
    so that their reads are followed as the inputs' are."""
    idc = 0 if name.endswith("idc0") else 2
    data = _band(idc, n_frames=2, seed=1420)
    pic, ci, co, R = _parsed(data)[1]             # a P picture
    w, h = pic.width_mbs, pic.height_mbs
    sy = torch.zeros((R, 16 * h, 16 * w), dtype=torch.uint8)
    sc = torch.zeros((R, 2, 8 * h, 8 * w), dtype=torch.uint8)
    slots = torch.tensor([1])
    if name.startswith("mesh"):
        lay = TPK.get_packed_layout_v2(w, h)
        buf, bk = TPK.pack_picture_v2(pic, lay, TPK.PackScratchV2(lay))
        cross, rows = idc == 0, (h // BANDS + (idc == 0))
        if name.startswith("mesh_run"):
            def body(bufs, ref_y, ref_c, slots, workspace):
                return SL.decode_band_run(
                    bufs, ref_y, ref_c, (1, 2), ("v2", lay, bk, ci, co),
                    BANDS, cross, w, h, co, halo=(ref_y[0], ref_c[0]),
                    workspace=workspace)[-1][0]
        else:
            def body(bufs, ref_y, ref_c, slots, workspace):
                finals = [(ref_y[k % R, :16 * rows], ref_c[k % R, :, :8 * rows])
                          for k in range(BANDS)]
                return SL.gather_into_slot(finals, ref_y, ref_c, slots, w, h,
                                           cross)
    elif name.startswith("band_v2"):
        lay = TPK.get_packed_layout_v2(w, h)
        buf, bk = TPK.pack_picture_v2(pic, lay, TPK.PackScratchV2(lay))
        body = functools.partial(SL.decode_band_picture, n_bands=BANDS,
                                 cross=idc == 0, lay=lay, bk=bk,
                                 constrained_intra=ci, chroma_qp_offset=co)
    elif name.startswith("band_arrays"):
        make = SL.band_host_arrays_ghost if idc == 0 else SL.band_host_arrays
        stacked = make(pic, BANDS, co, ci)
        layout = TPK.host_arrays_layout(stacked)
        buf = TPK.pack_host_arrays(stacked, layout)
        body = functools.partial(SL.decode_band_arrays, layout=layout,
                                 n_bands=BANDS, cross=idc == 0, w_mbs=w,
                                 h_mbs=h, chroma_qp_offset=co,
                                 whole_conceal=False)
    elif name == "v1":
        buf, kb, lay = _v1_pictures(data)[1][:3]
        body = functools.partial(TRC.decode_picture_packed_slots, lay=lay,
                                 kb=kb, constrained_intra=ci,
                                 chroma_qp_offset=co)
    else:
        arrs = TRC.host_picture_arrays(pic, co, ci)
        layout = TPK.host_arrays_layout(arrs)
        buf = TPK.pack_host_arrays(arrs, layout)
        body = functools.partial(TRC.decode_host_arrays_slots, layout=layout,
                                 w_mbs=w, h_mbs=h, chroma_qp_offset=co,
                                 whole_conceal=False)
    return body, (torch.from_numpy(buf[None]), sy, sc, slots)


@pytest.mark.parametrize("name", ["band_v2_idc0", "band_v2_idc2",
                                  "band_arrays_idc0", "v1", "unpacked",
                                  "mesh_run_idc0", "mesh_run_idc2",
                                  "mesh_gather_idc0"])
def test_bodies_read_no_input_on_the_host(name, monkeypatch):
    """What a CUDA graph captures may not read a device value on the host,
    nor make a shape of one. Under a dispatch mode that follows which
    tensors derive from the body's inputs (buffer, stacks, slot), no
    ``_local_scalar_dense`` or ``nonzero`` reads one: the host reads left
    are of the whole_conceal flags, made on the host. The kernels' plain
    versions, which read the host but never run on the card, are stubbed
    out."""
    body, inputs = _body_case(name)

    def mc_stub(ref_y, ref_c, mv, *a, **k):
        n = mv.shape[0]
        return (torch.zeros((n, 16, 16), dtype=torch.uint8),
                torch.zeros((n, 8, 16), dtype=torch.uint8))

    monkeypatch.setattr(K1, "mc_predict", mc_stub)
    monkeypatch.setattr(KW, "intra_wavefront", lambda *a, **k: None)
    monkeypatch.setattr(KW, "deblock_wavefront", lambda *a, **k: None)
    ptr = lambda t: t.untyped_storage().data_ptr()
    # storages, so that a view or an in-place write is followed too; the
    # tensors are held, so that no storage is freed and handed out again
    held = list(inputs)
    derived = {ptr(t) for t in held}
    reads = []
    host_reads = (torch.ops.aten._local_scalar_dense.default,
                  torch.ops.aten.nonzero.default)

    class InputReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            from_inputs = any(ptr(t) in derived for t in ins)
            if func in host_reads:
                reads.append(from_inputs)
            elif from_inputs:
                for t in ins + tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        held.append(t)
                        derived.add(ptr(t))
            return out

    with InputReads():
        yuv = body(*inputs, workspace=None)
    assert ptr(yuv) in derived
    assert not any(reads)


# ------------------------------------------------------ the fake card
def _arm_on(monkeypatch, module, name, fails, at=1):
    """Wrap module.name (an eager step): its call number `at` arms
    FakeGraph to fail the next capture (fails="capture"); with
    fails="replay", every capture arms it to fail the replay after the
    capture's own. Returns the eager step's call count."""
    calls, step = [0], getattr(module, name)

    def spy(*a, **k):
        calls[0] += 1
        if fails == "capture" and calls[0] == at:
            FakeGraph.fail = "capture"
        return step(*a, **k)

    monkeypatch.setattr(module, name, spy)
    if fails == "replay":
        record = GR.GroupGraph.record_and_replay

        def captured_then_armed(self, *a, **k):
            out = record(self, *a, **k)
            FakeGraph.fail = "replay"
            return out

        monkeypatch.setattr(GR.GroupGraph, "record_and_replay",
                            captured_then_armed)
    return calls


@pytest.mark.parametrize("pack", ["v2", "none"])
def test_band_routes_follow_the_policy_and_outlive_the_call(fake_card,
                                                            pack):
    """Two decode_stream_sliced calls of one geometry on the (fake) card:
    the first runs each key's first picture eagerly, captures its second
    and replays the rest; the second, on the same pooled set, replays
    from its first picture of a recurring key and captures nothing."""
    data = _band(0, n_frames=6, seed=1430)
    keys = _band_keys(data, pack)
    want = _want(data)
    routes = []
    for graphs_exist in (False, True):
        st = {}
        assert SL.decode_stream_sliced(data, "cpu", BANDS, pack=pack,
                                       stats=st) == want
        assert st["routes"] == dict(_routes(keys, graphs_exist),
                                    **NO_MESH)
        routes.append(st["routes"])
    assert len(FakeGraph.made) == routes[0]["captured"] >= 1
    assert routes[1]["captured"] == 0 and routes[1]["replayed"] >= 1
    graphs = [g for free in fake_card._free.values() for s in free
              for g in s.graphs.graphs()]
    assert [g.kind for g in graphs] == \
        ["band" if pack == "v2" else "band_arrays"] * len(graphs)
    assert all(g.workspace.numel() == H_MBS // BANDS + 1 for g in graphs)


@pytest.mark.parametrize("fails", ["capture", "replay"])
@pytest.mark.parametrize("pack", ["v2", "none"])
def test_failed_band_capture_or_replay_raises_without_eager_step(
        fake_card, monkeypatch, pack, fails):
    """One key for every picture of the stream (at 12x8 MBs the IDR's
    buckets are the P pictures'): the capture at the second picture, or
    the replay at the third, raises out of decode_stream_sliced, and no
    eager band step runs in its place (the body runs once more: in the
    capture)."""
    data = _band(2, n_frames=4, seed=1440)
    assert len(set(_band_keys(data, pack))) == 1
    eager = _arm_on(monkeypatch, SL, "decode_band_picture" if pack == "v2"
                    else "decode_band_arrays", fails)
    st = {}
    with pytest.raises(RuntimeError, match=f"{fails} failed"):
        SL.decode_stream_sliced(data, "cpu", BANDS, pack=pack, stats=st)
    assert st["routes"]["eager"] == 1
    assert eager[0] == 1 + (fails == "replay")
    assert fake_card.stats()["leased"] == 0


def test_sliced_dp_routes_per_stream_and_second_call_captures_nothing(
        fake_card):
    """Two streams (idc 0 and idc 2), each band-sharded over its row of a
    [2, 2] grid of one device: each stream's routes follow the policy on
    its own keys, each on its own decoder's set; a second call leases
    each stream the set that holds its graphs, and captures nothing."""
    datas = [streams.banded_stream(width_mbs=W_MBS, height_mbs=H_MBS,
                                   n_bands=2, n_frames=4, seed=1450 + i,
                                   deblock_idc=idc)[0]
             for i, idc in enumerate((0, 2))]
    wants = [_want(d) for d in datas]
    keys = [_band_keys(d, "v2") for d in datas]
    for graphs_exist in (False, True):
        st = {}
        assert SL.decode_streams_sliced_dp(datas, [["cpu"] * 2] * 2, 2,
                                           stats=st) == wants
        assert [s["routes"] for s in st["streams"]] == \
            [dict(_routes(k, graphs_exist), **NO_MESH)
             for k in keys]
        assert st["rounds"] == 4
    assert len(FakeGraph.made) == sum(_routes(k)["captured"] for k in keys)
    assert fake_card.stats()["sets"] == 2


@pytest.mark.parametrize("order", ["free_list_reversed",
                                   "first_picture_declined"])
def test_sliced_dp_second_call_captures_nothing_whatever_the_lease_order(
        fake_card, monkeypatch, order):
    """The second decode_streams_sliced_dp call gives each stream back the
    set that holds its graphs (the pool tag ("sliced_dp", i)), also when
    the free sets lie in the other order (as if the streams had closed
    the other way round), or when stream 0's first picture is declined to
    its own decoder, which then leases its set from its own thread after
    stream 1's was leased in the round: the streams' keys differ (idc 0
    and idc 2), so a swapped set would capture again."""
    datas = [streams.banded_stream(width_mbs=W_MBS, height_mbs=H_MBS,
                                   n_bands=2, n_frames=4, seed=1455 + i,
                                   deblock_idc=idc)[0]
             for i, idc in enumerate((0, 2))]
    wants = [_want(d) for d in datas]
    keys = [_band_keys(d, "v2") for d in datas]
    if order == "first_picture_declined":
        keys[0] = keys[0][1:]
        orig = SL.BandSlicer.__call__

        def declining(self, dec, pic):
            if dec.stack_affinity == ("sliced_dp", 0) and \
                    dec.pic_number == 0:
                self.stats["declined"] += 1
                return None
            return orig(self, dec, pic)

        monkeypatch.setattr(SL.BandSlicer, "__call__", declining)
    for graphs_exist in (False, True):
        st = {}
        assert SL.decode_streams_sliced_dp(datas, [["cpu"] * 2] * 2, 2,
                                           stats=st) == wants
        assert [s["routes"] for s in st["streams"]] == \
            [dict(_routes(k, graphs_exist), **NO_MESH)
             for k in keys]
        assert [s["declined"] for s in st["streams"]] == \
            [int(order == "first_picture_declined"), 0]
        if order == "free_list_reversed":
            for free in fake_card._free.values():
                free.reverse()
    assert len(FakeGraph.made) == sum(_routes(k)["captured"] for k in keys)
    assert fake_card.stats()["sets"] == 2


def test_pool_hands_a_set_back_to_the_holder_of_its_tag():
    """StackPool.lease(affinity=): a free set goes back only to a holder
    of its tag (the set of that tag returned last), wherever it lies
    among the free sets; an unknown tag gets a new set, and no tag the
    untagged set."""
    pool = GR.StackPool()
    sets = {tag: pool.lease("cpu", 32, 32, 2, affinity=tag)
            for tag in ("a", "b", "c", None)}
    for tag in ("a", "c", None, "b"):
        pool.release(sets[tag])
    assert pool.lease("cpu", 32, 32, 2, affinity="c") is sets["c"]
    assert pool.lease("cpu", 32, 32, 2, affinity="a") is sets["a"]
    new = pool.lease("cpu", 32, 32, 2, affinity="z")
    assert new.affinity == "z" and new not in sets.values()
    got = pool.lease("cpu", 32, 32, 2)
    assert got is sets[None] and got.affinity is None
    assert pool.lease("cpu", 32, 32, 2, affinity="c") is not sets["c"]
    assert pool.lease("cpu", 32, 32, 2, affinity="b") is sets["b"]


@pytest.mark.parametrize("order", ["as_returned", "free_lists_reversed"])
def test_band_decoder_gets_back_its_set_after_other_decoders(fake_card,
                                                             order):
    """A band decoder's set is leased under the slicer's tag ("band"):
    after a band call, default decoders and two decode_streams_sliced_dp
    calls of the same geometry, in turns, a band decoder made by hand
    (Decoder(recon_strategy=BandSlicer)) still replays from its first
    picture of a recurring key, whatever order the free sets lie in."""
    data = _band(0, n_frames=4, seed=1457)
    want = _want(data)
    keys = _band_keys(data, "v2")
    mesh = SL.make_band_mesh("cpu", BANDS)
    st = {}
    assert SL.decode_stream_sliced(data, mesh, BANDS, stats=st) == want
    assert st["routes"] == dict(_routes(keys), **NO_MESH)
    for _ in range(2):
        assert _frames(Decoder(device="cpu"), data) == want
        assert SL.decode_streams_sliced_dp([data, data], [["cpu"] * 2] * 2,
                                           2) == [want, want]
    if order == "free_lists_reversed":
        for free in fake_card._free.values():
            free.reverse()
    assert _frames(Decoder(device="cpu"), data) == want
    st = {}
    dec = Decoder(device="cpu", recon_strategy=SL.BandSlicer(mesh, stats=st))
    assert dec.stack_affinity == "band"
    assert _frames(dec, data) == want
    assert st["routes"] == dict(_routes(keys, True), **NO_MESH)
    assert fake_card.stats()["sets"] == 4     # default, band, two dp


def test_band_decode_resumed_from_load_state(fake_card):
    """save_state after the band graphs' captures, load_state into a new
    band-sliced decoder: it replays the same graphs on re-seeded stacks,
    and the frames equal the JAX package's."""
    data = _band(0, n_frames=6, seed=1460)
    want = _want(data)
    nals = [TDEC.NalUnit(p) for _, p in TDEC.br.split_nal_units(data)]
    mesh = SL.make_band_mesh("cpu", BANDS)
    st = {}
    dec = Decoder(device="cpu", recon_strategy=SL.BandSlicer(mesh, stats=st))
    k = 0
    while dec.pic_number < 4 or dec.pic is not None:
        dec.decode_nal(nals[k])
        k += 1
    assert st["routes"]["captured"] >= 1
    state = dec.save_state()
    head = [o.frame.tobytes() for o in dec.outputs]
    dec.close()
    st2 = {}
    resumed = Decoder(device="cpu",
                      recon_strategy=SL.BandSlicer(mesh, stats=st2))
    resumed.load_state(state)
    for nal in nals[k:]:
        resumed.decode_nal(nal)
    resumed.flush()
    tail = [o.frame.tobytes() for o in resumed.outputs]
    resumed.close()
    assert head + tail == want
    assert st2["routes"]["captured"] == 0 and st2["routes"]["replayed"] >= 1
    assert st["pictures"] + st2["pictures"] == len(want)


def test_mesh_over_two_devices_counts_eager_multi_card():
    """cpu and cpu:0 are two device objects: the mesh runs the band step
    of a mesh over several devices, eagerly on the CPU, counted as its
    own route (multi_card_eager; eager_multi_card until the mesh had
    graphs on cards)."""
    data = _band(2, n_frames=3, seed=1470)
    st = {}
    got = SL.decode_stream_sliced(data, ["cpu", "cpu:0"] * 2, BANDS,
                                  stats=st)
    assert got == _frames(Decoder(device="cpu", recon="numpy"), data)
    assert st["routes"] == dict(NO_MESH, eager=0, captured=0, replayed=0,
                                multi_card_eager=3)


def _v1_keys(data):
    return [(p[1], p[3], p[4]) for p in _v1_pictures(data)]


@pytest.mark.parametrize("pack", ["v1", "none"])
def test_v1_and_unpacked_decoders_route_through_graphs(fake_card, pack):
    """Decoder(pack="v1" | "none") on the (fake) card: a key's first
    picture eager, its second captured, the rest replayed, every frame
    the JAX package's; a second decoder captures nothing."""
    data = streams.inter_stream(width_mbs=5, height_mbs=4, n_frames=6,
                                seed=1480, deblock=True, mvd_range=30)[0]
    keys = _v1_keys(data) if pack == "v1" else [0] * 6
    want = _want(data)
    counts = []
    for graphs_exist in (False, True):
        dec = Decoder(device="cpu", pack=pack)
        got = [o.frame.tobytes() for o in dec.decode_annexb(data)]
        counts.append(dict(dec.group_graphs.counts))
        dec.close()
        assert got == want
        assert counts[-1] == _routes(keys, graphs_exist)
    assert counts[0]["captured"] >= 1
    graphs = [g for free in fake_card._free.values() for s in free
              for g in s.graphs.graphs()]
    assert {g.kind for g in graphs} == {"v1" if pack == "v1" else "unpacked"}


@pytest.mark.parametrize("fails", ["capture", "replay"])
def test_failed_unpacked_capture_or_replay_raises_without_eager_step(
        fake_card, monkeypatch, fails):
    """Decoder(pack="none"), one key for every picture: the capture at the
    second picture, or the replay at the third, raises out of the decoder,
    and no eager step runs in its place (the body runs once more: in the
    capture)."""
    data = streams.inter_stream(width_mbs=5, height_mbs=4, n_frames=4,
                                seed=1490, deblock=True)[0]
    eager = _arm_on(monkeypatch, GR, "decode_host_arrays_slots", fails)
    dec = Decoder(device="cpu", pack="none")
    with pytest.raises(RuntimeError, match=f"{fails} failed"):
        dec.decode_annexb(data)
    dec.close()
    assert eager[0] == 1 + (fails == "replay") and dec._stacks is None


def test_unpacked_key_holds_the_whole_conceal_flag(fake_card, jax_ref):
    """One set, one slot that the picture does not read: a P picture's
    arrays clean and wholly concealed (K3 skipped), each twice and then
    once more in turn, through graphs.unpacked_step. The concealed picture
    makes a key of its own (so no capture freezes the flag), and every
    result equals the JAX package's decode_picture on the same arrays."""
    data = streams.inter_stream(width_mbs=5, height_mbs=4, n_frames=2,
                                seed=1500, deblock=True)[0]
    pic, ci, co, R = _parsed(data)[1]
    w, h = pic.width_mbs, pic.height_mbs
    W, H = 16 * w, 16 * h
    clean = TRC.host_picture_arrays(pic, co, ci)
    concealed = dict(clean, whole_conceal=np.array(True))
    slot = max(set(range(R)) - set(np.unique(clean["ref_blk"]).tolist()))
    rng = np.random.RandomState(1501)
    s = fake_card.lease("cpu", W, H, R)
    s.stack_y.copy_(torch.from_numpy(rng.randint(0, 256, s.stack_y.shape,
                                                 dtype=np.uint8)))
    s.stack_c.copy_(torch.from_numpy(rng.randint(0, 256, s.stack_c.shape,
                                                 dtype=np.uint8)))
    steps = {k: jnp.asarray(v) for k, v in RT.step_tables(w, h).items()}
    jy = jnp.stack([K_mcp.pad_luma(jnp.asarray(p, jnp.int32))
                    for p in s.stack_y.numpy()])
    jc = jnp.stack([K_mcp.pad_chroma(jnp.asarray(p[0], jnp.int32),
                                     jnp.asarray(p[1], jnp.int32))
                    for p in s.stack_c.numpy()])
    wants = {}
    for name, arrs in (("clean", clean), ("concealed", concealed)):
        y, cb, cr = RT.decode_picture(
            {k: jnp.asarray(v) for k, v in arrs.items()}, jy, jc, steps,
            w_mbs=w, h_mbs=h, chroma_qp_offset=co, mc="xla", wf="xla")
        wants[name] = b"".join(np.asarray(p).astype(np.uint8).tobytes()
                               for p in (y, cb, cr))
    assert wants["clean"] != wants["concealed"]
    order = ["clean", "clean", "concealed", "concealed", "clean",
             "concealed"]
    for k, name in enumerate(order):
        arrs = clean if name == "clean" else concealed
        yuv = GR.unpacked_step(s, arrs, slot, s.stack_y, s.stack_c, co).yuv
        assert bytes(yuv.numpy()) == wants[name], (k, name)
    assert s.graphs.counts == {"eager": 2, "captured": 2, "replayed": 2}
    assert sorted(g.kind for g in s.graphs.graphs()) == ["unpacked"] * 2
    fake_card.release(s)


def test_lockstep_fallback_replays(fake_card, monkeypatch):
    """Two streams of 5 pictures whose pictures 2-4 the v2 packer
    declines: each stream's declined pictures take the unpacked fallback
    on its own stacks of the lockstep set, eager, captured, replayed (one
    key a stream); the rounds count apart; every stream equals its
    single-stream decode."""
    datas = [streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=5,
                                  seed=1510 + s, deblock=True,
                                  mvd_range=30)[0] for s in range(2)]
    wants = [_want(d) for d in datas]
    packed = [TPK.pack_stream(d) for d in datas]
    keys = [(tuple(max(p[k][1][j] for p in packed) for j in range(3)),
             packed[0][k][3], packed[0][k][4]) for k in (0, 4)]
    orig, calls, lock = TPK.pack_picture_v2, {}, threading.Lock()

    def declining(*a, **k):
        with lock:
            me = threading.get_ident()
            calls[me] = calls.get(me, 0) + 1
            decline = 2 <= calls[me] <= 4
        return None if decline else orig(*a, **k)

    monkeypatch.setattr(TPK, "pack_picture_v2", declining)
    st = {}
    assert LS.decode_streams_lockstep(datas, device="cpu", parallel_slices=2,
                                      stats=st) == wants
    assert st["fallbacks"] == 6 and st["batches"] == [2, 2]
    assert st["fallback_routes"] == {"eager": 2, "captured": 2,
                                     "replayed": 2}
    assert st["routes"] == _routes(keys)
    graphs = [g for free in fake_card._free.values() for s in free
              for g in s.graphs.graphs()]
    assert collections.Counter(g.kind for g in graphs) == \
        {"unpacked": 2, "round": st["routes"]["captured"]}


# ---------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    GR.STACK_POOL.clear()
    return torch.device("cuda")


def _launches():
    return (K1.mc_predict.launches, KW.intra_wavefront.launches,
            KW.deblock_wavefront.launches, KW.device_launches(KW.INTRA),
            KW.device_launches(KW.DEBLOCK))


@pytest.mark.cuda
@pytest.mark.parametrize("pack", ["v2", "none"])
@pytest.mark.parametrize("idc", [0, 2])
def test_band_graphs_on_the_card(card, idc, pack):
    """The band path over a one-card mesh of 4 bands (K2 over 2 rows, K3
    over 3 with the ghost row), twice: every frame the port's NumPy
    path's, routes as counted on the host, K1 / K2 / K3 4 a picture
    through the replays, and the second call captures nothing."""
    data = _band(idc, n_frames=6, seed=1520)
    want = _frames(Decoder(device="cpu", recon="numpy"), data)
    keys = _band_keys(data, pack)
    for graphs_exist in (False, True):
        before = _launches()
        st = {}
        assert SL.decode_stream_sliced(data, "cuda", BANDS, pack=pack,
                                       stats=st) == want
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_launches(), before)] == \
            [BANDS * len(want)] * 5
        assert st["routes"] == dict(_routes(keys, graphs_exist),
                                    **NO_MESH)


@pytest.mark.cuda
@pytest.mark.parametrize("pack", ["v1", "none"])
def test_v1_and_unpacked_graphs_on_the_card(card, pack):
    data = streams.realistic_stream(width_mbs=12, height_mbs=8, n_frames=6,
                                    n_slices=3, seed=1530)[0]
    want = _frames(Decoder(device="cpu", recon="numpy"), data)
    keys = _v1_keys(data) if pack == "v1" else [0] * len(want)
    for graphs_exist in (False, True):
        before = _launches()
        dec = Decoder(device="cuda", pack=pack)
        got = [o.frame.tobytes() for o in dec.decode_annexb(data)]
        counts = dict(dec.group_graphs.counts)
        dec.close()
        torch.cuda.synchronize()
        assert got == want
        assert [a - b for a, b in zip(_launches(), before)] == \
            [len(want)] * 5
        assert counts == _routes(keys, graphs_exist)
