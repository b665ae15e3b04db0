"""Band-sharded decode of the port (``broadway_tpu_torch.parallel.slices``)
on the CPU, through the kernels' plain versions, held against the JAX
package's ``parallel/slices.py`` on virtual CPU devices and against the
port's own single-stream decoder: the three cases of
tests/test_slice_parallel.py (independent bands, the idc-0 chained
deblock, the unaligned decline) in both upload forms, the 2-D form on a
2 x 2 grid, and the pieces on their own: K1's band form, the banded host
arrays, the device cut of a v2 unpack, and the ghost row that K3 filters
into. Every comparison is byte equality.

The cases marked ``cuda`` hold K1's and K3's band forms on the card
against their plain versions and skip without one."""

import numpy as np
import pytest
import torch

import streams
from broadway_tpu_torch.core import decoder as TDEC
from broadway_tpu_torch.core import packed as TPK
from broadway_tpu_torch.core import recon as TRC
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.core.state import tables_from_numpy
from broadway_tpu_torch.ops.gpu import deblock as TDB
from broadway_tpu_torch.ops.gpu import inter
from broadway_tpu_torch.ops.gpu import mc_kernel as K1
from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
from broadway_tpu_torch.parallel import slices as SL
from broadway_tpu_torch.parallel import streams as LS

try:        # the reference package; the card's host has no JAX
    import jax
    from jax.sharding import Mesh
    from broadway_tpu.core import decoder as JDEC
    from broadway_tpu.core import recon_tpu as RT
    from broadway_tpu.ops.tpu import mc_pallas as K_mcp
    from broadway_tpu.parallel import slices as JSL
except ImportError:
    jax = None



@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs JAX and the JAX package (the reference)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the cases of tests/test_slice_parallel.py: name -> (stream, its
# pictures, how many take the idc-0 chain, how many are declined)
CASES = {
    "idc2": (lambda: streams.banded_stream(n_bands=4, height_mbs=4,
                                           n_frames=3, seed=702)[0], 3, 0, 0),
    "idc0": (lambda: streams.banded_stream(n_bands=4, height_mbs=8,
                                           n_frames=3, seed=703,
                                           deblock_idc=0)[0], 3, 3, 0),
    # 3 slices over 4 bands, and 6 rows do not divide by 4
    "unaligned": (lambda: streams.multislice_stream(
        width_mbs=4, height_mbs=6, n_frames=2, n_slices=3, seed=704)[0],
        2, 0, 2),
}

_jax_cache = {}


def _frames(dec, data):
    return [o.frame.tobytes() for o in dec.decode_annexb(data)]


def _cpus(n):
    cpus = jax.devices("cpu")
    if len(cpus) < n:
        pytest.skip(f"need {n} virtual cpu devices")
    return cpus[:n]


def _jax_sliced(name):
    """The JAX package's decode_stream_sliced on 4 virtual CPU devices."""
    if name not in _jax_cache:
        data = CASES[name][0]()
        mesh = Mesh(np.array(_cpus(4)), ("sp",))
        _jax_cache[name] = (data, JSL.decode_stream_sliced(data, mesh,
                                                           n_bands=4))
    return _jax_cache[name]


@pytest.mark.parametrize("pack", ["v2", "none"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sliced_decode_equals_jax_and_single(name, pack, jax_ref):
    data, want = _jax_sliced(name)
    n_pics, n_cross, n_declined = CASES[name][1:]
    assert len(want) == n_pics
    assert _frames(Decoder(device="cpu"), data) == want
    st = {}
    got = SL.decode_stream_sliced(data, "cpu", 4, pack=pack, stats=st)
    assert got == want, [i for i, (a, b) in enumerate(zip(got, want))
                         if a != b]
    n = n_pics - n_declined
    assert st == {"pictures": n, "declined": n_declined, "cross": n_cross,
                  "host_arrays": 0 if pack == "v2" else n,
                  "routes": {"eager": n, "captured": 0, "replayed": 0,
                             "multi_card_eager": 0, "multi_card_captured": 0,
                             "multi_card_replayed": 0}}


def test_sliced_decode_runs_no_kernel_on_the_cpu():
    data = CASES["idc0"][0]()
    before = (K1.mc_predict.launches, KW.intra_wavefront.launches,
              KW.deblock_wavefront.launches)
    SL.decode_stream_sliced(data, "cpu", 4)
    assert (K1.mc_predict.launches, KW.intra_wavefront.launches,
            KW.deblock_wavefront.launches) == before


@pytest.mark.parametrize("decline", ["none", "every_other"])
def test_mirror_stacks_follow_declines(decline, monkeypatch):
    """Two "distinct" devices (cpu and cpu:0 are different device objects,
    so the second keeps its own copy of the stacks, as another card
    would): bands 1 and 3 predict from that copy. Declined pictures reach
    only the decoder's stacks, and the copy is refreshed before the next
    band-sharded picture; 5 pictures, so that a stale slot would show.
    The copy is a stack set leased beside the decoder's and refreshed in
    place: its storage (which a card's graphs bake in) never changes,
    and its bytes equal the decoder's stacks at every band picture."""
    data = streams.banded_stream(n_bands=4, height_mbs=8, n_frames=5,
                                 seed=706, deblock_idc=0)[0]
    want = _frames(Decoder(device="cpu", recon="numpy"), data)
    calls = [0]
    if decline == "every_other":
        aligned = SL._bands_aligned

        def flaky(pic, n):
            calls[0] += 1
            return calls[0] % 2 == 1 and aligned(pic, n)

        monkeypatch.setattr(SL, "_bands_aligned", flaky)
    ptrs, stacks = set(), SL.BandSlicer._stacks

    def spy(self, dec):
        got = stacks(self, dec)
        (sy, sc), (my, mc) = got[0].values()
        assert torch.equal(sy, my) and torch.equal(sc, mc)
        ptrs.add((my.untyped_storage().data_ptr(),
                  mc.untyped_storage().data_ptr()))
        return got

    monkeypatch.setattr(SL.BandSlicer, "_stacks", spy)
    mesh = ["cpu", "cpu:0", "cpu", "cpu:0"]
    st = {}
    assert SL.decode_stream_sliced(data, mesh, 4, stats=st) == want
    assert st["declined"] == (2 if decline == "every_other" else 0)
    assert st["pictures"] == 5 - st["declined"]
    assert len(ptrs) == 1


def test_sliced_dp_equals_jax_on_a_2x2_grid(jax_ref):
    """Two independent-band streams, each band-sharded over its row of a
    [2, 2] grid: the JAX package's decode_streams_sliced_dp on a (dp, sp)
    mesh of 4 virtual CPU devices, and the port's single decoder."""
    datas = [streams.banded_stream(n_bands=2, height_mbs=4, n_frames=3,
                                   seed=705 + s)[0] for s in range(2)]
    wants = [_frames(Decoder(device="cpu"), d) for d in datas]
    mesh = Mesh(np.array(_cpus(4)).reshape(2, 2), ("dp", "sp"))
    assert JSL.decode_streams_sliced_dp(datas, mesh, n_bands=2) == wants
    st = {}
    got = SL.decode_streams_sliced_dp(datas, [["cpu"] * 2] * 2, 2, stats=st)
    assert got == wants
    assert st["rounds"] == 3
    assert [s["pictures"] for s in st["streams"]] == [3, 3]


def test_sliced_dp_chains_and_declines():
    """The port's 2-D form runs the idc-0 chain and declines an unaligned
    stream's pictures (which the JAX package's 2-D form does not take):
    streams of unequal length, against the port's NumPy path."""
    datas = [streams.banded_stream(n_bands=2, height_mbs=4, n_frames=3,
                                   seed=707, deblock_idc=0)[0],
             streams.multislice_stream(width_mbs=4, height_mbs=4,
                                       n_frames=2, n_slices=3, seed=708)[0]]
    wants = [_frames(Decoder(device="cpu", recon="numpy"), d) for d in datas]
    st = {}
    assert SL.decode_streams_sliced_dp(datas, [["cpu"] * 2] * 2, 2,
                                       stats=st) == wants
    one, two = st["streams"]
    assert (one["pictures"], one["cross"], one["declined"]) == (3, 3, 0)
    assert two["declined"] == 2 - two["pictures"]
    assert st["rounds"] == 3


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def _pictures(mod, data, **kw):
    """Each parsed picture of `data` (the given package's decoder)."""
    out = []

    def collect(dec, pic):
        out.append((pic, dec.pps.chroma_qp_index_offset,
                    dec.pps.constrained_intra_pred))
        return mod.SKIP_RECON

    mod.Decoder(recon_strategy=collect, **kw).decode_annexb(data)
    return out


@pytest.mark.parametrize("name", ["idc2", "idc0"])
def test_band_host_arrays_equal_jax(name, jax_ref):
    """host_picture_arrays(band=), band_host_arrays and
    band_host_arrays_ghost against the JAX package's, array for array."""
    data = CASES[name][0]()
    ours = _pictures(TDEC, data, device="cpu")
    theirs = _pictures(JDEC, data, backend="cpu")
    assert len(ours) == len(theirs) == 3
    for (tp, co, ci), (jp, _, _) in zip(ours, theirs):
        h = tp.height_mbs
        for band in ((0, h // 4), (h // 4, h // 2), (h - 1, 1)):
            a = TRC.host_picture_arrays(tp, co, ci, band=band)
            b = RT.host_picture_arrays(jp, co, ci, band=band)
            assert sorted(a) == sorted(b)
            for k in a:
                assert np.array_equal(a[k], np.asarray(b[k]).astype(
                    a[k].dtype)), (band, k)
        for ours_fn, jax_fn in ((SL.band_host_arrays, JSL.band_host_arrays),
                                (SL.band_host_arrays_ghost,
                                 JSL.band_host_arrays_ghost)):
            a, b = ours_fn(tp, 4, co, ci), jax_fn(jp, 4, co, ci)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].shape == b[k].shape, k
                assert np.array_equal(a[k], b[k].astype(a[k].dtype)), k


def test_host_picture_arrays_band_refuses_outside():
    pic, co, ci = _pictures(TDEC, CASES["idc2"][0](), device="cpu")[0]
    for band in ((-1, 2), (3, 2), (0, 0)):
        with pytest.raises(ValueError):
            TRC.host_picture_arrays(pic, co, ci, band=band)


@pytest.mark.parametrize("name", ["idc2", "idc0"])
def test_device_cut_of_v2_equals_host_bands(name):
    """cut_band / cut_band_ghost of the v2 unpack (the device form) equal
    the host-array form of each band, key for key."""
    data = CASES[name][0]()
    pics = _pictures(TDEC, data, device="cpu")
    for (buf, bk, lay, ci, co, _), (pic, _, _) in zip(TPK.pack_stream(data),
                                                      pics):
        whole = TPK.unpack_arrs_v2(torch.from_numpy(buf), lay, bk, ci, co)
        for cut, host in ((SL.cut_band, SL.band_host_arrays),
                          (SL.cut_band_ghost, SL.band_host_arrays_ghost)):
            stacked = host(pic, 4, co, ci)
            for k in range(4):
                a = cut(whole, k, lay.w, lay.h // 4)
                b = tables_from_numpy({key: v[k] for key, v in stacked.items()})
                assert sorted(a) == sorted(b)
                for key in a:
                    if key == "whole_conceal":
                        assert not bool(a[key]) and not bool(b[key])
                        continue
                    x, y = a[key].to(b[key].dtype), b[key]
                    if key == "total_coeff":     # v2 carries only > 0
                        x, y = x > 0, y > 0
                    assert torch.equal(x, y), (k, key)


def _jax_refs(y, c):
    jy = jax.numpy.stack([K_mcp.pad_luma(jax.numpy.asarray(p)) for p in y])
    jc = jax.numpy.stack([K_mcp.pad_chroma(jax.numpy.asarray(p[0]),
                                           jax.numpy.asarray(p[1]))
                          for p in c])
    return jy, jc


def _band_operands(w, h, hb, R, seed):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 256, (R, 16 * h, 16 * w)).astype(np.uint8)
    c = rng.randint(0, 256, (R, 2, 8 * h, 8 * w)).astype(np.uint8)
    n = w * hb
    mv = rng.randint(-300, 300, (n, 4, 4, 2)).astype(np.int32)
    uniform = rng.rand(n) < 0.5          # both of K1's staging forms
    mv[uniform] = mv[uniform, :1, :1]
    rb = rng.randint(-1, R, (n, 4, 4)).astype(np.int32)
    rb[uniform] = np.abs(rb[uniform, :1, :1])
    return y, c, mv, rb


@pytest.mark.parametrize("band", [0, 1, 3])
def test_mc_band_plain_equals_jax_mc_predict_xla(band, jax_ref):
    """mc_predict_plain(mb0=, ref_h_mbs=) against JAX's
    mc_predict_xla(mb0=) with the FULL picture height: the band's MBs at
    their global positions, clamped into the full-height references."""
    w, h, hb, R = 4, 8, 2, 2
    y, c, mv, rb = _band_operands(w, h, hb, R, 900 + band)
    jy, jc = _jax_refs(y, c)
    mb0 = band * hb * w
    want_y, want_c = RT.mc_predict_xla(jy, jc, jax.numpy.asarray(mv),
                                       jax.numpy.asarray(rb), w, h, mb0=mb0)
    got_y, got_c = K1.mc_predict(torch.from_numpy(y), torch.from_numpy(c),
                                 torch.from_numpy(mv), torch.from_numpy(rb),
                                 w, hb, mb0=mb0, ref_h_mbs=h)
    used = rb >= 0
    my = np.repeat(np.repeat(used, 4, axis=1), 4, axis=2)
    mc = np.repeat(np.repeat(used, 2, axis=1), 4, axis=2)
    assert np.array_equal(got_y.numpy()[my], np.asarray(want_y)[my])
    assert np.array_equal(got_c.numpy()[mc], np.asarray(want_c)[mc])
    assert not got_y.numpy()[~my].any() and not got_c.numpy()[~mc].any()
    # band 0 of a picture is the picture's first rows: the same as the
    # whole-picture form on those MBs
    if band == 0:
        full_mv = np.concatenate([mv, np.zeros((w * (h - hb), 4, 4, 2),
                                               np.int32)])
        full_rb = np.concatenate([rb, -np.ones((w * (h - hb), 4, 4),
                                               np.int32)])
        fy, fc = K1.mc_predict(torch.from_numpy(y), torch.from_numpy(c),
                               torch.from_numpy(full_mv),
                               torch.from_numpy(full_rb), w, h)
        assert torch.equal(fy[:w * hb], got_y) and \
            torch.equal(fc[:w * hb], got_c)


def test_mc_band_refuses_batches_and_outside():
    w, h, hb, R = 4, 8, 2, 2
    y, c, mv, rb = (torch.from_numpy(a)
                    for a in _band_operands(w, h, hb, R, 950))
    for kw in ({"mb0": 7 * w, "ref_h_mbs": h},      # past the last row
               {"mb0": -w, "ref_h_mbs": h},
               {"mb0": 0, "ref_h_mbs": hb - 1}):
        with pytest.raises(ValueError, match="band"):
            K1.mc_predict(y, c, mv, rb, w, hb, **kw)
    # a band in a batch: two bands' MBs, or a stack_base table
    with pytest.raises(ValueError):
        K1.mc_predict(y, c, torch.cat([mv, mv]), torch.cat([rb, rb]), w, hb,
                      mb0=w * hb, ref_h_mbs=h)
    with pytest.raises(ValueError, match="band"):
        K1.mc_predict(y, c, mv, rb, w, hb,
                      torch.zeros(1, dtype=torch.int32), R, mb0=w * hb,
                      ref_h_mbs=h)
    # without the band, the band's MBs against full-height stacks are not
    # whole pictures of this geometry
    with pytest.raises(ValueError):
        inter.mc_predict_plain(y, c, mv, rb, w, h)


def _ghost_case():
    """An idc-0 picture of 8 MB rows, band 2 of 4 with its ghost row."""
    data = CASES["idc0"][0]()
    pic, co, ci = _pictures(TDEC, data, device="cpu")[1]      # a P picture
    full = tables_from_numpy(TRC.host_picture_arrays(pic, co, ci))
    g = SL.band_host_arrays_ghost(pic, 4, co, ci)
    ghost = tables_from_numpy({k: v[2] for k, v in g.items()})
    return pic, full, ghost


def test_ghost_row_deblock_params():
    """K3 needs no ghost-row form: deblock_params over hb + 1 rows reads the
    ghost row's qp, total_coeff, mv and ref_blk for row 1's top edge (row
    1's parameters equal the band's first row's in the whole picture),
    and with the ghost row's enable / FT / FL off every bS of row 0 is 0."""
    pic, full, ghost = _ghost_case()
    w, h = pic.width_mbs, pic.height_mbs
    hb = h // 4
    Pf = TDB.deblock_params(full, w, h)
    Pg = TDB.deblock_params(ghost, w, hb + 1)
    lo = 2 * hb * w
    assert torch.equal(Pg[w:], Pf[lo:lo + hb * w])
    assert not Pg[:w, :32].any()
    # the edge really is filtered: row 1's top edge has bS > 0 somewhere
    assert Pg[w:2 * w, 16:20].any()


def _ghost_planes(pic, seed):
    """Smooth planes (small noise, a step of 6 at every MB row) that the
    filter changes wherever bS > 0."""
    rng = np.random.RandomState(seed)
    w, hb = pic.width_mbs, pic.height_mbs // 4

    def plane(shape, mb):
        step = (np.arange(shape[-2]) // mb * 6)[:, None]
        return torch.from_numpy((100 + step + rng.randint(0, 3, shape))
                                .astype(np.uint8))

    return (plane((16 * (hb + 1), 16 * w), 16),
            plane((2, 8 * (hb + 1), 8 * w), 8))


def test_ghost_row_is_filtered_only_at_its_bottom():
    """K3 (its plain version here) over hb + 1 rows leaves the ghost row's
    pels 0-12 (chroma 0-5) as they were: only row 1's top edge reaches
    into it, by at most 3 luma (2 chroma) lines."""
    pic, _, ghost = _ghost_case()
    w, hb = pic.width_mbs, pic.height_mbs // 4
    Y, C = _ghost_planes(pic, 11)
    Y0, C0 = Y.clone(), C.clone()
    KW.deblock_wavefront(Y, C, TDB.deblock_params(ghost, w, hb + 1), w,
                         hb + 1)
    assert torch.equal(Y[:13], Y0[:13]) and torch.equal(C[:, :6], C0[:, :6])
    assert not torch.equal(Y[13:16], Y0[13:16])


def test_mesh_of_cuda_devices_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    data = CASES["idc2"][0]()
    for call in (lambda: SL.make_band_mesh("cuda", 4),
                 lambda: SL.make_band_mesh(["cpu", "cuda:0"], 2),
                 lambda: SL.decode_stream_sliced(data),
                 lambda: SL.decode_streams_sliced_dp([data, data]),
                 lambda: LS.make_dp_mesh(),
                 lambda: LS.make_dp_mesh(["cuda:0"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_band_mesh_shapes():
    assert SL.make_band_mesh("cpu", 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        SL.make_band_mesh(["cpu"] * 3, 4)
    with pytest.raises(ValueError):
        SL.make_band_mesh("meta", 2)
    with pytest.raises(ValueError):
        SL.make_band_mesh("cpu", 0)


def test_strategy_refuses_frame_groups():
    with pytest.raises(ValueError, match="frame groups"):
        Decoder(device="cpu", recon_strategy=lambda d, p: None,
                group_frames=2)


def test_comm_volume_2d(jax_ref):
    v = SL.comm_volume_2d(120, 68, 4, 2)
    plane = 1920 * 1088 * 3 // 2
    assert v == {"sp_bytes_per_pic_per_chip": plane * 3 // 4,
                 "dp_bytes_per_pic": 0, "streams": 2, "bands": 4}
    j = JSL.comm_volume_2d(120, 68, 4, 2)
    assert j["sp_bytes_per_pic_per_chip"] == 4 * v["sp_bytes_per_pic_per_chip"]


def test_dp_mesh_and_shard_batch():
    mesh = LS.make_dp_mesh(["cpu", "cpu"])
    tree = {"a": torch.arange(8).reshape(4, 2),
            "b": [np.arange(6), (torch.ones(2, 3),)]}
    parts = LS.shard_batch(mesh, tree)
    assert len(parts) == 2
    assert torch.equal(parts[1]["a"], torch.tensor([[4, 5], [6, 7]]))
    assert torch.equal(parts[0]["b"][0], torch.tensor([0, 1, 2]))
    assert tuple(parts[1]["b"][1][0].shape) == (1, 3)
    with pytest.raises(ValueError):
        LS.shard_batch(mesh, {"odd": torch.zeros(3)})


# ---------------------------------------------------------------------------
# the card: K1's and K3's band forms against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("band", [0, 1, 3])
def test_mc_band_kernel_equals_plain(band, cuda):
    w, h, hb, R = 9, 8, 2, 3
    y, c, mv, rb = (torch.from_numpy(a).cuda()
                    for a in _band_operands(w, h, hb, R, 960 + band))
    args = (y, c, mv, rb, w, hb)
    kw = {"mb0": band * hb * w, "ref_h_mbs": h}
    before = K1.mc_predict.launches
    got = K1.mc_predict(*args, **kw)
    assert K1.mc_predict.launches == before + 1
    want = inter.mc_predict_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_ghost_deblock_kernel_equals_plain(cuda):
    pic, _, ghost = _ghost_case()
    w, hb = pic.width_mbs, pic.height_mbs // 4
    Y, C = _ghost_planes(pic, 12)
    P = TDB.deblock_params(ghost, w, hb + 1)
    want = (Y.clone(), C.clone())
    KW.deblock_wavefront(*want, P, w, hb + 1)
    Yd, Cd = Y.cuda(), C.cuda()
    KW.deblock_wavefront(Yd, Cd, P.cuda(), w, hb + 1)
    assert torch.equal(Yd.cpu(), want[0]) and torch.equal(Cd.cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["idc2", "idc0", "unaligned"])
def test_sliced_decode_on_the_card(name, cuda):
    data, n_pics = CASES[name][0](), CASES[name][1]
    want = _frames(Decoder(device="cpu", recon="numpy"), data)
    assert SL.decode_stream_sliced(data, "cuda", 4) == want
    assert SL.decode_stream_sliced(data, "cuda", 4, pack="none") == want
    assert len(want) == n_pics


def test_bandcheck_tool_on_cpu_devices(capsys):
    """tools/bandcheck.py (the multi-card check) on two CPU device objects
    and on one: byte-equal runs, a line of JSON each."""
    import json

    from broadway_tpu_torch.tools import bandcheck
    assert bandcheck.main(["--devices", "cpu,cpu:0", "--devices", "cpu,cpu",
                           "--width", "5", "--height", "4", "--frames", "2",
                           "--passes", "1"]) == 0
    runs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["devices"] for r in runs] == [["cpu", "cpu:0"], ["cpu", "cpu"]]
    for r in runs:
        assert r["streams"]["a"]["stats"]["cross"] == 2
        assert r["streams"]["b"]["stats"]["pictures"] == 2
        assert r["dp_grid"]
    # the routes and host ms by route; a mesh of two devices by device too
    mesh, one = (r["streams"]["a"] for r in runs)
    assert mesh["routes"]["multi_card_eager"] == 2 == one["routes"]["eager"]
    assert len(mesh["step_host_ms"]["eager"]) == 2
    assert sorted(mesh["step_card_ms"]["eager"]) == ["cpu", "cpu:0"]
    assert "one_card_band_fps" in mesh and "one_card_band_fps" not in one
