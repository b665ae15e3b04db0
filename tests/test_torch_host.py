"""The port's own host engine (bitstream parser, DPB/POC, concealment,
v2 packer, stream generator: broadway_tpu_torch/{bitstream,core,tools})
held against the JAX package's on the same bytes, made from seeds.
Small pictures (<= 12x10 MBs), CPU only, every comparison exact:

(a) pack_picture_v2 buffers and bucket triples, picture by picture;
(b) Decoder(device="cpu") and its recon="numpy" path against
    broadway_tpu's Decoder(backend="cpu"), frame by frame and in output
    order, with a dropped slice, a cut slice, and a checkpoint carried
    across the two packages both ways;
(c) the port's stream generator against tools/streams.py;
(d) frontend="native" raises when its library cannot be built.
"""

import pickle

import numpy as np
import pytest

import streams as ref_streams
from broadway_tpu.bitstream import bitreader as ref_br
from broadway_tpu.core import decoder as ref_dec
from broadway_tpu.core import packed as ref_pk
from broadway_tpu_torch.bitstream import native as nat
from broadway_tpu_torch.core import decoder as port_dec
from broadway_tpu_torch.core.packed import pack_stream
from broadway_tpu_torch.ops.gpu import _build
from broadway_tpu_torch.tools import streams as port_streams

# ---------------------------------------------------------------------------
# the streams: every generator call is made on BOTH generators, see (c)
# ---------------------------------------------------------------------------

GEN = {
    "inter": ("inter_stream", dict(
        width_mbs=5, height_mbs=4, n_frames=5, seed=813, deblock=True)),
    "inter_multi_ref": ("inter_stream", dict(
        width_mbs=4, height_mbs=3, n_frames=6, seed=918, num_ref_frames=2,
        multi_ref_idx=True, deblock=True, mvd_range=50)),
    "inter_wild_mv": ("inter_stream", dict(
        width_mbs=11, height_mbs=7, n_frames=4, seed=20260821, deblock=True,
        mvd_range=400, num_ref_frames=2, multi_ref_idx=True)),
    "intra_mixed": ("intra_mixed_stream", dict(
        width_mbs=5, height_mbs=4, seed=812, deblock=True)),
    "ipcm": ("ipcm_stream", dict(width_mbs=4, height_mbs=3)),
    "multislice_idc0": ("multislice_stream", dict(
        width_mbs=4, height_mbs=3, seed=902, deblock_idc=0, alpha_off=2,
        beta_off=-2)),
    "multislice_idc0_neg": ("multislice_stream", dict(
        width_mbs=4, height_mbs=3, seed=896, deblock_idc=0, alpha_off=-4,
        beta_off=4)),
    "multislice_idc1": ("multislice_stream", dict(
        width_mbs=4, height_mbs=3, seed=912, deblock_idc=1, alpha_off=2,
        beta_off=-2)),
    "multislice_idc2": ("multislice_stream", dict(
        width_mbs=4, height_mbs=3, seed=926, deblock_idc=2, alpha_off=6,
        beta_off=-6)),
    "multislice_idc2_neg": ("multislice_stream", dict(
        width_mbs=4, height_mbs=3, seed=914, deblock_idc=2, alpha_off=-6,
        beta_off=6)),
    "multislice_chroma_off_idc0": ("multislice_stream", dict(
        width_mbs=6, height_mbs=5, seed=940, deblock_idc=0, alpha_off=3,
        beta_off=-1, chroma_qp_offset=-4)),
    "multislice_chroma_off_idc2": ("multislice_stream", dict(
        width_mbs=6, height_mbs=5, seed=942, deblock_idc=2, alpha_off=3,
        beta_off=-1, chroma_qp_offset=-4)),
    "fmo_type1": ("fmo_stream", dict(map_type=1, width_mbs=4, height_mbs=3,
                                     seed=917)),
    "fmo_type2": ("fmo_stream", dict(map_type=2, width_mbs=4, height_mbs=3,
                                     seed=917)),
    "realistic": ("realistic_stream", dict(
        width_mbs=12, height_mbs=8, n_frames=3, n_slices=3, seed=5)),
    "poc_reorder": ("poc_reorder_stream", dict(
        poc_type=0, width_mbs=4, height_mbs=3)),
    "cropped": ("cropped_stream", {}),
    "frame_num_gaps": ("gaps_stream", {}),
    "long_term_refs": ("long_term_stream", {}),
    "redundant_slices": ("redundant_stream", {}),
}
PACKED = ["inter", "inter_multi_ref", "inter_wild_mv", "intra_mixed", "ipcm",
          "multislice_idc0", "multislice_idc2", "multislice_chroma_off_idc2",
          "fmo_type1", "fmo_type2", "realistic"]


def _stream(name, mod=port_streams):
    fn, kw = GEN[name]
    return getattr(mod, fn)(**kw)[0]


# ---------------------------------------------------------------------------
# (c) the generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GEN))
def test_generator_writes_the_same_bytes(name):
    a, b = _stream(name, port_streams), _stream(name, ref_streams)
    assert len(a) > 100 and a == b


# ---------------------------------------------------------------------------
# (a) the v2 packer
# ---------------------------------------------------------------------------

def _ref_pack_stream(data):
    out = []

    def collect(dec, pic):
        lay = ref_pk.get_packed_layout_v2(dec.sps.width_mbs,
                                          dec.sps.height_mbs)
        buf, bk = ref_pk.pack_picture_v2(pic, lay, ref_pk.PackScratchV2(lay))
        out.append((buf, bk, (lay.w, lay.h), dec.pps.constrained_intra_pred,
                    dec.pps.chroma_qp_index_offset, dec.dpb.dpb_size + 1))
        return ref_dec.SKIP_RECON

    ref_dec.Decoder(backend="cpu", recon_strategy=collect).decode_annexb(data)
    return out


def _meaning(buf, lay, bk):
    """The bytes of a v2 buffer that carry meaning, in order: the base,
    then per sparse section all its indices and the value rows of the
    live ones. The packer allocates with np.empty, so alignment gaps and
    the value rows behind a pad index are undefined in both packages."""
    kb8, kb16, eb = bk
    out = [buf[:lay.base_size]]
    for ioff, voff, kb, row, pad in (
            (lay.idx_off, lay.val8_off(kb8), kb8, 16, lay.NR),
            (lay.idx16_off(kb8), lay.val16_off(kb8, kb16), kb16, 32, lay.NR),
            (lay.eidx_off(kb8, kb16), lay.eval_off(kb8, kb16, eb), eb, 80,
             lay.NE)):
        idx = buf[ioff:ioff + 4 * kb].view(np.int32)
        live = int((idx != pad).sum())
        assert (idx[live:] == pad).all() and (idx[:live] < pad).all()
        out += [idx.view(np.uint8), buf[voff:voff + row * live]]
    return b"".join(a.tobytes() for a in out)


@pytest.mark.parametrize("name", PACKED)
def test_pack_picture_v2_equals_jax_package(name):
    data = _stream(name)
    got, want = pack_stream(data), _ref_pack_stream(data)
    assert want and len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[1] == w[1], f"picture {i}: bucket triple {g[1]} vs {w[1]}"
        assert (g[2].w, g[2].h) == w[2] and g[3:] == w[3:]
        assert g[0].dtype == np.uint8 and g[0].shape == w[0].shape
        assert _meaning(g[0], g[2], g[1]) == _meaning(w[0], g[2], w[1]), \
            f"picture {i}: buffer"


def test_layout_v2_equals_jax_package():
    from broadway_tpu_torch.core.packed import get_packed_layout_v2
    for w, h in [(1, 1), (4, 3), (12, 10), (120, 68), (256, 136)]:
        a, b = get_packed_layout_v2(w, h), ref_pk.get_packed_layout_v2(w, h)
        assert (a.k8buckets, a.k16buckets, a.ebuckets, a.idx_off) == \
            (b.k8buckets, b.k16buckets, b.ebuckets, b.idx_off)
        for bk in [(4096, 512, 512), (a.NR, a.NR, a.NE)]:
            assert a.total_size(*bk) == b.total_size(*bk)
            assert a.eval_off(*bk) == b.eval_off(*bk)


# ---------------------------------------------------------------------------
# (b) the decoder
# ---------------------------------------------------------------------------

def _outs(dec, data):
    try:
        return [(o.frame.tobytes(), o.is_idr, o.pic_id, o.num_err_mbs,
                 o.width, o.height, o.crop) for o in dec.decode_annexb(data)]
    finally:
        dec.close()


def _check(data, **kw):
    want = _outs(ref_dec.Decoder(backend="cpu"), data)
    got = _outs(port_dec.Decoder(device="cpu", **kw), data)
    assert want and len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[1:] == w[1:], f"output {i}: {g[1:]} vs {w[1:]}"
        assert g[0] == w[0], f"output {i}: pixels differ"


PATHS = {"torch": {}, "numpy": {"recon": "numpy"},
         "numpy_python_parser": {"recon": "numpy", "frontend": "python"},
         "torch_slice_pool": {"parallel_slices": 3}}


@pytest.mark.parametrize("path", ["torch", "numpy"])
@pytest.mark.parametrize("name", sorted(GEN))
def test_decoder_equals_jax_package(name, path):
    _check(_stream(name), **PATHS[path])


@pytest.mark.parametrize("path", ["numpy_python_parser", "torch_slice_pool"])
@pytest.mark.parametrize("name", ["inter", "multislice_idc2", "fmo_type1",
                                  "realistic"])
def test_decoder_other_front_ends(name, path):
    _check(_stream(name), **PATHS[path])


def test_resolution_change():
    data = port_streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3,
                                     seed=61, deblock=True)[0] + \
        port_streams.inter_stream(width_mbs=6, height_mbs=5, n_frames=3,
                                  seed=62, deblock=True)[0]
    for kw in PATHS.values():
        _check(data, **kw)


def _rewrite_nals(data, index, keep_frac=None):
    """Drop NAL `index` (keep_frac None) or cut it to keep_frac."""
    out = bytearray()
    for i, (_, payload) in enumerate(ref_br.split_nal_units(data)):
        if i == index:
            if keep_frac is None:
                continue
            payload = payload[:max(4, int(len(payload) * keep_frac))]
        out += b"\x00\x00\x00\x01" + payload
    return bytes(out)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("case", ["dropped_slice", "cut_slice",
                                  "dropped_picture"])
def test_concealment_equals_jax_package(case, path):
    """A lost slice of a multi-slice picture, a slice cut short, and a
    whole lost picture: concealed on the host by the port's own
    conceal.py, and later pictures predict from the concealed frame."""
    if case == "dropped_picture":
        data = _rewrite_nals(_stream("inter"), 4)
    else:
        data = port_streams.realistic_stream(width_mbs=6, height_mbs=6,
                                             n_frames=4, n_slices=3,
                                             seed=77)[0]
        # NALs: SPS, PPS, then 3 slices per picture; hit picture 1
        data = _rewrite_nals(data, 6, None if case == "dropped_slice"
                             else 0.4)
    outs = port_dec.Decoder(device="cpu", **PATHS[path]).decode_annexb(data)
    assert len(outs) >= 3
    if case != "dropped_picture":
        assert any(o.num_err_mbs for o in outs)
    _check(data, **PATHS[path])


def _split(make_dec, data, at_pic):
    """Decode NAL by NAL until `at_pic` pictures are done; return the
    decoder, its snapshot and the remaining NALs' index."""
    nals = list(ref_br.split_nal_units(data))
    dec = make_dec()
    for i, (_, payload) in enumerate(nals):
        dec.decode_nal(_nal_for(dec, payload))
        if dec.pic_number == at_pic and dec.pic is None:
            return dec, dec.save_state(), i + 1
    raise AssertionError("checkpoint never reached")


def _nal_for(dec, payload):
    """A NalUnit of the decoder's own package (no object crosses)."""
    if isinstance(dec, port_dec.Decoder):
        from broadway_tpu_torch.bitstream.bitreader import NalUnit
    else:
        NalUnit = ref_br.NalUnit
    return NalUnit(payload)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax",
                                       "port_to_port_numpy"])
def test_checkpoint_crosses_packages(direction):
    """save_state() mid-stream in one package, pickled, load_state() in
    the other: the frames across the checkpoint equal one uninterrupted
    decode. What the port loads holds no object of broadway_tpu."""
    data = _stream("inter_multi_ref")
    want = [o.frame.tobytes() for o in
            ref_dec.Decoder(backend="cpu").decode_annexb(data)]
    make = {"jax": lambda: ref_dec.Decoder(backend="cpu"),
            "port": lambda: port_dec.Decoder(device="cpu"),
            "port_numpy": lambda: port_dec.Decoder(device="cpu",
                                                   recon="numpy")}
    src, dst = {"jax_to_port": ("jax", "port"),
                "port_to_jax": ("port", "jax"),
                "port_to_port_numpy": ("port", "port_numpy")}[direction]
    d1, state, k = _split(make[src], data, at_pic=3)
    state = pickle.loads(pickle.dumps(state))
    d2 = make[dst]()
    d2.load_state(state)
    if dst != "jax":
        held = [d2.sps, d2.pps, d2.poc_state, d2.aub,
                *d2.sps_store.values(), *d2.pps_store.values()]
        assert all(type(o).__module__.startswith("broadway_tpu_torch.")
                   for o in held)
    for _, payload in list(ref_br.split_nal_units(data))[k:]:
        d2.decode_nal(_nal_for(d2, payload))
    d2.flush()
    got = [o.frame.tobytes() for o in d1.outputs] + \
        [o.frame.tobytes() for o in d2.outputs]
    assert got == want


def test_decoder_is_its_own_class():
    mro = port_dec.Decoder.__mro__
    assert all(not c.__module__.startswith("broadway_tpu.") for c in mro)
    assert mro == (port_dec.Decoder, object)


# ---------------------------------------------------------------------------
# (d) no quiet Python parser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frontend", ["native", "auto"])
def test_native_frontend_raises_without_compiler(monkeypatch, tmp_path,
                                                 frontend):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        port_dec.Decoder(device="cpu", frontend=frontend)
    with pytest.raises(RuntimeError, match="not found"):
        nat.load()
    # only the explicit request parses in Python
    outs = port_dec.Decoder(device="cpu", frontend="python",
                            recon="numpy").decode_annexb(_stream("ipcm"))
    assert len(outs) == 3
