"""The port's Decoder end to end on the CPU (its kernels' plain
versions): every output frame equals both the JAX package's decoder
(backend="tpu", JAX on the CPU) and the NumPy decoder (backend="cpu").
Scenarios of tests/test_tpu_backend.py, a checkpoint taken by the JAX
decoder and resumed by the port, and concealment. Exact."""

import pickle

import pytest

import streams
from broadway_tpu.bitstream import bitreader as br
from broadway_tpu.core.decoder import Decoder as BaseDecoder
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.core.recon import TorchFrame


def _frames(dec, data):
    return [o.frame.tobytes() for o in dec.decode_annexb(data)]


def cross_check(data, with_jax=True):
    want = _frames(BaseDecoder(backend="cpu"), data)
    got = _frames(Decoder(device="cpu"), data)
    assert want and len(got) == len(want)
    if with_jax:
        pytest.importorskip("jax")
        assert _frames(BaseDecoder(backend="tpu"), data) == want
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            off = next(j for j in range(len(w)) if g[j] != w[j])
            raise AssertionError(f"frame {i} differs at byte {off}: "
                                 f"port={g[off]} numpy={w[off]}")


SCENARIOS = {
    "ipcm": lambda: streams.ipcm_stream(width_mbs=4, height_mbs=3)[0],
    "intra_mixed": lambda: streams.intra_mixed_stream(
        width_mbs=4, height_mbs=3, seed=811)[0],
    "intra_deblock": lambda: streams.intra_mixed_stream(
        width_mbs=4, height_mbs=3, seed=812, deblock=True)[0],
    "inter": lambda: streams.inter_stream(
        width_mbs=4, height_mbs=3, n_frames=5, seed=813, deblock=True)[0],
    "inter_multi_ref": lambda: streams.inter_stream(
        width_mbs=4, height_mbs=3, n_frames=6, seed=814, num_ref_frames=2,
        multi_ref_idx=True, deblock=True, mvd_range=50)[0],
    "inter_wild_mv": lambda: streams.inter_stream(
        width_mbs=11, height_mbs=7, n_frames=6, seed=20260821, deblock=True,
        mvd_range=400, num_ref_frames=2, multi_ref_idx=True)[0],
    "inter_wild_mv_small": lambda: streams.inter_stream(
        width_mbs=5, height_mbs=4, n_frames=5, seed=818, deblock=True,
        mvd_range=700)[0],
    "odd_height": lambda: streams.inter_stream(
        width_mbs=12, height_mbs=9, n_frames=4, seed=819, deblock=True,
        mvd_range=120)[0],
    "multislice": lambda: streams.multislice_stream(
        width_mbs=4, height_mbs=3, seed=815, deblock_idc=0, alpha_off=2,
        beta_off=-2)[0],
    "fmo": lambda: streams.fmo_stream(map_type=1, width_mbs=4, height_mbs=3,
                                      seed=816)[0],
    "realistic": lambda: streams.realistic_stream(
        width_mbs=12, height_mbs=8, n_frames=3, n_slices=3, seed=5)[0],
    # host-side DPB paths that move pictures between stack slots
    "resolution_change": lambda: (
        streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3, seed=61,
                             deblock=True)[0]
        + streams.inter_stream(width_mbs=6, height_mbs=5, n_frames=3,
                               seed=62, deblock=True)[0]),
    "poc_reorder": lambda: streams.poc_reorder_stream(
        poc_type=0, width_mbs=4, height_mbs=3)[0],
    "cropped": lambda: streams.cropped_stream()[0],
    "frame_num_gaps": lambda: streams.gaps_stream()[0],
    "long_term_refs": lambda: streams.long_term_stream()[0],
    "redundant_slices": lambda: streams.redundant_stream()[0],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_equals_jax_and_numpy(name):
    cross_check(SCENARIOS[name]())


def _rewrite_nals(data, index, keep_frac=None):
    """Drop NAL `index` (keep_frac None) or cut it to keep_frac."""
    out = bytearray()
    for i, (_, payload) in enumerate(br.split_nal_units(data)):
        if i == index:
            if keep_frac is None:
                continue
            payload = payload[:max(4, int(len(payload) * keep_frac))]
        out += b"\x00\x00\x00\x01" + payload
    return bytes(out)


@pytest.mark.parametrize("index,keep_frac",
                         [(4, 0.4), (3, 0.5), (6, 0.3), (4, None)])
def test_concealment(index, keep_frac):
    """A truncated or lost picture is concealed on the host; the port
    uploads the concealed frame into its stack slot, so later P pictures
    predict from it."""
    data = streams.inter_stream(width_mbs=5, height_mbs=4, n_frames=6,
                                seed=956, deblock=True)[0]
    data = _rewrite_nals(data, index, keep_frac)
    outs = Decoder(device="cpu").decode_annexb(data)
    if keep_frac is not None:       # a lost picture leaves a frame gap
        assert any(o.num_err_mbs for o in outs)
    assert all(isinstance(o.frame, TorchFrame) for o in outs)
    cross_check(data)


def test_resume_from_jax_checkpoint():
    """save_state() of the JAX package's decoder mid-stream -> the port's
    load_state() -> decode the rest: the frames across the checkpoint
    equal one uninterrupted NumPy decode."""
    pytest.importorskip("jax")
    data = streams.inter_stream(width_mbs=5, height_mbs=4, n_frames=7,
                                seed=4242, num_ref_frames=2,
                                multi_ref_idx=True, deblock=True,
                                mvd_range=80)[0]
    nals = [br.NalUnit(p) for _, p in br.split_nal_units(data)]
    want = _frames(BaseDecoder(backend="cpu"), data)

    d1 = BaseDecoder(backend="tpu")
    state, k = None, 0
    for i, nal in enumerate(nals):
        d1.decode_nal(nal)
        if d1.pic_number == 4 and d1.pic is None:
            state, k = d1.save_state(), i + 1
            break
    assert state is not None
    state = pickle.loads(pickle.dumps(state))
    d2 = Decoder(device="cpu")
    d2.load_state(state)
    for nal in nals[k:]:
        d2.decode_nal(nal)
    d2.flush()
    got = [o.frame.tobytes() for o in d1.outputs] + \
        [o.frame.tobytes() for o in d2.outputs]
    assert got == want
