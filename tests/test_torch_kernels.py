"""The port's three hand-written CUDA kernels against their plain torch
versions, on the card (marker ``cuda``; without a card every test here
skips). Inputs come from real packed pictures of small streams, made
from fixed seeds, and for the persistent wavefront kernels also from
synthetic operands at chosen geometries; comparisons are byte equality.
The kernels' tests need nothing of the JAX package; the whole-decoder
test takes that package's NumPy decoder (which imports no JAX) as its
reference, so that the port is not held against itself. Run on a CUDA
host:

    python -m pytest tests/test_torch_kernels.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.core.packed import pack_stream, unpack_arrs_v2
from broadway_tpu_torch.core.recon import decode_picture
from broadway_tpu_torch.ops.gpu import deblock, inter, intra
from broadway_tpu_torch.ops.gpu import mc_kernel as K1
from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
from broadway_tpu_torch.ops.gpu.residual import residual_stage
from broadway_tpu_torch.tools import streams, synth

pytestmark = pytest.mark.cuda

STREAMS = {
    "intra_mixed": lambda: streams.intra_mixed_stream(
        width_mbs=6, height_mbs=5, n_frames=2, seed=812, deblock=True)[0],
    "wild_mv_multi_ref": lambda: streams.inter_stream(
        width_mbs=11, height_mbs=7, n_frames=4, seed=20260821, deblock=True,
        mvd_range=400, num_ref_frames=2, multi_ref_idx=True)[0],
    "multislice_idc2": lambda: streams.multislice_stream(
        width_mbs=6, height_mbs=5, seed=926, deblock_idc=2, alpha_off=6,
        beta_off=-6, chroma_qp_offset=2)[0],
    "realistic": lambda: streams.realistic_stream(
        width_mbs=12, height_mbs=8, n_frames=3, n_slices=3, seed=5)[0],
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(name, dev):
    """(arrs, w, h, chroma offset, random ref stacks) per picture."""
    rng = np.random.RandomState(7)
    for buf, bk, lay, ci, co, R in pack_stream(STREAMS[name]()):
        arrs = unpack_arrs_v2(torch.from_numpy(buf).to(dev), lay, bk, ci, co)
        ref_y = torch.from_numpy(rng.randint(
            0, 256, (R, 16 * lay.h, 16 * lay.w), dtype=np.uint8)).to(dev)
        ref_c = torch.from_numpy(rng.randint(
            0, 256, (R, 2, 8 * lay.h, 8 * lay.w), dtype=np.uint8)).to(dev)
        yield arrs, lay.w, lay.h, co, ref_y, ref_c


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k1_mc_equals_plain(cuda, name):
    for arrs, w, h, _, ref_y, ref_c in _inputs(name, cuda):
        n0 = K1.mc_predict.launches
        got = K1.mc_predict(ref_y, ref_c, arrs["mv"], arrs["ref_blk"], w, h)
        want = inter.mc_predict_plain(ref_y, ref_c, arrs["mv"],
                                      arrs["ref_blk"], w, h)
        torch.cuda.synchronize()
        assert K1.mc_predict.launches == n0 + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k2_intra_equals_plain(cuda, name):
    for arrs, w, h, co, ref_y, ref_c in _inputs(name, cuda):
        Y0, C0 = decode_picture(arrs, ref_y, ref_c, w, h, co, run_stages=1)
        RY, RC = residual_stage(arrs, co)
        P = intra.intra_params(arrs)
        Yk, Ck, Yp, Cp = Y0.clone(), C0.clone(), Y0.clone(), C0.clone()
        KW.intra_wavefront(Yk, Ck, RY, RC, P, w, h)
        intra.intra_wavefront_plain(Yp, Cp, RY, RC, P, w, h)
        torch.cuda.synchronize()
        assert torch.equal(Yk, Yp) and torch.equal(Ck, Cp)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k3_deblock_equals_plain(cuda, name):
    for arrs, w, h, co, ref_y, ref_c in _inputs(name, cuda):
        Y0, C0 = decode_picture(arrs, ref_y, ref_c, w, h, co, run_stages=2)
        P = deblock.deblock_params(arrs, w, h)
        Yk, Ck, Yp, Cp = Y0.clone(), C0.clone(), Y0.clone(), C0.clone()
        KW.deblock_wavefront(Yk, Ck, P, w, h)
        deblock.deblock_wavefront_plain(Yp, Cp, P, w, h)
        torch.cuda.synchronize()
        assert torch.equal(Yk, Yp) and torch.equal(Ck, Cp)


def test_wrappers_check_cuda_inputs(cuda):
    w, h = 2, 2
    Y = torch.zeros((32, 32), dtype=torch.uint8, device=cuda)
    C = torch.zeros((2, 16, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):        # int32 params expected
        KW.deblock_wavefront(Y, C, torch.zeros((4, 64), device=cuda), w, h)
    with pytest.raises(ValueError):        # planes must be contiguous
        KW.deblock_wavefront(Y.t(), C, torch.zeros(
            (4, 64), dtype=torch.int32, device=cuda), w, h)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_cuda_decoder_equals_numpy(cuda, name):
    # the reference side only: the JAX package's NumPy decoder
    from broadway_tpu.core.decoder import Decoder as BaseDecoder
    data = STREAMS[name]()
    want = [o.frame.tobytes()
            for o in BaseDecoder(backend="cpu").decode_annexb(data)]
    got = [o.frame.tobytes()
           for o in Decoder(device="cuda").decode_annexb(data)]
    assert want and got == want
    # the port's own NumPy path, which chip_smoke.py takes as reference
    own = [o.frame.tobytes() for o in
           Decoder(device="cpu", recon="numpy").decode_annexb(data)]
    assert own == want


# ---------------------------------------------------------------------------
# the persistent wavefront kernels (one launch per picture) on synthetic
# operands: edge geometries, every kind of picture, the row stride
# ---------------------------------------------------------------------------

GEOMETRIES = [(1, 1), (1, 7), (9, 1), (3, 2), (120, 68)]


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _run_intra(dev, w, h, kind, seed, runs=1):
    Y0, C0 = (_t(a, dev) for a in synth.planes(w, h, seed))
    RY, RC, P = (_t(a, dev) for a in synth.intra_operands(w, h, seed + 1,
                                                          kind))
    Yp, Cp = Y0.clone(), C0.clone()
    intra.intra_wavefront_plain(Yp, Cp, RY, RC, P, w, h)
    for _ in range(runs):
        Yk, Ck = Y0.clone(), C0.clone()
        KW.intra_wavefront(Yk, Ck, RY, RC, P, w, h)
        torch.cuda.synchronize()
        assert torch.equal(Yk, Yp) and torch.equal(Ck, Cp)


def _run_deblock(dev, w, h, kind, seed, runs=1):
    Y0, C0 = (_t(a, dev) for a in synth.planes(w, h, seed, smooth=True))
    P = _t(synth.deblock_operands(w, h, seed + 1, kind), dev)
    Yp, Cp = Y0.clone(), C0.clone()
    deblock.deblock_wavefront_plain(Yp, Cp, P, w, h)
    if kind == "intra" and w * h > 1:
        assert not torch.equal(Yp, Y0)       # the filter did fire
    for _ in range(runs):
        Yk, Ck = Y0.clone(), C0.clone()
        KW.deblock_wavefront(Yk, Ck, P, w, h)
        torch.cuda.synchronize()
        assert torch.equal(Yk, Yp) and torch.equal(Ck, Cp)


@pytest.mark.parametrize("kind", synth.KINDS)
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_k2_persistent_geometries(cuda, geom, kind):
    _run_intra(cuda, geom[0], geom[1], kind, seed=100 + geom[0])


@pytest.mark.parametrize("kind", synth.KINDS)
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_k3_persistent_geometries(cuda, geom, kind):
    _run_deblock(cuda, geom[0], geom[1], kind, seed=200 + geom[0])


@pytest.mark.parametrize("kind", synth.KINDS)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_more_rows_than_resident_ctas(cuda, kernel, kind):
    """23 rows on a grid capped at 5 CTAs: each CTA takes rows y, y + 5,
    ... in increasing order and must neither deadlock nor differ."""
    run, which = {"K2": (_run_intra, KW.INTRA),
                  "K3": (_run_deblock, KW.DEBLOCK)}[kernel]
    old = KW.set_max_ctas(5)
    try:
        run(cuda, 17, 23, kind, seed=300)
        assert KW.last_grid(which) == 5
    finally:
        KW.set_max_ctas(old)
    run(cuda, 17, 23, kind, seed=300)
    assert KW.last_grid(which) == 23


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_twice_on_the_same_workspace(cuda, kernel):
    """Stale progress counters would let the second run read neighbours
    before they are written: it passes once and fails twice."""
    run = {"K2": _run_intra, "K3": _run_deblock}[kernel]
    run(cuda, 40, 30, "intra", seed=400, runs=3)
    run(cuda, 40, 30, "mixed", seed=401, runs=3)


def test_one_device_launch_per_picture(cuda):
    w, h = 20, 12
    KW.device_launches(KW.INTRA, reset=True)
    KW.device_launches(KW.DEBLOCK, reset=True)
    _run_intra(cuda, w, h, "intra", seed=500)
    _run_deblock(cuda, w, h, "intra", seed=501)
    assert KW.device_launches(KW.INTRA) == 1
    assert KW.device_launches(KW.DEBLOCK) == 1


def test_handoff_probe_runs(cuda):
    KW.device_launches(KW.PROBE, reset=True)
    KW.handoff_probe(120, 68, cuda)
    torch.cuda.synchronize()
    assert KW.device_launches(KW.PROBE) == 1
