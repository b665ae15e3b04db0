"""The port's three hand-written CUDA kernels against their plain torch
versions, on the card (marker ``cuda``; without a card every test here
skips). Inputs come from real packed pictures of small streams, made
from fixed seeds; comparisons are byte equality. Run on a CUDA host:

    python -m pytest tests/test_torch_kernels.py -m cuda -q
"""

import numpy as np
import pytest
import torch

import streams
from broadway_tpu.core.decoder import Decoder as BaseDecoder
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.core.packed import pack_stream, unpack_arrs_v2
from broadway_tpu_torch.core.recon import decode_picture
from broadway_tpu_torch.ops.gpu import deblock, inter, intra
from broadway_tpu_torch.ops.gpu import mc_kernel as K1
from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
from broadway_tpu_torch.ops.gpu.residual import residual_stage

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
    data = STREAMS[name]()
    want = [o.frame.tobytes()
            for o in BaseDecoder(backend="cpu").decode_annexb(data)]
    got = [o.frame.tobytes()
           for o in Decoder(device="cuda").decode_annexb(data)]
    assert want and got == want
