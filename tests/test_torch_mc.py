"""Plain MC of the port (K1's plain version, through the K1 wrapper on
CPU tensors) equals the JAX package's ``recon_tpu.mc_predict_xla`` on
wild-MV streams: the port clamps every window coordinate into unpadded
planes where JAX clips window origins into PAD-24 edge-replicated ones,
and the two must agree however far outside the picture a vector points.
Exact, on every 4x4 block that predicts something (``ref_blk >= 0``). A
block with ``ref_blk < 0`` (intra MB) predicts nothing: the port writes
0 there, the JAX package a value that nothing ever reads, so those
blocks are required to be 0 and left out of the comparison. Outputs are
uint8."""

import numpy as np
import pytest
import torch

import streams

jax = pytest.importorskip("jax")

from bench_common import parse_pictures  # noqa: E402
from broadway_tpu.core import recon_tpu as RT  # noqa: E402
from broadway_tpu.ops.tpu import mc_pallas as K_mcp  # noqa: E402
from broadway_tpu_torch.ops.gpu import inter  # noqa: E402
from broadway_tpu_torch.ops.gpu import mc_kernel as K1  # noqa: E402
from broadway_tpu_torch.tools import synth  # noqa: E402

_mc_xla = jax.jit(RT.mc_predict_xla, static_argnames=("w_mbs", "h_mbs"))


def _refs(w, h, R, seed):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 256, (R, 16 * h, 16 * w)).astype(np.uint8)
    c = rng.randint(0, 256, (R, 2, 8 * h, 8 * w)).astype(np.uint8)
    jy = jax.numpy.stack([K_mcp.pad_luma(jax.numpy.asarray(y[r]))
                          for r in range(R)])
    jc = jax.numpy.stack([K_mcp.pad_chroma(jax.numpy.asarray(c[r, 0]),
                                           jax.numpy.asarray(c[r, 1]))
                          for r in range(R)])
    return torch.from_numpy(y), torch.from_numpy(c), jy, jc


def _block_masks(ref_blk):
    """ref_blk [n, 4, 4] -> boolean masks of pred_y [n, 16, 16] and
    pred_c [n, 8, 16] that are true where the block predicts."""
    used = ref_blk >= 0
    return (np.repeat(np.repeat(used, 4, axis=1), 4, axis=2),
            np.repeat(np.repeat(used, 2, axis=1), 4, axis=2))


def _compare(mv, ref_blk, w, h, R, seed):
    ty, tc, jy, jc = _refs(w, h, R, seed)
    want_y, want_c = _mc_xla(jy, jc, jax.numpy.asarray(mv),
                             jax.numpy.asarray(ref_blk), w_mbs=w, h_mbs=h)
    got_y, got_c = K1.mc_predict(ty, tc, torch.from_numpy(mv),
                                 torch.from_numpy(ref_blk), w, h)
    assert got_y.dtype == got_c.dtype == torch.uint8
    assert got_y.shape == (w * h, 16, 16) and got_c.shape == (w * h, 8, 16)
    my, mc = _block_masks(ref_blk)
    got_y, got_c = got_y.numpy(), got_c.numpy()
    assert np.array_equal(got_y[my], np.asarray(want_y)[my])
    assert np.array_equal(got_c[mc], np.asarray(want_c)[mc])
    assert not got_y[~my].any() and not got_c[~mc].any()
    return int(my.sum())


@pytest.mark.parametrize("w,h,mvd_range,seed,multi_ref", [
    (11, 7, 400, 20260821, True),
    (5, 4, 700, 818, False),
    (5, 4, 700, 819, True),
])
def test_plain_mc_equals_jax_on_wild_streams(w, h, mvd_range, seed,
                                             multi_ref):
    data = streams.inter_stream(
        width_mbs=w, height_mbs=h, n_frames=5, seed=seed, deblock=True,
        mvd_range=mvd_range, num_ref_frames=2 if multi_ref else 1,
        multi_ref_idx=multi_ref)[0]
    pics = parse_pictures(data)     # error-free pictures only
    assert len(pics) >= 4
    for i, (arrs, pw, ph, _, R) in enumerate(pics):
        _compare(arrs["mv"].astype(np.int32),
                 arrs["ref_blk"].astype(np.int32), pw, ph, R, seed=i)


@pytest.mark.parametrize("span", [40, 300, 4000])
def test_plain_mc_equals_jax_on_random_vectors(span):
    """Uniformly random per-block vectors up to `span` quarter-pels and
    random slots, including -1 (intra MBs)."""
    w, h, R = 6, 4, 3
    rng = np.random.RandomState(span)
    mv = rng.randint(-span, span + 1, (w * h, 4, 4, 2)).astype(np.int32)
    ref_blk = rng.randint(-1, R, (w * h, 4, 4)).astype(np.int32)
    _compare(mv, ref_blk, w, h, R, seed=span)


@pytest.mark.parametrize("case", synth.MC_CASES)
def test_plain_mc_equals_jax_on_case(case):
    """The named cases of ``synth.mc_operands`` (mixed intra/inter MBs,
    16 different vectors per MB, each of the 16 fraction cases with one
    vector per MB and with one per block, windows across every picture
    edge and corner), the same that the card tests give the kernel."""
    w, h, R = 5, 3, 3
    mv, ref_blk = synth.mc_operands(case, w, h, R)
    used = _compare(mv, ref_blk, w, h, R, seed=len(case))
    assert used > 0
    if case == "mixed_intra_inter":
        assert used < w * h * 256
    if case == "sixteen_vectors":
        assert all(len({tuple(v) for v in m.reshape(16, 2)}) == 16
                   for m in mv)
    if case.startswith("frac"):
        fy, fx = int(case[5]), int(case[6])
        assert ((mv[..., 0] & 3) == fx).all()
        assert ((mv[..., 1] & 3) == fy).all()


def test_wrapper_takes_plain_version_on_cpu():
    w, h, R = 3, 2, 2
    rng = np.random.RandomState(1)
    ref_y = torch.from_numpy(rng.randint(0, 256, (R, 32, 48), np.uint8))
    ref_c = torch.from_numpy(rng.randint(0, 256, (R, 2, 16, 24), np.uint8))
    mv = torch.from_numpy(rng.randint(-90, 90, (6, 4, 4, 2), np.int32))
    rb = torch.from_numpy(rng.randint(0, R, (6, 4, 4), np.int32))
    before = K1.mc_predict.launches
    got = K1.mc_predict(ref_y, ref_c, mv, rb, w, h)
    want = inter.mc_predict_plain(ref_y, ref_c, mv, rb, w, h)
    assert K1.mc_predict.launches == before
    assert all(torch.equal(g, x) for g, x in zip(got, want))
