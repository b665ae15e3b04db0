"""Stage by stage, the port's decode_picture equals the JAX pipeline's
plain path (mc="xla", wf="xla"; tests/test_pallas_interpret.py pins that
path byte-equal to the three Pallas kernels in interpret mode) on the
same per-MB arrays and the same random reference planes (unpadded uint8
for the port, through pad_luma/pad_chroma for JAX).

run_stages: 0 residual + base assembly, 1 + MC (K1's plain version),
2 + intra wavefront (K2's), 3 + deblock wavefront (K3's). Exact."""

import functools

import numpy as np
import pytest

import streams

jax = pytest.importorskip("jax")

from bench_common import parse_pictures  # noqa: E402
from broadway_tpu.core import recon_tpu as RT  # noqa: E402
from broadway_tpu.ops.tpu import mc_pallas as K_mcp  # noqa: E402
from broadway_tpu_torch.core import state  # noqa: E402
from broadway_tpu_torch.core.recon import decode_picture  # noqa: E402

STREAMS = {
    "inter": lambda: streams.inter_stream(
        width_mbs=6, height_mbs=5, n_frames=3, seed=5, deblock=True,
        mvd_range=60)[0],
    "intra_mixed": lambda: streams.intra_mixed_stream(
        width_mbs=6, height_mbs=5, n_frames=2, seed=812, deblock=True)[0],
    "multislice_offsets": lambda: streams.multislice_stream(
        width_mbs=6, height_mbs=5, n_frames=3, seed=815, deblock_idc=2,
        alpha_off=6, beta_off=-6, chroma_qp_offset=2)[0],
    "wild_mv_multi_ref": lambda: streams.inter_stream(
        width_mbs=6, height_mbs=5, n_frames=4, seed=818, deblock=True,
        mvd_range=700, num_ref_frames=2, multi_ref_idx=True)[0],
}


@functools.lru_cache(maxsize=None)
def _pictures(name):
    return parse_pictures(STREAMS[name]())


def _refs(w, h, R, seed):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 256, (R, 16 * h, 16 * w)).astype(np.uint8)
    c = rng.randint(0, 256, (R, 2, 8 * h, 8 * w)).astype(np.uint8)
    jy = jax.numpy.stack([K_mcp.pad_luma(jax.numpy.asarray(y[r]))
                          for r in range(R)])
    jc = jax.numpy.stack([K_mcp.pad_chroma(jax.numpy.asarray(c[r, 0]),
                                           jax.numpy.asarray(c[r, 1]))
                          for r in range(R)])
    return (y, c), (jy, jc)


@pytest.mark.parametrize("run_stages", [0, 1, 2, 3])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stage_equals_jax(name, run_stages):
    import torch
    pics = _pictures(name)
    assert pics
    for i, (arrs, w, h, cqo, R) in enumerate(pics):
        (y, c), (jy, jc) = _refs(w, h, R, seed=i)
        steps = {k: jax.numpy.asarray(v)
                 for k, v in RT.step_tables(w, h).items()}
        want = RT.decode_picture(
            {k: jax.numpy.asarray(v) for k, v in arrs.items()}, jy, jc,
            steps, w_mbs=w, h_mbs=h, chroma_qp_offset=cqo, mc="xla",
            wf="xla", run_stages=run_stages)
        Y, C = decode_picture(state.tables_from_numpy(arrs),
                              torch.from_numpy(y), torch.from_numpy(c), w, h,
                              cqo, run_stages=run_stages)
        for plane, got, ref in (("y", Y, want[0]), ("cb", C[0], want[1]),
                                ("cr", C[1], want[2])):
            got = got.numpy().astype(np.int32)
            ref = np.asarray(ref)
            assert got.shape == ref.shape
            bad = np.argwhere(got != ref)
            assert not len(bad), (i, plane, bad[:4])
