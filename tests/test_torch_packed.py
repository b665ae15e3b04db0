"""The port's v2 unpack (broadway_tpu_torch.core.packed.unpack_arrs_v2)
equals the JAX package's on every key, for buffers from the shared
native packer (exact equality)."""

import numpy as np
import pytest
import torch

import streams

jax = pytest.importorskip("jax")

from broadway_tpu.core import packed as PK  # noqa: E402
from broadway_tpu_torch.core import packed as TP  # noqa: E402

# the deblock offsets x idc x FMO x multi-ref matrix of
# test_packed2_matrix.py, plus a multi-ref wild-MV stream
STREAMS = {
    "idc0_a2_b-2": lambda: streams.multislice_stream(
        width_mbs=4, height_mbs=3, seed=902, deblock_idc=0, alpha_off=2,
        beta_off=-2)[0],
    "idc0_a-4_b4": lambda: streams.multislice_stream(
        width_mbs=4, height_mbs=3, seed=896, deblock_idc=0, alpha_off=-4,
        beta_off=4)[0],
    "idc1": lambda: streams.multislice_stream(
        width_mbs=4, height_mbs=3, seed=912, deblock_idc=1, alpha_off=2,
        beta_off=-2)[0],
    "idc2_a6_b-6": lambda: streams.multislice_stream(
        width_mbs=4, height_mbs=3, seed=926, deblock_idc=2, alpha_off=6,
        beta_off=-6)[0],
    "idc2_a-6_b6": lambda: streams.multislice_stream(
        width_mbs=4, height_mbs=3, seed=914, deblock_idc=2, alpha_off=-6,
        beta_off=6)[0],
    "fmo": lambda: streams.fmo_stream(map_type=1, width_mbs=4, height_mbs=3,
                                      seed=917)[0],
    "multi_ref": lambda: streams.inter_stream(
        width_mbs=4, height_mbs=3, n_frames=6, seed=918, num_ref_frames=2,
        multi_ref_idx=True, deblock=True, mvd_range=50)[0],
    "wild_mv_multi_ref": lambda: streams.inter_stream(
        width_mbs=11, height_mbs=7, n_frames=4, seed=20260821, deblock=True,
        mvd_range=400, num_ref_frames=2, multi_ref_idx=True)[0],
    "intra_pcm": lambda: streams.ipcm_stream(width_mbs=4, height_mbs=3)[0],
    "intra_mixed_deblock": lambda: streams.intra_mixed_stream(
        width_mbs=5, height_mbs=4, seed=812, deblock=True)[0],
    "chroma_qp_offset": lambda: streams.multislice_stream(
        width_mbs=4, height_mbs=3, seed=931, chroma_qp_offset=-3)[0],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_unpack_v2_equals_jax(name):
    pics = TP.pack_stream(STREAMS[name]())
    assert pics
    for i, (buf, bk, lay, ci, co, _) in enumerate(pics):
        want = PK.unpack_arrs_v2(jax.numpy.asarray(buf), lay, bk, ci, co)
        got = TP.unpack_arrs_v2(torch.from_numpy(buf), lay, bk, ci, co)
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            g = got[k].numpy()
            assert g.shape == w.shape, (i, k, g.shape, w.shape)
            assert g.dtype == (np.bool_ if w.dtype == np.bool_
                               else np.int32), (i, k, g.dtype)
            assert np.array_equal(g, w), (i, k)


@pytest.mark.parametrize("chroma_qp_offset", [0, 5])
def test_unpack_v2_constrained_intra_flags(chroma_qp_offset):
    """The constrained-intra availability masks (a flag of the unpack,
    not of the buffer) on a picture mixing inter and intra MBs."""
    pics = TP.pack_stream(streams.inter_stream(
        width_mbs=6, height_mbs=5, n_frames=3, seed=77, deblock=True)[0])
    for buf, bk, lay, _, _, _ in pics:
        want = PK.unpack_arrs_v2(jax.numpy.asarray(buf), lay, bk, True,
                                 chroma_qp_offset)
        got = TP.unpack_arrs_v2(torch.from_numpy(buf), lay, bk, True,
                                chroma_qp_offset)
        for k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_unpack_v2_rejects_bad_buffers():
    (buf, bk, lay, ci, co, _), = TP.pack_stream(
        streams.ipcm_stream(width_mbs=4, height_mbs=3, n_frames=1)[0])
    with pytest.raises(ValueError):
        TP.unpack_arrs_v2(torch.from_numpy(buf).to(torch.int32), lay, bk, ci,
                          co)
    with pytest.raises(ValueError):
        TP.unpack_arrs_v2(torch.from_numpy(buf[:-2048]), lay, bk, ci, co)
