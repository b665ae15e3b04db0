"""The torch port's constant tables and state conversions equal the JAX
package's (exact equality)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from broadway_tpu.core import recon_tpu as RT  # noqa: E402
from broadway_tpu.ops.tpu import deblock as K_db  # noqa: E402
from broadway_tpu.ops.tpu import intra as K_in  # noqa: E402
from broadway_tpu.ops.tpu import mc_pallas as K_mcp  # noqa: E402
from broadway_tpu.ops.tpu import residual as K_res  # noqa: E402
from broadway_tpu_torch.core import state  # noqa: E402
from broadway_tpu_torch.ops.gpu import tables as T  # noqa: E402

# port table name -> the JAX package's array
JAX_TABLES = {
    "LEVEL_SCALE": K_res._LS, "POS_CLASS": K_res._PC, "QP_C": K_res.QP_C_J,
    "ZIGZAG": K_res._ZZ, "INV_ZZ": K_res._INV_ZZ_J,
    "ALPHAS": K_db.ALPHAS_J, "BETAS": K_db.BETAS_J, "TC0": K_db.TC0_J,
    "I4_IDX": K_in.IDX_J, "I4_COEF": K_in.COEF_J, "I4_RND": K_in.RND_J,
    "I4_SHIFT": K_in.SHIFT_J, "Z_PERM": RT._Z_PERM_J,
    "AVUR_CODE": RT._AVUR_CODE_J,
}


@pytest.mark.parametrize("name", sorted(JAX_TABLES))
def test_table_equals_jax(name):
    got = T.tables("cpu")[name]
    want = np.asarray(JAX_TABLES[name])
    assert got.dtype == torch.int32
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_block_order_and_upright():
    assert T.BLK_ORDER == K_in.BLK_ORDER
    assert T.NO_UPRIGHT == K_in.NO_UPRIGHT


def test_i4_kernel_table_layout():
    tab = T.tables("cpu")["I4_KERNEL"].numpy()
    assert tab.shape == (9 * 16 + 16, 8)
    taps = tab[:144].reshape(9, 4, 4, 8)
    assert np.array_equal(taps[..., 0:3], K_in.IDX)
    assert np.array_equal(taps[..., 3:6], K_in.COEF)
    assert np.array_equal(taps[..., 6], K_in.RND)
    assert np.array_equal(taps[..., 7], K_in.SHIFT)
    assert [tuple(r) for r in tab[144:, :2]] == K_in.BLK_ORDER
    assert np.array_equal(tab[144:, 2], RT._AVUR_CODE)


@pytest.mark.parametrize("w,h", [(4, 3), (6, 5), (12, 10), (1, 1), (7, 2)])
def test_diagonals_match_wavefront_layout(w, h):
    lay = RT.get_layout(w, h)
    diags = T.diagonals(w, h, "cpu")
    assert len(diags) == lay.S
    seen = []
    for d, (ys, xs) in enumerate(diags):
        assert np.array_equal((xs + 2 * ys).numpy(), np.full(len(ys), d))
        assert ys.numpy().min() == lay.ymin[d]
        seen += list(zip(ys.tolist(), xs.tolist()))
    assert sorted(seen) == [(y, x) for y in range(h) for x in range(w)]


@pytest.mark.parametrize("w_mbs,h_mbs,R", [(4, 3, 2), (6, 5, 3), (11, 7, 4)])
def test_ref_stacks_from_jax_round_trip(w_mbs, h_mbs, R):
    W, H = 16 * w_mbs, 16 * h_mbs
    rng = np.random.RandomState(w_mbs * 100 + h_mbs)
    y = rng.randint(0, 256, (R, H, W)).astype(np.uint8)
    c = rng.randint(0, 256, (R, 2, H // 2, W // 2)).astype(np.uint8)
    jy = np.stack([np.asarray(K_mcp.pad_luma(jax.numpy.asarray(y[r])))
                   for r in range(R)])
    jc = np.stack([np.asarray(K_mcp.pad_chroma(jax.numpy.asarray(c[r, 0]),
                                               jax.numpy.asarray(c[r, 1])))
                   for r in range(R)])
    assert state.PAD == K_mcp.PAD
    ty, tc = state.ref_stacks_from_jax(jy, jc, W, H)
    assert ty.dtype == tc.dtype == torch.uint8
    assert np.array_equal(ty.numpy(), y)
    assert np.array_equal(tc.numpy(), c)


def test_tables_from_numpy_types():
    arrs = {"b": np.array([True, False]), "u8": np.array([1, 255], np.uint8),
            "i64": np.array([-3, 7], np.int64), "scalar": np.array(False)}
    got = state.tables_from_numpy(arrs)
    assert got["b"].dtype == torch.bool
    assert got["u8"].dtype == got["i64"].dtype == torch.int32
    assert got["scalar"].shape == () and not bool(got["scalar"])
    assert got["u8"].tolist() == [1, 255] and got["i64"].tolist() == [-3, 7]
