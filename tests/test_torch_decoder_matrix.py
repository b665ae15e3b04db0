"""The deblock matrix of tests/test_packed2_matrix.py on the port:
deblock offsets x disable_deblocking_filter_idc x FMO x multi-ref, where
the boundary-strength path once miscompiled under XLA (bs_left of one
MB dropped to 0). Every frame of the port's Decoder equals the JAX
decoder and the NumPy decoder. Exact."""

import pytest

import streams
from test_torch_decoder import cross_check


@pytest.mark.parametrize("idc,alpha,beta", [
    (0, 2, -2),
    (0, -4, 4),
    (1, 2, -2),   # filtering disabled: offsets must be inert
    (2, 6, -6),   # slice-boundary gating with extreme offsets
    (2, -6, 6),
])
def test_offsets_idc_matrix(idc, alpha, beta):
    cross_check(streams.multislice_stream(width_mbs=4, height_mbs=3,
                                          seed=900 + idc * 10 + alpha,
                                          deblock_idc=idc, alpha_off=alpha,
                                          beta_off=beta)[0])


@pytest.mark.parametrize("idc", [0, 2])
def test_offsets_idc_chroma_offset(idc):
    cross_check(streams.multislice_stream(width_mbs=6, height_mbs=5,
                                          seed=940 + idc, deblock_idc=idc,
                                          alpha_off=3, beta_off=-1,
                                          chroma_qp_offset=-4)[0])


@pytest.mark.parametrize("map_type", [1, 2])
def test_fmo_with_offsets(map_type):
    cross_check(streams.fmo_stream(map_type=map_type, width_mbs=4,
                                   height_mbs=3, seed=917)[0])


def test_multi_ref_with_offsets():
    cross_check(streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=6,
                                     seed=918, num_ref_frames=2,
                                     multi_ref_idx=True, deblock=True,
                                     mvd_range=50)[0])
