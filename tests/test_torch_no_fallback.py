"""The port has no hidden fallback: what it cannot do, it refuses.

- a kernel wrapper given tensors on a device that is neither the CPU
  (plain version) nor CUDA (the kernel) raises;
- the Decoder takes no foreign recon_strategy, and raises when the
  native library is missing or the v2 packer refuses a picture (it never
  falls back to the NumPy backend);
- wrappers count launches only when the kernel runs."""

import pytest
import torch

import streams
from broadway_tpu.bitstream import native as nat
from broadway_tpu.core import packed as PK
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.ops.gpu import _build
from broadway_tpu_torch.ops.gpu import mc_kernel as K1
from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("wrapper", ["mc", "intra", "deblock"])
def test_wrapper_refuses_other_devices(wrapper):
    w, h = 2, 2
    n = w * h
    u8, i32 = torch.uint8, torch.int32
    Y, C = _meta((32, 32), u8), _meta((2, 16, 16), u8)
    with pytest.raises(ValueError, match="unsupported device"):
        if wrapper == "mc":
            K1.mc_predict(_meta((2, 32, 32), u8), _meta((2, 2, 16, 16), u8),
                          _meta((n, 4, 4, 2), i32), _meta((n, 4, 4), i32),
                          w, h)
        elif wrapper == "intra":
            KW.intra_wavefront(Y, C, _meta((n, 16, 16), i32),
                               _meta((n, 2, 8, 8), i32), _meta((n, 32), i32),
                               w, h)
        else:
            KW.deblock_wavefront(Y, C, _meta((n, 64), i32), w, h)


@pytest.mark.parametrize("bad", ["dtype", "shape", "stride"])
def test_check_tensor_rejects(bad):
    t = torch.zeros((4, 6), dtype=torch.int32)
    dev = t.device
    with pytest.raises(ValueError):
        if bad == "dtype":
            _build.check_tensor(t, "t", torch.uint8, (4, 6), dev)
        elif bad == "shape":
            _build.check_tensor(t, "t", torch.int32, (6, 4), dev)
        else:
            _build.check_tensor(t.t(), "t", torch.int32, (6, 4), dev)


def test_launch_error_raises():
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.check(9, "bw_test")
    _build.check(0, "bw_test")


def test_decoder_refuses_foreign_strategy():
    with pytest.raises(ValueError):
        Decoder(device="cpu", recon_strategy=lambda dec, pic: None)


def _stream():
    return streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=2,
                                seed=11, deblock=True)[0]


def test_decoder_raises_without_native_library(monkeypatch):
    monkeypatch.setattr(nat, "pack2_available", lambda: False)
    with pytest.raises(NotImplementedError, match="native"):
        Decoder(device="cpu", frontend="python").decode_annexb(_stream())


def test_decoder_raises_when_v2_pack_refuses(monkeypatch):
    monkeypatch.setattr(PK, "pack_picture_v2", lambda *a, **k: None)
    with pytest.raises(NotImplementedError, match="v2"):
        Decoder(device="cpu").decode_annexb(_stream())


def test_cpu_decode_launches_no_kernel():
    before = (K1.mc_predict.launches, KW.intra_wavefront.launches,
              KW.deblock_wavefront.launches)
    outs = Decoder(device="cpu").decode_annexb(_stream())
    assert len(outs) == 2
    assert (K1.mc_predict.launches, KW.intra_wavefront.launches,
            KW.deblock_wavefront.launches) == before
    assert all(isinstance(c, int) for c in before)
