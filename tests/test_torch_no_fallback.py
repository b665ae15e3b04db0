"""The port has no hidden fallback: what it cannot do, it refuses.

- a kernel wrapper given tensors on a device that is neither the CPU
  (plain version) nor CUDA (the kernel) raises;
- the Decoder takes no backend it does not know, and raises when the
  native library cannot be built or the v2 packer refuses a picture (it
  never falls back to the NumPy backend or to the Python parser);
- a failed build of either library raises with the compiler's output;
- wrappers count launches only when the kernel runs."""

import os
import stat

import pytest
import torch

from broadway_tpu_torch.bitstream import native as nat
from broadway_tpu_torch.core import packed as PK
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.tools import streams
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
    """No backend or front end by another name: the JAX package's
    `backend=` strings and anything else unknown are refused."""
    with pytest.raises(ValueError):
        Decoder(device="cpu", recon="tpu")
    with pytest.raises(ValueError):
        Decoder(device="cpu", frontend="jax")
    with pytest.raises(ValueError):
        Decoder(device="meta")
    with pytest.raises(TypeError):
        Decoder(device="cpu", backend="cpu")


def _stream():
    return streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=2,
                                seed=11, deblock=True)[0]


def _no_library(monkeypatch, tmp_path, cxx):
    """Point the front-end build at an empty directory and at `cxx`."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setenv("CXX", cxx)


def _fake_compiler(tmp_path, name, message):
    path = tmp_path / name
    path.write_text(f"#!/bin/sh\necho '{message}' >&2\nexit 1\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_decoder_raises_without_native_library(monkeypatch, tmp_path):
    """Even with the Python parser asked for, the torch path needs the
    native v2 packer, and says so instead of reconstructing on the host."""
    _no_library(monkeypatch, tmp_path, str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        Decoder(device="cpu", frontend="python").decode_annexb(_stream())


@pytest.mark.parametrize("frontend", ["native", "auto"])
def test_native_frontend_never_gives_way_to_python(monkeypatch, tmp_path,
                                                   frontend):
    _no_library(monkeypatch, tmp_path, str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        Decoder(device="cpu", frontend=frontend, recon="numpy")


def test_frontend_build_failure_carries_compiler_output(monkeypatch,
                                                        tmp_path):
    cxx = _fake_compiler(tmp_path, "c++", "frontend.cpp:1: boom")
    _no_library(monkeypatch, tmp_path, cxx)
    with pytest.raises(RuntimeError, match="boom"):
        nat.load()
    assert not os.listdir(tmp_path / "out")       # nothing half-built


def test_kernel_build_failure_carries_compiler_output(monkeypatch, tmp_path):
    (tmp_path / "bin").mkdir()
    _fake_compiler(tmp_path / "bin", "nvcc", "intra.cu(7): error: boom")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="boom"):
        _build.load()
    assert not os.listdir(tmp_path / "out")


def test_two_libraries_two_hashes():
    assert os.path.basename(_build.library_path()) != \
        os.path.basename(_build.frontend_library_path())
    assert all(s.endswith(".cu") for s in _build.sources())


def test_misaligned_planes_refused():
    """The persistent kernels move 32-bit words: a plane that does not
    start on a 4-byte boundary is refused, not copied behind the
    caller's back."""
    buf = torch.zeros(32 * 32 + 1, dtype=torch.uint8)
    Y = buf[1:].view(32, 32)
    C = torch.zeros((2, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="aligned"):
        KW._check_planes(Y, C, 2, 2)


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
