"""The port has no hidden fallback: what it cannot do, it refuses.

- a kernel wrapper given tensors on a device that is neither the CPU
  (plain version) nor CUDA (the kernel) raises;
- the Decoder takes no backend it does not know, and raises when the
  native library cannot be built; a picture the v2 packer refuses takes
  the v1 buffer, and nothing falls back to the NumPy backend, to the
  Python parser or to the unpacked arrays on its own;
- the lockstep path and the multi-instance tool default to the card and
  swallow no exception;
- a frame group whose graph capture or replay fails raises: nothing runs
  the eager step or the plain versions in its place;
- a failed build of either library raises with the compiler's output;
- wrappers count launches only when the kernel runs."""

import os
import stat

import numpy as np
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
    if frontend == "auto":      # no alias: an unknown name is refused
        with pytest.raises(ValueError, match="unknown frontend"):
            Decoder(device="cpu", frontend=frontend, recon="numpy")
        return
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
    """A picture the v2 packer refuses takes the v1 packed buffer (held
    equal in tests/test_torch_decoder_matrix.py). When that packer fails
    too, the decoder raises: it goes neither to the unpacked arrays nor to
    the NumPy backend on its own."""
    monkeypatch.setattr(PK, "pack_picture_v2", lambda *a, **k: None)

    def no_v1(*a, **k):
        raise RuntimeError("bw_pack_picture failed (1)")

    monkeypatch.setattr(nat, "pack_picture_native", no_v1)
    with pytest.raises(RuntimeError, match="bw_pack_picture"):
        Decoder(device="cpu").decode_annexb(_stream())


@pytest.mark.parametrize("pack", ["v1", "v2"])
def test_packed_paths_raise_without_native_library(monkeypatch, tmp_path,
                                                   pack):
    """Only pack="none" works without the native packers, and only on
    request: the packed paths say that the library is missing."""
    _no_library(monkeypatch, tmp_path, str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        Decoder(device="cpu", frontend="python",
                pack=pack).decode_annexb(_stream())
    outs = Decoder(device="cpu", frontend="python",
                   pack="none").decode_annexb(_stream())
    assert len(outs) == 2


def _port_source(*rel):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "broadway_tpu_torch", *rel)) as f:
        return f.read()


@pytest.mark.parametrize("rel", [("parallel", "streams.py"),
                                 ("tools", "multiinstance.py"),
                                 ("core", "recon.py"),
                                 ("core", "graphs.py")])
def test_no_except_and_carry_on_around_a_launch(rel):
    """The lockstep path catches an exception only to abort the whole
    group and raise it again: no handler swallows a failed launch, and no
    name of the plain versions appears on the card's path."""
    import ast
    src = _port_source(*rel)
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.ExceptHandler):
            body = ast.unparse(node)
            assert "raise" in body or "errors.append" in body, body
    assert "_plain" not in src and "torch.compile" not in src


def test_lockstep_entry_points_default_to_cuda():
    import inspect
    from broadway_tpu_torch.parallel import streams as LS
    from broadway_tpu_torch.tools import multiinstance as MI
    assert inspect.signature(
        LS.decode_streams_lockstep).parameters["device"].default == "cuda"
    for fn in (MI.run, MI.run_lockstep):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    for fn in (MI.run, MI.run_lockstep):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(_stream(), 2)


def test_batched_wrappers_refuse_what_the_kernels_cannot_take():
    """Shapes are checked before anything is launched: planes with two
    leading axes, and a skip table that does not match the batch."""
    Y = torch.zeros((1, 2, 32, 32), dtype=torch.uint8)
    C = torch.zeros((1, 2, 2, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="expected"):
        KW._check_planes(Y, C, 2, 2)
    assert KW._check_planes(Y[0], C[0], 2, 2) == 2
    assert KW._check_planes(Y[0, 0], C[0, 0], 2, 2) == 1


def test_cpu_decode_launches_no_kernel():
    before = (K1.mc_predict.launches, KW.intra_wavefront.launches,
              KW.deblock_wavefront.launches)
    outs = Decoder(device="cpu").decode_annexb(_stream())
    assert len(outs) == 2
    assert (K1.mc_predict.launches, KW.intra_wavefront.launches,
            KW.deblock_wavefront.launches) == before
    assert all(isinstance(c, int) for c in before)


def _forbid_eager(monkeypatch):
    """Every way the group path could compute a picture other than through
    its graph: each raises if called."""
    from broadway_tpu_torch.core import decoder as DEC
    from broadway_tpu_torch.core import graphs as GR
    from broadway_tpu_torch.core import recon as RC

    def forbidden(*a, **k):
        raise AssertionError("the group path fell back")

    for mod, name in ((GR, "decode_pictures_packed_group"),
                      (RC, "decode_picture_packed2"),
                      (DEC, "decode_picture_packed2"),
                      (GR, "decode_picture_packed_slots"),
                      (GR, "decode_host_arrays_slots"),
                      (K1, "mc_predict_plain"),
                      (KW, "intra_wavefront_plain"),
                      (KW, "deblock_wavefront_plain")):
        monkeypatch.setattr(mod, name, forbidden)


@pytest.mark.parametrize("fails", ["capture", "replay"])
def test_group_graph_failure_raises_without_fallback(monkeypatch, fails):
    """GroupGraphs on a device tensor (meta here: no card): a capture or a
    replay that raises reaches the caller, and neither the eager step nor
    a plain version runs instead."""
    from broadway_tpu_torch.core import graphs as GR

    def init(self, ref_y, ref_c, group, size, *args):
        self.group, self.args, self.replays = group, args, 0

    def capture(self, *a):
        if fails == "capture":
            raise RuntimeError("capture failed")
        return torch.zeros((self.group, 8), dtype=torch.uint8)

    def replay(self, *a):
        raise RuntimeError("replay failed")

    monkeypatch.setattr(GR.GroupGraph, "__init__", init)
    monkeypatch.setattr(GR.GroupGraph, "capture", capture)
    monkeypatch.setattr(GR.GroupGraph, "replay", replay)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    _forbid_eager(monkeypatch)
    lay = PK.get_packed_layout_v2(2, 2)
    sy = torch.empty((3, 32, 32), dtype=torch.uint8, device="meta")
    sc = torch.empty((3, 2, 16, 16), dtype=torch.uint8, device="meta")
    bufs = np.zeros((2, 64), np.uint8)
    graphs = GR.GroupGraphs()
    if fails == "replay":
        graphs.run(bufs, [0, 1], sy, sc, lay, (1, 1, 1), False, 0)
    with pytest.raises(RuntimeError, match=f"{fails} failed"):
        graphs.run(bufs, [0, 1], sy, sc, lay, (1, 1, 1), False, 0)


def test_decoder_raises_when_the_group_step_fails(monkeypatch):
    """The decoder does not catch a failed group: no eager step for its
    pictures, no plain version."""
    from broadway_tpu_torch.core import graphs as GR

    def failing(self, *a, **k):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(GR.GroupGraphs, "run", failing)
    _forbid_eager(monkeypatch)
    with pytest.raises(RuntimeError, match="capture failed"):
        Decoder(device="cpu", group_frames=2).decode_annexb(_stream())
