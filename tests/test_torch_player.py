"""The port's player layer (``broadway_tpu_torch/player/``, its
``tools/mp4mux.py`` and its ``dectest`` CLI) held against the JAX
package's: the MP4 muxer and demuxer on the same bytes, ``MP4Player``
frames, the YUV->RGB converters on planes made with numpy from a seed,
``FpsStats`` with injected times, and both ``dectest`` CLIs as
subprocesses on one small stream. CPU only. Exact, except the two float
converters: within 1 code value (the reason stands at that test)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mp4mux as ref_mux
from broadway_tpu.player import mp4 as ref_mp4
from broadway_tpu.player import player as ref_player
from broadway_tpu.player import yuv2rgb as ref_rgb
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.core.recon import TorchFrame
from broadway_tpu_torch.player import mp4 as port_mp4
from broadway_tpu_torch.player import player as port_player
from broadway_tpu_torch.player import yuv2rgb as port_rgb
from broadway_tpu_torch.tools import mp4mux as port_mux
from broadway_tpu_torch.tools import streams
from conftest import REPO

STREAMS = {
    "inter": lambda: streams.inter_stream(n_frames=4, seed=941,
                                          deblock=True),
    "intra_mixed": lambda: streams.intra_mixed_stream(seed=942),
    "multislice": lambda: streams.multislice_stream(
        width_mbs=4, height_mbs=3, seed=926, deblock_idc=2, alpha_off=6,
        beta_off=-6),
    "poc_reorder": lambda: streams.poc_reorder_stream(
        poc_type=0, width_mbs=4, height_mbs=3),
}


def _mp4(name):
    data, info = STREAMS[name]()
    w = info.get("width", 64)
    h = info.get("height", 48)
    return data, port_mux.mux(data, w, h), (w, h)


# ---------------------------------------------------------------------------
# MP4 mux and demux
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(STREAMS))
def test_mux_and_reader_equal_jax_package(name):
    data, mp4, (w, h) = _mp4(name)
    assert mp4 == ref_mux.mux(data, w, h)
    want = ref_mp4.MP4Reader(mp4).read()
    got = port_mp4.MP4Reader(mp4).read()
    assert (got.ftyp, got.timescale, got.duration, len(got.tracks)) == \
        (want.ftyp, want.timescale, want.duration, len(want.tracks))
    gt, wt = got.video_track, want.video_track
    assert gt is not None and (gt.width, gt.height) == (w, h)
    assert dataclasses.asdict(gt) == dataclasses.asdict(wt)   # all tables
    assert gt.avcc.nal_length_size == 4 and len(gt.avcc.sps) == 1
    assert gt.sample_count == wt.sample_count > 0
    for s in range(gt.sample_count):
        assert gt.sample_nal_units(mp4, s) == wt.sample_nal_units(mp4, s)
        assert gt.sample_offset(s) == wt.sample_offset(s)
        assert gt.sample_to_chunk(s) == wt.sample_to_chunk(s)
    for t in (0, 999, 1000, 2500, 10 ** 9):
        assert gt.time_to_sample(t) == wt.time_to_sample(t)


def test_reader_without_video_track():
    with pytest.raises(ValueError, match="no AVC video track"):
        port_player.MP4Player(b"\x00\x00\x00\x10ftypisom\x00\x00\x02\x00",
                              device="cpu")


# ---------------------------------------------------------------------------
# the players
# ---------------------------------------------------------------------------

def _meta(pic: dict, *drop):
    """A picture dict without the keys `drop` (the port's also carries
    the decoded "frame", which the JAX package's does not)."""
    return {k: v for k, v in pic.items() if k not in drop}


@pytest.mark.parametrize("reorder", [False, True],
                         ids=["display_order", "no_output_reordering"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_mp4_player_equals_jax_package(name, reorder):
    data, mp4, _ = _mp4(name)
    want = ref_player.MP4Player(mp4, backend="cpu",
                                no_output_reordering=reorder).play()
    got = port_player.MP4Player(mp4, device="cpu",
                                no_output_reordering=reorder).play()
    assert [_meta(f, "frame") for f in got.frames] == want.frames \
        and want.frames                                 # dicts incl. bytes
    assert all(isinstance(f["frame"], TorchFrame) for f in got.frames)
    assert got.stats.total_frames == want.stats.total_frames
    if not reorder:
        assert [f["yuv"] for f in got.frames] == \
            [o.frame.tobytes()
             for o in Decoder(device="cpu").decode_annexb(data)]


@pytest.mark.parametrize("render", ["rgb_int", "rec601", "rec709"])
def test_player_renders_on_the_frames_device(render):
    _, mp4, (w, h) = _mp4("inter")
    seen = []
    port_player.MP4Player(mp4, device="cpu", render=render,
                          on_picture=seen.append).play()
    want = ref_player.MP4Player(mp4, backend="cpu", render=render).play()
    key = "rgba" if render == "rgb_int" else "rgb"
    assert len(seen) == len(want.frames) > 0
    for g, x in zip(seen, want.frames):
        assert isinstance(g[key], torch.Tensor)
        assert g[key].dtype == torch.uint8
        assert tuple(g[key].shape) == (h, w, 4 if key == "rgba" else 3)
        assert _meta(g, key, "frame") == _meta(x, key)
        diff = np.abs(g[key].numpy().astype(int)
                      - np.asarray(x[key]).astype(int)).max()
        assert diff <= (0 if render == "rgb_int" else 1)


def test_player_refuses_unknown_render():
    with pytest.raises(ValueError, match="unknown render"):
        port_player.Player(device="cpu", render="rgb565")


def test_player_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default constructs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_player.Player()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_player.MP4Player(_mp4("inter")[1])


# ---------------------------------------------------------------------------
# YUV -> RGB
# ---------------------------------------------------------------------------

def _planes(seed, h=32, w=48):
    """Random planes with the range ends and the video-range ends planted,
    each luma extreme against each chroma extreme."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 256, (h, w)).astype(np.uint8)
    cb = rng.randint(0, 256, (h // 2, w // 2)).astype(np.uint8)
    cr = rng.randint(0, 256, (h // 2, w // 2)).astype(np.uint8)
    ext_y = [0, 16, 235, 255]
    ext_c = [0, 1, 16, 127, 128, 129, 240, 255]
    k = 0
    for b in ext_c:
        for r in ext_c:
            cy, cx = divmod(k, w // 2)
            cb[cy, cx], cr[cy, cx] = b, r
            y[2 * cy:2 * cy + 2, 2 * cx:2 * cx + 2] = \
                np.array(ext_y, np.uint8).reshape(2, 2)
            k += 1
    return y, cb, cr


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_rgba_int_equals_jax_function(seed):
    y, cb, cr = _planes(seed)
    want = np.asarray(ref_rgb.yuv420_to_rgba_int(y, cb, cr))
    got = port_rgb.yuv420_to_rgba_int(*(torch.from_numpy(a)
                                        for a in (y, cb, cr)))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    # and the scalar asm.js formula at the planted extremes
    for yy in range(4):
        for xx in range(8):
            Y, U, V = int(y[yy, xx]), int(cb[yy // 2, xx // 2]), \
                int(cr[yy // 2, xx // 2])
            a0 = 1192 * (Y - 16)
            rgb = ((a0 + 1634 * (V - 128)) >> 10,
                   (a0 - 832 * (V - 128) - 400 * (U - 128)) >> 10,
                   (a0 + 2066 * (U - 128)) >> 10)
            assert tuple(got[yy, xx].tolist()) == \
                tuple(min(255, max(0, c)) for c in rgb) + (255,)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("matrix", ["rec601", "rec709"])
def test_matrix_convert_close_to_jax_function(matrix, seed):
    """Tolerance 1 code value: both sides compute in float32, but the JAX
    package contracts the four products with an einsum, whose summation
    order is the backend's, and the port adds them in a fixed order; the
    sums differ in the last bits, and `* 255 + 0.5` truncated turns a
    last-bit difference next to a half into one code value."""
    y, cb, cr = _planes(seed)
    ref_fn = getattr(ref_rgb, f"yuv_to_rgb_{matrix}")
    port_fn = getattr(port_rgb, f"yuv_to_rgb_{matrix}")
    want = np.asarray(ref_fn(y, cb, cr)).astype(int)
    got = port_fn(*(torch.from_numpy(a) for a in (y, cb, cr)))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(int) - want)
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01        # and nearly everywhere equal
    assert np.array_equal(getattr(port_rgb, matrix.upper()),
                          getattr(ref_rgb, matrix.upper()))


def test_converters_take_a_frames_device_planes():
    outs = Decoder(device="cpu").decode_annexb(STREAMS["inter"]()[0])
    f = outs[0].frame
    got = port_rgb.yuv420_to_rgba_int(f.dev_y, f.dev_cb, f.dev_cr)
    assert f._host is None                  # no trip through the host
    want = port_rgb.yuv420_to_rgba_int(*(torch.from_numpy(a.copy())
                                         for a in (f.y, f.cb, f.cr)))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# FpsStats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [1.0 / 30.0, 0.4, 1.7])
def test_fps_stats_equal_jax_package(step):
    a, b = ref_player.FpsStats(), port_player.FpsStats()
    t = 100.0
    for i in range(1300):
        a.tick(t)
        b.tick(t)
        t += step if i % 7 else 2 * step
        if i in (0, 1, 89, 1199, 1299):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.total_frames == 1300 and b.score is not None
    assert b.fps_min <= b.fps <= b.fps_max


# ---------------------------------------------------------------------------
# dectest
# ---------------------------------------------------------------------------

def _cli(tmp_path, which, stream, args):
    out = tmp_path / f"{which}.yuv"
    cwd = tmp_path / which
    cwd.mkdir()
    if which == "ref":
        cmd = [sys.executable, os.path.join(REPO, "tools", "dectest.py")]
    else:
        cmd = [sys.executable, "-m", "broadway_tpu_torch.tools.dectest"]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run(cmd + [f"-O{out}", "-B", "cpu", *args, str(stream)],
                       capture_output=True, text=True, timeout=300, cwd=cwd,
                       env=env)
    assert r.returncode == 0, r.stderr
    trc = cwd / "dec_api.trc"
    return out.read_bytes(), r.stdout, trc.read_text() if trc.exists() else ""


@pytest.mark.parametrize("args", [(), ("-P",), ("-U",), ("-C",), ("-R",),
                                  ("-N3",), ("-T",)],
                         ids=lambda a: a[0] if a else "plain")
def test_dectest_equals_jax_package(tmp_path, args):
    if args == ("-C",):
        data = streams.cropped_stream()[0]
    elif args == ("-R",):
        data = STREAMS["poc_reorder"]()[0]
    else:
        data = streams.inter_stream(n_frames=4, seed=901, deblock=True)[0]
    stream = tmp_path / "s.h264"
    stream.write_bytes(data)
    want = _cli(tmp_path, "ref", stream, args)
    got = _cli(tmp_path, "port", stream, args)
    assert got[0] == want[0] and want[0]            # the YUV file
    assert got[1] == want[1] and "pictures decoded" in got[1]
    assert got[2] == want[2]
    if args == ("-T",):
        assert "H264SwDecDecode#" in got[2]
    if args == ("-N3",):
        assert got[1].splitlines()[-1].startswith("3 pictures")
    if args == ("-C",):
        l, r, t, b = 4, 6, 2, 8
        assert len(got[0]) == 2 * (64 - l - r) * (48 - t - b) * 3 // 2


def test_dectest_without_card_fails(tmp_path):
    """No -B: the card, and without one the CLI fails instead of
    decoding on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    stream = tmp_path / "s.h264"
    stream.write_bytes(streams.cropped_stream()[0])
    r = subprocess.run(
        [sys.executable, "-m", "broadway_tpu_torch.tools.dectest",
         "-Onone", str(stream)], capture_output=True, text=True,
        timeout=300, cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
