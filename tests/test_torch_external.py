"""x264 streams through the port: a third-party encoder's bitstream (the
port's own copy of ``tools/ext_encoder.py``) decoded by the port's NumPy
path (``recon="numpy"``), its torch path on the CPU (the kernels' plain
versions, with and without the dispatch pump) and its MP4 player, each
byte-equal to the JAX package's ``Decoder(backend="cpu")`` on the same
bytes. The streams are those of ``tests/test_external_stream.py``, which
holds the JAX package against the C oracle.

Also the committed 1080p fixture (``broadway_tpu_torch/tools/data/``):
the stream hashes to what its JSON says, its SPS is 1920x1088 cropped to
1080, and (marked ``slow``, outside tier-1) the JAX package still gives
the JSON's picture hashes. The bottom of this file makes the fixture.
"""

import hashlib
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from broadway_tpu_torch.tools import ext_encoder  # noqa: E402

DATA = os.path.join(REPO, "broadway_tpu_torch", "tools", "data")
FIXTURE_H264 = os.path.join(DATA, "x264_natural_1080p.h264")
FIXTURE_JSON = os.path.join(DATA, "x264_natural_1080p.json")
# encode_natural(width, height, n_frames, **kw) of the fixture
FIXTURE_ARGS = (1920, 1080, 8, dict(seed=11, slices=4, keyint=8, refs=3))

# the streams of tests/test_external_stream.py: encode_natural arguments
STREAMS = {
    "192x160x20_2slices_refs3": (192, 160, 20,
                                 dict(seed=3, slices=2, keyint=8, refs=3)),
    "176x144x8_2slices": (176, 144, 8, dict(seed=4, slices=2, keyint=8)),
}
MP4_STREAM = (192, 160, 6, dict(seed=5, keyint=6))

needs_x264 = pytest.mark.skipif(
    not ext_encoder.available(),
    reason="the system's libavcodec / libx264 do not load")


def _encode(args) -> bytes:
    w, h, n, kw = args
    return ext_encoder.encode_natural(w, h, n, **kw)


def _jax_frames(data: bytes):
    from broadway_tpu.core.decoder import Decoder as JaxDecoder
    return [o.frame.tobytes()
            for o in JaxDecoder(backend="cpu").decode_annexb(data)]


def _port_frames(data: bytes, **kw):
    from broadway_tpu_torch.core.decoder import Decoder
    dec = Decoder(**kw)
    try:
        return [o.frame.tobytes() for o in dec.decode_annexb(data)]
    finally:
        dec.close()


@pytest.fixture(scope="module")
def x264():
    """name -> (stream, the JAX package's frames), made once a module."""
    out = {}
    for name, args in STREAMS.items():
        data = _encode(args)
        out[name] = (data, _jax_frames(data))
    return out


PORT_PATHS = {
    "numpy": dict(device="cpu", recon="numpy"),
    "torch_cpu": dict(device="cpu"),
    "torch_cpu_pumped": dict(device="cpu", async_pump=True),
    "torch_cpu_slices4_pumped": dict(device="cpu", parallel_slices=4,
                                     async_pump=True),
}


@needs_x264
@pytest.mark.parametrize("path", sorted(PORT_PATHS))
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_x264_stream_port_equals_jax(x264, stream, path):
    data, want = x264[stream]
    got = _port_frames(data, **PORT_PATHS[path])
    assert len(got) == len(want) == STREAMS[stream][2]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{stream} {path}: picture {i} differs"


@needs_x264
@pytest.mark.parametrize("render", ["yuv", "rgb_int"])
def test_x264_through_port_mp4_player(render):
    """External content end to end: the port's MP4 mux, demux and
    MP4Player, against the JAX package's decoder on the Annex-B bytes."""
    from broadway_tpu_torch.player.player import MP4Player
    from broadway_tpu_torch.tools import mp4mux

    w, h, n, _ = MP4_STREAM
    data = _encode(MP4_STREAM)
    want = _jax_frames(data)
    p = MP4Player(mp4mux.mux(data, w, h, fps=30), device="cpu",
                  render=render).play()
    assert p.stats.total_frames == len(want) == n
    assert [f["frame"].tobytes() for f in p.frames] == want
    if render == "yuv":
        assert [f["yuv"] for f in p.frames] == want


def _fixture_info() -> dict:
    with open(FIXTURE_JSON) as f:
        return json.load(f)


def _fixture_sps(data: bytes):
    from broadway_tpu_torch.bitstream import bitreader as br
    from broadway_tpu_torch.bitstream.params import parse_sps
    for _, payload in br.split_nal_units(data):
        nal = br.NalUnit(payload)
        if nal.nal_type == br.NAL_SPS:
            return parse_sps(br.BitReader(nal.rbsp))
    raise AssertionError("the stream has no SPS")


def test_fixture_stream_is_what_its_json_says():
    with open(FIXTURE_H264, "rb") as f:
        data = f.read()
    info = _fixture_info()
    assert len(data) == info["stream_bytes"]
    assert hashlib.md5(data).hexdigest() == info["stream_md5"]
    w, h, n, kw = FIXTURE_ARGS
    assert (info["width"], info["height"]) == (w, h)
    assert {k: info["x264"][k] for k in kw} == kw
    assert info["x264"]["n_frames"] == n == len(info["frames"])
    assert all(len(m) == 32 and int(m, 16) >= 0 for m in info["frames"])


def test_fixture_sps_is_1088_cropped_to_1080():
    with open(FIXTURE_H264, "rb") as f:
        sps = _fixture_sps(f.read())
    info = _fixture_info()
    assert (sps.width, sps.height) == (1920, 1088)
    assert (sps.width_mbs, sps.height_mbs) == (120, 68)
    assert sps.crop == (0, 0, 0, 8) == tuple(info["crop"])
    assert (info["coded_width"], info["coded_height"]) == (1920, 1088)
    assert sps.profile_idc == 66          # Baseline


def test_fixture_is_tracked_by_git():
    """`*.h264` is ignored by .gitignore; the fixture's directory is the
    exception, so a checkout holds the stream."""
    import subprocess
    r = subprocess.run(["git", "-C", REPO, "check-ignore", "-q",
                        FIXTURE_H264], capture_output=True)
    if r.returncode == 128:
        pytest.skip("not a git checkout")
    assert r.returncode == 1, "the fixture stream is ignored by git"


@pytest.mark.slow
def test_fixture_rehash_with_jax_package():
    """The JAX package's CPU decoder still gives the JSON's hashes (minutes
    at 1080p: not in tier-1)."""
    with open(FIXTURE_H264, "rb") as f:
        data = f.read()
    got = [hashlib.md5(b).hexdigest() for b in _jax_frames(data)]
    assert got == _fixture_info()["frames"]


# ----------------------------------------------------------------------
# Making the committed fixture (run once, where libx264 loads):
#
#     timeout 1200 python3 tests/test_torch_external.py
#
# encodes FIXTURE_ARGS with the port's ext_encoder, writes the stream to
# broadway_tpu_torch/tools/data/, decodes it with the JAX package's
# Decoder(backend="cpu") (minutes at 1080p) and writes the md5 of every
# output picture's bytes, in output order, into the JSON beside it.

def _library_versions() -> dict:
    import ctypes as ct
    avc = ct.CDLL("libavcodec.so.59")
    avu = ct.CDLL("libavutil.so.57")
    avc.avcodec_version.restype = ct.c_uint
    avu.av_version_info.restype = ct.c_char_p
    v = avc.avcodec_version()
    return {"libavcodec": f"{v >> 16}.{(v >> 8) & 255}.{v & 255}",
            "ffmpeg": avu.av_version_info().decode()}


def _x264_sei(data: bytes) -> str:
    """x264's version and options, from the user-data SEI it writes."""
    i = data.find(b"x264 - core")
    return data[i:data.index(b"\0", i)].decode() if i >= 0 else ""


def make_fixture() -> None:
    import hashlib
    import json
    import time

    from broadway_tpu.core.decoder import Decoder as JaxDecoder

    assert ext_encoder.available(), "libx264 does not load here"
    w, h, n, kw = FIXTURE_ARGS
    data = ext_encoder.encode_natural(w, h, n, **kw)
    with open(FIXTURE_H264, "wb") as f:
        f.write(data)
    sps = _fixture_sps(data)
    t0 = time.perf_counter()
    outs = JaxDecoder(backend="cpu").decode_annexb(data)
    sec = time.perf_counter() - t0
    info = {
        "stream": os.path.basename(FIXTURE_H264),
        "stream_bytes": len(data),
        "stream_md5": hashlib.md5(data).hexdigest(),
        "width": w, "height": h,
        "coded_width": sps.width, "coded_height": sps.height,
        "crop": list(sps.crop),
        "x264": {"width": w, "height": h, "n_frames": n, **kw,
                 "profile": "baseline", "preset": "medium", "crf": 23,
                 "bf": 0, "threads": 1, "x264-params":
                     f"slices={kw['slices']}:scenecut=0"},
        "made_with": dict(_library_versions(), x264_sei=_x264_sei(data)),
        "reference": "broadway_tpu.core.decoder.Decoder(backend='cpu')"
                     ".decode_annexb, md5 of each frame.tobytes()",
        "frames": [hashlib.md5(o.frame.tobytes()).hexdigest()
                   for o in outs],
    }
    with open(FIXTURE_JSON, "w") as f:
        json.dump(info, f, indent=1)
        f.write("\n")
    print(f"{FIXTURE_H264}: {len(data)} B, {len(outs)} pictures hashed by "
          f"the JAX package in {sec:.1f} s")


if __name__ == "__main__":
    make_fixture()
