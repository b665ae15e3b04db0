"""The port's last tools on the CPU: ``tools/conformance_sweep.py`` (the
repository's sweep matrix, the port's NumPy path as its reference),
``tools/demo.py`` (``tree`` and the six-player ``story`` over the port's
players) and ``tools/ext_encoder.py`` (the port's copy of the x264
binding), each against the repository's own tool or the JAX package's
decoder on the same bytes.
"""

import os

import pytest

import conformance_sweep as root_sweep
from broadway_tpu.core.decoder import Decoder as BaseDecoder
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.tools import conformance_sweep, demo, ext_encoder
from broadway_tpu_torch.tools import mp4mux, streams

SWEEP_SEED = 20260821


def _jax_frames(data):
    return [o.frame.tobytes()
            for o in BaseDecoder(backend="cpu").decode_annexb(data)]


def test_sweep_draws_the_repository_matrix():
    """The same seed gives the repository's sweep's streams: names and
    bytes (the port's generator is the repository's)."""
    import random
    port = list(conformance_sweep.gen_streams(random.Random(SWEEP_SEED), 12))
    root = list(root_sweep.gen_streams(random.Random(SWEEP_SEED), 12))
    assert [n for n, _ in port] == [n for n, _ in root]
    assert [d for _, d in port] == [d for _, d in root]
    kinds = {n.split("-")[0] for n, _ in port}
    assert kinds == {"wildmv", "mslice", "intra", "fmo", "inter", "ipcm"}


def test_run_sweep_on_cpu_is_all_byte_equal():
    got = conformance_sweep.run_sweep("cpu", 6, SWEEP_SEED)
    assert len(got) == 6
    assert all(ok for _, ok in got), got


def test_sweep_reference_equals_the_jax_package():
    """The sweep's reference (the port's NumPy path) equals the JAX
    package's NumPy decoder on the first stream of each kind."""
    import random
    for name, data in conformance_sweep.gen_streams(
            random.Random(SWEEP_SEED), 6):
        assert conformance_sweep.reference_yuv(data) == \
            b"".join(_jax_frames(data)), name


def test_sweep_cli_exits_1_on_a_mismatch(monkeypatch, capsys):
    argv = ["conformance_sweep", "-B", "cpu", "-N", "2", "--seed", "5"]
    assert conformance_sweep.main(argv) == 0
    assert "2/2 streams byte-equal" in capsys.readouterr().out
    monkeypatch.setattr(conformance_sweep, "reference_yuv",
                        lambda data: b"not the frames")
    assert conformance_sweep.main(argv) == 1
    out = capsys.readouterr().out
    assert "FAIL" in out and "0/2 streams byte-equal" in out
    assert conformance_sweep.main(["conformance_sweep", "-X"]) == 2


def _story_stream():
    # 4x3 MBs, deblock on, two references
    return streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3,
                                seed=5, deblock=True, num_ref_frames=2,
                                multi_ref_idx=True)[0]


def test_story_six_players_on_cpu_are_equal():
    data = _story_stream()
    want = _jax_frames(data)
    res = demo.story(data, "cpu")
    assert [(r["device"], r["render"]) for r in res] == \
        [("cpu", "yuv"), ("cpu", "rgb_int"), ("cpu", "yuv"),
         ("cpu", "rec601"), ("cpu", "rec709"), ("cpu", "rgb_int")]
    for r in res:
        assert r["frames"] == len(want) == 3
        assert r["yuv"] == want, r["label"]
        assert r["fps"] > 0 and r["seconds"] > 0


def test_story_raises_what_a_player_raised():
    """Four players on a device the decoder refuses: story raises their
    error after the two CPU players have ended."""
    with pytest.raises(ValueError, match="unsupported device"):
        demo.story(_story_stream(), "meta")


@pytest.mark.parametrize("render", ["yuv", "rgb_int"])
def test_tree_on_the_port_mp4_mux(render):
    data = streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=4,
                                seed=7, deblock=True)[0]
    r = demo.tree(mp4mux.mux(data, 64, 48), "cpu", render)
    assert r["label"] == "tree" and r["render"] == render
    assert r["yuv"] == _jax_frames(data)


@pytest.mark.parametrize("form", [["-B", "cpu"], ["-Bcpu"]])
def test_demo_cli(tmp_path, capsys, form):
    data = _story_stream()
    path = tmp_path / "s.h264"
    path.write_bytes(data)
    assert demo.main(["demo", "tree", *form, "-R", "rec709",
                      str(path)]) == 0
    out = capsys.readouterr().out
    assert "[tree] device=cpu render=rec709: 3 frames" in out
    assert demo.main(["demo", "bogus"]) == 1


needs_x264 = pytest.mark.skipif(
    not ext_encoder.available(),
    reason="the system's libavcodec / libx264 do not load")


@needs_x264
def test_ext_encoder_copy_equals_the_repository_tool():
    import ext_encoder as root_encoder
    import numpy as np
    args = (96, 64, 4)
    kw = dict(seed=9, slices=2, keyint=4, refs=2)
    for a, b in zip(ext_encoder.natural_frames(*args, seed=9),
                    root_encoder.natural_frames(*args, seed=9)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    data = ext_encoder.encode_natural(*args, **kw)
    assert data == root_encoder.encode_natural(*args, **kw)
    assert [o.frame.tobytes() for o in
            Decoder(device="cpu").decode_annexb(data)] == _jax_frames(data)


def test_ext_encoder_refuses_planar_arrays():
    if not ext_encoder.available():
        pytest.skip("the system's libavcodec / libx264 do not load")
    import numpy as np
    with pytest.raises(ValueError, match="tuples"):
        ext_encoder.encode_annexb([np.zeros((24, 16), np.uint8)], 16, 16)


def test_tools_default_to_the_card():
    import inspect
    assert inspect.signature(conformance_sweep.run_sweep).parameters[
        "device"].default == "cuda"
    for fn in (demo.play, demo.tree, demo.story):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert os.path.basename(conformance_sweep.__file__) == \
        "conformance_sweep.py"
