"""The torch port never imports JAX nor anything of the JAX package
(``broadway_tpu``): not at import, not while making a stream, not while
decoding through the engine or the public entry points (API, OMX
component, MP4 player, dectest, the lockstep group, multiinstance, frame
groups with their graphs module, the band-sharded decode, the dispatch
pump, the conformance sweep, the demos and the x264 encoder), and
chip_smoke.py neither. Checked in fresh interpreters, so
nothing a test process imported earlier can hide an import."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DECODE_NO_JAX = r"""
import importlib, pkgutil, sys
import torch
sys.path.insert(0, %(repo)r)
import broadway_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(broadway_tpu_torch.__path__,
                                              "broadway_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.tools import streams
data, _ = streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3,
                               seed=3, deblock=True)
for kw in ({}, {"recon": "numpy"}, {"frontend": "python"},
           {"group_frames": 2, "prefetch_outputs": True}):
    outs = Decoder(device="cpu", **kw).decode_annexb(data)
    assert len(outs) == 3 and all(
        len(o.frame.tobytes()) == 64 * 48 * 3 // 2 for o in outs)
# frame groups: the graphs module and the lazy frames of a group
from broadway_tpu_torch.core import graphs
from broadway_tpu_torch.core.recon import LazyTorchFrame
outs = Decoder(device="cpu", group_frames=3).decode_annexb(data)
assert isinstance(outs[0].frame, LazyTorchFrame)
assert graphs.MAX_GRAPHS >= 1
# the public entry points: API, OMX component, MP4 player, dectest
from broadway_tpu_torch.omx import SoftAvc
from broadway_tpu_torch.player.player import MP4Player
from broadway_tpu_torch.tools import dectest, mp4mux
c = SoftAvc(device="cpu")
c.queue_input(data, eos=True)
c.reconfigure_output()
n = 0
while c.dequeue_output() is not None:
    n += 1
assert n == 3 and c.eos_delivered
p = MP4Player(mp4mux.mux(data, 64, 48), device="cpu", render="rgb_int").play()
assert len(p.frames) == 3 and tuple(p.frames[0]["rgba"].shape) == (48, 64, 4)
import tempfile, os
with tempfile.TemporaryDirectory() as d:
    with open(os.path.join(d, "s.h264"), "wb") as f:
        f.write(data)
    assert dectest.main(["dectest", "-Onone", "-B", "cpu",
                         os.path.join(d, "s.h264")]) == 0
    # the lockstep group and the multi-instance tool, both modes
    from broadway_tpu_torch.parallel.streams import decode_streams_lockstep
    from broadway_tpu_torch.tools import multiinstance
    got = decode_streams_lockstep([data, data[:]], device="cpu")
    assert [len(g) for g in got] == [3, 3] and got[0] == got[1]
    for mode in ([], ["--lockstep"]):
        assert multiinstance.main(["multiinstance", "-n2", "-B", "cpu",
                                   "-Onone", *mode,
                                   os.path.join(d, "s.h264")]) == 0
# band-sharded decode: the idc-0 chain, the decline, the 2-D form
from broadway_tpu_torch.parallel import multihost, slices
band = streams.banded_stream(width_mbs=4, height_mbs=4, n_bands=2,
                             n_frames=2, deblock_idc=0)[0]
one = [o.frame.tobytes() for o in Decoder(device="cpu").decode_annexb(band)]
st = {}
assert slices.decode_stream_sliced(band, "cpu", 2, stats=st) == one
assert st["cross"] == 2
st = {}
assert len(slices.decode_stream_sliced(data, "cpu", 3, stats=st)) == 3
assert st["declined"] == 3
assert slices.decode_streams_sliced_dp([band, band], [["cpu"] * 2] * 2,
                                       2) == [one, one]
assert multihost.local_devices("cpu", 2) == [torch.device("cpu")] * 2
# the dispatch pump, and the last tools: the sweep, the demos, x264
dec = Decoder(device="cpu", async_pump=True)
assert [o.frame.tobytes() for o in dec.decode_annexb(data)] == \
    [o.frame.tobytes() for o in Decoder(device="cpu").decode_annexb(data)]
dec.close()
from broadway_tpu_torch.tools import conformance_sweep, demo, ext_encoder
assert all(ok for _, ok in conformance_sweep.run_sweep("cpu", 1, 5))
assert demo.tree(data, "cpu")["frames"] == 3
if ext_encoder.available():
    x = ext_encoder.encode_natural(64, 48, 2, seed=1)
    assert len(Decoder(device="cpu").decode_annexb(x)) == 2
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "broadway_tpu"))
assert not bad, bad
print("NO-JAX-OK", len(mods))
"""


def _run(code, cwd=REPO, env_extra=None):
    env = dict(os.environ)
    env.pop("BW_FRONTEND", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_port_imports_and_decodes_without_jax():
    r = _run(["-c", _DECODE_NO_JAX % {"repo": REPO}])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "NO-JAX-OK" in r.stdout


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "broadway_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_statement(path):
    """No `import`/`from` of jax, jaxlib or broadway_tpu (the name not
    followed by `_torch`), at any indentation."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|broadway_tpu)"
                     r"(?![A-Za-z0-9_])")
    with open(path) as f:
        hits = [ln for ln in f if bad.match(ln)]
    assert not hits, hits


def test_cuda_decoder_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the refusal is for hosts "
                    "without it")
    from broadway_tpu_torch.core.decoder import Decoder
    with pytest.raises(RuntimeError, match="CUDA"):
        Decoder(device="cuda")


def test_chip_smoke_fails_without_cuda():
    r = _run(["chip_smoke.py"], env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
