"""The port's benchmark (``broadway_tpu_torch/tools/bench.py``) on the CPU,
at the CPU rehearsal's size (``--tiny``: 8x6 MBs, 2 pictures): every
section runs and holds its md5s, no time is reported off the card, a
missing card and a failed section give a non-zero exit; the port's
``parse_pictures`` against the JAX package's, ``annexb_prefix``, and the
committed md5s (``broadway_tpu_torch/tools/data/bench_md5.json``) remade
with the JAX package for the rehearsal's streams.

The bottom of this file makes that JSON (the JAX package's NumPy decoder
and its XLA pipeline on the CPU, tens of minutes for the 1080p and 4K
streams):

    JAX_PLATFORMS=cpu timeout 3600 python3 tests/test_torch_bench.py
"""

import hashlib
import json
import os
import re
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

jax = pytest.importorskip("jax")

import bench_common as jax_bench_common  # noqa: E402
import streams as jax_streams  # noqa: E402
from broadway_tpu.core import recon_tpu as RT  # noqa: E402
from broadway_tpu.core.decoder import Decoder as JaxDecoder  # noqa: E402
from broadway_tpu.ops.tpu import mc_pallas as K_mcp  # noqa: E402
from broadway_tpu_torch.core.decoder import Decoder  # noqa: E402
from broadway_tpu_torch.tools import bench  # noqa: E402
from broadway_tpu_torch.tools import bench_common as BC  # noqa: E402

# the names of every time, rate and share field in the bench's lines
TIMED = re.compile(r"(^fps|_fps$|_ms$|_s$|_mbps$|_share$|^value$|"
                   r"^vs_baseline$|ms_per_frame)")
TINY = bench.PLANS["tiny"]
SEEDS = (0, 1)                 # the pipeline's committed seeds


@pytest.fixture
def one_thread():
    """The plain versions on 8x6 MBs are many tiny torch ops: one intra-op
    thread runs them faster than several (and beside the other test
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(capsys, *argv):
    rc = bench.main(list(argv))
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    return rc, lines


def _timed_leaves(obj, under=False, path=""):
    """(path, value) of every leaf under a timed key."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _timed_leaves(v, under or bool(TIMED.search(k)),
                                     f"{path}.{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _timed_leaves(v, under, f"{path}[{i}]")
    elif under:
        yield path, obj


def _checks(obj):
    """Every md5_ok flag in a line."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k == "md5_ok":
                yield v
            else:
                yield from _checks(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _checks(v)


def test_tiny_runs_every_section_on_the_cpu(capsys, one_thread):
    rc, lines = _run(capsys, "--device", "cpu", "--tiny", "--passes", "1")
    *sections, last = lines
    assert [s["section"] for s in sections] == list(bench.SECTIONS)
    for s in sections:
        assert s["ok"] and s["error"] is None, s
        assert list(_checks(s)), f"{s['section']} holds no md5 check"
        assert all(v is True for v in _checks(s)), s["section"]
    assert set(last) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert last["detail"]["device"] == "cpu"
    assert last["detail"]["card"] is None
    assert last["detail"]["sections"] == {s["section"]: s for s in sections}
    leaves = list(_timed_leaves(lines))
    assert len(leaves) > 50
    assert [p for p, v in leaves if v is not None] == []
    # the counts carry values: rounds and batch sizes of the lockstep
    batch = sections[1]["runs"][0]
    assert (batch["B"], batch["rounds"], batch["batches"]) == (2, 2, [2, 2])
    assert sections[2]["run"]["pictures"] == 2
    assert rc == 0


def test_cuda_without_a_card_runs_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc, lines = _run(capsys, "--device", "cuda", "--tiny")
    assert rc != 0 and lines == []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run(plan="tiny", device="cuda")


def test_a_failed_section_fails_the_run_and_the_others_print(
        capsys, monkeypatch, one_thread):
    """A bad 4K stream (64 bytes of its second picture overwritten) fails
    its section on the md5s; the sections before and after it still run
    and print, and the exit code is 1."""
    make = bench.make_streams
    uhd = TINY.uhd[0]

    def bad(plan, fixture):
        out = make(plan, fixture)
        data = bytearray(out[uhd])
        mid = len(BC.annexb_prefix(bytes(data), 1)) + 40
        data[mid:mid + 64] = bytes(range(64))
        out[uhd] = bytes(data)
        return out

    monkeypatch.setattr(bench, "make_streams", bad)
    rc, lines = _run(capsys, "--device", "cpu", "--tiny", "--passes", "1",
                     "--section", "e2e", "--section", "4k",
                     "--section", "fetch")
    *sections, last = lines
    assert [(s["section"], s["ok"]) for s in sections] == [
        ("e2e", True), ("4k", False), ("fetch", True)]
    assert sections[1]["error"]
    assert last["detail"]["sections"]["4k"]["ok"] is False
    assert rc == 1


@pytest.mark.parametrize("kind", ["realistic", "dense"])
def test_parse_pictures_equals_the_jax_package(kind):
    key = bench.stream_key(kind, 8, 6, 4242 if kind == "realistic" else 909)
    data = bench._generate(key, 3)
    got = BC.parse_pictures(data)
    want = jax_bench_common.parse_pictures(data)
    assert len(got) == len(want) == 3
    for (ga, *gm), (wa, *wm) in zip(got, want):
        assert gm == wm
        assert sorted(ga) == sorted(wa)
        for k in wa:
            assert np.asarray(ga[k]).dtype == np.asarray(wa[k]).dtype, k
            assert np.array_equal(ga[k], wa[k]), k
    assert len(BC.parse_pictures(data, max_pics=2)) == 2


def _frames(data):
    dec = Decoder(device="cpu")
    try:
        return [o.frame.tobytes() for o in dec.decode_annexb(data)]
    finally:
        dec.close()


@pytest.mark.parametrize("key", [bench.stream_key("realistic", 8, 6, 4242),
                                 bench.stream_key("dense", 8, 6, 909)])
def test_annexb_prefix_decodes_to_the_first_pictures(key):
    n = 3
    data = bench._generate(key, n)
    full = _frames(data)
    assert len(full) == n
    assert BC.annexb_prefix(data, n) == data
    assert BC.annexb_prefix(data, n + 2) == data
    for k in range(1, n):
        pre = BC.annexb_prefix(data, k)
        assert data.startswith(pre) and len(pre) < len(data)
        assert _frames(pre) == full[:k]
        # the generator's shorter stream is the same bytes: the bench takes
        # a prefix where it has the longer stream
        gen, kw = bench.stream_args(key, k)
        assert getattr(jax_streams, gen)(**kw)[0] == pre
    with pytest.raises(ValueError):
        BC.annexb_prefix(data, 0)


# ----------------------------------------------------------------------
# The committed md5s: what the JAX package gives on the CPU

def jax_stream_entry(key: str, n_frames: int) -> dict:
    """Stream `key` of `n_frames` pictures from the JAX package's generator
    (tools/streams.py), decoded by its NumPy decoder."""
    gen, kw = bench.stream_args(key, n_frames)
    t0 = time.perf_counter()
    data = getattr(jax_streams, gen)(**kw)[0]
    t1 = time.perf_counter()
    outs = JaxDecoder(backend="cpu").decode_annexb(data)
    t2 = time.perf_counter()
    return {"generator": f"tools/streams.py {gen}", "args": kw,
            "bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(),
            "pictures": [hashlib.md5(o.frame.tobytes()).hexdigest()
                         for o in outs],
            "seconds_here": {"generate": round(t1 - t0, 1),
                             "decode": round(t2 - t1, 1)}}


def jax_pipeline_entry(key: str, idx: int) -> dict:
    """The JAX package's decode_picture(mc="xla", wf="xla") at run_stages
    0-3 on picture `idx` of stream `key` (its parse_pictures), against
    reference planes from bench_common.reference_planes(seed), padded."""
    gen, kw = bench.stream_args(key, idx + 1)
    t0 = time.perf_counter()
    data = getattr(jax_streams, gen)(**kw)[0]
    arrs, w, h, cqo, R = jax_bench_common.parse_pictures(
        data, max_pics=idx + 1)[idx]
    jarrs = {k: jax.numpy.asarray(v) for k, v in arrs.items()}
    steps = {k: jax.numpy.asarray(v) for k, v in RT.step_tables(w, h).items()}
    out = {"w_mbs": w, "h_mbs": h, "n_slots": R, "seeds": {}}
    for seed in SEEDS:
        y, c = BC.reference_planes(w, h, R, seed)
        jy = jax.numpy.stack([K_mcp.pad_luma(jax.numpy.asarray(y[r]))
                              for r in range(R)])
        jc = jax.numpy.stack([K_mcp.pad_chroma(jax.numpy.asarray(c[r, 0]),
                                               jax.numpy.asarray(c[r, 1]))
                              for r in range(R)])
        md5 = {}
        for rs in range(4):
            planes = RT.decode_picture(jarrs, jy, jc, steps, w_mbs=w,
                                       h_mbs=h, chroma_qp_offset=cqo,
                                       mc="xla", wf="xla", run_stages=rs)
            md5[str(rs)] = hashlib.md5(b"".join(
                np.asarray(p).astype(np.uint8).tobytes()
                for p in planes[:3])).hexdigest()
        out["seeds"][str(seed)] = md5
    out["seconds_here"] = round(time.perf_counter() - t0, 1)
    return out


def fixture_work():
    """(streams: key -> the most pictures any plan generates, pipeline
    pictures: sorted (key, index)) that the JSON must hold."""
    streams, pics = {}, set()
    for plan in bench.PLANS.values():
        for k, n in plan.generate.items():
            streams[k] = max(streams.get(k, 0), n)
        pics.update(plan.pipeline)
    return streams, sorted(pics)


def test_the_json_holds_every_plan_and_its_rehearsal_is_remade():
    """Every stream and pipeline picture of every plan is in the JSON at
    its longest, with both seeds; the rehearsal's (--tiny) streams are
    what the JAX package gives now (its generator's bytes, its NumPy
    decoder's pictures). The rehearsal's pipeline md5s are held by the
    port's plain versions in the test above (and the port's pipeline by
    tests/test_torch_stages.py against the JAX package's)."""
    fix = bench.load_fixture()
    streams, pics = fixture_work()
    assert {k: e["args"]["n_frames"] for k, e in fix["streams"].items()} \
        == streams
    assert sorted(fix["pipeline"]["pictures"]) == sorted(
        f"{k}#{i}" for k, i in pics)
    for k, n in TINY.generate.items():
        got, want = jax_stream_entry(k, n), fix["streams"][k]
        for field in ("args", "bytes", "sha256", "pictures"):
            assert got[field] == want[field], (k, field)
    for pic in fix["pipeline"]["pictures"].values():
        assert set(pic["seeds"]) == {str(s) for s in SEEDS}
        assert all(set(m) == {"0", "1", "2", "3"}
                   for m in pic["seeds"].values())


def make_fixture(workers: int = 6) -> None:
    import multiprocessing
    streams, pics = fixture_work()
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ctx.Pool(workers) as pool:
        # the longest first, so that the pool ends together
        order = sorted(streams, key=lambda k: -streams[k] * np.prod(
            [int(v) for v in k.split("_")[1].split("x")]))
        sj = {k: pool.apply_async(jax_stream_entry, (k, streams[k]))
              for k in order}
        pj = {f"{k}#{i}": pool.apply_async(jax_pipeline_entry, (k, i))
              for k, i in pics}
        out = {
            "reference": "broadway_tpu.core.decoder.Decoder(backend='cpu')"
                         ".decode_annexb (the JAX package's NumPy decoder) "
                         "on the JAX package's generator's bytes: md5 of "
                         "each output frame.tobytes(), in output order",
            "made_by": "python3 tests/test_torch_bench.py",
            "streams": {k: j.get() for k, j in sorted(sj.items())},
            "pipeline": {
                "reference": "broadway_tpu.core.recon_tpu.decode_picture("
                             "..., mc='xla', wf='xla', run_stages=k) on the "
                             "picture's host arrays (tools/bench_common."
                             "parse_pictures) against broadway_tpu_torch."
                             "tools.bench_common.reference_planes(w, h, R, "
                             "seed) through pad_luma / pad_chroma: md5 of "
                             "Y, Cb, Cr as uint8",
                "pictures": {k: j.get() for k, j in sorted(pj.items())}},
        }
    with open(bench.FIXTURE, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"{bench.FIXTURE}: {len(streams)} streams, {len(pics)} pipeline "
          f"pictures in {time.perf_counter() - t0:.0f} s")


if __name__ == "__main__":
    make_fixture()
