"""The lockstep client and its cells on the CPU: the plan of the cells
that have no group, pinned to what it was before groups existed; the
plan of a group; the group's readers on hand-made runs; and whole runs
of the tiny lockstep cell through ``decode_streams_lockstep(device="cpu")``,
sound and with a fault planted in one stream."""

import hashlib
import json
import sys
import time

import pytest

from portbench import lookup, run
from portbench.tests import tiny

# sha256 of the specs, one JSON line each (as the harness sends them),
# untraced and then traced, with the root "ROOT": what the plan gave these
# cells before the lockstep key existed
PINNED = {
    ("story-360p.procs6", 0):
    "bfa013a54c656b888ef65cd51f9492379ad4592a1b882c8c0789c678d4e1778d",
    ("story-360p.procs6", 2**31 + 99):
    "a4db37cf31130385d50d0c93e46880737681a80adeb2c1f935dd5c24888503e9",
    ("story-360p.procs6", 3_000_000_017):
    "2664c9a001a86afe00b7472a4cc13ee05ac890bb2f4fc69c4febfa85eb5287cb",
    ("cam-1080p.procs8", 0):
    "8b45f16a6ef8d513b538c9de43b83cbbcf9fffa3ecb2d13b42024a1c6d709672",
    ("cam-1080p.procs8", 2**31 + 99):
    "921156b52d63840b9e71081f9f8cdada32f260fa40cae689aa23a37a12333ef4",
    ("cam-1080p.procs8", 3_000_000_017):
    "05a9698949bad96de960c4fb505b9393b11bc3005e131de2e085d6415e50181c",
}


def _plan(name, seed, trace=False):
    cell = lookup.workload(name)
    cfg = lookup.config(cell["config"])
    n = len(lookup.manifest(cell["config"])["gops"])
    return run.plan(cell, cfg, n, seed, trace, "cuda", root="ROOT")


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_the_plan_of_a_cell_without_a_group_is_as_it_was(name, seed):
    lines = [json.dumps(s) for trace in (False, True)
             for s in _plan(name, seed, trace)]
    digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()
    assert digest == PINNED[(name, seed)]


def test_the_plan_of_a_group_is_the_seeds_and_covers_the_pool():
    name = "story-360p.lockstep6"
    a = _plan(name, 2**31 + 99)
    assert a == _plan(name, 2**31 + 99) and a != _plan(name, 2**31 + 100)
    assert len(a) == 1
    spec = a[0]
    assert "order" not in spec and "warm_pictures" not in spec
    assert spec["warm_calls"] == lookup.workload(name)["traffic"][
        "warm_gops"]
    assert len(spec["streams"]) == 6
    for s in spec["streams"]:
        assert sorted(s["order"]) == list(range(6))
        assert 0 <= s["start"] < 6
    # the streams do not all walk the pool alike
    assert len({(tuple(s["order"]), s["start"])
                for s in spec["streams"]}) > 1
    assert spec["live"] == _plan("story-360p.procs6", 2**31 + 99)[0]["live"]


def _lock_run(batches, fallbacks):
    clients = [{"batches": b, "fallbacks": f}
               for b, f in zip(batches, fallbacks)]
    # a client of the other kind sends neither
    clients.append({"routes": {"replayed": 3}})
    return {"clients": clients}


@pytest.mark.parametrize("batches,fallbacks,want_batch,want_share", [
    ([[6] * 30], [0], 6.0, 0.0),
    ([[6, 6, 4, 2]], [2], 4.5, 100 * 2 / 20),
    ([[6, 5], [3]], [1, 0], 14 / 3, 100 * 1 / 15),
])
def test_group_readers_on_hand_made_runs(batches, fallbacks, want_batch,
                                         want_share):
    r = _lock_run(batches, fallbacks)
    assert lookup.metric("round_batch.lock").read(r) == \
        pytest.approx(want_batch)
    assert lookup.metric("fallback_share.lock").read(r) == \
        pytest.approx(want_share)


def test_group_readers_find_nothing_without_a_group():
    r = {"clients": [{"routes": {"replayed": 3}}]}
    assert lookup.metric("round_batch").read(r) is None
    assert lookup.metric("fallback_share").read(r) is None
    r = _lock_run([[]], [0])
    assert lookup.metric("round_batch").read(r) is None
    assert lookup.metric("fallback_share").read(r) is None


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("tiny")))


# 12 s: a call of two streams of six pictures takes some 5 s on the CPU
# here, so the window counts at least one call
SECONDS = 12.0


def _gather(root, argv=None, trace=False, seed=2**31 + 7):
    t_start = time.time()
    r = run.collect(tiny.LOCK_CELL, seed, SECONDS, trace, "cpu", argv, root)
    return r, run.report(r, t_start)


def test_a_sound_run_of_the_tiny_lockstep_cell_is_correct(tiny_root):
    r, out = _gather(tiny_root)
    assert out["correct"] is True and out["failed"] == 0
    assert out["metrics"]["fps"]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    assert list(out)[-1] == "checks"
    assert out["checks"]["live_differing"]["value"] == 0
    assert out["checks"]["pictures_checked"]["value"] > 0
    (c,) = r["clients"]
    counted = [p for p in c["pictures"] if p[5] <= SECONDS]
    assert counted and len(counted) % 12 == 0
    # a picture's first NAL is its call's start, its completion the return
    assert all(p[3] == p[5] for p in c["pictures"])
    assert out["metrics"]["fps"]["value"] == len(counted) / SECONDS
    # on the CPU every round is eager, of both streams
    calls = len(counted) // 12
    assert c["batches"] == [2] * 6 * calls and c["fallbacks"] == 0
    assert c["routes"] == {"eager": 6 * calls, "captured": 0,
                           "replayed": 0}
    assert c["program"]["counters"] and c["program"]["spans"] == []
    assert sorted(c["thread_cpu_s"]) == ["feed", "pump", "runtime",
                                         "slice"]
    assert sum(c["thread_cpu_s"].values()) == pytest.approx(c["cpu_s"],
                                                            abs=0.05)
    json.dumps(out)


def test_a_traced_run_of_the_tiny_lockstep_cell_reads_the_group(tiny_root):
    """On the CPU no profiler runs, so the device readers find nothing;
    the group's and the host's readers read."""
    r, out = _gather(tiny_root, trace=True, seed=2**31 + 8)
    assert out["correct"] is True
    m = out["metrics"]
    assert m["round_batch"]["value"] == 2.0
    assert m["fallback_share"]["value"] == 0.0
    assert m["replayed_share"]["value"] == 0.0
    assert m["host_cpu_ms"]["value"] > 0
    for name in ("step_device_ms", "device_idle_share", "k1_mc_roofline"):
        assert name not in m
    assert "busy_s" not in out["device"]


@pytest.mark.parametrize("fault", ["alter", "unchanged", "half"])
def test_a_fault_in_one_stream_of_the_group_is_not_correct(tiny_root,
                                                           fault):
    argv = [sys.executable, "-m", "portbench.tests.faulty_lockstep_client",
            fault]
    _, out = _gather(tiny_root, argv)
    assert out["correct"] is False
    assert out["checks"]["pictures_differing"]["value"] + \
        out["checks"]["live_differing"]["value"] > 0
