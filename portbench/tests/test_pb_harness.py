"""The harness on the CPU: names, plans, the readers on a canned trace of
two clients, the roofline counts by hand, and whole runs of a tiny cell,
sound and with faults planted under the timed path."""

import json
import os
import sys
import time

import pytest

from portbench import lookup, roofline, run
from portbench import trace as TR
from portbench.tests import tiny

S = 1_000_000_000        # ns a second


def test_every_cell_and_configuration_is_found_by_name():
    bench = lookup.benchmark()
    cells = bench.get("workloads") or [
        {"name": f[:-5]} for f in os.listdir(
            os.path.join(lookup.HERE, "workloads"))]
    assert cells
    for w in cells:
        cell = lookup.workload(w["name"])
        cfg = lookup.config(cell["config"])
        assert cfg["name"] == cell["config"]
        if "config" in w:
            assert w["config"] == cell["config"]
        assert lookup.manifest(cell["config"])["gops"]
        for m in lookup.per_layer_metrics(w["name"]):
            reader = lookup.metric(m)
            assert reader.UNIT and callable(reader.read)
    for c in bench.get("configs", []):
        assert lookup.config(c["name"])["source"] == c["source"]
    with pytest.raises(ValueError):
        lookup.workload("../BENCHMARK")


def test_plan_is_the_seeds_and_covers_the_pool():
    cell = lookup.workload("story-360p.procs6")
    cfg = lookup.config("story-360p")
    a = run.plan(cell, cfg, 6, 2**31 + 99, False, "cuda")
    b = run.plan(cell, cfg, 6, 2**31 + 99, False, "cuda")
    c = run.plan(cell, cfg, 6, 2**31 + 100, False, "cuda")
    assert a == b and a != c
    assert len(a) == 6
    for spec in a:
        assert sorted(spec["order"]) == list(range(6))
        assert 60 <= spec["warm_pictures"] < 90


def test_roofline_counts_of_a_2x2_picture_by_hand():
    classes = {"intra": 1, "inter": 2, "skip": 1}
    assert roofline.k1_mc_bytes(classes) == 2 * (384 + 384)
    assert roofline.k2_intra_bytes(classes) == 1 * (384 + 768)
    assert roofline.k3_deblock_bytes(classes) == 4 * (384 + 384)
    assert roofline.share(3072, 1e-6) == pytest.approx(
        100 * 3072 / 3.35e12 / 1e-6)
    assert roofline.share(0, 1.0) is None and roofline.share(1, 0) is None


def _canned():
    k0 = {"intra": 4, "inter": 0, "skip": 0}
    k1 = {"intra": 1, "inter": 2, "skip": 1}
    a = {"t0": 100.0, "cpu_s": 0.5,
         "thread_cpu_s": {"feed": 0.2, "slice": 0.1, "pump": 0.15,
                          "runtime": 0.05},
         "routes": {"eager": 0, "captured": 1, "replayed": 3},
         "pictures": [[0, 0, -0.1, -0.05, 0.01, 0.2],
                      [0, 1, 0.1, 1.15, 0.02, 1.3],
                      [0, 0, 1.2, 1.5, 0.03, None],
                      [0, 1, 1.6, 1.9, 0.04, 2.5]],
         "trace": {"t0": 101 * S, "t1": 102 * S,
                   "busy": [[101 * S, 1012 * S // 10],
                            [1015 * S // 10, 1016 * S // 10]],
                   "ops": {"void mc_kernel(unsigned char const*)":
                           [2, S // 20],
                           "(anonymous namespace)::deblock_rows_kernel":
                           [3, S // 10],
                           "at::native::elementwise_kernel":
                           [1, 15 * S // 100]}}}
    b = {"t0": 100.0, "cpu_s": 0.3,
         "thread_cpu_s": {"feed": 0.1, "slice": 0.05, "pump": 0.1,
                          "runtime": 0.05},
         "routes": {"eager": 1, "captured": 0, "replayed": 4},
         "pictures": [[0, 1, 0.0, 0.5, 0.05, 0.8],
                      [0, 0, 0.9, 1.2, 0.06, 1.9]],
         "trace": {"t0": 101 * S, "t1": 102 * S,
                   "busy": [[1011 * S // 10, 1013 * S // 10],
                            [1019 * S // 10, 1022 * S // 10]],
                   "ops": {"(anonymous namespace)::intra_rows_kernel":
                           [1, S // 50],
                           "(anonymous namespace)::deblock_rows_kernel":
                           [1, 8 * S // 100]}}}
    r = {"seconds": 2.0, "clients": [a, b],
         "manifest": {"gops": [{"mb_classes": [k0, k1]}]}}
    run.add_trace_union(r)
    return r


@pytest.mark.parametrize("name,want", [
    ("frame_ms_p95", 1180.0),
    ("feed_ms", 40.0),
    ("host_cpu_ms", 200.0),
    ("feed_cpu_ms", 75.0),
    ("slice_cpu_ms", 37.5),
    ("pump_cpu_ms", 62.5),
    ("runtime_cpu_ms", 25.0),
    ("replayed_share", 100 * 7 / 9),
    ("step_device_ms", 100.0),
    ("device_idle_share", 50.0),
    ("k1_mc_roofline", 100 * 4 * 768 / 3.35e12 / 0.05),
    ("k2_intra_roofline", 100 * 10 * 1152 / 3.35e12 / 0.02),
    ("k3_deblock_roofline", 100 * 16 * 768 / 3.35e12 / 0.18),
])
def test_readers_on_a_canned_trace_of_two_clients(name, want):
    assert lookup.metric(name).read(_canned()) == pytest.approx(want)


def test_readers_find_nothing_without_a_trace():
    r = _canned()
    for c in r["clients"]:
        c["trace"] = None
    run.add_trace_union(r)
    for name in ("step_device_ms", "device_idle_share", "k1_mc_roofline",
                 "k2_intra_roofline", "k3_deblock_roofline"):
        assert lookup.metric(name).read(r) is None


def test_thread_readers_add_up_to_host_cpu_ms_and_need_the_split():
    r = _canned()
    parts = sum(lookup.metric(m).read(r) for m in (
        "feed_cpu_ms", "slice_cpu_ms", "pump_cpu_ms", "runtime_cpu_ms"))
    assert parts == pytest.approx(lookup.metric("host_cpu_ms").read(r))
    for c in r["clients"]:
        del c["thread_cpu_s"]
    for m in ("feed_cpu_ms", "slice_cpu_ms", "pump_cpu_ms",
              "runtime_cpu_ms"):
        assert lookup.metric(m).read(r) is None


def test_replayed_share_counts_only_the_three_routes():
    r = _canned()
    r["clients"][0]["routes"]["captures_skipped"] = 50
    assert lookup.metric("replayed_share").read(r) == \
        pytest.approx(100 * 7 / 9)


def test_breakdown_of_the_canned_trace():
    b = run.breakdown(_canned())
    assert [round(s, 9) for _, s in b["idle_gaps"]] == [0.3, 0.2]
    assert [n for n, _ in b["idle_gaps"]] == ["feed.P", "feed.I"]
    assert b["device_ops"][0][0] == \
        "(anonymous namespace)::deblock_rows_kernel"
    assert b["device_ops"][0][1] == pytest.approx(0.18)
    assert b["device_ops"][1] == ["at::native::elementwise_kernel", 0.15]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("tiny")))


def _gather(root, argv=None, trace=False):
    """The tiny cell's run as gathered, and its result line's object."""
    t_start = time.time()
    # 6 s: the plain versions on the CPU take some 0.4 s a picture here,
    # and the DPB puts a picture out only at the next IDR at this size
    r = run.collect(tiny.CELL, 2**31 + 7, 6.0, trace, "cpu", argv, root)
    return r, run.report(r, t_start)


def _run(root, fault=None):
    argv = None
    if fault:
        argv = [sys.executable, "-m", "portbench.tests.faulty_client", fault]
    return _gather(root, argv)[1]


def _split_is_the_process_cpu(r):
    for c in r["clients"]:
        parts = c["thread_cpu_s"]
        assert sorted(parts) == ["feed", "pump", "runtime", "slice"]
        assert min(parts.values()) >= 0.0
        # the four add up to the process's CPU clock; os.times counts it
        # in ticks of 10 ms at each end
        assert sum(parts.values()) == pytest.approx(c["cpu_s"], abs=0.05)
        assert parts["feed"] > 0 and parts["slice"] > 0


def test_a_sound_run_of_the_tiny_cell_is_correct(tiny_root):
    r, out = _gather(tiny_root)
    _split_is_the_process_cpu(r)
    # the program's recorder: its counters, and no spans without a trace
    assert all(c["program"]["counters"] and c["program"]["spans"] == []
               for c in r["clients"])
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert out["metrics"]["fps"]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    assert list(out)[-1] == "checks"
    assert out["checks"]["pictures_checked"]["value"] > 0
    json.dumps(out)


@pytest.mark.parametrize("fault", ["alter", "unchanged"])
def test_a_fault_under_the_timed_path_is_not_correct(tiny_root, fault):
    out = _run(tiny_root, fault)
    assert out["correct"] is False
    assert out["checks"]["pictures_differing"]["value"] > 0


def test_program_counters_reach_a_traced_run_as_window_deltas(tiny_root):
    """A decoder with ``trace_snapshot``: its counters come back as the
    window's deltas; a CPU client runs no profiler, so no spans; the
    thread readers read the split."""
    argv = [sys.executable, "-m", "portbench.tests.snapshot_client"]
    r, out = _gather(tiny_root, argv, trace=True)
    assert out["correct"] is True
    _split_is_the_process_cpu(r)
    for c in r["clients"]:
        prog = c["program"]
        assert prog["spans"] == []
        counters = prog["counters"]
        assert counters["snapshots"] == 1 and counters["made"] == 0
        whole = sum(1 for p in c["pictures"] if p[2] >= 0.0 and
                    p[3] is not None)
        assert counters["nal_units"] >= 2 * whole > 0
    for m in ("feed_cpu_ms", "slice_cpu_ms", "pump_cpu_ms",
              "runtime_cpu_ms", "host_cpu_ms"):
        assert out["metrics"][m]["value"] >= 0.0
    parts = sum(out["metrics"][m]["value"] for m in (
        "feed_cpu_ms", "slice_cpu_ms", "pump_cpu_ms", "runtime_cpu_ms"))
    assert parts == pytest.approx(out["metrics"]["host_cpu_ms"]["value"],
                                  rel=0.05)


def test_program_spans_are_clipped_to_a_clients_trace():
    spans = [["parse", "MainThread", 100 * S, 101 * S + 5],
             ["pack", "MainThread", 101 * S + 10, 101 * S + 20],
             ["late", "bw-pump_0", 102 * S - 5, 103 * S],
             ["before", "MainThread", 99 * S, 100 * S],
             ["after", "MainThread", 102 * S, 102 * S + 9]]
    assert TR.clip_spans(spans, 101 * S, 102 * S) == [
        ["parse", "MainThread", 101 * S, 101 * S + 5],
        ["pack", "MainThread", 101 * S + 10, 101 * S + 20],
        ["late", "bw-pump_0", 102 * S - 5, 102 * S]]


def test_idle_gaps_take_the_name_of_the_program_spans():
    """The canned trace's gaps lie at 101.3-101.5 s and 101.6-101.9 s.
    Where every client sent spans, each gap is named by the innermost
    span most clients had open at its middle, over their threads; where
    one client sent none, by the feed threads as before."""
    r = _canned()
    raw = {0: [["decode_nal", "MainThread", 1013 * S // 10, 1015 * S // 10],
               ["parse", "ThreadPoolExecutor-0_0", 10135 * S // 100,
                10145 * S // 100],
               ["pump.wait", "bw-pump_0", 1016 * S // 10, 1019 * S // 10],
               ["outside", "MainThread", 99 * S, 1037 * S // 10]],
           1: [["parse", "ThreadPoolExecutor-0_1", 1012 * S // 10,
                1016 * S // 10],
               ["pump.wait", "bw-pump_0", 10170 * S // 100,
                10180 * S // 100]]}
    for i, c in enumerate(r["clients"]):
        t = c["trace"]
        c["program"] = {"counters": {},
                        "spans": TR.clip_spans(raw[i], t["t0"], t["t1"])}
    b = run.breakdown(r)
    assert b["idle_gaps"] == [["pump.wait", 0.3], ["parse", 0.2]]
    r["clients"][1]["program"] = None
    b = run.breakdown(r)
    assert [n for n, _ in b["idle_gaps"]] == ["feed.P", "feed.I"]
