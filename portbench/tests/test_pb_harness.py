"""The harness on the CPU: names, plans, the readers on a canned trace of
two clients, the roofline counts by hand, and whole runs of a tiny cell,
sound and with faults planted under the timed path."""

import json
import os
import sys
import time

import pytest

from portbench import lookup, roofline, run
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


def test_breakdown_of_the_canned_trace():
    b = run.breakdown(_canned())
    assert [round(s, 9) for _, s in b["idle_gaps"]] == [0.3, 0.2]
    assert b["device_ops"][0][0] == \
        "(anonymous namespace)::deblock_rows_kernel"
    assert b["device_ops"][0][1] == pytest.approx(0.18)
    assert b["device_ops"][1] == ["at::native::elementwise_kernel", 0.15]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("tiny")))


def _run(root, fault=None, trace=False):
    argv = None
    if fault:
        argv = [sys.executable, "-m", "portbench.tests.faulty_client", fault]
    # 6 s: the plain versions on the CPU take some 0.4 s a picture here,
    # and the DPB puts a picture out only at the next IDR at this size
    return run.run_cell(tiny.CELL, 2**31 + 7, 6.0, trace, device="cpu",
                        client_argv=argv, t_start=time.time(),
                        root=root)


def test_a_sound_run_of_the_tiny_cell_is_correct(tiny_root):
    out = _run(tiny_root)
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
