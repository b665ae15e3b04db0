"""The readers of the program's spans and counters (``metrics/_spans.py``
and the readers that use it) on a canned run of two clients: self time
under nesting, the thread filters, the counters' share, the idle gaps
that no span names, and None wherever a client sent no spans; then the
tiny cell on the CPU with the real decoder, whose ``program`` holds
counters and no spans (its clients run no profiler)."""

import random
import time

import pytest

from portbench import lookup, run
from portbench import trace as TR
from portbench.metrics import _spans, idle_unnamed_share
from portbench.tests import tiny

MS = 1_000_000           # ns a millisecond

SPAN_READERS = ("pump_sync_ms", "pump_enqueue_ms", "pump_queue_ms",
                "pump_drain_ms", "front_parse_ms", "pool_wait_ms",
                "slice_parse_ms", "front_header_ms", "pack_ms",
                "idle_unnamed_share")
READERS = SPAN_READERS + ("sync_blocked_share",)


def _t(seconds: float) -> int:
    return round(seconds * 1000) * MS


def _span(name, thread, a, b):
    return [name, thread, _t(a), _t(b)]


def _canned():
    """Two clients traced over 101-102 s (4 pictures fed inside the
    traces); the union of their device intervals leaves two gaps,
    101.3-101.5 s and 101.6-101.9 s."""
    S = 1_000_000_000
    a = {"t0": 100.0,
         "pictures": [[0, 0, -0.1, -0.05, 0.01, 0.2],
                      [0, 1, 0.1, 1.15, 0.02, 1.3],
                      [0, 0, 1.2, 1.5, 0.03, None],
                      [0, 1, 1.6, 1.9, 0.04, 2.5]],
         "trace": {"t0": 101 * S, "t1": 102 * S,
                   "busy": [[_t(101.0), _t(101.2)], [_t(101.5), _t(101.6)]],
                   "ops": {}},
         "program": {
             "counters": {"graph.uploads": 10, "graph.sync_blocked": 3},
             "spans": [
                 _span("front.header", "MainThread", 101.0, 101.4),
                 _span("front.start_picture", "MainThread", 101.05, 101.1),
                 _span("front.pool_wait", "MainThread", 101.1, 101.2),
                 _span("front.finish", "MainThread", 101.2, 101.35),
                 _span("front.pack", "MainThread", 101.25, 101.3),
                 _span("pump.submit", "MainThread", 101.3, 101.32),
                 _span("front.submit", "MainThread", 101.4, 101.45),
                 _span("pump.queued", "bw-pump_0", 101.31, 101.5),
                 _span("pump.job", "bw-pump_0", 101.5, 101.7),
                 _span("graph.sync", "bw-pump_0", 101.5, 101.6),
                 _span("graph.upload", "bw-pump_0", 101.6, 101.62),
                 _span("graph.replay", "bw-pump_0", 101.65, 101.68),
                 _span("pump.drain", "MainThread", 101.9, 101.95),
                 _span("slice.queued", "bw-slice_0", 101.0, 101.05),
                 _span("slice.parse", "bw-slice_0", 101.05, 101.3)]}}
    b = {"t0": 100.0,
         "pictures": [[0, 1, 0.0, 0.5, 0.05, 0.8],
                      [0, 0, 0.9, 1.2, 0.06, 1.9]],
         "trace": {"t0": 101 * S, "t1": 102 * S,
                   "busy": [[_t(101.1), _t(101.3)], [_t(101.9), _t(102.2)]],
                   "ops": {}},
         "program": {
             "counters": {"graph.uploads": 10, "graph.sync_blocked": 1},
             "spans": [
                 _span("front.parse", "MainThread", 101.0, 101.2),
                 _span("graph.sync", "bw-pump_0", 101.3, 101.4),
                 # not the pump's: pump_sync_ms leaves it out
                 _span("graph.sync", "MainThread", 101.5, 101.6)]}}
    r = {"seconds": 2.0, "clients": [a, b],
         "manifest": {"gops": [{"mb_classes": [{}, {}]}]}}
    run.add_trace_union(r)
    return r


@pytest.mark.parametrize("name,want", [
    ("pump_sync_ms", (100 + 100) / 4),
    # pump.job's 200 less its three children's 150, upload 20, replay 30
    ("pump_enqueue_ms", (50 + 20 + 30) / 4),
    ("pump_queue_ms", 190 / 4),
    ("pump_drain_ms", 50 / 4),
    ("front_parse_ms", 200 / 4),
    ("pool_wait_ms", 100 / 4),
    ("slice_parse_ms", 250 / 4),
    # front.header's 400 less start_picture 50, pool_wait 100, finish 150;
    # start_picture 50; front.submit 50
    ("front_header_ms", (100 + 50 + 50) / 4),
    ("pack_ms", 50 / 4),
    ("sync_blocked_share", 100 * 4 / 20),
    ("idle_unnamed_share", 100 * 0.3 / 0.5),
])
def test_span_readers_on_a_canned_run_of_two_clients(name, want):
    assert lookup.metric(name).read(_canned()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("how", ["no_program", "no_spans"])
def test_span_readers_need_every_clients_spans(name, how):
    r = _canned()
    if how == "no_program":
        r["clients"][1]["program"] = None
    else:
        r["clients"][0]["program"]["spans"] = []
    assert lookup.metric(name).read(r) is None


def test_self_time_takes_out_only_what_nests_on_the_same_thread():
    spans = [["outer", "T", 0, 100], ["mid", "T", 10, 60],
             ["inner", "T", 20, 30], ["mid", "T", 70, 80],
             ["outer", "U", 40, 90],               # another thread
             ["x.queued", "T", 5, 95],              # a wait: taken whole
             ["late", "T", 95, 120]]                # overlaps, not nested
    assert _spans.self_ns(spans, {"outer"}) == 100 - 50 - 10 + 50
    assert _spans.self_ns(spans, {"outer"}, "T") == 40
    assert _spans.self_ns(spans, {"mid"}) == 40 + 10
    assert _spans.self_ns(spans, {"inner", "x.queued"}) == 10 + 90
    assert _spans.self_ns(spans, {"late"}) == 25


def test_idle_gaps_are_named_as_the_breakdown_names_them():
    """Every gap gets ``run.host_activity``'s name on the whole run, over
    random spans of three clients on three threads."""
    rng = random.Random(11)
    r = _canned()
    r["clients"].append(dict(r["clients"][1]))
    lo, hi = r["trace_window"]
    for c in r["clients"]:
        spans = []
        for _ in range(60):
            s = rng.randrange(lo - 50 * MS, hi)
            spans.append([rng.choice("abcd"), rng.choice(["M", "P", "S"]),
                          s, s + rng.randrange(0, 200 * MS)])
        c["program"] = {"counters": {},
                        "spans": TR.clip_spans(spans, lo, hi)}
    ends = sorted(rng.sample(range(lo, hi), 400))
    gaps = list(zip(ends[0::2], ends[1::2]))
    progs = [c["program"] for c in r["clients"]]
    assert list(idle_unnamed_share._names(r, progs, gaps)) == \
        [run.host_activity(r, s, e) for s, e in gaps]


def test_the_breakdown_names_the_canned_gaps_by_spans():
    b = run.breakdown(_canned())
    assert b["idle_gaps"] == [["host", pytest.approx(0.3)],
                              ["front.submit", pytest.approx(0.2)]]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("tiny")))


def test_the_tiny_cell_sends_counters_and_no_spans(tiny_root):
    """With the real decoder on the CPU: ``program`` holds the counters
    (no graph on the CPU: no upload) and no spans, since a CPU client
    runs no profiler; every span reader finds nothing."""
    t_start = time.time()
    r = run.collect(tiny.CELL, 2**31 + 11, 6.0, True, "cpu", None,
                    tiny_root)
    out = run.report(r, t_start)
    assert out["correct"] is True
    for c in r["clients"]:
        assert c["program"] == {"counters": {"graph.uploads": 0,
                                             "graph.sync_blocked": 0,
                                             "graph.upload_ahead": 0},
                                "spans": []}
    for name in READERS:
        assert lookup.metric(name).read(r) is None
        assert name not in out["metrics"]
