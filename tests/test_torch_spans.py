"""The port's span and counter recorder (``core/spans.py``), read through
``Decoder.trace_snapshot()``, end to end on the CPU: a multi-slice P
stream decoded with the slice pool and the dispatch pump, and without
the pool. Nothing is recorded before the first snapshot; the spans lie
on their threads, nest inside their parents and fall inside the decode;
a snapshot returns only what ended since the previous one; outputs are
the same bytes with recording on and off; the bounded buffer keeps the
newest spans; no append is lost to a concurrent snapshot.

The recorder is the process's, and the suite's workers run many files in
one process, so every test here records into a fresh ``Recorder`` put in
its place (``monkeypatch``), never into the process's own."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from broadway_tpu_torch.bitstream import bitreader as br
from broadway_tpu_torch.core import graphs as GR
from broadway_tpu_torch.core import spans as SP
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.tools import streams

W, H, N_FRAMES, N_SLICES = 6, 4, 4, 3


@pytest.fixture(scope="module")
def stream():
    return streams.multislice_stream(width_mbs=W, height_mbs=H,
                                     n_frames=N_FRAMES, seed=5,
                                     n_slices=N_SLICES)[0]


@pytest.fixture
def recorder(monkeypatch):
    rec = SP.Recorder()
    monkeypatch.setattr(SP, "RECORDER", rec)
    return rec


def _decode(dec, data):
    """Every output's bytes (each frame forced, as a caller reads it)."""
    try:
        return [o.frame.tobytes() for o in dec.decode_annexb(data)]
    finally:
        dec.close()


def _traced(data, **kw):
    """(spans of one decode, the time before it, the time after it)."""
    dec = Decoder(device="cpu", **kw)
    assert dec.trace_snapshot()["spans"] == []       # recording begins
    before = time.time_ns()
    _decode(dec, data)
    after = time.time_ns()
    return dec.trace_snapshot()["spans"], before, after


@pytest.fixture(scope="module")
def pooled(stream):
    """One decode with the slice pool and the pump, into a fresh recorder
    for the module's tests to read."""
    saved, SP.RECORDER = SP.RECORDER, SP.Recorder()
    try:
        return _traced(stream, parallel_slices=2, async_pump=True)
    finally:
        SP.RECORDER = saved


def test_nothing_is_recorded_before_the_first_snapshot(stream, recorder):
    _decode(Decoder(device="cpu", parallel_slices=2, async_pump=True),
            stream)
    assert not recorder.on and len(recorder.spans) == 0
    assert set(recorder.counters.values()) == {0}
    snap = Decoder(device="cpu").trace_snapshot()
    assert recorder.on
    assert snap == {"counters": dict.fromkeys(SP.COUNTERS, 0), "spans": []}


@pytest.mark.parametrize("name,thread", [
    ("front.header", "MainThread"),
    ("front.start_picture", "MainThread"),
    ("front.submit", "MainThread"),
    ("front.pool_wait", "MainThread"),
    ("front.finish", "MainThread"),
    ("front.pack", "MainThread"),
    ("pump.submit", "MainThread"),
    ("pump.drain", "MainThread"),
    ("slice.queued", "bw-slice"),
    ("slice.parse", "bw-slice"),
    ("pump.queued", "bw-pump"),
    ("pump.job", "bw-pump"),
    ("step.eager", "bw-pump"),
])
def test_each_span_of_the_cpu_path_lies_on_its_thread(pooled, name, thread):
    threads = {th for n, th, _, _ in pooled[0] if n == name}
    assert threads and all(th.startswith(thread) for th in threads)


def test_the_cpu_path_takes_no_graph_and_parses_each_slice_once(pooled):
    names = [n for n, *_ in pooled[0]]
    assert not any(n.startswith("graph.") for n in names)
    assert "front.parse" not in names
    assert names.count("slice.parse") == N_FRAMES * N_SLICES
    assert names.count("slice.queued") == N_FRAMES * N_SLICES
    assert names.count("pump.job") == N_FRAMES
    assert names.count("step.eager") == N_FRAMES


def test_spans_fall_inside_the_decode(pooled):
    spans, before, after = pooled
    assert spans
    for _, _, s, e in spans:
        assert before <= s <= e <= after


def _nested(spans):
    """Per thread, the spans that are work on it (a ``*.queued`` span is
    a job's wait before it ran, begun on another thread): any two are
    disjoint or one holds the other."""
    by = {}
    for n, th, s, e in spans:
        if not n.endswith(".queued"):
            by.setdefault(th, []).append((s, e, n))
    for th, ivs in by.items():
        ivs.sort(key=lambda v: (v[0], -v[1]))
        open_ = []
        for s, e, n in ivs:
            while open_ and open_[-1][1] <= s:
                open_.pop()
            assert not open_ or e <= open_[-1][1], (th, n, open_[-1][2])
            open_.append((s, e, n))


def test_spans_on_one_thread_nest(pooled):
    _nested(pooled[0])


@pytest.mark.parametrize("child,parent", [
    ("front.start_picture", "front.header"),
    ("front.pack", "front.finish"),
    ("pump.submit", "front.finish"),
    ("step.eager", "pump.job"),
])
def test_a_span_lies_inside_its_parent(pooled, child, parent):
    spans = pooled[0]
    kids = [(th, s, e) for n, th, s, e in spans if n == child]
    assert kids
    for th, s, e in kids:
        assert any(n == parent and t == th and a <= s and e <= b
                   for n, t, a, b in spans)


def test_a_snapshot_returns_only_what_ended_since_the_previous(stream,
                                                              recorder):
    nals = [br.NalUnit(p) for _, p in br.split_nal_units(stream)]
    dec = Decoder(device="cpu", parallel_slices=2, async_pump=True)
    try:
        dec.trace_snapshot()
        first = dec.trace_snapshot()["spans"]      # nothing ran between
        half = len(nals) // 2
        for nal in nals[:half]:
            dec.decode_nal(nal)
        t_a = time.time_ns()
        second = dec.trace_snapshot()["spans"]
        t_b = time.time_ns()
        for nal in nals[half:]:
            dec.decode_nal(nal)
        dec.flush()
        for o in dec.outputs:
            o.frame.tobytes()
    finally:
        dec.close()
    third = dec.trace_snapshot()["spans"]
    assert first == [] and second and third
    assert all(e <= t_b for *_, e in second)
    assert all(e >= t_a for *_, e in third)
    assert not {tuple(x) for x in second} & {tuple(x) for x in third}
    assert dec.trace_snapshot()["spans"] == []


def test_without_the_pool_the_feed_thread_parses_each_slice(stream,
                                                            recorder):
    spans, _, _ = _traced(stream, parallel_slices=0)
    names = [n for n, *_ in spans]
    assert names.count("front.parse") == N_FRAMES * N_SLICES
    assert {th for n, th, *_ in spans if n == "front.parse"} == \
        {"MainThread"}
    assert not any(n.startswith("slice.") or n == "front.submit"
                   for n in names)
    _nested(spans)


@pytest.mark.parametrize("kw", [
    dict(parallel_slices=2, async_pump=True),
    dict(parallel_slices=0),
], ids=["pool_and_pump", "inline"])
def test_outputs_are_the_same_bytes_with_recording_on_and_off(stream,
                                                              recorder, kw):
    off = _decode(Decoder(device="cpu", **kw), stream)
    assert not recorder.on
    recorder.snapshot()
    on = _decode(Decoder(device="cpu", **kw), stream)
    assert len(recorder.spans) > 0
    assert len(off) == N_FRAMES and on == off


def test_the_buffer_keeps_the_newest_spans(monkeypatch):
    rec = SP.Recorder(maxlen=8)
    monkeypatch.setattr(SP, "RECORDER", rec)
    rec.snapshot()
    for k in range(1, 21):
        SP.end("s", k)
    got = rec.snapshot()["spans"]
    assert [s for _, _, s, _ in got] == list(range(13, 21))
    assert {th for _, th, _, _ in got} == {threading.current_thread().name}


def test_no_span_is_lost_to_a_concurrent_snapshot(monkeypatch):
    """Sixteen threads append while the main thread takes snapshots, the
    interpreter switching threads every microsecond: every span comes
    back exactly once."""
    rec = SP.Recorder()
    monkeypatch.setattr(SP, "RECORDER", rec)
    rec.snapshot()
    n_threads, per = 16, 2000
    got = []

    def writer(k):
        for i in range(per):
            SP.end("w", 1 + k * per + i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=writer, args=(k,))
              for k in range(n_threads)]
        for t in ts:
            t.start()
        while any(t.is_alive() for t in ts):
            got += rec.snapshot()["spans"]
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    got += rec.snapshot()["spans"]
    starts = sorted(s for _, _, s, _ in got)
    assert starts == list(range(1, 1 + n_threads * per))


class _Event:
    def __init__(self, done):
        self.done, self.waited, self.queried = done, 0, 0

    def query(self):
        self.queried += 1
        return self.done

    def synchronize(self):
        self.waited += 1


@pytest.mark.parametrize("done,blocked", [
    ((True,), 0), ((False,), 1), ((True, False), 1), ((True, True), 0)])
def test_an_upload_wait_counts_whether_it_blocked(recorder, done, blocked):
    """A graph with one staging buffer (``MeshGraph``): its last upload is
    the one that wrote the buffer, so an upload that blocked was also
    made ahead of it. Only the events still in flight are synchronized."""
    events = [_Event(d) for d in done]
    GR._wait_for_upload(events)          # off: counts nothing
    assert set(recorder.counters.values()) == {0}
    recorder.snapshot()
    GR._wait_for_upload(events)
    assert recorder.counters == {"graph.uploads": 1,
                                 "graph.sync_blocked": blocked,
                                 "graph.upload_ahead": blocked}
    assert [ev.waited for ev in events] == [0 if d else 2 for d in done]
    assert [n for n, *_ in recorder.snapshot()["spans"]] == ["graph.sync"]


class _Stream:
    """The current stream of a fake card: its k-th recorded event (the
    copies of the k-th upload) is done as done(k) says."""

    def __init__(self, done):
        self.done, self.events = done, []

    def record_event(self):
        self.events.append(_Event(self.done(len(self.events))))
        return self.events[-1]


RING_SIZE = 8


def _ring_graph(monkeypatch, depth, done):
    """A one-picture graph on the CPU with `depth` staging buffers, its
    uploads' events from a fake stream (no capture: only ``_upload``
    runs)."""
    monkeypatch.setattr(GR, "STAGING_DEPTH", depth)
    monkeypatch.setattr(GR, "runs_eagerly", lambda dev: False)
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda keep_graph=False: None)
    stream = _Stream(done)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream)
    ref = torch.zeros((3, 16, 16), dtype=torch.uint8)
    return GR.PictureGraph("v1", ref, ref, RING_SIZE, 1, None), stream


def _done(k):
    """Whether upload k's copies have completed: all but those of uploads
    1, 4, 7, ..., which are still in flight whenever they are queried."""
    return k % 3 != 1


@pytest.mark.parametrize("case", ["turns", "waits", "counters", "shapes"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_the_staging_ring(recorder, monkeypatch, depth, case):
    """Upload k of a graph writes staging buffer k mod D and leaves the
    others as they were; it waits only on upload k - D's event, so the
    first D wait on nothing, and a finished event is never synchronized;
    the counters count only while recording: uploads after the first,
    those whose buffer's copy was in flight (k - D) and those made while
    the previous upload (k - 1) was; a wrong shape still raises, and
    takes no turn."""
    g, stream = _ring_graph(monkeypatch, depth, _done)
    n, on = 3 * depth + 4, depth + 2  # recording from upload `on` on

    def upload(k):
        g._upload(np.full((1, RING_SIZE), k, dtype=np.uint8), [k % 3])

    for k in range(n):
        if case == "counters" and k == on:
            assert set(recorder.counters.values()) == {0}
            # off: only the buffer's own event was queried, once
            assert sum(ev.queried for ev in stream.events) == on - depth
            recorder.snapshot()
        if case == "shapes":
            with pytest.raises(ValueError):
                g._upload(np.zeros((1, RING_SIZE + 1), np.uint8), [0])
            with pytest.raises(ValueError):
                g._upload(np.zeros((1, RING_SIZE), np.uint8), [0, 1])
        upload(k)
        if case in ("turns", "shapes"):
            held = [int(b[0, 0]) for b, _ in g._staging]
            assert all(held[j % depth] == j
                       for j in range(max(0, k - depth + 1), k + 1))
            assert int(g.bufs[0, 0]) == k
            assert [int(i[0]) for _, i in g._staging][k % depth] == k % 3
        elif case == "waits":
            waited = [i for i, ev in enumerate(stream.events) if ev.waited]
            assert waited == [i for i in range(k - depth + 1)
                              if not _done(i)]
            assert all(ev.waited <= 1 for ev in stream.events)
    assert len(stream.events) == n
    if case == "counters":
        seen = range(on, n)
        assert recorder.counters == {
            "graph.uploads": sum(1 for k in seen if k >= 1),
            "graph.sync_blocked": sum(1 for k in seen if k >= depth
                                      and not _done(k - depth)),
            "graph.upload_ahead": sum(1 for k in seen if k >= 1
                                      and not _done(k - 1))}
        names = [s[0] for s in recorder.snapshot()["spans"]]
        assert names.count("graph.upload") == len(seen)
        assert names.count("graph.sync") == sum(1 for k in seen if k >= 1)
