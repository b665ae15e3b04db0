"""One client of a cell: one process, one stream, one long-lived
``broadway_tpu_torch.core.decoder.Decoder`` on the card's default path.

The harness (``portbench/run.py``) starts it with ``subprocess`` and
talks to it over its pipes:

1. stdin, one line: the client's spec (JSON; ``run.plan`` makes it).
2. The client warms up (its stream's first pictures, so that every key
   of the cell is captured and replays), then writes ``ready``.
3. stdin, one line: ``go <t0> <t1>``, the window on the host's wall
   clock. The client feeds its stream's NAL units through
   ``decode_nal``, picture after picture, as fast as the decoder takes
   them (a closed loop), until t1.
4. stdout, one line: what it measured and kept (JSON), then it exits.

A picture is complete when an event recorded on the decoder's stream as
the picture appears in ``Decoder.outputs`` has completed; its time is
the event's, read against an event recorded at t0. Its frames stay on
the card, save a sample that is copied to the host after the window for
the comparison with the reference.

The OMP and torch thread counts are fixed to one before torch is
imported; the client's only other threads are the decoder's slice
threads and its dispatch pump.

Over the window the client reads the process's CPU clock and every live
Python thread's own (``thread_cpu_s``), split by what runs on the
thread: ``feed`` (the main thread: the client's loop and ``decode_nal``),
``pump`` (the dispatch pump, threads named ``bw-pump*``), ``slice``
(every other Python thread: the decoder's slice pool) and ``runtime``
(the rest of the process's CPU: the threads that Python did not start,
the CUDA driver's and torch's, and any Python thread that ended inside
the window). A thread that starts inside the window counts from 0.

The program's own spans and counters come in through one method that
the decoder may offer, ``trace_snapshot()``, which returns
``{"counters": {name: number}, "spans": [[name, thread name, start ns,
end ns], ...]}``: counters cumulative since the decoder was made; the
spans that ended since the previous call, which the call removes; times
on ``time.time_ns()``, the clock that the profiler's device timestamps
are read on (``portbench/trace.py``). The client calls it as the window
opens (the counters' base; its spans are dropped), right after its
profiler starts (spans dropped) and after the window, and sends back
``program``: the counters' deltas over the window and the spans clipped
to its trace (none where it ran no profiler); null where the decoder has
no such method.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import sys
import threading
import time

from . import trace as TR

FORBIDDEN = ("jax", "jaxlib", "flax", "broadway_tpu")


def forbidden_modules() -> list:
    """The top-level names of loaded modules that the benchmark must not
    load, compared whole (``broadway_tpu_torch`` is not ``broadway_tpu``)."""
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def split_pictures(data: bytes, n_pictures: int) -> list:
    """A GOP's NAL payloads, grouped by picture: its parameter sets go
    with the IDR, and every picture has as many slices."""
    from broadway_tpu_torch.bitstream.bitreader import split_nal_units
    nals = [p for _, p in split_nal_units(data)]
    params = [p for p in nals if p[0] & 0x1F in (7, 8)]
    slices = [p for p in nals if p[0] & 0x1F in (1, 5)]
    if len(params) + len(slices) != len(nals) or \
            len(slices) % n_pictures:
        raise ValueError("a GOP of parameter sets and equal pictures "
                         "expected")
    per = len(slices) // n_pictures
    pics = [slices[k * per:(k + 1) * per] for k in range(n_pictures)]
    pics[0] = params + pics[0]
    return pics


def thread_role(t: threading.Thread) -> str:
    if t is threading.main_thread():
        return "feed"
    if t.name.startswith("bw-pump"):
        return "pump"
    return "slice"


def cpu_clocks(threads_first: bool) -> tuple:
    """(the process's CPU clock, {thread: its CPU clock}) in ns, of every
    live Python thread. Read the threads first at a window's end and last
    at its start: reading a running thread's clock brings its count up to
    date, and the process's clock lags by what its other running threads
    ran since their last tick, so the process's difference then holds
    every thread's and the residual cannot fall below 0."""
    def threads():
        out = {}
        for t in threading.enumerate():
            try:
                out[t] = time.clock_gettime_ns(
                    time.pthread_getcpuclockid(t.ident))
            except OSError:           # ended since it was listed
                pass
        return out

    if threads_first:
        th = threads()
        return time.clock_gettime_ns(time.CLOCK_PROCESS_CPUTIME_ID), th
    proc = time.clock_gettime_ns(time.CLOCK_PROCESS_CPUTIME_ID)
    return proc, threads()


def thread_cpu_s(start: tuple, end: tuple) -> dict:
    """CPU seconds between two ``cpu_clocks`` readings by thread role;
    ``runtime`` is the process's CPU less the three, so that the four add
    up to it."""
    (p0, c0), (p1, c1) = start, end
    ns = {"feed": 0, "slice": 0, "pump": 0}
    for t, c in c1.items():
        ns[thread_role(t)] += c - c0.get(t, 0)
    ns["runtime"] = p1 - p0 - sum(ns.values())
    return {role: v / 1e9 for role, v in ns.items()}


def program_delta(base, end, lo, hi):
    """``program`` from two ``trace_snapshot()`` results: the counters'
    deltas, and the spans clipped to [lo, hi] ns (none where lo is
    None: no trace). None where the decoder offers no snapshot."""
    if base is None or end is None:
        return None
    counters = {k: v - base["counters"].get(k, 0)
                for k, v in end["counters"].items()}
    spans = [] if lo is None else TR.clip_spans(end["spans"], lo, hi)
    return {"counters": counters, "spans": spans}


class Client:
    def __init__(self, spec: dict) -> None:
        import torch
        from broadway_tpu_torch.core.decoder import Decoder
        from . import lookup
        torch.set_num_threads(1)
        self.torch = torch
        self.spec = spec
        self.cuda = spec["device"] == "cuda"
        root = spec["root"]
        man = lookup.manifest(spec["config"], root)
        self.gops = [split_pictures(lookup.gop_bytes(spec["config"], e,
                                                     root), len(e["md5"]))
                     for e in man["gops"]]
        if spec["trace"] and self.cuda:
            # the profiler's first start in a process takes seconds (the
            # device tracer's set-up): paid here, before the decoder
            # exists, and not inside the window
            prof = self._profiler()
            prof.start()
            prof.stop()
        self.dec = Decoder(device=spec["device"],
                           parallel_slices=spec["parallel_slices"])
        self.order = spec["order"]
        self.pos = 0                 # next picture: (order index, picture)
        self.fed = []                # per picture fed: [gop, index, t0, t1, s]
        self.done = {}               # picture id -> completion mark
        self.rng = random.Random(spec["rng_seed"])
        self.sample, self.seen = {}, 0
        self.live, self.live_ids = {}, None
        self.in_window = False
        self.t0 = None

    # ------------------------------------------------------------------
    def _next(self):
        o, k = divmod(self.pos, len(self.gops[0]))
        self.pos += 1
        gop = self.order[o % len(self.order)]
        return gop, k, self.gops[gop][k]

    def _mark(self):
        """A completion mark on the decoder's stream: a timed event on the
        card, the host's clock on the CPU (where every step is done when
        its call returns)."""
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.time()

    def _outputs(self) -> None:
        for o in self.dec.outputs:
            yuv = o.frame.yuv     # its step is enqueued (the pump drained
            #                       up to it where it had not run yet)
            if self.live_ids is not None and o.pic_id in self.live_ids:
                self.live[o.pic_id] = yuv
            if not self.in_window:
                continue
            self.done[o.pic_id] = self._mark()
            # a uniform sample of the window's pictures (reservoir)
            self.seen += 1
            k = self.spec["sample"]
            if len(self.sample) < k:
                self.sample[o.pic_id] = yuv
            else:
                j = self.rng.randrange(self.seen)
                if j < k:
                    del self.sample[self.rng.choice(sorted(self.sample))]
                    self.sample[o.pic_id] = yuv
        self.dec.outputs.clear()

    def feed_picture(self, stop_at=None) -> bool:
        """Feed the next picture's NAL units; False if the window closed
        before its last one."""
        from broadway_tpu_torch.bitstream.bitreader import NalUnit
        gop, k, nals = self._next()
        pid = len(self.fed)
        if self.in_window and k == 0 and self.live_ids is None and \
                gop == self.spec["live"]["gop"]:
            self.live_ids = set(range(pid,
                                      pid + self.spec["live"]["pictures"]))
        t_first = time.time()
        spent = 0.0
        rec = [gop, k, t_first, None, 0.0]
        self.fed.append(rec)
        for payload in nals:
            if stop_at is not None and time.time() >= stop_at:
                rec[4] = spent
                return False
            a = time.perf_counter()
            self.dec.decode_nal(NalUnit(payload))
            spent += time.perf_counter() - a
            self._outputs()
        rec[3], rec[4] = time.time(), spent
        return True

    def warm_up(self) -> None:
        for _ in range(self.spec["warm_pictures"]):
            self.feed_picture()
        if self.cuda:
            self.torch.cuda.synchronize()
            self.torch.cuda.reset_peak_memory_stats()

    def routes(self) -> dict:
        g = self.dec.group_graphs
        return dict(g.counts) if g is not None else {}

    def _snapshot(self):
        snap = getattr(self.dec, "trace_snapshot", None)
        return snap() if snap is not None else None

    def _profiler(self):
        torch = self.torch
        return torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])

    def _drain(self) -> None:
        """Put out every picture decoded so far, with no step left on the
        dispatch pump. Only at a GOP's end: what the next IDR does, done a
        picture early (the profiler is started and stopped only with the
        pump idle; with a step in flight on it, its start or stop hangs)."""
        self.dec.flush()
        self._outputs()

    def window(self, t0: float, t1: float) -> dict:
        torch = self.torch
        spec = self.spec
        prof = None
        trace_at = t1 - spec["trace_seconds"] if spec["trace"] else None
        time.sleep(max(0.0, t0 - time.time()))
        self.t0 = t0
        start_mark = self._mark()
        self.in_window = True
        routes0 = self.routes()
        program0 = self._snapshot()
        cpu0 = os.times()
        clocks0 = cpu_clocks(threads_first=False)
        trace_t0 = None
        n_pics = len(self.gops[0])
        while time.time() < t1:
            if trace_at is not None and prof is None and self.cuda and \
                    time.time() >= trace_at and self.pos % n_pics == 0:
                self._drain()
                prof = self._profiler()
                prof.start()
                trace_t0 = time.time_ns()
                self._snapshot()
            if not self.feed_picture(stop_at=t1):
                break
        clocks1 = cpu_clocks(threads_first=True)
        cpu1 = os.times()
        routes1 = self.routes()
        program1 = self._snapshot()
        self.in_window = False
        self._drain()
        if self.cuda:
            torch.cuda.synchronize()
        if prof is not None:
            prof.stop()
        out = {"t0": t0,
               "cpu_s": (cpu1.user + cpu1.system) -
                        (cpu0.user + cpu0.system),
               "thread_cpu_s": thread_cpu_s(clocks0, clocks1),
               "routes": {r: routes1.get(r, 0) - routes0.get(r, 0)
                          for r in routes1},
               "program": program_delta(program0, program1, trace_t0,
                                        int(t1 * 1e9))}
        out["pictures"] = self._pictures(start_mark)
        out["trace"] = self._trace(prof, trace_t0, int(t1 * 1e9))
        return out

    def _pictures(self, start_mark) -> list:
        """[gop, index, fed from, fed until, feed s, done] of every picture
        fed, times in seconds after t0 (done None: not put out)."""
        rows = []
        for pid, (gop, k, a, b, s) in enumerate(self.fed):
            m = self.done.get(pid)
            if m is None:
                d = None
            elif self.cuda:
                d = start_mark.elapsed_time(m) / 1e3
            else:
                d = m - self.t0
            rows.append([gop, k, a - self.t0,
                         None if b is None else b - self.t0, s, d])
        return rows

    def _trace(self, prof, lo: int, hi: int):
        if prof is None:
            return None
        ops = TR.device_ops(prof)
        busy = TR.merge(TR.clip([(s, e) for _, s, e in ops], lo, hi))
        by_name = {}
        for name, s, e in ops:
            part = min(e, hi) - max(s, lo)
            if part > 0:
                c = by_name.setdefault(name, [0, 0])
                c[0] += 1
                c[1] += part
        return {"t0": lo, "t1": hi, "busy": busy, "ops": by_name}

    def answers(self) -> dict:
        """md5 of the sampled pictures and of the live-check pictures:
        {picture id: [gop, index, md5]}."""
        def md5(yuv):
            return hashlib.md5(yuv.cpu().numpy().tobytes()).hexdigest()
        out = {}
        for which, kept in (("sample", self.sample), ("live", self.live)):
            out[which] = [[pid] + self.fed[pid][:2] + [md5(yuv)]
                          for pid, yuv in sorted(kept.items())]
        return out

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        return int(self.torch.cuda.max_memory_reserved())

    def device_name(self) -> str:
        if not self.cuda:
            return "cpu"
        return self.torch.cuda.get_device_name()


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    if spec["device"] == "cuda":
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            print("portbench client: no CUDA card", file=sys.stderr)
            return 2
    client = Client(spec)
    client.warm_up()
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    if not line or line[0] != "go":
        return 1
    result = client.window(float(line[1]), float(line[2]))
    result["memory_peak_bytes"] = client.memory_peak()
    result["answers"] = client.answers()
    result["device_name"] = client.device_name()
    client.dec.close()
    result["forbidden_modules"] = forbidden_modules()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
