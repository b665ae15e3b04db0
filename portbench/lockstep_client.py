"""One client of a lockstep cell: one process that decodes N streams as
one group through
``broadway_tpu_torch.parallel.streams.decode_streams_lockstep``, one GOP
of every stream a call.

The harness (``portbench/run.py``) starts it for a cell whose traffic has
``lockstep`` and talks to it as to ``portbench/client.py``: the spec on
stdin, ``ready``, ``go <t0> <t1>``, the result line on stdout. The result
has the same keys, so that ``run.report``, the readers and
``check.judge`` read it unchanged. What differs from ``client.py``:

- A call hands over one GOP of each stream (SPS, PPS, an IDR and its P
  pictures: a closed segment, as a segment-fed player or a
  multi-instance box hands streams to the API), stream i's
  ``order[(start + c) % len(order)]`` in call c, with
  ``fetch=False``: the frames stay on the card. The loop is closed: the
  next call starts as soon as one returns.
- The call synchronises the card before it returns, so every picture of
  a call is complete at its return: a picture's first-NAL time is its
  call's start, its completion its call's return, both on the host's
  clock, and its feed time its call's time over the call's pictures. A
  call that straddles t1 counts nothing: its pictures complete after the
  window, and its routes, batches and CPU time are left out with them.
- ``routes``: the rounds' and the fallbacks' steps by route (``stats``'
  ``routes`` and ``fallback_routes``) summed over the window's calls;
  ``batches``: the B of every batched step of those calls, in order;
  ``fallbacks``: their pictures that took the unpacked path; ``keys``:
  the most distinct round keys that one of them met.
- ``program``: the process's span recorder
  (``broadway_tpu_torch.core.spans.RECORDER``) read as ``client.py``
  reads ``Decoder.trace_snapshot()``: its counters' deltas run to the
  return of the window's last call, the straddling one's included; null
  where the program has none.
- ``thread_cpu_s``: a group's stream threads live inside one call, so
  their CPU (the parse, the pack and each round's leader) comes under
  ``runtime`` with the CUDA threads'; ``feed`` is the main thread (the
  loop, each call's set-up and joins); ``slice`` and ``pump`` are 0.
- A traced run starts its profiler at the first call boundary within the
  window's last ``trace_seconds``, and its trace ends at the return of
  the last call that the window counts; none where no call was counted
  after the profiler started.

Warm-up: ``warm_calls`` calls before the window, so that every round key
of the cell has been captured and replays.
"""

from __future__ import annotations

import json
import os
import random
import sys
import time

from . import client as C
from . import lookup

ROUTES = ("eager", "captured", "replayed")


class LockstepClient(C.Client):
    """The group and its calls. ``Client``'s sample, answers, profiler and
    readings of the card are inherited and read what this class fills in
    (``fed``, ``sample``, ``live``); ``Client.__init__``, which makes one
    decoder, does not run."""

    def __init__(self, spec: dict) -> None:
        import torch
        from broadway_tpu_torch.parallel.streams import \
            decode_streams_lockstep
        torch.set_num_threads(1)
        self.torch = torch
        self.decode = decode_streams_lockstep
        self.spec = spec
        self.cuda = spec["device"] == "cuda"
        root = spec["root"]
        man = lookup.manifest(spec["config"], root)
        self.gops = [lookup.gop_bytes(spec["config"], e, root)
                     for e in man["gops"]]
        self.n_pics = len(man["gops"][0]["md5"])
        if spec["trace"] and self.cuda:
            # the profiler's first start in a process takes seconds: paid
            # here, not inside the window
            prof = self._profiler()
            prof.start()
            prof.stop()
        self.calls = 0               # calls made so far
        self.fed = []                # the window's rows (``_pictures``)
        self.rng = random.Random(spec["rng_seed"])
        self.sample, self.seen = {}, 0
        self.live = {}
        self.t0 = None

    def call(self) -> tuple:
        """The group's next call: (each stream's GOP, each stream's output
        pictures in display order, the call's stats, its start, its
        return)."""
        c = self.calls
        self.calls += 1
        gops = [s["order"][(s["start"] + c) % len(s["order"])]
                for s in self.spec["streams"]]
        stats = {}
        a = time.time()
        outs = self.decode([self.gops[g] for g in gops],
                           device=self.spec["device"],
                           parallel_slices=self.spec["parallel_slices"],
                           fetch=False, stats=stats)
        return gops, outs, stats, a, time.time()

    def warm_up(self) -> None:
        for _ in range(self.spec["warm_calls"]):
            self.call()
        if self.cuda:
            self.torch.cuda.synchronize()
            self.torch.cuda.reset_peak_memory_stats()

    def _snapshot(self):
        try:
            from broadway_tpu_torch.core.spans import RECORDER
        except ImportError:
            return None
        return RECORDER.snapshot()

    def _keep(self, gops, outs, base: int) -> None:
        """A counted call's pictures into the sample (uniform over the
        window's pictures: a reservoir), and from the first counted call
        that decodes the live GOP the live pictures of its first stream
        that does; picture ids from `base` on, as ``_pictures`` numbers
        its rows."""
        live = self.spec["live"]
        size = self.spec["sample"]
        for i, (g, got) in enumerate(zip(gops, outs)):
            take_live = not self.live and g == live["gop"]
            for k, o in enumerate(got[:self.n_pics]):
                pid = base + i * self.n_pics + k
                yuv = o.frame.yuv
                if take_live and k < live["pictures"]:
                    self.live[pid] = yuv
                self.seen += 1
                if len(self.sample) < size:
                    self.sample[pid] = yuv
                else:
                    j = self.rng.randrange(self.seen)
                    if j < size:
                        del self.sample[self.rng.choice(sorted(self.sample))]
                        self.sample[pid] = yuv

    def _pictures(self, log: list) -> list:
        """[gop, index, call start, call return, call s over its pictures,
        done] of every picture of the window's calls (`log`: each call's
        GOPs, start, return and output count a stream), times in seconds
        after t0; done None for a picture the call did not put out."""
        rows = []
        for gops, a, b, lens in log:
            s = (b - a) / (len(gops) * self.n_pics)
            a, b = a - self.t0, b - self.t0
            for g, n in zip(gops, lens):
                rows += [[g, k, a, b, s, b if k < n else None]
                         for k in range(self.n_pics)]
        return rows

    def window(self, t0: float, t1: float) -> dict:
        spec = self.spec
        trace_at = t1 - spec["trace_seconds"] \
            if spec["trace"] and self.cuda else None
        prof = trace_t0 = hi = None
        routes = dict.fromkeys(ROUTES, 0)
        batches, fallbacks, keys = [], 0, 0
        log = []
        time.sleep(max(0.0, t0 - time.time()))
        self.t0 = t0
        program0 = self._snapshot()
        cpu0 = cpu1 = os.times()
        clocks0 = clocks1 = C.cpu_clocks(threads_first=False)
        while time.time() < t1:
            if trace_at is not None and prof is None and \
                    time.time() >= trace_at:
                # between calls the card is idle: the previous call
                # synchronised it. The spans so far are dropped first: the
                # pop takes tens of ms, which would open the trace on an
                # idle card
                self._snapshot()
                prof = self._profiler()
                prof.start()
                trace_t0 = time.time_ns()
            gops, outs, st, a, b = self.call()
            # the window's calls as one tuple each, made into a row a
            # picture only after the window: rows made here would survive
            # into the collector's oldest generation and set off its full
            # passes, which stop every stream thread, inside the window
            log.append((tuple(gops), a, b, tuple(map(len, outs))))
            if b > t1:
                break
            self._keep(gops, outs, (len(log) - 1) * len(gops) * self.n_pics)
            clocks1 = C.cpu_clocks(threads_first=True)
            cpu1 = os.times()
            for r in ROUTES:
                routes[r] += st["routes"][r] + st["fallback_routes"][r]
            batches += st["batches"]
            fallbacks += st["fallbacks"]
            keys = max(keys, st["keys"])
            if prof is not None:
                # after every reading above: the trace ends after the
                # counted pictures' return on any rounding of the clock
                hi = time.time_ns()
        program1 = self._snapshot()
        if prof is not None:
            prof.stop()
        out = {"t0": t0,
               "cpu_s": (cpu1.user + cpu1.system) -
                        (cpu0.user + cpu0.system),
               "thread_cpu_s": C.thread_cpu_s(clocks0, clocks1),
               "routes": routes, "batches": batches,
               "fallbacks": fallbacks, "keys": keys,
               "program": C.program_delta(program0, program1,
                                          None if hi is None else trace_t0,
                                          hi),
               "pictures": self._pictures(log)}
        self.fed = out["pictures"]
        out["trace"] = self._trace(prof, trace_t0, hi) \
            if hi is not None else None
        return out


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    if spec["device"] == "cuda":
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            print("portbench lockstep client: no CUDA card", file=sys.stderr)
            return 2
    client = LockstepClient(spec)
    client.warm_up()
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    if not line or line[0] != "go":
        return 1
    result = client.window(float(line[1]), float(line[2]))
    result["memory_peak_bytes"] = client.memory_peak()
    result["answers"] = client.answers()
    result["device_name"] = client.device_name()
    result["forbidden_modules"] = C.forbidden_modules()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
