#!/usr/bin/env python3
"""The port's measuring program: the counterpart of the repository's
``bench.py`` and of its stage profilers (``tools/profile_e2e2.py``,
``profile_dense.py``, ``profile_lockstep.py``, ``profile_stages.py``,
``profile_xfer.py``), on one CUDA card.

    python3 -m broadway_tpu_torch.tools.bench [--section NAME ...]
        [--passes P] [--seed S] [--device cuda|cpu] [--quick | --tiny]

Sections, in ``bench.py``'s order (``--section`` may repeat; without it
every section runs in turn), each with its own time limit (checked
between passes), each printing one JSON line as soon as it ends:

  e2e       the realistic 1920x1088 stream through Decoder(device,
            parallel_slices=8) with the dispatch pump on (the default on
            the card) and off, then the committed x264 1080p fixture off
            and on; frames stay on the card, one synchronize at the end;
            frames/s median, min, max over the warm passes, taken in turns;
            each decode's per-picture steps by route (eager, captured,
            replayed: core/graphs.py), first and last pass
  batch     parallel.streams.decode_streams_lockstep over B streams beside
            B sequential single-stream decodes of the same bytes: aggregate
            frames/s, rounds, batch sizes, launches a round
  4k        the realistic 3840x2160 stream (240x135 MBs) end to end
  pipeline  core.recon.decode_picture on one picture's host arrays resident
            on the card, at run_stages 0, 1, 2, 3, against reference stacks
            drawn from --seed: span and host enqueue per step, device ms
            behind a held stream, each stage as the increase over the last
  dense     the dense stream (every MB with residual) end to end; its
            parse-only pass and the rest
  stages    every picture of the realistic and the dense stream through
            each layer in turn, called from here: parse, pack, upload, step
            (host enqueue; device ms behind a held stream), the same step
            as a graph replay of its key (host ms), fetch; a table
            of median and max ms a frame by layer beside e2e's ms a frame,
            and the card's busy share over one warm pass (torch.profiler)
  fetch     the first pictures of the realistic stream with every frame's
            bytes delivered to the host (prefetch_outputs=True) beside the
            same without; the link (D2H pinned, H2D pageable and pinned) on
            computed tensors, and bench.py's overlap and serial bounds

Every decoded frame (and every pipeline output) is held to the md5s that
the JAX package's NumPy decoder made on the CPU
(``tools/data/bench_md5.json``; ``tests/test_torch_bench.py`` makes them):
a differing byte fails its section. A section that fails or overruns its
limit prints its error; the others still run and the exit code is 1. A
single-threaded parse-only pass over the first 4 pictures of the
realistic stream times the host (``host_probe``): before the first section
and after the last (in ``detail``), and before each section (in its line).

Plans: the default is the full size; --quick is the short form that
``chip_smoke.py`` runs (4 pictures, B = 2, 2 pictures of 4K and dense, one
pipeline picture); --tiny is the CPU rehearsal at 8x6 MBs. --device cpu
(for the tests) runs the kernels' plain versions: every time, rate and
share field is then null, and only the counts and the checks carry
values. --device cuda without a card exits 2 and runs nothing.

The last line has bench.py's form: {"metric", "value", "unit",
"vs_baseline", "detail"}; value is e2e's median frames/s with the pump on,
vs_baseline that over 30 (real-time playback).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import multiprocessing
import os
import subprocess
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import bench_common as BC

SECTIONS = ("e2e", "batch", "4k", "pipeline", "dense", "stages", "fetch")
REAL_TIME_FPS = 30.0           # the reference's 29.97 fps clips
SLICE_THREADS = 8              # Decoder(parallel_slices=) of every decode
SM_CLOCK_KHZ = 1.98e6          # H100 SXM boost clock: cycles a ms, at most
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE = os.path.join(DATA, "bench_md5.json")
X264 = os.path.join(DATA, "x264_natural_1080p")

# a stream's key -> (generator of tools/streams.py, its arguments but
# n_frames); bench_common generates and caches it with these arguments
KINDS = {"realistic": ("realistic_stream", {"n_slices": 8}),
         "dense": ("inter_stream", {"seed": 909, "deblock": True,
                                    "mvd_range": 40})}


def stream_key(kind: str, w_mbs: int, h_mbs: int, seed: int) -> str:
    return f"{kind}_{w_mbs}x{h_mbs}_s{seed}"


def stream_args(key: str, n_frames: int) -> Tuple[str, dict]:
    """(generator, its keyword arguments) that make stream `key` with
    `n_frames` pictures."""
    kind, size, seed = key.split("_")
    w, h = (int(v) for v in size.split("x"))
    gen, extra = KINDS[kind]
    kw = dict(width_mbs=w, height_mbs=h, n_frames=n_frames, seed=int(seed[1:]))
    kw.update(extra)
    return gen, kw


def _generate(key: str, n_frames: int) -> bytes:
    """Stream `key` with `n_frames` pictures, from build/'s cache or the
    port's generator (module level: a worker process runs it)."""
    gen, kw = stream_args(key, n_frames)
    w, h, seed = kw["width_mbs"], kw["height_mbs"], kw["seed"]
    if gen == "realistic_stream":
        return BC.realistic_bench_stream(w, h, n_frames=n_frames,
                                         n_slices=kw["n_slices"], seed=seed)
    return BC.bench_stream(w, h, n_frames=n_frames, seed=seed)


def _cache_name(key: str, n_frames: int) -> str:
    gen, kw = stream_args(key, n_frames)
    w, h = kw["width_mbs"], kw["height_mbs"]
    if gen == "realistic_stream":
        return BC.realistic_name(w, h, n_frames, kw["seed"])
    return BC.dense_name(w, h, n_frames)


@dataclasses.dataclass(frozen=True)
class Plan:
    """What each section decodes: streams as (key, pictures), a prefix of
    the stream that ``generate`` makes (key -> pictures generated)."""
    generate: Dict[str, int]
    e2e: Tuple[str, int]
    x264: bool                   # e2e also runs the committed x264 fixture
    batch: Tuple[Tuple[Tuple[str, int], ...], ...]   # one entry per B
    uhd: Tuple[str, int]
    pipeline: Tuple[Tuple[str, int], ...]            # (key, picture index)
    dense: Tuple[str, int]
    stages: Tuple[Tuple[str, int], ...]
    fetch: Tuple[str, int]
    limits: Dict[str, float]     # section -> seconds


def _plan(w: int, h: int, uw: int, uh: int, n: int, n_uhd: int,
          n_dense: int, batch, n_fetch: int, x264: bool, pipeline,
          limit: float) -> Plan:
    real = stream_key("realistic", w, h, 4242)
    uhd = stream_key("realistic", uw, uh, 7777)
    dense = stream_key("dense", w, h, 909)
    gen = {real: n, uhd: n_uhd, dense: n_dense}
    for streams in batch:
        for k, m in streams:
            gen[k] = max(gen.get(k, 0), m)
    pick = {"real": real, "dense": dense}
    return Plan(gen, (real, n), x264, batch, (uhd, n_uhd),
                tuple((pick[p], i) for p, i in pipeline), (dense, n_dense),
                ((real, n), (dense, n_dense)), (real, min(n_fetch, n)),
                dict.fromkeys(SECTIONS, limit))


def _lockstep(w, h, n, count):
    return tuple(tuple((stream_key("realistic", w, h, 5000 + s), n)
                       for s in range(B)) for B in count)


PLANS = {
    # the default: bench.py's sizes
    "full": _plan(120, 68, 240, 135, 16, 8, 8,
                  _lockstep(120, 68, 8, (2, 4, 8)), 6, True,
                  (("dense", 1), ("real", 1)), 600.0),
    # chip_smoke.py's phase 13: phase 3's 4-picture stream, phase 9's
    # streams at B = 2 (seeds 4242 x4 and 4243 x2), 2 pictures of 4K and
    # of the dense stream, one pipeline picture
    "quick": _plan(120, 68, 240, 135, 4, 2, 2,
                   (((stream_key("realistic", 120, 68, 4242), 4),
                     (stream_key("realistic", 120, 68, 4243), 2)),),
                   6, True, (("real", 1),), 120.0),
    # the CPU rehearsal: 8x6 MBs, an odd-rowed 12x9 for 4K, no x264
    "tiny": _plan(8, 6, 12, 9, 2, 2, 2, _lockstep(8, 6, 2, (2,)), 2, False,
                  (("dense", 1), ("real", 1)), 300.0),
}


# ---------------------------------------------------------------- helpers
def md5s(frames) -> List[str]:
    """md5 of each frame's bytes; every device-to-host copy starts before
    the first is waited for."""
    for f in frames:
        start = getattr(f, "start_fetch", None)
        if start is not None:
            start()
    return [hashlib.md5(f if isinstance(f, bytes) else f.tobytes())
            .hexdigest() for f in frames]


def check_md5s(got: List[str], want: List[str], what: str) -> None:
    if got != list(want):
        k = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        raise AssertionError(f"{what}: picture {k} of {len(got)} differs "
                             f"from the {len(want)} committed md5s")


def launch_counts() -> Dict[str, int]:
    from ..ops.gpu import mc_kernel as K1
    from ..ops.gpu import wavefront_kernels as KW
    return {"K1_mc": K1.mc_predict.launches,
            "K2_intra": KW.intra_wavefront.launches,
            "K3_deblock": KW.deblock_wavefront.launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _device_union_ms(prof) -> Tuple[Optional[float], Optional[float]]:
    """(union, sum) in ms of the device intervals a torch.profiler run
    traced; (None, None) if it traced none."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None) is not None
                   and "cuda" in str(e.device_type).lower())
    if not spans:
        return None, None
    union, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    return union / 1e3, sum(b - a for a, b in spans) / 1e3


class SectionTimeout(RuntimeError):
    pass


class Bench:
    """One run: the device, the plan, the streams and the committed md5s.
    Times are taken on a CUDA device only: on the CPU every time, rate
    and share is None."""

    def __init__(self, plan: Plan, device: str, passes: int, seed: int,
                 fixture: dict, streams: Dict[str, bytes],
                 x264: Optional[dict]) -> None:
        self.plan = plan
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.passes = passes
        self.seed = seed
        self.fixture = fixture
        self.streams = streams
        self.x264 = x264
        self.deadline = float("inf")
        self.routes = None     # the last decode's steps by route

    # -- clocks ---------------------------------------------------------
    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def t(self, seconds):
        """A host-clock reading as it is reported: None off the card."""
        return seconds if self.cuda else None

    def tick(self) -> None:
        if time.perf_counter() > self.deadline:
            raise SectionTimeout("the section overran its time limit")

    def rates(self, n: int, secs: List[float]) -> dict:
        if not self.cuda:
            return {"fps_median": None, "fps_min": None, "fps_max": None,
                    "fps_passes": None, "ms_per_frame_median": None}
        fps = [n / s for s in secs]
        return {"fps_median": _median(fps), "fps_min": min(fps),
                "fps_max": max(fps), "fps_passes": fps,
                "ms_per_frame_median": 1e3 / _median(fps)}

    # -- streams --------------------------------------------------------
    def stream(self, key: str, n: int) -> Tuple[bytes, List[str]]:
        """The first n pictures of stream `key` and their committed md5s."""
        if key == "x264":
            data, want = self.x264["data"], self.x264["info"]["frames"]
        else:
            have = self.plan.generate[key]
            if n > have:
                raise ValueError(f"{key}: {n} pictures asked, {have} made")
            data = self.streams[key]
            if n < have:
                data = BC.annexb_prefix(data, n)
            want = self.fixture["streams"][key]["pictures"]
        if n > len(want):
            raise ValueError(f"{key}: {n} pictures, {len(want)} committed")
        return data, want[:n]

    # -- decoding -------------------------------------------------------
    def decode(self, data: bytes, **kw) -> Tuple[list, float]:
        """(frames, seconds) of one decode: frames stay on the device, the
        clock stops after one synchronize. Keeps its per-picture steps by
        route in ``routes``."""
        from ..core.decoder import Decoder
        dec = Decoder(device=self.dev, parallel_slices=SLICE_THREADS, **kw)
        try:
            self.sync()
            t0 = time.perf_counter()
            outs = dec.decode_annexb(data)
            self.sync()
            sec = time.perf_counter() - t0
            graphs = dec.group_graphs
            self.routes = None if graphs is None else dict(graphs.counts)
        finally:
            dec.close()
        return [o.frame for o in outs], sec

    def checked(self, data: bytes, want: List[str], what: str, **kw) -> dict:
        """One decode held to the committed md5s; its launches."""
        before = launch_counts()
        frames, _ = self.decode(data, **kw)
        check_md5s(md5s(frames), want, what)
        return {"md5_ok": True, "launches": _since(before),
                "steps_first_pass": self.routes}

    def turns(self, runs: Dict[str, Callable[[], float]]
              ) -> Dict[str, List[float]]:
        """`passes` warm passes of each run, taken in turns (the order
        flips every pass); each run returns its seconds."""
        secs = {k: [] for k in runs}
        for p in range(self.passes):
            self.tick()
            for k in (list(runs) if p % 2 == 0 else list(runs)[::-1]):
                secs[k].append(runs[k]())
        return secs

    def parse_only(self, data: bytes, parallel_slices: int) -> Tuple[int,
                                                                      float]:
        """(pictures, seconds) of the host front end alone."""
        from ..core import decoder as DEC
        n = []
        dec = DEC.Decoder(device="cpu", parallel_slices=parallel_slices,
                          recon_strategy=lambda d, p: (n.append(1),
                                                       DEC.SKIP_RECON)[1])
        try:
            t0 = time.perf_counter()
            dec.decode_annexb(data)
            sec = time.perf_counter() - t0
        finally:
            dec.close()
        return len(n), sec

    def host_probe(self) -> Optional[float]:
        """ms a picture of the single-threaded parse-only pass over the
        first 4 pictures of the realistic stream: how fast this host is."""
        key, n = self.plan.e2e
        data, _ = self.stream(key, min(4, n))
        pics, sec = self.parse_only(data, 0)
        return self.t(1e3 * sec / pics)

    def held_ms(self, fn, hold_ms: float):
        """(host ms to enqueue fn, device ms of it) with the stream held
        for hold_ms first, so that CUDA events around fn read the card's
        time and not the host's enqueue; device ms is None where the hold
        ended before the enqueue did."""
        from ..ops.gpu import probe
        self.sync()
        held = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        probe.hold_stream(int(hold_ms * SM_CLOCK_KHZ), self.dev)
        held.record()
        start.record()
        t0 = time.perf_counter()
        out = fn()
        host = time.perf_counter() - t0
        end.record()
        covered = not held.query()
        self.sync()
        return out, 1e3 * host, (start.elapsed_time(end) if covered
                                 else None)


# --------------------------------------------------------------- sections
def _pump_pair(b: Bench, key: str, n: int, order: Tuple[bool, bool]) -> dict:
    data, want = b.stream(key, n)
    rec = {"stream": key, "pictures": n, "stream_bytes": len(data)}
    for pump in order:
        rec["pump_on" if pump else "pump_off"] = b.checked(
            data, want, f"{key} async_pump={pump}", async_pump=pump)
    routes = {}

    def timed(pump):
        sec = b.decode(data, async_pump=pump)[1]
        routes[pump] = b.routes
        return sec

    secs = b.turns({pump: (lambda pump=pump: timed(pump)) for pump in order})
    for pump in order:
        rec["pump_on" if pump else "pump_off"].update(
            b.rates(n, secs[pump]), steps_last_pass=routes[pump])
    return rec


def section_e2e(b: Bench) -> dict:
    key, n = b.plan.e2e
    real = _pump_pair(b, key, n, (True, False))
    out = {"fps_e2e_device": real["pump_on"]["fps_median"], "frames": n,
           "stream_bytes": real["stream_bytes"], "realistic": real}
    if b.plan.x264:
        b.tick()
        out["x264"] = _pump_pair(b, "x264", len(b.x264["info"]["frames"]),
                                 (False, True))
    else:
        out["x264"] = "not in this plan"
    return out


def section_batch(b: Bench) -> dict:
    from ..parallel.streams import decode_streams_lockstep

    runs, agg = [], {}
    for spec in b.plan.batch:
        b.tick()
        got = [b.stream(k, n) for k, n in spec]
        datas = [d for d, _ in got]
        B, total = len(datas), sum(n for _, n in spec)
        stats = {}
        before = launch_counts()
        frames = decode_streams_lockstep(datas, device=b.dev,
                                         parallel_slices=SLICE_THREADS,
                                         stats=stats)
        launches = _since(before)
        for (k, _), f, (_, want) in zip(spec, frames, got):
            check_md5s(md5s(f), want, f"lockstep B={B} {k}")

        def lockstep():
            t0 = time.perf_counter()
            decode_streams_lockstep(datas, device=b.dev,
                                    parallel_slices=SLICE_THREADS,
                                    fetch=False)
            return time.perf_counter() - t0

        secs = b.turns({"lockstep": lockstep,
                        "sequential": lambda: sum(b.decode(d)[1]
                                                  for d in datas)})
        rec = {"B": B, "streams": [k for k, _ in spec],
               "pictures": [n for _, n in spec], "rounds": stats["rounds"],
               "batches": stats["batches"], "fallbacks": stats["fallbacks"],
               "md5_ok": True, "launches": launches,
               "launches_per_round": {k: v / stats["rounds"]
                                      for k, v in launches.items()},
               "lockstep": b.rates(total, secs["lockstep"]),
               "sequential": b.rates(total, secs["sequential"])}
        runs.append(rec)
        agg[str(B)] = rec["lockstep"]["fps_median"]
    return {"fps_batch_aggregate": agg, "runs": runs}


def _one_stream(b: Bench, key: str, n: int) -> dict:
    data, want = b.stream(key, n)
    rec = {"stream": key, "pictures": n, "stream_bytes": len(data)}
    rec.update(b.checked(data, want, key))
    rec.update(b.rates(n, b.turns({"e2e": lambda: b.decode(data)[1]})["e2e"]),
               steps_last_pass=b.routes)
    return rec


def section_4k(b: Bench) -> dict:
    rec = _one_stream(b, *b.plan.uhd)
    return {"fps_4k_e2e": rec["fps_median"], "run": rec}


def section_pipeline(b: Bench) -> dict:
    from ..core import state
    from ..core.recon import decode_picture

    reps = 8
    pics = []
    for key, idx in b.plan.pipeline:
        b.tick()
        ref = f"{key}#{idx}"
        committed = b.fixture["pipeline"]["pictures"][ref]["seeds"]
        if str(b.seed) not in committed:
            raise ValueError(f"no committed md5s for seed {b.seed} of {ref} "
                             f"(seeds {sorted(committed)})")
        want = committed[str(b.seed)]
        data, _ = b.stream(key, idx + 1)
        arrs, w, h, cqo, R = BC.parse_pictures(data, max_pics=idx + 1)[idx]
        darrs = state.tables_from_numpy(arrs, b.dev)
        # the wholly-concealed flag stays on the host, as the packed paths
        # keep it: K3's skip decision then reads no device value
        darrs["whole_conceal"] = torch.from_numpy(
            np.asarray(arrs["whole_conceal"]))
        ry, rc = (torch.from_numpy(p).to(b.dev)
                  for p in BC.reference_planes(w, h, R, b.seed))
        rec = {"picture": ref, "w_mbs": w, "h_mbs": h, "n_slots": R,
               "seed": b.seed, "md5_ok": True, "run_stages": {}}
        prev = 0.0
        for rs in range(4):
            def step(rs=rs):
                return decode_picture(darrs, ry, rc, w, h, cqo, run_stages=rs)
            Y, C = step()
            got = hashlib.md5(Y.cpu().numpy().tobytes() +
                              C.cpu().numpy().tobytes()).hexdigest()
            if got != want[str(rs)]:
                raise AssertionError(f"pipeline {ref} seed {b.seed} "
                                     f"run_stages={rs}: md5 {got} != "
                                     f"committed {want[str(rs)]}")
            st = {"span_ms": None, "host_enqueue_ms": None,
                  "device_ms": None, "stage_device_ms": None}
            if b.cuda:
                b.sync()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                for _ in range(reps):
                    step()
                end.record()
                st["host_enqueue_ms"] = 1e3 * (time.perf_counter() - t0) / reps
                b.sync()
                st["span_ms"] = start.elapsed_time(end) / reps
                dev = [b.held_ms(step, 4 * st["host_enqueue_ms"] + 20)[2]
                       for _ in range(3)]
                dev = [d for d in dev if d is not None]
                if dev:
                    st["device_ms"] = _median(dev)
                    st["stage_device_ms"] = st["device_ms"] - prev
                    prev = st["device_ms"]
            rec["run_stages"][str(rs)] = st
        pics.append(rec)
    span = pics[0]["run_stages"]["3"]["span_ms"]
    return {"fps_pipeline": None if span is None else 1e3 / span,
            "pictures": pics}


def section_dense(b: Bench) -> dict:
    key, n = b.plan.dense
    rec = _one_stream(b, key, n)
    data, _ = b.stream(key, n)
    parse = []
    for _ in range(b.passes):
        b.tick()
        pics, sec = b.parse_only(data, SLICE_THREADS)
        parse.append(1e3 * sec / pics)
    parse_ms = b.t(_median(parse))
    fps = rec["fps_median"]
    return {"fps_dense_e2e": fps, "dense_parse_ms_per_frame": parse_ms,
            "dense_e2e_minus_parse_ms": (None if fps is None
                                         else 1e3 / fps - parse_ms),
            "run": rec}


def _stage_table(b: Bench, key: str, n: int) -> dict:
    """Each picture of the stream through each layer in turn, from here:
    the decoder parses (recon_strategy), then this file packs, uploads,
    steps and fetches it. The strategy's picture goes into stacks of its
    own, so the next picture predicts from it; its frame is SKIP_RECON to
    the decoder. On the card the step runs eagerly (the host enqueue of
    its ops) and then once more as the CUDA graph of its key (core/
    graphs.py; captured untimed where the key has none yet), whose replay
    writes the same picture into the same slot and must give the same
    bytes: the replay's host ms is the row beside the enqueue's."""
    from ..core import decoder as DEC
    from ..core import packed as PK
    from ..core.graphs import GroupGraphs
    from ..core.recon import decode_picture_packed2

    data, want = b.stream(key, n)
    lay_ms = {k: [] for k in ("parse", "pack", "upload", "step_host",
                              "step_device", "step_replay_host", "fetch")}
    got, upload_bytes, unheld = {}, [], [0]
    st = {"t": 0.0, "scratch": None, "stacks": None, "hold": 30.0}
    graphs = GroupGraphs()

    def layers(dec, pic):
        t_in = time.perf_counter()
        lay_ms["parse"].append(1e3 * (t_in - st["t"]))
        sps, pps = dec.sps, dec.pps
        lay = PK.get_packed_layout_v2(sps.width_mbs, sps.height_mbs)
        if st["scratch"] is None or st["scratch"].lay is not lay:
            st["scratch"] = PK.PackScratchV2(lay)
        R = dec.dpb.dpb_size + 1
        if st["stacks"] is None or st["stacks"][0].shape[0] != R:
            st["stacks"] = (
                torch.zeros((R, sps.height, sps.width), dtype=torch.uint8,
                            device=b.dev),
                torch.zeros((R, 2, sps.height // 2, sps.width // 2),
                            dtype=torch.uint8, device=b.dev))
        t0 = time.perf_counter()
        res = PK.pack_picture_v2(pic, lay, st["scratch"])
        lay_ms["pack"].append(1e3 * (time.perf_counter() - t0))
        if res is None:
            raise RuntimeError(f"{key}: the v2 packer declined picture "
                               f"{dec.pic_number}")
        buf, bk = res
        upload_bytes.append(buf.nbytes)
        t0 = time.perf_counter()
        dbuf = torch.from_numpy(buf).to(b.dev)
        b.sync()
        lay_ms["upload"].append(1e3 * (time.perf_counter() - t0))

        def step():
            return decode_picture_packed2(
                dbuf, *st["stacks"], dec.dpb.current.slot, lay, bk,
                pps.constrained_intra_pred, pps.chroma_qp_index_offset)
        if b.cuda:
            frame, host_ms, dev_ms = b.held_ms(step, st["hold"])
            st["hold"] = max(30.0, 4 * host_ms)
            unheld[0] += dev_ms is None
            lay_ms["step_replay_host"].append(
                _replay_host_ms(b, graphs, buf, dec.dpb.current.slot,
                                st["stacks"], lay, bk, pps, frame))
        else:
            t0 = time.perf_counter()
            frame = step()
            host_ms, dev_ms = 1e3 * (time.perf_counter() - t0), None
        lay_ms["step_host"].append(host_ms)
        lay_ms["step_device"].append(dev_ms)
        t0 = time.perf_counter()
        frame.start_fetch()
        got[dec.pic_number] = frame.tobytes()
        lay_ms["fetch"].append(1e3 * (time.perf_counter() - t0))
        st["t"] = time.perf_counter()
        return DEC.SKIP_RECON

    before = launch_counts()
    dec = DEC.Decoder(device="cpu", parallel_slices=SLICE_THREADS,
                      recon_strategy=layers)
    try:
        st["t"] = time.perf_counter()
        outs = dec.decode_annexb(data)
    finally:
        dec.close()
    check_md5s(md5s([got[o.pic_id] for o in outs]), want, f"stages {key}")
    launches = _since(before)

    table = {}
    for layer, xs in lay_ms.items():
        xs = [x for x in xs if x is not None] if b.cuda else []
        table[layer] = {"median_ms": _median(xs) if xs else None,
                        "max_ms": max(xs) if xs else None}
    med = {k: v["median_ms"] for k, v in table.items()}
    serial = (None if not b.cuda else
              med["parse"] + med["pack"] + med["upload"] + med["step_host"])
    e2e = b.rates(n, b.turns({"e2e": lambda: b.decode(data)[1]})["e2e"])
    busy = {"busy_ms": None, "busy_sum_ms": None, "wall_ms": None,
            "busy_share": None, "busy_of_e2e_share": None}
    if b.cuda:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sec = b.decode(data)[1]
        union, total = _device_union_ms(prof)
        if union is None:
            busy = dict.fromkeys(busy, "not measured")
        else:
            # the profiler slows the host: the share of its own pass, and
            # the busy ms a frame over the unprofiled passes' ms a frame
            busy = {"busy_ms": union, "busy_sum_ms": total,
                    "wall_ms": 1e3 * sec, "busy_share": union / (1e3 * sec),
                    "busy_of_e2e_share": union / n
                    / e2e["ms_per_frame_median"]}
    return {"stream": key, "pictures": n, "md5_ok": True,
            "launches": launches, "layers": table,
            "upload_bytes_median": _median(upload_bytes),
            "step_graphs": len(graphs.graphs()),
            "step_capture_parts_ms": [g.capture_parts
                                      for g in graphs.graphs()],
            "device_not_held": unheld[0],
            "sum_no_fetch_ms": serial,
            "sum_ms": None if serial is None else serial + med["fetch"],
            "e2e_ms_per_frame": e2e["ms_per_frame_median"],
            "overlap_ms": (None if serial is None
                           else serial - e2e["ms_per_frame_median"]),
            "profiled_pass": busy}


def _replay_host_ms(b: Bench, graphs, buf, slot: int, stacks, lay, bk,
                    pps, frame) -> float:
    """The picture's step once more, as the graph of its key: captured
    first (untimed) if the key has none; then one replay, from an idle
    card, timed on the host clock. The replay rewrites the picture's slot
    with the same planes, and its YUV must equal the eager step's."""
    args = (buf, slot, *stacks, lay, bk, pps.constrained_intra_pred,
            pps.chroma_qp_index_offset)
    if graphs.step(*args) is None:       # the key's first picture
        graphs.step(*args)               # captured, and replayed once
    b.sync()
    t0 = time.perf_counter()
    yuv = graphs.step(*args)
    ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(yuv, frame.yuv):
        raise AssertionError("the step's graph replay differs from its "
                             "eager step")
    return ms


def section_stages(b: Bench) -> dict:
    out = {}
    for key, n in b.plan.stages:
        b.tick()
        out[key.split("_")[0]] = _stage_table(b, key, n)
    return out


def _link_mbps(b: Bench, nbytes: int) -> dict:
    """The host<->device link on four frame-sized buffers, best of three
    rounds a direction: D2H from computed tensors (an upload would read
    back nothing new) into pinned memory, H2D from pageable and from
    pinned memory."""
    if not b.cuda:
        return {"link_d2h_mbps": None, "link_h2d_pageable_mbps": None,
                "link_h2d_pinned_mbps": None}
    base = torch.zeros(nbytes, dtype=torch.uint8, device=b.dev)
    outs = [base + (i + 1) for i in range(4)]
    pinned = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
              for _ in range(4)]
    pageable = [np.full(nbytes, i, np.uint8) for i in range(4)]

    def rate(fn):
        best = None
        for _ in range(3):
            b.sync()
            t0 = time.perf_counter()
            fn()
            b.sync()
            sec = time.perf_counter() - t0
            best = sec if best is None else min(best, sec)
        return 4 * nbytes / best / 1e6

    def d2h():
        for o, p in zip(outs, pinned):
            p.copy_(o, non_blocking=True)

    def h2d_pageable():
        for a in pageable:
            torch.from_numpy(a).to(b.dev)

    def h2d_pinned():
        for o, p in zip(outs, pinned):
            o.copy_(p, non_blocking=True)
    return {"link_d2h_mbps": rate(d2h),
            "link_h2d_pageable_mbps": rate(h2d_pageable),
            "link_h2d_pinned_mbps": rate(h2d_pinned)}


def section_fetch(b: Bench) -> dict:
    key, n = b.plan.fetch
    data, want = b.stream(key, n)
    before = launch_counts()
    frames, _ = b.decode(data, prefetch_outputs=True)
    check_md5s(md5s(frames), want, f"fetch {key}")
    launches = _since(before)
    fetched = sum(len(f.tobytes()) for f in frames)

    def delivered():
        from ..core.decoder import Decoder
        dec = Decoder(device=b.dev, parallel_slices=SLICE_THREADS,
                      prefetch_outputs=True)
        try:
            b.sync()
            t0 = time.perf_counter()
            for o in dec.decode_annexb(data):
                o.frame.tobytes()
            return time.perf_counter() - t0
        finally:
            dec.close()

    secs = b.turns({"fetch": delivered, "device": lambda: b.decode(data)[1]})
    fetch, device = b.rates(n, secs["fetch"]), b.rates(n, secs["device"])
    link = _link_mbps(b, fetched // n)
    out = {"stream": key, "fetch_frames": n, "fetched_bytes": fetched,
           "md5_ok": True, "launches": launches,
           "fps_e2e_fetch": fetch["fps_median"], "fetch": fetch,
           "fps_e2e_device_same_stream": device["fps_median"], **link,
           "fetch_bound_overlap_fps": None, "fetch_bound_serial_fps": None}
    if b.cuda:
        # bench.py's bounds: the pump issues each frame's copy right after
        # its step, so delivery tracks min(link, decode); the serial bound
        # is the floor when the copies do not overlap the decode
        link_fps = link["link_d2h_mbps"] * 1e6 / (fetched / n)
        dev_fps = device["fps_median"]
        out["fetch_bound_overlap_fps"] = min(link_fps, dev_fps)
        out["fetch_bound_serial_fps"] = 1 / (1 / link_fps + 1 / dev_fps)
    return out


SECTION_FNS = {"e2e": section_e2e, "batch": section_batch, "4k": section_4k,
               "pipeline": section_pipeline, "dense": section_dense,
               "stages": section_stages, "fetch": section_fetch}


# -------------------------------------------------------------------- run
def load_fixture() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


def load_x264() -> dict:
    """The committed x264 stream and its JSON; the stream must hash to
    what the JSON says."""
    with open(X264 + ".h264", "rb") as f:
        data = f.read()
    with open(X264 + ".json") as f:
        info = json.load(f)
    if hashlib.md5(data).hexdigest() != info["stream_md5"]:
        raise ValueError("the x264 fixture does not hash to its JSON")
    return {"data": data, "info": info}


def make_streams(plan: Plan, fixture: dict) -> Dict[str, bytes]:
    """Every stream of the plan, generated where build/ has no copy, in
    spawned processes side by side (pure Python: ~20 s a 1080p IDR). A
    stream generated at the committed length must hash to the committed
    sha256."""
    todo = {k: n for k, n in plan.generate.items()
            if not os.path.exists(BC.cache_file(_cache_name(k, n)))}
    if len(todo) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(len(todo), os.cpu_count() or 1)) as pool:
            jobs = [pool.apply_async(_generate, (k, n))
                    for k, n in todo.items()]
            for j in jobs:
                j.get(timeout=1800)
    out = {}
    for k, n in plan.generate.items():
        out[k] = _generate(k, n)
        entry = fixture["streams"][k]
        if n == entry["args"]["n_frames"] and \
                hashlib.sha256(out[k]).hexdigest() != entry["sha256"]:
            raise ValueError(f"{k}: the generator's {n} pictures do not hash "
                             "to the committed sha256")
    return out


def _card() -> Optional[str]:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def run(sections=SECTIONS, plan: str = "full", device: str = "cuda",
        passes: int = 5, seed: int = 0, emit=print) -> Tuple[int, dict]:
    """Run the sections in turn, `emit` each one's JSON line as it ends;
    returns (exit code, the last line's object). Exit code 0 only if
    every section held its md5s and ran to its end."""
    from ..core import graphs as GR
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench --device cuda: CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    p = PLANS[plan]
    fixture = load_fixture()
    t0 = time.perf_counter()
    streams = make_streams(p, fixture)
    b = Bench(p, device, passes, seed, fixture, streams,
              load_x264() if p.x264 and "e2e" in sections else None)
    detail = {"device": (torch.cuda.get_device_name(b.dev) if b.cuda
                         else "cpu"),
              "card": _card() if b.cuda else None,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "plan": plan, "passes": passes, "seed": seed,
              "limits": {k: p.limits[k] for k in sections},
              "streams_s": b.t(time.perf_counter() - t0),
              "host_probe_parse_ms": {"before": b.host_probe()}}
    lines, ok = {}, True
    for name in sections:
        start = time.perf_counter()
        b.deadline = start + p.limits[name]
        rec = {"section": name, "ok": False, "error": None,
               "host_probe_parse_ms": b.host_probe()}
        before = launch_counts()
        try:
            rec.update(SECTION_FNS[name](b))
            rec["ok"] = True
        except Exception as e:       # the next section still runs
            traceback.print_exc(file=sys.stderr)
            rec["error"] = f"{type(e).__name__}: {e}"
            ok = False
        with contextlib.suppress(RuntimeError):
            b.sync()             # a failed section's error shows only once
        rec["section_launches"] = _since(before)
        # the reference stacks and graphs the process holds after it
        rec["stack_pool"] = GR.STACK_POOL.stats() if b.cuda else None
        rec["section_s"] = b.t(time.perf_counter() - start)
        emit(json.dumps(rec))
        lines[name] = rec
    detail["host_probe_parse_ms"]["after"] = b.host_probe()
    detail["sections"] = lines
    fps = lines.get("e2e", {}).get("fps_e2e_device")
    size = stream_args(p.e2e[0], 1)[1]
    last = {"metric": f"frames/s {16 * size['width_mbs']}x"
                      f"{16 * size['height_mbs']} Baseline end to end on "
                      "one card (bitstream in -> frames on the card; "
                      "realistic multi-slice idc-0 stream, dispatch pump on)",
            "value": fps, "unit": "frames/s",
            "vs_baseline": None if fps is None else fps / REAL_TIME_FPS,
            "detail": detail}
    return (0 if ok else 1), last


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m broadway_tpu_torch.tools.bench",
        description="The port's benchmark (see the module's docstring).")
    ap.add_argument("--section", action="append", choices=SECTIONS,
                    help="a section to run (repeat for more; default all)")
    ap.add_argument("--passes", type=int, default=5,
                    help="warm passes a timing (default 5)")
    ap.add_argument("--seed", type=int, default=0,
                    help="draws the pipeline's reference stacks (default 0)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default); cpu runs the plain versions and "
                         "reports no times")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--quick", action="store_const", dest="plan",
                      const="quick", help="the short form of chip_smoke.py")
    size.add_argument("--tiny", action="store_const", dest="plan",
                      const="tiny", help="8x6 MBs: the CPU rehearsal")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: --device cuda but CUDA is not available; nothing was "
              "run", file=sys.stderr)
        return 2
    rc, last = run(tuple(args.section or SECTIONS), args.plan or "full",
                   args.device, args.passes, args.seed,
                   emit=lambda s: print(s, flush=True))
    print(json.dumps(last), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
