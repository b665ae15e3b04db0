"""Band-sharded decode over a list of devices, checked and timed.

Two streams of one geometry, slices aligned with the bands: (a) the
realistic generator with one idc-0 slice a band (the chained ghost-row
deblock) and (b) the banded generator at idc 2 (independent bands). Each
goes through ``parallel.slices.decode_stream_sliced`` over the devices,
one band each, with the stack pool emptied first, and must equal the
single-device decoder on the first of them byte for byte, with K1 / K2 /
K3 launched once per band and picture (on CUDA). Printed beside it: the
band step's routes as counted (eager, captured, replayed; a mesh over
several devices counts them as multi_card_*), its host ms by route, in
total and by card, each capture's ms by card and the bytes it added to
each card's graph pool; then frames/s of the band path (median of warm
passes, one synchronize of every device at the end of a pass), of the
same bands on the first device alone (a mesh of distinct devices only)
and of the single-device decoder, in turns; each card's device span for
one replay of the first P picture's graph; then the 2-D form
(``decode_streams_sliced_dp``) over a [2, n/2] grid of the devices on (b)
and (a). Each --devices list runs on the same two streams (cached under
build/, generation is pure Python and takes a minute at 1080p). Prints
one JSON line per list; exits non-zero on any difference.

    python3 -m broadway_tpu_torch.tools.bandcheck --devices cuda:0,cuda:1,cuda:2,cuda:3 --devices cuda:0,cuda:0,cuda:0,cuda:0
    python3 -m broadway_tpu_torch.tools.bandcheck --devices cpu,cpu:0 --width 6 --height 4 --frames 2
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from typing import List

ROUTES = ("eager", "captured", "replayed")


def _sync(devices) -> None:
    import torch
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _counts():
    from ..ops.gpu import mc_kernel as K1
    from ..ops.gpu import wavefront_kernels as KW
    return [K1.mc_predict.launches, KW.intra_wavefront.launches,
            KW.deblock_wavefront.launches]


def _card() -> str:
    """nvidia-smi's name and power limit of every card, or "" without."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.CalledProcessError):
        return ""


def band_streams(width_mbs: int, height_mbs: int, n_frames: int,
                 n: int) -> dict:
    """Streams (a) and (b) for n bands, cached under build/."""
    from . import streams
    from .bench_common import _cached
    tag = f"{width_mbs}x{height_mbs}_{n_frames}_{n}"
    return {
        "a": _cached(f"band_real_{tag}.h264", lambda: streams.realistic_stream(
            width_mbs, height_mbs, n_frames=n_frames, n_slices=n)[0]),
        "b": _cached(f"band_banded_{tag}.h264", lambda: streams.banded_stream(
            width_mbs, height_mbs, n_bands=n, n_frames=n_frames,
            deblock_idc=2)[0])}


@contextlib.contextmanager
def step_times():
    """Around band decodes: each band step's host ms by the route it took
    ({route: [ms]}; a mesh's multi_card_* routes under the same names)
    and, for a mesh over several devices, by card ({route: {card:
    [ms]}}, ``GroupGraphs.card_ms``)."""
    from ..parallel import slices as SL

    out = {"host_ms": {r: [] for r in ROUTES},
           "card_ms": {r: {} for r in ROUTES}}
    saved = {name: getattr(SL.BandSlicer, name)
             for name in ("_one_device", "_multi_card")}

    def timed(name):
        step = saved[name]

        def call(slicer, dec, *a, **k):
            routes = slicer.stats["routes"]
            before = dict(routes)
            t0 = time.perf_counter()
            frame = step(slicer, dec, *a, **k)
            ms = 1e3 * (time.perf_counter() - t0)
            route = next(r for r in routes if routes[r] > before[r])
            route = route.replace("multi_card_", "")
            out["host_ms"][route].append(ms)
            if name == "_multi_card":
                for card, t in dec.group_graphs.card_ms.items():
                    out["card_ms"][route].setdefault(card, []).append(t)
            return frame
        return call

    for name in saved:
        setattr(SL.BandSlicer, name, timed(name))
    try:
        yield out
    finally:
        for name, step in saved.items():
            setattr(SL.BandSlicer, name, step)


def _graph_of(pool, bk):
    """The band graph (kind "band_mesh" or "band") of the pool whose key
    holds bucket triple bk, with the most replays."""
    best = None
    for s in pool._free.values():
        for st in s:
            for key, g in st.graphs._graphs.items():
                hit = (key[0] == "band_mesh" and key[1][0] == "v2"
                       and key[1][2] == bk) or (key[0] == "band" and
                                                key[4] == bk)
                if hit and (best is None or g.replays > best.replays):
                    best = g
    return best


def p_spans(pics) -> dict:
    """One replay of the first P picture's band graph, into a slot that
    picture does not read, every card idle at its start: each card's
    device span (ms, CUDA events on its current stream) to the end of its
    work, and for a mesh over several cards to the end of its runs'
    graphs (``run_end_ms``: the chain's progress) too; {} without one."""
    import torch

    from ..core import graphs as GR

    buf, bk, *_, n_slots = pics[1]
    g = _graph_of(GR.STACK_POOL, bk)
    if g is None:
        return {}
    mesh = g.kind == "band_mesh"
    cards = g.cards if mesh else [g.device]
    for c in cards:
        torch.cuda.synchronize(c)
    ev = {c: [torch.cuda.Event(enable_timing=True) for _ in range(3)]
          for c in cards}
    for c in cards:
        ev[c][0].record(torch.cuda.current_stream(c))
    if mesh:
        g.replay(buf[None], [n_slots - 1],
                 marks={c: evs[1:] for c, evs in ev.items()})
    else:
        g.replay(buf[None], [n_slots - 1])
        ev[cards[0]][2].record(torch.cuda.current_stream(cards[0]))
    for c in cards:
        torch.cuda.synchronize(c)
    out = {"span_ms": {str(c): e[0].elapsed_time(e[2])
                       for c, e in ev.items()}}
    if mesh:
        out["run_end_ms"] = {str(c): e[0].elapsed_time(e[1])
                             for c, e in ev.items()}
    return out


def run(devices: List[str], width_mbs: int, height_mbs: int, n_frames: int,
        passes: int) -> dict:
    from ..core import graphs as GR
    from ..core.decoder import Decoder
    from ..core.packed import pack_stream
    from ..parallel import slices as SL

    n = len(devices)
    mesh = SL.make_band_mesh(devices, n)
    cards = list(dict.fromkeys(mesh))
    on_cuda = mesh[0].type == "cuda"
    datas = band_streams(width_mbs, height_mbs, n_frames, n)
    out = {"devices": [str(d) for d in mesh], "card": _card(),
           "cards": len(cards), "width_mbs": width_mbs,
           "height_mbs": height_mbs, "streams": {}}

    def single(data):
        dec = Decoder(device=mesh[0], parallel_slices=8)
        try:
            outs = dec.decode_annexb(data)
            _sync(mesh)
            return outs
        finally:
            dec.close()

    def banded(data, over):
        dec = Decoder(device=over[0], parallel_slices=8,
                      recon_strategy=SL.BandSlicer(over))
        try:
            outs = dec.decode_annexb(data)
            _sync(over)
            return outs
        finally:
            dec.close()

    GR.STACK_POOL.clear()          # the band graphs, counted from none
    wants = {}
    med = lambda xs: sorted(xs)[len(xs) // 2]
    for lab, data in datas.items():
        want = [o.frame.tobytes() for o in single(data)]
        before = _counts()
        st = {}
        with step_times() as t:
            got = SL.decode_stream_sliced(data, mesh, n, parallel_slices=8,
                                          stats=st)
        launches = [a - b for a, b in zip(_counts(), before)]
        if got != want:
            raise AssertionError(f"stream ({lab}) over {out['devices']}: "
                                 "differs from the single-device decoder")
        if st["pictures"] != len(want) or st["declined"]:
            raise AssertionError(f"stream ({lab}): {st}")
        if on_cuda and launches != [n * len(want)] * 3:
            raise AssertionError(f"stream ({lab}): launches {launches} for "
                                 f"{len(want)} pictures of {n} bands")
        wants[lab] = want
        times = {"single": [], "band": [], "one_card_band": []}
        for _ in range(passes):
            for label, fn in (("single", single),
                              ("band", lambda d: banded(d, mesh)),
                              ("one_card_band",
                               lambda d: banded(d, [mesh[0]] * n))):
                if label == "one_card_band" and len(cards) == 1:
                    continue
                t0 = time.perf_counter()
                fn(data)
                times[label].append(time.perf_counter() - t0)
        rec = out["streams"][lab] = {
            "pictures": len(want), "stats": st, "launches": launches,
            "routes": st["routes"], "step_host_ms": t["host_ms"],
            "step_card_ms": t["card_ms"]}
        for label, ts in times.items():
            if ts:
                rec[f"{label}_fps"] = len(want) / med(ts)
                rec[f"{label}_fps_passes"] = [len(want) / s for s in ts]
        if on_cuda:
            rec["p_span_ms"] = p_spans(pack_stream(data, max_pics=2))
    out["captures"] = [
        {"kind": g.kind, "capture_ms": g.capture_ms,
         "capture_parts_ms": g.capture_parts, "pool_bytes": g.pool_bytes,
         "replays": g.replays,
         "capture_card_ms": getattr(g, "card_capture_ms", None),
         "pool_card_bytes": getattr(g, "card_pool_bytes", None)}
        for s in GR.STACK_POOL._free.values() for st in s
        for g in st.graphs.graphs() if g.kind in ("band", "band_mesh")]
    if n % 2 == 0:
        grid = [list(devices[:n // 2]), list(devices[n // 2:])]
        got = SL.decode_streams_sliced_dp([datas["b"], datas["a"]], grid,
                                          n // 2, parallel_slices=8)
        if got != [wants["b"], wants["a"]]:
            raise AssertionError(f"the 2-D form over {grid} differs")
        out["dp_grid"] = grid
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bandcheck", description=__doc__.split(
        "\n\n")[0])
    p.add_argument("--devices", action="append",
                   help="one device per band, comma-separated (may repeat); "
                   "the option may be given again for another run "
                   "(default cuda:0,cuda:1,cuda:2,cuda:3)")
    p.add_argument("--width", type=int, default=120, help="MBs")
    p.add_argument("--height", type=int, default=68, help="MBs")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--passes", type=int, default=3)
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    for spec in a.devices or ["cuda:0,cuda:1,cuda:2,cuda:3"]:
        devices = spec.split(",")
        if a.height % len(devices):
            p.error(f"{a.height} MB rows do not divide into {len(devices)} "
                    "bands")
        print(json.dumps(run(devices, a.width, a.height, a.frames,
                             a.passes)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
