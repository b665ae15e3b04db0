"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (``portbench/workloads/<cell>.json``) names a configuration and
its traffic: how many clients decode at once, each one stream in a
process of its own on one card, with how many slice threads, and how
the run warms up, samples and traces. This process plans the clients'
streams from ``--seed``, builds the port's libraries once, starts the
clients (``portbench/client.py``), opens the window for all of them at
once, gathers what they measured, judges their pictures against the
plain reference (``portbench/check.py``) and prints one JSON line, the
last of its standard output:

- ``--trace 0``: the cell's end-to-end metrics (its file's
  ``end_to_end``): ``fps`` (pictures completed by all clients in the
  window, over its length) and ``setup_s`` (from this command's start to
  the window's), each under the name the cell gives it;
- ``--trace 1``: the cell's per-layer metrics (``portbench/metrics/``,
  as BENCHMARK.json lists them), each client traced by
  ``torch.profiler`` over the window's last ``trace_seconds``, with
  ``device.busy_s`` and ``device.window_s`` and a ``breakdown``.

It imports no torch and holds no CUDA context itself, so that the card
is the clients'; a client that finds no card, or fewer than the cell
asks for, ends with an error, and so does the run, with no result.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    __package__ = "portbench"

from portbench import check, lookup  # noqa: E402
from portbench import trace as TR  # noqa: E402
from portbench.client import forbidden_modules  # noqa: E402

READY_S = 600         # the longest a client may take to warm up
GRACE_S = 180         # after the window, to finish and report


def fail(msg: str, code: int = 1) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def plan(cell: dict, cfg: dict, n_gops: int, seed: int, trace: bool,
         device: str, root: str = lookup.HERE) -> list:
    """Each client's spec, from the seed: every client goes through the
    whole pool, in an order of its own from a start of its own, and
    starts its window at a picture of its own inside a GOP, so that every
    seed gives the card the same work in another arrangement.

    A client of a lockstep cell (``traffic.lockstep`` = N streams,
    ``portbench/lockstep_client.py``) gets N streams instead, each with an
    order of its own over the whole pool and a GOP of its own to start
    from, and ``warm_gops`` calls of warm-up; a cell without the key
    draws what it drew before the key existed."""
    t = cell["traffic"]
    rng = random.Random(seed)
    n_pics = cfg["generator"]["args"]["n_frames"]
    live = {"gop": rng.randrange(n_gops),
            "pictures": t["check"]["live_pictures"]}

    def shuffled() -> list:
        order = list(range(n_gops))
        rng.shuffle(order)
        return order

    specs = []
    for i in range(t["clients"]):
        spec = {"client": i, "config": cell["config"], "root": root,
                "device": device, "parallel_slices": t["parallel_slices"]}
        if "lockstep" in t:
            spec["streams"] = [{"order": shuffled(),
                                "start": rng.randrange(n_gops)}
                               for _ in range(t["lockstep"])]
            spec["warm_calls"] = t["warm_gops"]
        else:
            spec["order"] = shuffled()
            spec["warm_pictures"] = t["warm_gops"] * n_pics + \
                rng.randrange(n_pics)
        spec.update(trace=trace, trace_seconds=t["trace_seconds"],
                    sample=t["check"]["sample_per_client"],
                    rng_seed=rng.getrandbits(63), live=live)
        specs.append(spec)
    return specs


def build_libraries() -> None:
    """The port's two native libraries, built into the checkout's
    ``build/torch_kernels`` once, before any client starts (the build's
    lock works inside one process only)."""
    from broadway_tpu_torch.ops.gpu import _build
    _build.build_frontend()
    _build.build()


def start_clients(specs: list, client_argv: list) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1",
               PYTHONPATH=lookup.REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    procs = []
    for spec in specs:
        p = subprocess.Popen(client_argv, stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, text=True,
                             cwd=lookup.REPO, env=env)
        p.stdin.write(json.dumps(spec) + "\n")
        p.stdin.flush()
        procs.append(p)
    return procs


def read_line(p, deadline: float) -> str:
    """The client's next line, or '' if it ended first. A client that
    outlives the deadline is ended."""
    import selectors
    with selectors.DefaultSelector() as sel:
        sel.register(p.stdout, selectors.EVENT_READ)
        if not sel.select(max(0.0, deadline - time.time())):
            p.kill()
            return ""
    return p.stdout.readline()


def stop_all(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
        for f in (p.stdin, p.stdout):
            if f is not None and not f.closed:
                f.close()


def power_limit():
    """The card's power limit in W as ``nvidia-smi`` reads it (None where
    it cannot)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=30)
        return float(r.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", client_argv=None, t_start: float = None,
             root: str = lookup.HERE) -> dict:
    """One run of the cell; returns the result line's object, whose last
    key, "checks", holds the numbers compared with their limits. Raises
    RuntimeError where no result may be printed. `device`, `client_argv`
    and `root` are for the tests: the CPU, a client with a fault planted,
    a tree of tiny cells."""
    t_start = T_START if t_start is None else t_start
    run = collect(name, seed, seconds, trace, device, client_argv, root)
    return report(run, t_start)


def collect(name: str, seed: int, seconds: float, trace: bool,
            device: str, client_argv, root: str) -> dict:
    """Start the cell's clients, open the window for all of them at once
    and gather what they sent back: the run that ``report`` reads."""
    cell = lookup.workload(name, root)
    cfg = lookup.config(cell["config"], root)
    man = lookup.manifest(cell["config"], root)
    specs = plan(cell, cfg, len(man["gops"]), seed, trace, device, root)
    if device == "cuda":
        build_libraries()
    module = ("portbench.lockstep_client" if "lockstep" in cell["traffic"]
              else "portbench.client")
    argv = client_argv or [sys.executable, "-m", module]
    procs = start_clients(specs, argv)
    try:
        deadline = time.time() + READY_S
        for p in procs:
            if read_line(p, deadline).strip() != "ready":
                raise RuntimeError("a client did not warm up")
        t0 = time.time() + 0.25
        t1 = t0 + seconds
        for p in procs:
            p.stdin.write(f"go {t0!r} {t1!r}\n")
            p.stdin.flush()
        results = []
        for p in procs:
            line = read_line(p, t1 + GRACE_S)
            if not line.strip():
                raise RuntimeError("a client ended without its result")
            results.append(json.loads(line))
        for p in procs:
            p.wait(timeout=GRACE_S)
            if p.returncode != 0:
                raise RuntimeError(f"a client exited {p.returncode}")
    finally:
        stop_all(procs)
    found = sorted({m for r in results for m in r["forbidden_modules"]})
    if found:
        raise RuntimeError("loaded by a client: " + ", ".join(found))
    return {"cell": name, "cell_spec": cell, "config": cfg, "manifest": man,
            "root": root, "seconds": seconds, "clients": results,
            "traced": trace, "device": device, "t0": t0,
            "live": specs[0]["live"]}


def report(run: dict, t_start: float) -> dict:
    """The result line's object of a run that ``collect`` gathered."""
    name, root, seconds = run["cell"], run["root"], run["seconds"]
    cell, results, device = run["cell_spec"], run["clients"], run["device"]
    done = [d for r in results for *_, d in r["pictures"]
            if d is not None and 0.0 <= d <= seconds]
    fed = sum(1 for r in results for p in r["pictures"]
              if p[2] >= 0.0)
    checks = check.judge(run, run["live"])
    metrics = {}
    if not run["traced"]:
        value = {"fps": (len(done) / seconds, "frames/s"),
                 "setup_s": (run["t0"] - t_start, "s")}
        for m in cell["end_to_end"]:
            v, unit = value[lookup.quantity(m)]
            metrics[m] = {"value": v, "unit": unit}
    else:
        if device == "cuda":
            report_untraced(run)
        add_trace_union(run)
        for m in lookup.per_layer_metrics(name, root):
            reader = lookup.metric(m)
            v = reader.read(run)
            if v is not None:
                metrics[m] = {"value": v, "unit": reader.UNIT}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": results[0]["device_name"], "count": 1,
           "memory_peak_bytes": sum(r["memory_peak_bytes"]
                                    for r in results),
           "power_limit_w": power_limit() if device == "cuda" else None}
    out = {"correct": checks["correct"], "attempted": fed,
           "failed": checks["failed"], "metrics": metrics, "device": dev}
    if run["traced"] and run.get("union") is not None:
        dev["busy_s"] = TR.covered(run["union"]) / 1e9
        dev["window_s"] = (run["trace_window"][1] -
                           run["trace_window"][0]) / 1e9
        out["breakdown"] = breakdown(run)
    out["checks"] = checks["numbers"]
    print(f"reference: {checks['reference_s']:.3f} s", file=sys.stderr)
    return out


def report_untraced(run: dict) -> None:
    """On stderr, each client that sent back no trace: its profiler
    starts only at a GOP boundary inside the window's last
    ``trace_seconds``, and it crossed none there."""
    last = run["cell_spec"]["traffic"]["trace_seconds"]
    since = run["seconds"] - last
    for i, r in enumerate(run["clients"]):
        if r["trace"]:
            continue
        fed = sum(1 for _, _, a, *_ in r["pictures"] if a >= since)
        print(f"portbench: client {i} sent no trace: it fed {fed} "
              f"pictures in the window's last {last} s and crossed no "
              f"GOP boundary there", file=sys.stderr)


def add_trace_union(run: dict) -> None:
    """The traced window (from the last client's trace start to the
    window's end) and the union of every client's device intervals in
    it."""
    traces = [r["trace"] for r in run["clients"] if r["trace"]]
    if not traces or len(traces) != len(run["clients"]):
        run["union"] = run["trace_window"] = None
        return
    lo = max(t["t0"] for t in traces)
    hi = min(t["t1"] for t in traces)
    run["trace_window"] = (lo, hi)
    run["union"] = TR.merge(TR.clip(
        [iv for t in traces for iv in t["busy"]], lo, hi))


def breakdown(run: dict) -> dict:
    """The ten device operations that took most time over all clients,
    and the ten longest stretches in which no client had an operation on
    the card, each named by what the clients' hosts were in then
    (``host_activity``)."""
    totals = {}
    for r in run["clients"]:
        for name, (_, ns) in r["trace"]["ops"].items():
            totals[name] = totals.get(name, 0) + ns
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    lo, hi = run["trace_window"]
    idle = sorted(TR.gaps(run["union"], lo, hi), key=lambda g: g[0] - g[1])
    return {"device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[host_activity(run, s, e), (e - s) / 1e9]
                          for s, e in idle[:10]]}


def host_activity(run: dict, s: int, e: int) -> str:
    """What most clients' hosts were in at the middle of [s, e]: where
    every client sent the program's spans, the innermost span open then
    on any of its threads (``host`` where none was); otherwise what its
    feed thread was in, ``feed.I`` or ``feed.P`` (a ``decode_nal`` call
    of that picture), or ``host`` (between calls)."""
    mid = (s + e) // 2
    spans = [(r.get("program") or {}).get("spans") for r in run["clients"]]
    named = all(spans)
    votes = {}
    for r, sp in zip(run["clients"], spans):
        if named:
            what = TR.innermost(sp, mid) or "host"
        else:
            what = feed_activity(r, mid / 1e9)
        votes[what] = votes.get(what, 0) + 1
    return max(sorted(votes), key=lambda w: votes[w])


def feed_activity(r: dict, t: float) -> str:
    for _, k, a, b, *_ in r["pictures"]:
        if b is not None and a + r["t0"] <= t <= b + r["t0"]:
            return "feed.I" if k == 0 else "feed.P"
    return "host"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        import broadway_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the program is not here: {e}")
    try:
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except (RuntimeError, KeyError, ValueError) as e:
        return fail(str(e))
    found = forbidden_modules()
    if found:
        return fail("loaded in the harness: " + ", ".join(found))
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
