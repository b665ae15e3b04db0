"""Make, or check, the benchmark's pool of GOPs.

Each configuration (``portbench/configs/<name>.json``) names its
generator arguments and the seeds of its GOPs. Every GOP is one
``realistic_stream`` of the frozen generator in this folder: its
parameter sets, an IDR and the P pictures after it, so that GOPs joined
in any order make one valid stream. The pool of a configuration is
``portbench/streams/<name>/`` with a ``manifest.json`` that holds, for
each file, its sha256, its generator arguments, its macroblocks by class
per picture and the md5 of every picture as the plain reference
(``portbench/reference``) decodes it.

    python3 -m portbench.gen.make_pool story-360p          # make
    python3 -m portbench.gen.make_pool --check story-360p  # remake, compare

Each GOP is made, and decoded by the reference, in a process of its own
(``--jobs`` at a time); nothing is shared between them but files.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

from .. import lookup


def gop_name(seed: int) -> str:
    return f"gop-{seed}.h264"


def make_one(config: str, seed: int, out_dir: str) -> dict:
    """Generate one GOP into `out_dir` and decode it with the reference;
    returns its manifest entry."""
    from . import streams
    from ..reference import decode as ref
    cfg = lookup.config(config)
    args = dict(cfg["generator"]["args"], seed=seed)
    data, info = streams.realistic_stream(**args)
    path = os.path.join(out_dir, gop_name(seed))
    with open(path, "wb") as f:
        f.write(data)
    md5s = [ref.md5(p) for p in ref.decode_annexb(data)]
    return {"file": gop_name(seed), "bytes": len(data),
            "sha256": hashlib.sha256(data).hexdigest(),
            "generator": cfg["generator"]["function"], "args": args,
            "mb_classes": info["mb_classes"], "md5": md5s}


def run_jobs(config: str, seeds, out_dir: str, jobs: int) -> list:
    """make_one for every seed, each in a process of its own."""
    entries, running, todo = {}, [], list(seeds)
    while todo or running:
        while todo and len(running) < jobs:
            s = todo.pop(0)
            p = subprocess.Popen(
                [sys.executable, "-m", "portbench.gen.make_pool", config,
                 "--one", str(s), out_dir],
                stdout=subprocess.PIPE, text=True, cwd=lookup.REPO)
            running.append((s, p))
        s, p = running.pop(0)
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"GOP {s} of {config}: exit {p.returncode}")
        entries[s] = json.loads(out.strip().splitlines()[-1])
    return [entries[s] for s in seeds]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--check", action="store_true",
                    help="remake every GOP in a scratch folder and compare "
                         "it with the manifest")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--one", nargs=2, metavar=("SEED", "OUT_DIR"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.one:
        print(json.dumps(make_one(a.config, int(a.one[0]), a.one[1])))
        return 0
    cfg = lookup.config(a.config)
    seeds = cfg["generator"]["seeds"]
    pool = lookup.pool_dir(a.config)
    if not a.check:
        os.makedirs(pool, exist_ok=True)
        entries = run_jobs(a.config, seeds, pool, a.jobs)
        with open(os.path.join(pool, "manifest.json"), "w") as f:
            json.dump({"config": a.config, "gops": entries}, f, indent=1)
            f.write("\n")
        return 0
    scratch = os.path.join(lookup.REPO, "build", "portbench", "pool_check",
                           a.config)
    os.makedirs(scratch, exist_ok=True)
    have = lookup.manifest(a.config)["gops"]
    again = run_jobs(a.config, seeds, scratch, a.jobs)
    bad = [n["file"] for h, n in zip(have, again) if h != n]
    for h in have:
        with open(os.path.join(pool, h["file"]), "rb") as f:
            if hashlib.sha256(f.read()).hexdigest() != h["sha256"]:
                bad.append(h["file"] + " (committed bytes)")
    print(json.dumps({"config": a.config, "gops": len(have),
                      "differ": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
