"""A tree of one tiny cell for the CPU tests: a configuration of 8x6
macroblocks, a pool of three GOPs made by the frozen generator and
decoded by the reference, a cell of two clients and a cell of one client
that decodes two streams as a lockstep group."""

from __future__ import annotations

import json
import os

from portbench.gen import streams
from portbench.reference import decode as ref

ARGS = {"width_mbs": 8, "height_mbs": 6, "n_frames": 6, "n_slices": 2,
        "gop": 6, "num_ref_frames": 3}
SEEDS = (1, 2, 3)
CELL = "tiny.procs2"
LOCK_CELL = "tiny.lockstep2"


def make(root: str) -> str:
    for d in ("configs", "workloads", "streams/tiny"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    cfg = {"name": "tiny", "generator": {"function": "realistic_stream",
                                         "args": ARGS,
                                         "seeds": list(SEEDS)}}
    gops = []
    for s in SEEDS:
        data, info = streams.realistic_stream(**dict(ARGS, seed=s))
        name = f"gop-{s}.h264"
        with open(os.path.join(root, "streams", "tiny", name), "wb") as f:
            f.write(data)
        gops.append({"file": name, "mb_classes": info["mb_classes"],
                     "md5": [ref.md5(p) for p in ref.decode_annexb(data)]})
    cell = {"config": "tiny", "why": "the CPU tests' cell",
            "end_to_end": ["fps", "setup_s"],
            "traffic": {"clients": 2, "parallel_slices": 2, "warm_gops": 1,
                        "trace_seconds": 0.5,
                        "check": {"sample_per_client": 8,
                                  "live_pictures": 3}}}
    lock = {"config": "tiny", "why": "the CPU tests' lockstep cell",
            "end_to_end": ["fps", "setup_s"],
            "traffic": {"clients": 1, "lockstep": 2, "parallel_slices": 1,
                        "warm_gops": 1, "trace_seconds": 0.5,
                        "check": {"sample_per_client": 8,
                                  "live_pictures": 3}}}
    for rel, obj in (("configs/tiny.json", cfg),
                     ("streams/tiny/manifest.json",
                      {"config": "tiny", "gops": gops}),
                     (f"workloads/{CELL}.json", cell),
                     (f"workloads/{LOCK_CELL}.json", lock)):
        with open(os.path.join(root, rel), "w") as f:
            json.dump(obj, f)
    return root
