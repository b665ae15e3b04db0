"""The control of the comparison that decides ``correct``: the plain
reference decoder with one step in a lower precision, the step that
would tempt a faster decoder. The quarter-sample luma interpolation's
6-tap sums run in float16 instead of exact integers; float16 holds whole
numbers exactly only up to 2048, and the taps' sums reach some 10,000
(half samples) and some 350,000 (centre samples), so the predictions of
most fractional motion vectors change. The configuration states a
bit-exact decode, so the control has to come out as not correct.

    python3 -m portbench.reference.control --workload <cell> --seed <n>...

reads, for each seed, the pictures that the run of that seed checks
against the reference in the run itself (``check.judge``'s live
pictures), decoded by the control in the program's place, and prints
how many differ from the reference: the number that the run compares
with its limit of 0.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from unittest import mock

import numpy as np

from . import decode as ref
from . import inter


def _tap6_half(a: np.ndarray, axis: int) -> np.ndarray:
    """``inter._tap6`` in float16, rounded back to whole numbers."""
    s = [slice(None)] * a.ndim

    def sl(i, n):
        s2 = list(s)
        s2[axis] = slice(i, i + n)
        return a[tuple(s2)].astype(np.float16)

    n = a.shape[axis] - 5
    with np.errstate(over="ignore", invalid="ignore"):
        v = (sl(0, n) - np.float16(5) * sl(1, n) + np.float16(20) * sl(2, n)
             + np.float16(20) * sl(3, n) - np.float16(5) * sl(4, n)
             + sl(5, n))
        v = np.nan_to_num(v, posinf=65504, neginf=-65504)
    return np.rint(v.astype(np.float32)).astype(np.int32)


def decode_annexb(data: bytes, max_pictures: int = None):
    """The reference decode of `data` with the lower-precision step."""
    with mock.patch.object(inter, "_tap6", _tap6_half):
        return ref.decode_annexb(data, max_pictures)


def main(argv=None) -> int:
    from .. import lookup, run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    cell = lookup.workload(a.workload)
    cfg = lookup.config(cell["config"])
    gops = lookup.manifest(cell["config"])["gops"]
    for seed in a.seed:
        live = run.plan(cell, cfg, len(gops), seed, False, "cuda")[0]["live"]
        entry = gops[live["gop"]]
        data = lookup.gop_bytes(cell["config"], entry)
        t = time.time()
        got = [ref.md5(f) for f in
               decode_annexb(data, live["pictures"])][:live["pictures"]]
        want = [ref.md5(f) for f in
                ref.decode_annexb(data, live["pictures"])][:len(got)]
        print(json.dumps({
            "workload": a.workload, "seed": seed, "gop": entry["file"],
            "pictures": len(got),
            "live_differing": sum(g != w for g, w in zip(got, want)),
            "differing_from_pool": sum(
                g != m for g, m in zip(got, entry["md5"])),
            "seconds": round(time.time() - t, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
