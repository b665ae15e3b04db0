"""What decides ``correct``: the clients' pictures against the plain
reference (``portbench/reference``), byte for byte.

Two comparisons, each a count of pictures whose bytes differ, with the
limit 0 (the configuration's guarantee is a bit-exact decode):

- ``pictures_differing``: every client's sample of the pictures it put
  out in the window (uniform over them, drawn from the seed: IDR and P
  pictures at every depth of their GOP, so that every reference frame of
  the multi-reference stacks is read) against the md5 that the reference
  gave each picture of the pool when the pool was made (the manifest);
- ``live_differing``: the first pictures of one GOP of the pool, drawn
  from the seed, decoded by the reference in this run, against the same
  pictures as each client put them out in the window, and against the
  manifest (which this keeps honest).

The reference runs here, after every client has exited, on the host.
"""

from __future__ import annotations

import time

from . import lookup


def judge(run: dict, live: dict) -> dict:
    """{"correct", "failed", "numbers": {name: {"value", "limit"}},
    "reference_s": the reference's time}."""
    from .reference.decode import decode_annexb as decode
    from .reference.decode import md5
    man = run["manifest"]["gops"]
    sampled = differing = 0
    unchecked = 0
    for r in run["clients"]:
        got = r["answers"]["sample"]
        if not got:
            unchecked += 1
        for _, gop, k, h in got:
            sampled += 1
            differing += h != man[gop]["md5"][k]
    t = time.time()
    entry = man[live["gop"]]
    want = [md5(f) for f in decode(
        lookup.gop_bytes(run["cell_spec"]["config"], entry, run["root"]),
        live["pictures"])][:live["pictures"]]
    live_s = time.time() - t
    live_checked = live_bad = 0
    for r in run["clients"]:
        for _, gop, k, h in r["answers"]["live"]:
            live_checked += 1
            live_bad += k >= len(want) or h != want[k]
    pool_bad = sum(h != m for h, m in zip(want, entry["md5"]))
    numbers = {
        "pictures_differing": {"value": differing, "limit": 0},
        "live_differing": {"value": live_bad + pool_bad, "limit": 0},
        "clients_unchecked": {"value": unchecked, "limit": 0},
        "pictures_checked": {"value": sampled + live_checked,
                             "limit": "at least 1"},
    }
    correct = (differing == 0 and live_bad == 0 and pool_bad == 0 and
               unchecked == 0 and sampled + live_checked > 0)
    return {"correct": correct, "failed": differing + live_bad,
            "numbers": numbers, "reference_s": live_s}
