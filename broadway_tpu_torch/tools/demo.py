#!/usr/bin/env python3
"""Demo runner of the port, counterpart of the repository's
``tools/demo.py``: the CLI analogue of the reference's demo pages
(Player/treeDemo.html: one player; Player/storyDemo.html: six players at
once across device / render configurations, the de-facto stress test;
the fps / score overlay of mp4.js:805-955).

  python3 -m broadway_tpu_torch.tools.demo tree  [-B device] [-R render] \\
      file.(mp4|h264)
  python3 -m broadway_tpu_torch.tools.demo story [-B device] file.(mp4|h264)

tree:  one player; its frame count, seconds and fps.
story: six players on six threads at once: (cpu, yuv), (cpu, rgb_int),
       and (device, yuv), (device, rec601), (device, rec709),
       (device, rgb_int), the multi-player matrix of storyDemo.html.
-B is "cuda" (the default; needs a card) or "cpu".
"""

from __future__ import annotations

import sys
import threading
import time
from typing import List

from ..player.player import MP4Player, Player

STORY_RENDERS = ("yuv", "rec601", "rec709", "rgb_int")


def _kind(data: bytes) -> str:
    return "mp4" if data[4:8] == b"ftyp" else "annexb"


def play(data: bytes, device="cuda", render: str = "yuv",
         label: str = "player") -> dict:
    """Play one stream (MP4 or Annex-B) to its end -> {"label", "device",
    "render", "frames", "seconds", "fps", "yuv"}: "yuv" holds every
    display-order picture's YUV bytes, read after the clock stops."""
    t0 = time.perf_counter()
    if _kind(data) == "mp4":
        p = MP4Player(data, device=device, render=render).play()
    else:
        p = Player(device=device, render=render)
        p.decode(data)
        p.end_of_stream()
    try:
        yuv = [f["frame"].tobytes() for f in p.frames]
        sec = time.perf_counter() - t0
    finally:
        p.decoder.release()
    n = p.stats.total_frames
    return {"label": label, "device": str(device), "render": render,
            "frames": n, "seconds": sec, "fps": n / sec if sec > 0 else 0.0,
            "yuv": yuv}


def tree(data: bytes, device="cuda", render: str = "yuv") -> dict:
    """One player (treeDemo.html)."""
    return play(data, device, render, "tree")


def story(data: bytes, device="cuda") -> List[dict]:
    """Six players at once on six threads (storyDemo.html): two on the
    CPU, four on `device` with the four renders. A player that raises
    makes story raise, after every thread has ended."""
    configs = [("cpu", "yuv"), ("cpu", "rgb_int")] + \
        [(device, r) for r in STORY_RENDERS]
    results, errors = [None] * len(configs), []

    def run(i, dev, render):
        try:
            results[i] = play(data, dev, render, f"story{i}")
        except BaseException as e:      # re-raised below, on the caller's
            errors.append(e)            # thread

    threads = [threading.Thread(target=run, args=(i, d, r),
                                name=f"story{i}")
               for i, (d, r) in enumerate(configs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _report(r: dict) -> str:
    return (f"[{r['label']}] device={r['device']} render={r['render']}: "
            f"{r['frames']} frames in {r['seconds']:.2f}s -> "
            f"{r['fps']:.1f} fps (score={r['fps']:.1f})")


def main(argv) -> int:
    if len(argv) < 3 or argv[1] not in ("tree", "story"):
        print(__doc__)
        return 1
    device, render, fname = "cuda", "yuv", None
    args = list(argv[2:])
    while args:
        a = args.pop(0)
        if a in ("-B", "-R"):           # "-B cuda" or "-Bcuda"
            a += args.pop(0)
        if a.startswith("-B"):
            device = a[2:]
        elif a.startswith("-R"):
            render = a[2:]
        else:
            fname = a
    with open(fname, "rb") as f:
        data = f.read()
    if argv[1] == "tree":
        print(_report(tree(data, device, render)))
        return 0
    t0 = time.perf_counter()
    results = story(data, device)
    sec = time.perf_counter() - t0
    for r in results:
        print(_report(r))
    total = sum(r["frames"] for r in results)
    print(f"[story] 6 players, {total} frames total in {sec:.2f}s "
          f"({total / sec:.1f} fps aggregate)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
