"""Generate and cache the benchmark streams (port of the two caching
helpers of the repository's ``tools/bench_common.py``; same cache file
names under ``build/``, so a stream cached by either is reused)."""

from __future__ import annotations

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cached(name: str, make) -> bytes:
    cache = os.path.join(REPO, "build", name)
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            return f.read()
    data = make()
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    tmp = f"{cache}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, cache)
    return data


def bench_stream(width_mbs, height_mbs, n_frames=4, seed=909) -> bytes:
    """Generate (and cache) a dense inter stream at the given size."""
    from . import streams
    return _cached(
        f"bench_{width_mbs}x{height_mbs}_{n_frames}.h264",
        lambda: streams.inter_stream(
            width_mbs=width_mbs, height_mbs=height_mbs, n_frames=n_frames,
            seed=seed, deblock=True, mvd_range=40)[0])


def realistic_bench_stream(width_mbs=120, height_mbs=68, n_frames=16,
                           n_slices=8, seed=4242) -> bytes:
    """Generate (and cache) the realistic-statistics stream: multi-slice,
    idc 0, multi-ref, mostly skip with sparse residuals
    (``streams.realistic_stream``). Generation is pure Python and costs
    ~20 s per stream at 1080p, so every (size, frames, seed) variant is
    cached on disk."""
    from . import streams
    sfx = "" if seed == 4242 else f"_s{seed}"
    return _cached(
        f"bench_real_{width_mbs}x{height_mbs}_{n_frames}{sfx}.h264",
        lambda: streams.realistic_stream(
            width_mbs=width_mbs, height_mbs=height_mbs, n_frames=n_frames,
            n_slices=n_slices, seed=seed)[0])
