"""Benchmark streams and the host front end alone: the port of the
repository's ``tools/bench_common.py`` (the two caching generators, with
the same cache file names under ``build/``, so a stream cached by either
is reused, and ``parse_pictures``), and what the port's benchmark
(``tools/bench.py``) adds: ``annexb_prefix`` and ``reference_planes``."""

from __future__ import annotations

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_file(name: str) -> str:
    """Where a generated stream of this name is cached."""
    return os.path.join(REPO, "build", name)


def dense_name(width_mbs, height_mbs, n_frames) -> str:
    return f"bench_{width_mbs}x{height_mbs}_{n_frames}.h264"


def realistic_name(width_mbs, height_mbs, n_frames, seed=4242) -> str:
    sfx = "" if seed == 4242 else f"_s{seed}"
    return f"bench_real_{width_mbs}x{height_mbs}_{n_frames}{sfx}.h264"


def _cached(name: str, make) -> bytes:
    cache = cache_file(name)
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
        dense_name(width_mbs, height_mbs, n_frames),
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
    return _cached(
        realistic_name(width_mbs, height_mbs, n_frames, seed),
        lambda: streams.realistic_stream(
            width_mbs=width_mbs, height_mbs=height_mbs, n_frames=n_frames,
            n_slices=n_slices, seed=seed)[0])


def parse_pictures(data: bytes, max_pics: int = None) -> list:
    """Run the host front end only (port of ``parse_pictures`` of the
    repository's ``tools/bench_common.py``); returns a list of
    (host_arrays, w_mbs, h_mbs, chroma_qp_offset, n_ref_slots), one per
    picture in decode order. A ``recon_strategy`` that returns
    ``SKIP_RECON`` consumes each picture: no pixel is reconstructed, and
    the DPB / POC bookkeeping runs as in a real decode (frames stay
    None)."""
    from ..core import decoder as DEC
    from ..core.recon import host_picture_arrays

    out = []

    def collect(dec, pic):
        if max_pics is None or len(out) < max_pics:
            out.append((host_picture_arrays(pic,
                                            dec.pps.chroma_qp_index_offset,
                                            dec.pps.constrained_intra_pred),
                        dec.sps.width_mbs, dec.sps.height_mbs,
                        dec.pps.chroma_qp_index_offset,
                        len(dec.dpb.buffer)))
        return DEC.SKIP_RECON

    dec = DEC.Decoder(device="cpu", recon_strategy=collect)
    try:
        dec.decode_annexb(data)
    finally:
        dec.close()
    return out


def annexb_prefix(data: bytes, n_pictures: int) -> bytes:
    """The bytes of an Annex-B stream up to the start code of the first
    slice of picture `n_pictures` (all of it when it holds no more
    pictures): a stream of its first `n_pictures` pictures. A picture
    starts at a slice NAL whose first_mb_in_slice is 0, which holds for
    streams without arbitrary slice order (the generator's and x264's)."""
    from ..bitstream.bitreader import (NAL_SLICE, NAL_SLICE_IDR, BitReader,
                                       split_nal_units, unescape_rbsp)

    if n_pictures < 1:
        raise ValueError(f"n_pictures must be >= 1, got {n_pictures}")
    seen = 0
    for off, payload in split_nal_units(data):
        if payload[0] & 0x1F not in (NAL_SLICE, NAL_SLICE_IDR):
            continue
        # first_mb_in_slice is the header's first field: a few bytes do
        if BitReader(unescape_rbsp(payload[1:8])).ue() != 0:
            continue
        if seen == n_pictures:
            cut = off - 3            # the start code's 00 00 01
            while cut > 0 and data[cut - 1] == 0:
                cut -= 1             # and the zero_byte of a 4-byte one
            return data[:cut]
        seen += 1
    return data


def reference_planes(w_mbs: int, h_mbs: int, n_slots: int, seed: int):
    """Random reference stacks for one picture step, drawn from `seed`
    in the port's layout: uint8 numpy ref_y [R, H, W] and ref_c
    [R, 2, H/2, W/2] (the JAX package's padded layout is made from these
    with its pad_luma / pad_chroma)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 256, (n_slots, 16 * h_mbs, 16 * w_mbs))
    c = rng.randint(0, 256, (n_slots, 2, 8 * h_mbs, 8 * w_mbs))
    return y.astype(np.uint8), c.astype(np.uint8)
