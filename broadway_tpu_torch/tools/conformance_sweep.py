#!/usr/bin/env python3
"""Randomized conformance sweep of the port, counterpart of the
repository's ``tools/conformance_sweep.py``: N generated streams across
the feature matrix (geometries, wild vectors, multi-ref, multi-slice with
deblock offsets, QP extremes, FMO, I_PCM), each decoded by the port's
``dectest`` CLI on the requested device and by the port's NumPy path
(``Decoder(recon="numpy")``, the reference inside the port, where the
repository's sweep runs the C oracle), the YUV outputs byte-compared.

  python3 -m broadway_tpu_torch.tools.conformance_sweep [-B cuda|cpu] \\
      [-N count] [--seed S]

-B cuda (the default) needs a card; exit 0 = every stream byte-equal.
"""

from __future__ import annotations

import contextlib
import io
import os
import random
import sys
import tempfile
from typing import Iterator, List, Tuple

from ..core.decoder import Decoder
from . import dectest, streams


def gen_streams(rng: random.Random, count: int
                ) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, bytes) covering the decode feature matrix (the
    repository's sweep's matrix, drawn from the port's generator)."""
    geoms = [(4, 3), (5, 4), (11, 7), (16, 9), (6, 5), (9, 2), (3, 8)]
    for i in range(count):
        w, h = geoms[rng.randrange(len(geoms))]
        kind = i % 6
        seed = rng.randrange(1 << 30)
        if kind == 0:       # wild out-of-picture MVs, multi-ref
            yield (f"wildmv-{w}x{h}-s{seed}",
                   streams.inter_stream(
                       width_mbs=w, height_mbs=h, n_frames=5, seed=seed,
                       deblock=True, mvd_range=rng.choice([200, 400, 700]),
                       num_ref_frames=2, multi_ref_idx=True)[0])
        elif kind == 1:     # multi-slice idc 0 with offsets
            yield (f"mslice-{w}x{h}-s{seed}",
                   streams.multislice_stream(
                       width_mbs=w, height_mbs=h, seed=seed,
                       n_slices=rng.randrange(2, 5), deblock_idc=0,
                       alpha_off=rng.randrange(-6, 7),
                       beta_off=rng.randrange(-6, 7))[0])
        elif kind == 2:     # intra mix, QP extremes
            yield (f"intra-{w}x{h}-s{seed}",
                   streams.intra_mixed_stream(
                       width_mbs=w, height_mbs=h, seed=seed,
                       deblock=True,
                       qp=rng.choice([0, 10, 28, 45, 51]))[0])
        elif kind == 3:     # FMO
            yield (f"fmo-{w}x{h}-s{seed}",
                   streams.fmo_stream(map_type=rng.randrange(7),
                                      width_mbs=w, height_mbs=h,
                                      seed=seed)[0])
        elif kind == 4:     # plain inter, long
            yield (f"inter-{w}x{h}-s{seed}",
                   streams.inter_stream(
                       width_mbs=w, height_mbs=h, n_frames=8, seed=seed,
                       deblock=True, mvd_range=60)[0])
        else:               # IPCM
            yield (f"ipcm-{w}x{h}-s{seed}",
                   streams.ipcm_stream(width_mbs=w, height_mbs=h,
                                       seed=seed)[0])


def reference_yuv(data: bytes) -> bytes:
    """The port's NumPy path's output: every picture's YUV, in order."""
    dec = Decoder(device="cpu", recon="numpy")
    try:
        return b"".join(o.frame.tobytes() for o in dec.decode_annexb(data))
    finally:
        dec.close()


def dectest_yuv(data: bytes, device, tmp: str) -> bytes:
    """What the port's dectest CLI writes for `data` on `device` (run in
    this process; its report lines are dropped)."""
    src, out = os.path.join(tmp, "in.h264"), os.path.join(tmp, "out.yuv")
    with open(src, "wb") as f:
        f.write(data)
    if os.path.exists(out):
        os.remove(out)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = dectest.main(["dectest", "-B", str(device), "-O" + out, src])
    if rc != 0:
        raise RuntimeError(f"dectest returned {rc}")
    with open(out, "rb") as f:
        return f.read()


def run_sweep(device="cuda", count: int = 12, seed: int = 20260821
              ) -> List[Tuple[str, bool]]:
    """Generate `count` streams from `seed` and decode each on `device`
    through the dectest CLI and with the NumPy path; returns (name,
    byte-equal) per stream."""
    rng = random.Random(seed)
    out = []
    with tempfile.TemporaryDirectory(prefix="bwsweep-") as tmp:
        for name, data in gen_streams(rng, count):
            out.append((name, dectest_yuv(data, device, tmp)
                        == reference_yuv(data)))
    return out


def main(argv) -> int:
    device, count, seed = "cuda", 12, 20260821
    i = 1
    while i < len(argv):
        if argv[i] == "-B":
            i += 1
            device = argv[i]
        elif argv[i] == "-N":
            i += 1
            count = int(argv[i])
        elif argv[i] == "--seed":
            i += 1
            seed = int(argv[i])
        else:
            print(__doc__)
            return 2
        i += 1
    results = run_sweep(device, count, seed)
    for name, ok in results:
        print(f"{'OK  ' if ok else 'FAIL'} {name}", flush=True)
    good = sum(ok for _, ok in results)
    print(f"{good}/{count} streams byte-equal to the NumPy path "
          f"(device {device})")
    return 0 if good == count else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
