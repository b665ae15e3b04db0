#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (broadway_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

It needs nothing but this repository's ``broadway_tpu_torch`` package,
torch, nvcc and g++. Phases (any failure exits non-zero; no phase's
failure is caught):
  1. toolchain: torch, CUDA, nvcc versions and the card's name/power limit
  2. build both native libraries from broadway_tpu_torch/csrc, side by
     side: the CUDA kernels (one nvcc per source) and the host front end
  3. the realistic 1920x1088 stream (8 slices, deblock idc 0, multi-ref;
     broadway_tpu_torch.tools.bench_common, cached under build/)
  4. per kernel, on the stream's IDR and first P picture at 1080p
     shapes: the CUDA kernel against its plain torch version on the same
     inputs (byte equality), both timed with CUDA events; the kernel's
     bound from this run's inputs (distinct bytes once each, or integer
     operations; K1's counts only the blocks that predict); K1 also
     beside an empty kernel of its grid and block (its launch floor,
     csrc/probe.cu), and on two synthetic 1080p vector fields with 16
     different vectors per MB, where it is slowest; the wavefront
     hand-off floor (the scaffold of K2/K3 with an empty MB body over
     120x68 MBs, in thread-block clusters of 8 rows as K2/K3 launch), one
     step of it inside a cluster and across clusters (120x8 MBs with C = 8
     and C = 1), the cluster size and the clusters resident; K2 and K3
     must launch in clusters; each picture of each kernel is held to the
     larger of its bound and its floor, ratio printed; then each kernel
     on a BATCH
     of the stream's first four pictures (IDR, P, P, P: one launch for
     all four), byte-equal to its plain version and to four launches of
     one picture, timed beside them; and the scaling table: for B = 1,
     2, 4, 8 pictures a round the batched step's device ops, host
     enqueue and device span, K1 / K2 / K3 and the hand-off probe at
     that B, the grid of K2 / K3 and the CTAs the card holds resident
  5. K2 and K3 at 4096x2176 (256x136 MBs, every MB with work, synthetic
     operands from a seed): kernel against plain over the whole picture,
     with the grid, cluster size and resident CTAs of each launch and the
     hand-off floors at that size
  6. the per-picture step on the P picture: host enqueue, device span,
     device kernels per step; beside it the same step as a CUDA graph of
     one picture, captured as the default path captures it
     (core.graphs.GroupGraph.record_and_replay after the eager warm-up):
     byte-equal to the eager step, the capture's ms by part (the device
     synchronize, gc.collect and empty_cache that torch.cuda.graph does on
     entry, timed apart and no longer done; the recorded enqueue;
     instantiate), the bytes the capture added to the pool, host ms per
     replay and device span
  7. end to end: the port's Decoder(device="cuda", parallel_slices=8)
     over the stream, every frame byte-equal to the port's NumPy path
     (Decoder(recon="numpy")); every kernel must have launched on that
     run, K2 and K3 once per picture on the device; then timed warm
     passes (median frames/s)
  8. the entry points on the same stream: MP4Player(device="cuda",
     render="rgb_int") on the port's own mux of it (YUV byte-equal to
     the NumPy path's frames, RGBA byte-equal to the asm.js formula in
     NumPy, K1/K2/K3 launched once per picture), SoftAvc(device="cuda")
     fed 64 KB buffers (the same bytes out, EOS on the last), and the
     YUV->RGB converters timed at 1920x1088; neither JAX nor the JAX
     package may load
  9. lockstep multi-stream decode at full width: four 1920x1088 streams
     (seeds 4242-4245; 4, 2, 2, 2 pictures, so three streams leave after
     round 2) through parallel.streams.decode_streams_lockstep(
     device="cuda"), each stream byte-equal to the port's single-stream
     Decoder(device="cuda") on the same bytes; K1, K2, K3 launched once a
     round (wrapper and device counts). The rounds run as one CUDA graph
     per key (core.graphs.GroupGraphs.round) on a lockstep set of the
     stack pool: call 1 captures the keys it meets twice, call 2 has one
     picture that the v2 packer is made to decline (the unpacked fallback
     on the card) and captures nothing; then B = 8, phase 3's stream and
     phase 11's streams (a) and (b) as eight streams of 4 pictures, twice:
     the first call captures its B = 8 P round and replays it, the second
     captures nothing. Every call's routes (eager, captured, replayed)
     must be the capture policy's on the rounds' keys, packed on the host;
     printed with each capture's ms by part and pool bytes, the round's
     host ms eager against replay, and the lockstep sets' pool stats.
     Aggregate frames/s beside four sequential single-stream decodes
     (warm passes, which capture nothing); call 2's declined picture takes
     the unpacked fallback (its route printed: eager, its key met once).
     Then Decoder(pack="v1") and Decoder(pack="none") on the first 3
     pictures of phase 3's stream, each through two decoders in turn,
     byte-equal to the v2 decode: every step the graph of its key
     (GroupGraphs.picture, kinds "v1" and "unpacked"), routes as the
     capture policy gives on the keys counted on the host (the first
     decoder captures, the second replays), each step's host ms by route
     and each capture printed
 10. frame groups at 1080p: phase 9's four streams concatenated into one
     10-picture stream (IDRs at 0, 4, 6, 8) through Decoder(device="cuda",
     parallel_slices=8, group_frames=G) for G = 2 and 4 (groups of 4, 4
     and 2), every frame byte-equal to the default Decoder(device="cuda")
     (one graph per picture key);
     K1, K2 and K3 once per picture, counted through the graphs' replays;
     once more with prefetch_outputs=True, the same bytes; graphs
     captured, capture ms and pool bytes per key, host ms per replayed
     group, and frames/s (median of warm passes, one decoder per setting
     kept across passes, so that its graphs are reused) default beside
     G = 2 and G = 4
 11. band sharding at 1080p (parallel.slices) on a mesh of the card four
     times, 17 MB rows a band: (a) a 4-slice idc-0 stream
     (tools.streams.realistic_stream(120, 68, n_frames=4, n_slices=4):
     the chained deblock, K3 over 18 rows with the ghost row), (b) a
     4-band idc-2 stream (banded_stream: independent bands), (c) phase 3's
     8-slice stream (slices cross the bands: every picture declined to the
     decoder's per-picture step on the card). With the stack pool
     emptied, each through decode_stream_sliced, every frame byte-equal
     to the single-card Decoder(device="cuda") and to the NumPy path
     (decoded in side processes meanwhile); the band step of the one-card
     mesh as one CUDA graph per key (GroupGraphs.picture, kind "band") on
     the decoder's pooled set: routes as the capture policy gives on the
     keys packed on the host, each step's host ms by route (eager: a
     key's first picture) and each capture's ms by part and pool bytes
     printed; K1, K2 and K3 counted through the replays on each run: 4 a
     picture on (a) and (b), 1 on (c); decode_streams_sliced_dp over a
     [2, 2] grid of the card on (b) and (a), twice, the second call
     capturing nothing; per band of the IDR and the first P
     picture of (a), K1's band form (mb0 > 0 from band 1), K2 over 17 rows
     and K3 over 18 against their plain versions, timed, with K3 over 17
     rows without the ghost row beside it; frames/s of each band path
     beside the single-card decoder (median of 3 passes, which capture
     nothing). One card shows the band machinery, not cross-card copies
     or scaling (phase 16 runs over distinct cards when there are two).
 12. a third-party encoder and the last tools, at full width: (a) the
     committed x264 1920x1080 stream (broadway_tpu_torch/tools/data/, 8
     pictures, 4 slices, 3 references, cropped from 1088) through
     Decoder(device="cuda", parallel_slices=8) with async_pump=False and
     True, every picture's md5 equal to the committed JSON's (made once
     with the JAX package's CPU decoder), K1, K2 and K3 once a picture
     (device counts for K2 / K3), frames/s of both settings (median of 3
     warm passes, in turns), and the same two settings on phase 3's
     stream; (b) K1 on the x264 stream's first P picture against its
     plain version, timed as phase 4 times it, its bound from this run's
     inputs, the share of predicting MBs with more than one vector and
     with more than one fraction (beside phase 3's P picture); (c)
     tools.demo.tree on the port's MP4 mux of the x264 stream on the card,
     md5s equal to the JSON's; (d) tools.demo.story on a CIF stream (22x18
     MBs, 6 pictures, deblock, 3 references; generated in a side process)
     three times: six players at once, four pumped decoders on the card on
     four threads and two on the CPU, every player's YUV byte-equal to the
     NumPy path and K1 / K2 / K3 exactly 4 a picture; (e)
     tools.conformance_sweep.run_sweep("cuda", 12, 20260821), all 12
     byte-equal to the NumPy path.
 13. the port's benchmark in its short form, in this process:
     tools.bench.run(plan="quick", device="cuda"): every section (e2e
     pump on and off on phase 3's stream and the x264 fixture, lockstep
     B = 2 on phase 9's first two streams, 2 pictures of the 3840x2160
     realistic stream and of the dense 1080p stream, both generated in
     side processes at start-up, the pipeline's run_stages 0-3 on phase
     3's P picture, the stage table, host delivery and the link) present,
     run to its end, every picture equal to the committed md5s
     (tools/data/bench_md5.json, made by the JAX package's NumPy decoder),
     and K1, K2 and K3 launched in it.
 14. the default path's graphs (core/graphs.py): with the stack pool
     emptied, phase 3's stream through two default decoders in turn
     (Decoder(device="cuda", parallel_slices=8), the pump on), every frame
     byte-equal to the port's NumPy path (phase 7's), K1, K2 and K3 once a
     picture, replays counted; each picture's route (eager: a key's first
     picture for its decoder; captured at a key's second; replayed), the
     first decoder capturing at least one key and the second none; the
     keys of the stream, each capture's ms by part and pool bytes, host ms
     of each replay against each eager enqueue (both timed on the pump's
     worker), the pool's sets and bytes; beside them phase 7's launches
     per picture and phase 12 (d)'s launches per story run.
 15. the multi-process path on the card (parallel.multihost): two ranks,
     each a process with its own time limit, join one job with
     init_multihost's default backend (NCCL); each takes the card that
     rank_cards gives it (both share the card on a one-card machine; cards
     0 and 1 with two or more) and decodes its share of phase 9's three
     short 1080p streams (2 pictures each); the exchange runs over a gloo
     group of the job; every stream byte-equal, on both ranks, to the
     single-card decoder; world size, each rank's card and the backends
     printed. With four cards or more, once more with sp_bands=2 on
     phase 11's (a) and (b): each rank's bands over its own two cards.
 16. band sharding over distinct cards, with two cards or more (one band
     a card: cards 0-3 with four, else 0-1): phase 11's (a) and (b)
     through decode_stream_sliced twice, each frame byte-equal to the
     single-card decoder, the band step as a CUDA graph per card and a
     gather graph per card (core.graphs.MeshGraph: the halo chain and the
     gather as peer copies ordered by events), routes as counted on the
     host (multi_card_eager / _captured / _replayed; the second call
     capturing nothing), K1, K2 and K3 once a band and picture, host ms by
     route and by card, each capture by card. With one card it prints one
     line saying that it did not run, and why.
The last lines of stdout: the scaling table (JSON), the kernels' JSON
record, the nvidia-smi name/power-limit line, and {"ok": true,
"device": ...}.
Exits non-zero and prints no result without CUDA.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 4
WARM_PASSES = 5
TOL = 0      # decoding is integer-exact: every comparison is byte equality
K1_REPS = 50   # launches per timing of K1 (tens of microseconds each)
HOLD_MS = 40.0               # stream hold ahead of the short timings
SM_CLOCK_KHZ = 1.98e6        # H100 SXM boost clock: cycles per ms, at most
LOCKSTEP_STREAMS = ((4242, 4), (4243, 2), (4244, 2), (4245, 2))  # seed, frames
SCALING_BATCHES = (1, 2, 4, 8)
N_BANDS = 4                  # phase 11: 68 MB rows, 17 a band
BAND_PASSES = 3
# phase 11's streams beside phase 3's: (label, generator, arguments)
BAND_STREAMS = (
    ("a", "realistic_stream", dict(width_mbs=120, height_mbs=68, n_frames=4,
                                   n_slices=4)),
    ("b", "banded_stream", dict(width_mbs=120, height_mbs=68, n_bands=4,
                                n_frames=4, deblock_idc=2)),
)
BIG = (256, 136)             # 4096x2176: more rows than SMs, every MB busy
# phase 12: the story's CIF stream, the sweep (the committed x264
# fixture is tools.bench.X264)
STORY_STREAM = ("inter_stream", dict(width_mbs=22, height_mbs=18, n_frames=6,
                                     seed=352288, deblock=True,
                                     num_ref_frames=3, multi_ref_idx=True,
                                     mvd_range=60))
STORY_RUNS = 3
PUMP_PASSES = 3
SWEEP = (12, 20260821)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
INT_OPS_PER_S = 33.5e12      # int32 outside the tensor cores: half of 67 T

# kernel name -> (source, TPU kernel it replaces)
KERNELS = {
    "K1_mc": ("broadway_tpu_torch/csrc/mc.cu",
              "broadway_tpu/ops/tpu/mc_pallas.py:391"),
    "K2_intra": ("broadway_tpu_torch/csrc/intra.cu",
                 "broadway_tpu/ops/tpu/wavefront_pallas.py:496"),
    "K3_deblock": ("broadway_tpu_torch/csrc/deblock.cu",
                   "broadway_tpu/ops/tpu/wavefront_pallas.py:152"),
}


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int, hold_ms: float = 0.0) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA
    events around `reps` calls after one warm-up call). With hold_ms the
    stream is first kept busy for about that long (one spinning thread),
    so that the calls queue up behind it and the events read the device
    even where a call is shorter than its enqueue on the host: the hold
    must outlast the host's time for the `reps` calls, which is checked.
    A busy host (the side processes of the start-up generate streams on
    its cores) can take longer: the timing is then taken again with the
    hold doubled, up to 8 x hold_ms, and never read while the host was
    behind."""
    import torch
    fn()
    for hold in (hold_ms, 2 * hold_ms, 4 * hold_ms, 8 * hold_ms):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            from broadway_tpu_torch.ops.gpu import probe
            torch.cuda.synchronize()
            held = torch.cuda.Event()
            probe.hold_stream(int(hold * SM_CLOCK_KHZ), "cuda")
            held.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        behind = hold and held.query()
        torch.cuda.synchronize()
        if not behind:
            return start.elapsed_time(end) / reps
    raise AssertionError(f"the stream was held for up to {8 * hold_ms} ms "
                         f"but enqueueing {reps} calls took longer: the "
                         "timing would read the host")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    integer operations over the int32 rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bound_bytes": int(nbytes)}


def _mark(mask, slot, rows, cols, keep, H: int, W: int) -> None:
    idx = (slot * H + rows.clamp(0, H - 1)) * W + cols.clamp(0, W - 1)
    mask[idx[keep]] = True


def k1_distinct_ref_pels(ref_y, ref_c, mv, rb, w: int, h: int,
                         mb0: int = 0) -> int:
    """Reference pels that this picture's vectors point at, each counted
    once; a block with ref_blk < 0 predicts nothing and points at none.
    Per predicting 4x4 block the 4x4 window at its integer vector, widened to
    9 columns / 9 rows where the vector has a horizontal / vertical
    fraction (a 5-wide cross where only the two half-pel lines are
    averaged); per 2x2 chroma block 2 or 3 columns and rows, in both
    planes. mb0: the MBs are a band whose first MB is raster MB mb0."""
    import torch
    R, H, W = ref_y.shape
    dev = mv.device
    n = mv.shape[0]
    mb = mb0 + torch.arange(n, device=dev)
    bx = torch.arange(4, device=dev)[None, None, :]
    by = torch.arange(4, device=dev)[None, :, None]
    px = ((mb % w) * 16)[:, None, None] + bx * 4 + 0 * by
    py = ((mb // w) * 16)[:, None, None] + by * 4 + 0 * bx
    px, py = px.reshape(-1), py.reshape(-1)
    mvx = mv[..., 0].reshape(-1).long()
    mvy = mv[..., 1].reshape(-1).long()
    used = rb.reshape(-1) >= 0
    slot = rb.reshape(-1).clamp(0, R - 1).long()
    fx, fy = mvx & 3, mvy & 3
    cross = (fx & 1).bool() & (fy & 1).bool()   # b and h averaged, no j
    x0, y0 = px + (mvx >> 2) - 2, py + (mvy >> 2) - 2
    mask = torch.zeros(R * H * W, dtype=torch.bool, device=dev)
    for dy in range(9):
        row_ok = (fy != 0) if not 2 <= dy <= 5 else torch.ones_like(cross)
        for dx in range(9):
            col_ok = (fx != 0) if not 2 <= dx <= 5 else torch.ones_like(cross)
            keep = used & row_ok & col_ok
            if not (2 <= dy <= 6 or 2 <= dx <= 6):
                keep = keep & ~cross
            _mark(mask, slot, y0 + dy, x0 + dx, keep, H, W)
    luma = int(mask.sum())
    Hc, Wc = ref_c.shape[-2:]
    cx0, cy0 = px // 2 + (mvx >> 3), py // 2 + (mvy >> 3)
    mask = torch.zeros(R * Hc * Wc, dtype=torch.bool, device=dev)
    always = torch.ones_like(cross)
    for dy in range(3):
        row_ok = ((mvy & 7) != 0) if dy == 2 else always
        for dx in range(3):
            col_ok = ((mvx & 7) != 0) if dx == 2 else always
            _mark(mask, slot, cy0 + dy, cx0 + dx, used & row_ok & col_ok, Hc,
                  Wc)
    return luma + 2 * int(mask.sum())


def k1_bound(ref_y, ref_c, mv, rb, out, w: int, h: int, mb0: int = 0):
    # the reference pels the predicting blocks' vectors point at, once
    # each; the vectors and reference indices; one byte per pel written
    # (a block with ref_blk < 0 writes 0 and reads no reference); ~40
    # integer operations per PREDICTED pel (6-tap both ways, rounding,
    # clip): 16 luma + 8 chroma pels for each block with ref_blk >= 0,
    # none for the others, so an all-intra picture is bound by its bytes
    pels = out[0].numel() + out[1].numel()
    predicted = 24 * int((rb >= 0).sum())
    return bound(k1_distinct_ref_pels(ref_y, ref_c, mv, rb, w, h, mb0)
                 + _nbytes(mv, rb) + pels, 40 * predicted)


def k1_batch_bound(ref_y, ref_c, mv, rb, out, w: int, h: int, B: int):
    """K1's bound on a batch of B pictures (stacks [B*R, ...]): the sum of
    the pictures' bounds, each against its own reference planes."""
    n, R = w * h, ref_y.shape[0] // B
    bs = [k1_bound(ref_y[b * R:(b + 1) * R], ref_c[b * R:(b + 1) * R],
                   mv[b * n:(b + 1) * n], rb[b * n:(b + 1) * n],
                   [o[b * n:(b + 1) * n] for o in out], w, h)
          for b in range(B)]
    return {"bound_bytes": sum(b["bound_bytes"] for b in bs),
            "bound_ms": sum(b["bound_ms"] for b in bs),
            "bound_by": max(bs, key=lambda b: b["bound_ms"])["bound_by"]}


def k1_extras(r, label, ref_y, mv, rb, w: int, h: int, reps: int) -> None:
    """K1 beside an empty kernel of the same grid and block
    ("bound_launch_ms": what launching K1's CTAs for w * h MBs costs
    whatever they compute)."""
    from broadway_tpu_torch.ops.gpu import mc_kernel as K1
    from broadway_tpu_torch.ops.gpu import probe
    used = rb >= 0
    ctas, threads = K1.launch_shape(mv.shape[0])
    floor = cuda_ms(lambda: probe.launch_probe(ctas, threads, ref_y.device),
                    reps, HOLD_MS)
    r.setdefault("bound_launch_ms", []).append(floor)
    r["per_picture"][label].update(
        bound_launch_ms=floor, predicting_blocks=int(used.sum()))
    log(f"  K1_mc {label}: empty launch of K1's grid for {mv.shape[0]} MBs "
        f"({ctas} CTAs of {threads}) {floor:.5f} ms, {int(used.sum())} of "
        f"{used.numel()} blocks predict")


K1_SYNTHETIC = ("sixteen_vectors", "random_slots_300")


def k1_synthetic_phase(device, w: int = 120, h: int = 68, R: int = 3,
                       reps: int = K1_REPS) -> dict:
    """K1 where it is slowest: every MB of a 1080p picture with 16
    different vectors, fractions and slots (tools.synth.mc_operands),
    which the realistic stream hardly has. Kernel against plain (byte
    equality), kernel timed; not part of the means."""
    import numpy as np
    import torch

    from broadway_tpu_torch.ops.gpu import inter
    from broadway_tpu_torch.ops.gpu import mc_kernel as K1
    from broadway_tpu_torch.tools import synth

    rng = np.random.RandomState(68)
    ref_y = torch.from_numpy(rng.randint(0, 256, (R, 16 * h, 16 * w),
                                         dtype=np.uint8)).to(device)
    ref_c = torch.from_numpy(rng.randint(0, 256, (R, 2, 8 * h, 8 * w),
                                         dtype=np.uint8)).to(device)
    out = {}
    for case in K1_SYNTHETIC:
        mv, rb = (torch.from_numpy(a).to(device)
                  for a in synth.mc_operands(case, w, h, R))
        args = (ref_y, ref_c, mv, rb, w, h)
        got = K1.mc_predict(*args)
        want = inter.mc_predict_plain(*args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"K1_mc differs from its plain version on "
                                 f"the synthetic case {case}")
        bnd = k1_bound(ref_y, ref_c, mv, rb, got, w, h)
        ms = cuda_ms(lambda: K1.mc_predict(*args), reps, HOLD_MS)
        out[case] = {"ms": ms,
                     "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
                     "ms_over_bound": ms / bnd["bound_ms"]}
        log(f"  K1_mc synthetic {case} ({w}x{h} MBs): kernel {ms:.4f} ms = "
            f"{ms / bnd['bound_ms']:.2f}x its bound {bnd['bound_ms']:.5f} ms "
            f"({bnd['bound_by']}), byte-equal to plain")
    return out


def k2_bound(Pi, n_mbs: int):
    # all params are scanned; an intra MB reads its residuals (1536 B),
    # 71 neighbour pels and writes 384 pels; ~12 operations per pel
    busy = int(((Pi[:, 4] | Pi[:, 5]) != 0).sum())
    return bound(n_mbs * 128 + busy * (1536 + 71 + 384), busy * 384 * 12), busy


def k3_bound(Pd, n_mbs: int):
    # the bS half of the params is scanned for all MBs; a busy MB reads
    # the other half and its own 384 pels and writes them back (the pels
    # it changes in its left and upper neighbours are those MBs' own);
    # ~30 operations per luma line of an edge, 128 lines + chroma
    busy = int((Pd[:, :32] != 0).any(dim=1).sum())
    return bound(n_mbs * 128 + busy * (128 + 2 * 384), busy * 192 * 30), busy


def kernel_phase(pictures, device, seed: int = 0, reps: int = 10,
                 plain_reps: int = 1):
    """Each kernel against its plain version on the same inputs, at the
    pictures' shapes. Returns {name: {"max_abs_err", "ms", "plain_ms",
    "bound_ms", ...}} (times are means over the pictures; None off CUDA)."""
    import numpy as np
    import torch

    from broadway_tpu_torch.core.packed import unpack_arrs_v2
    from broadway_tpu_torch.core.recon import decode_picture
    from broadway_tpu_torch.ops.gpu import inter, intra, deblock
    from broadway_tpu_torch.ops.gpu import mc_kernel as K1
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
    from broadway_tpu_torch.ops.gpu.residual import residual_stage

    on_cuda = torch.device(device).type == "cuda"
    rng = np.random.RandomState(seed)
    res = {k: {"max_abs_err": 0, "ms": [], "plain_ms": [], "bound_ms": [],
               "bound_bytes": [], "bound_by": None, "per_picture": {}}
           for k in KERNELS}

    def record(name, got, want, run, run_plain, label, bnd, busy=None,
               reps=reps, hold_ms=0.0):
        err = max(int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
                  for g, w in zip(got, want))
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if err > TOL:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"on the {label} picture: max |err| {err}")
        if bnd["bound_ms"] >= max(r["bound_ms"], default=0.0):
            r["bound_by"] = bnd["bound_by"]     # of the larger bound
        r["bound_ms"].append(bnd["bound_ms"])
        r["bound_bytes"].append(bnd["bound_bytes"])
        if on_cuda:
            ms = cuda_ms(run, reps, hold_ms)
            pms = cuda_ms(run_plain, plain_reps)
            r["ms"].append(ms)
            r["plain_ms"].append(pms)
            r["per_picture"][label] = {"ms": ms, "plain_ms": pms,
                                       "bound_ms": bnd["bound_ms"],
                                       "bound_by": bnd["bound_by"],
                                       "busy_mbs": busy}
            if not hold_ms:
                # the same launches behind a held stream: the device's
                # time alone, where a short launch would read its enqueue
                dms = cuda_ms(run, reps, HOLD_MS)
                r["per_picture"][label]["device_ms"] = dms
                r.setdefault("device_ms", []).append(dms)
            dev_txt = ("" if hold_ms else f" (held stream: "
                       f"{r['per_picture'][label]['device_ms']:.4f} ms)")
            log(f"  {name} {label}: kernel {ms:.4f} ms{dev_txt}, plain "
                f"{pms:.4f} ms, "
                f"bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']}, "
                f"{bnd['bound_bytes']} B"
                + (f", {busy} busy MBs" if busy is not None else "")
                + f"), max |err| {err}")
        else:
            log(f"  {name} {label}: max |err| {err}")

    for label, (buf, bk, lay, ci, co, R) in zip(("IDR", "P"), pictures):
        w, h = lay.w, lay.h
        arrs = unpack_arrs_v2(torch.from_numpy(buf).to(device), lay, bk, ci,
                              co)
        ref_y = torch.from_numpy(rng.randint(0, 256, (R, 16 * h, 16 * w),
                                             dtype=np.uint8)).to(device)
        ref_c = torch.from_numpy(rng.randint(
            0, 256, (R, 2, 8 * h, 8 * w), dtype=np.uint8)).to(device)
        mv, rb = arrs["mv"], arrs["ref_blk"]

        got = K1.mc_predict(ref_y, ref_c, mv, rb, w, h)
        want = inter.mc_predict_plain(ref_y, ref_c, mv, rb, w, h)
        record("K1_mc", got, want,
               lambda: K1.mc_predict(ref_y, ref_c, mv, rb, w, h),
               lambda: inter.mc_predict_plain(ref_y, ref_c, mv, rb, w, h),
               label, k1_bound(ref_y, ref_c, mv, rb, got, w, h),
               reps=K1_REPS, hold_ms=HOLD_MS)
        if on_cuda:
            k1_extras(res["K1_mc"], label, ref_y, mv, rb, w, h, K1_REPS)

        Y0, C0 = decode_picture(arrs, ref_y, ref_c, w, h, co, run_stages=1)
        RY, RC = residual_stage(arrs, co)
        Pi = intra.intra_params(arrs)
        Yk, Ck, Yp, Cp = Y0.clone(), C0.clone(), Y0.clone(), C0.clone()
        KW.intra_wavefront(Yk, Ck, RY, RC, Pi, w, h)
        intra.intra_wavefront_plain(Yp, Cp, RY, RC, Pi, w, h)
        Ys, Cs = Y0.clone(), C0.clone()
        bnd, busy = k2_bound(Pi, w * h)
        record("K2_intra", (Yk, Ck), (Yp, Cp),
               lambda: KW.intra_wavefront(Ys, Cs, RY, RC, Pi, w, h),
               lambda: intra.intra_wavefront_plain(Ys, Cs, RY, RC, Pi, w, h),
               label, bnd, busy)

        Pd = deblock.deblock_params(arrs, w, h)
        Y1, C1 = Yk, Ck
        Yk, Ck, Yp, Cp = Y1.clone(), C1.clone(), Y1.clone(), C1.clone()
        KW.deblock_wavefront(Yk, Ck, Pd, w, h)
        deblock.deblock_wavefront_plain(Yp, Cp, Pd, w, h)
        Ys, Cs = Y1.clone(), C1.clone()
        bnd, busy = k3_bound(Pd, w * h)
        record("K3_deblock", (Yk, Ck), (Yp, Cp),
               lambda: KW.deblock_wavefront(Ys, Cs, Pd, w, h),
               lambda: deblock.deblock_wavefront_plain(Ys, Cs, Pd, w, h),
               label, bnd, busy)

    if on_cuda:
        # the 1080p launches' geometry: clusters of KW.CLUSTER rows
        for name, which in (("K2_intra", KW.INTRA),
                            ("K3_deblock", KW.DEBLOCK)):
            res[name].update(cluster=KW.last_cluster(which),
                             grid=KW.last_grid(which),
                             resident_ctas=KW.last_resident(which))
            if res[name]["cluster"] <= 1:
                raise AssertionError(f"{name} did not launch in clusters")
    for r in res.values():
        for k in ("ms", "plain_ms", "bound_ms", "bound_bytes",
                  "bound_launch_ms", "device_ms"):
            if k in r:
                r[k] = sum(r[k]) / len(r[k]) if r[k] else None
    return res


def handoff_phase(w: int, h: int, device, reps: int = 20) -> dict:
    """The dependency floor of a wavefront kernel: the scaffold with an
    empty MB body over w x h MBs is w + 2 (h - 1) hand-offs in a row, in
    clusters of KW.CLUSTER rows as K2 and K3 run. Beside it, one step of
    the chain inside a cluster (C rows in one cluster: every hand-off
    through the ring) and across clusters (the same rows with C = 1: every
    hand-off through the global counters), over w x C MBs."""
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
    C = KW.CLUSTER
    ms = cuda_ms(lambda: KW.handoff_probe(w, h, device), reps)
    grid, resident = KW.last_grid(KW.PROBE), KW.last_resident(KW.PROBE)
    chain = w + 2 * (h - 1)
    short = w + 2 * (C - 1)
    in_ms = cuda_ms(lambda: KW.handoff_probe(w, C, device), reps)
    across_ms = cuda_ms(lambda: KW.handoff_probe(w, C, device, cluster=1),
                        reps)
    out = {"handoff_floor_ms": ms, "handoffs": chain,
           "handoff_us": 1e3 * ms / chain, "cluster": C, "grid": grid,
           "resident_ctas": resident, "resident_clusters": resident // C,
           "in_cluster_us": 1e3 * in_ms / short,
           "across_cluster_us": 1e3 * across_ms / short}
    log(f"  hand-off floor {w}x{h}: {ms:.4f} ms for {chain} dependent "
        f"hand-offs = {out['handoff_us']:.3f} us each ({grid} CTAs in "
        f"clusters of {C}, {resident // C} clusters resident); one step "
        f"over {w}x{C} MBs: {out['in_cluster_us']:.3f} us inside a cluster, "
        f"{out['across_cluster_us']:.3f} us across clusters")
    return out


def big_phase(device, seed: int = 2176, reps: int = 5) -> dict:
    """K2 and K3 at BIG MBs with work in every MB (synthetic operands):
    kernel against plain over the WHOLE picture (no crop: the plain
    versions take some tens of seconds there, which the run affords)."""
    import numpy as np
    import torch

    from broadway_tpu_torch.ops.gpu import intra, deblock
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
    from broadway_tpu_torch.tools import synth

    w, h = BIG

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = {}
    Y0, C0 = (t(a) for a in synth.planes(w, h, seed))
    RY, RC, P = (t(a) for a in synth.intra_operands(w, h, seed + 1, "intra"))
    Yk, Ck, Yp, Cp = Y0.clone(), C0.clone(), Y0.clone(), C0.clone()
    KW.intra_wavefront(Yk, Ck, RY, RC, P, w, h)
    t0 = time.perf_counter()
    intra.intra_wavefront_plain(Yp, Cp, RY, RC, P, w, h)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not (torch.equal(Yk, Yp) and torch.equal(Ck, Cp)):
        raise AssertionError(f"K2_intra differs from plain at {w}x{h} MBs")
    ms = cuda_ms(lambda: KW.intra_wavefront(Yk, Ck, RY, RC, P, w, h), reps)
    out["K2_intra"] = {"ms": ms, "plain_ms": 1e3 * plain_s,
                       "grid": KW.last_grid(KW.INTRA),
                       "cluster": KW.last_cluster(KW.INTRA),
                       "resident_ctas": KW.last_resident(KW.INTRA)}

    Y0, C0 = (t(a) for a in synth.planes(w, h, seed + 2, smooth=True))
    P = t(synth.deblock_operands(w, h, seed + 3, "intra"))
    Yk, Ck, Yp, Cp = Y0.clone(), C0.clone(), Y0.clone(), C0.clone()
    KW.deblock_wavefront(Yk, Ck, P, w, h)
    t0 = time.perf_counter()
    deblock.deblock_wavefront_plain(Yp, Cp, P, w, h)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if torch.equal(Yp, Y0):
        raise AssertionError("the synthetic deblock picture filtered nothing")
    if not (torch.equal(Yk, Yp) and torch.equal(Ck, Cp)):
        raise AssertionError(f"K3_deblock differs from plain at {w}x{h} MBs")
    ms = cuda_ms(lambda: KW.deblock_wavefront(Yk, Ck, P, w, h), reps)
    out["K3_deblock"] = {"ms": ms, "plain_ms": 1e3 * plain_s,
                         "grid": KW.last_grid(KW.DEBLOCK),
                         "cluster": KW.last_cluster(KW.DEBLOCK),
                         "resident_ctas": KW.last_resident(KW.DEBLOCK)}
    for k, v in out.items():
        log(f"  {k} {w}x{h} MBs, every MB busy: kernel {v['ms']:.4f} ms, "
            f"plain {v['plain_ms']:.1f} ms, {v['grid']} CTAs in clusters "
            f"of {v['cluster']} ({v['resident_ctas']} resident), byte-equal")
    probe = handoff_phase(w, h, device, reps=5)
    out["handoff_floor_ms"] = probe["handoff_floor_ms"]
    out["handoff"] = probe
    return out


def device_ops(fn):
    """(device operations, their milliseconds in sum) that one call of fn
    puts on the card: kernels, copies and memsets as torch.profiler traces
    them. The sum is the time the card is busy for one call, whatever the
    host takes to enqueue it. (None, None) if the profiler sees no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None
               and "cuda" in str(e.device_type).lower()]
    if not on_card:
        return None, None
    return len(on_card), sum(e.time_range.elapsed_us()
                             for e in on_card) / 1e3


def enqueue_and_span_ms(fn, reps: int):
    """(host milliseconds to enqueue one call of fn, device milliseconds
    per call between CUDA events), over `reps` calls in a row after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return host_ms, start.elapsed_time(end) / reps


def _batch_operands(pics, device, seed: int):
    """B packed pictures of one geometry as one batch on the card: the
    unpacked dict, random reference stacks [B*R, ...], and (w, h, chroma
    offset, R, the uploaded buffers, their common bucket triple)."""
    import numpy as np
    import torch

    from broadway_tpu_torch.core.packed import expand_buf_v2, unpack_arrs_v2
    lay, ci, co, R = pics[0][2], pics[0][3], pics[0][4], pics[0][5]
    BK = tuple(max(p[1][j] for p in pics) for j in range(3))
    bufs = torch.from_numpy(np.stack(
        [expand_buf_v2(p[0], lay, p[1], BK) for p in pics])).to(device)
    arrs = unpack_arrs_v2(bufs, lay, BK, ci, co)
    B, w, h = len(pics), lay.w, lay.h
    rng = np.random.RandomState(seed)
    ref_y = torch.from_numpy(rng.randint(
        0, 256, (B * R, 16 * h, 16 * w), dtype=np.uint8)).to(device)
    ref_c = torch.from_numpy(rng.randint(
        0, 256, (B * R, 2, 8 * h, 8 * w), dtype=np.uint8)).to(device)
    return arrs, ref_y, ref_c, (w, h, co, R, bufs, BK)


def _wave_operands(arrs, ref_y, ref_c, w, h, co, B):
    """The batch's K2 and K3 operands: base planes, residuals, params."""
    from broadway_tpu_torch.core.recon import decode_picture
    from broadway_tpu_torch.ops.gpu import deblock, intra
    from broadway_tpu_torch.ops.gpu.residual import residual_stage
    Y0, C0 = decode_picture(arrs, ref_y, ref_c, w, h, co, run_stages=1,
                            batch=B)
    RY, RC = residual_stage(arrs, co)
    return (Y0, C0, RY, RC, intra.intra_params(arrs),
            deblock.deblock_params(arrs, w, h))


def batched_kernel_phase(pics, device, reps: int = 10) -> dict:
    """K1, K2 and K3 on a batch of len(pics) different 1080p pictures (an
    IDR among P pictures, as unequal streams give a lockstep round): one
    launch for all, byte-equal to the plain version on the same operands
    and to one launch per picture; the batch timed beside those launches
    in a row; the bound is the sum of the pictures' bounds (bytes and
    operations grow with the batch; the hand-off floor does not)."""
    import torch

    from broadway_tpu_torch.ops.gpu import deblock, inter, intra
    from broadway_tpu_torch.ops.gpu import mc_kernel as K1
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW

    B = len(pics)
    arrs, ref_y, ref_c, (w, h, co, R, _, _) = _batch_operands(pics, device, 4)
    n = w * h
    out = {}

    def same(got, want, name, what):
        err = max(int((g.int() - x.int()).abs().max())
                  for g, x in zip(got, want))
        if err > TOL:
            raise AssertionError(f"{name} on a batch of {B} differs from "
                                 f"{what}: max |err| {err}")
        return err

    def put(name, err, ms, plain_ms, singles_ms, bnd):
        out[name] = {"B": B, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms,
                     "ms_single_launches_in_a_row": singles_ms,
                     "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
                     "bound_bytes": bnd["bound_bytes"]}
        log(f"  {name} batch of {B} (IDR, P, P, P): one launch {ms:.4f} ms, "
            f"{B} launches in a row {singles_ms:.4f} ms, plain "
            f"{plain_ms:.1f} ms, bound {bnd['bound_ms']:.5f} ms "
            f"({bnd['bound_by']}), max |err| {err}")

    # ---- K1 ---------------------------------------------------------------
    mv, rb = arrs["mv"], arrs["ref_blk"]
    cut = [slice(b * n, (b + 1) * n) for b in range(B)]
    stk = [slice(b * R, (b + 1) * R) for b in range(B)]
    got = K1.mc_predict(ref_y, ref_c, mv, rb, w, h)
    t0 = time.perf_counter()
    want = inter.mc_predict_plain(ref_y, ref_c, mv, rb, w, h)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = same(got, want, "K1_mc", "its plain version")
    ones = [K1.mc_predict(ref_y[stk[b]], ref_c[stk[b]], mv[cut[b]],
                          rb[cut[b]], w, h) for b in range(B)]
    same(got, [torch.cat([o[k] for o in ones]) for k in range(2)], "K1_mc",
         f"{B} launches of one picture")

    def k1_singles():
        for b in range(B):
            K1.mc_predict(ref_y[stk[b]], ref_c[stk[b]], mv[cut[b]],
                          rb[cut[b]], w, h)

    bnd = k1_batch_bound(ref_y, ref_c, mv, rb, got, w, h, B)
    put("K1_mc", err,
        cuda_ms(lambda: K1.mc_predict(ref_y, ref_c, mv, rb, w, h), K1_REPS,
                HOLD_MS),
        plain_ms, cuda_ms(k1_singles, K1_REPS, HOLD_MS), bnd)

    # ---- K2, K3 -----------------------------------------------------------
    Y0, C0, RY, RC, Pi, Pd = _wave_operands(arrs, ref_y, ref_c, w, h, co, B)

    def wave(name, run, run_plain, Ya, Ca, ops, bnd):
        Yk, Ck, Yp, Cp = Ya.clone(), Ca.clone(), Ya.clone(), Ca.clone()
        run(Yk, Ck, *ops)
        t0 = time.perf_counter()
        run_plain(Yp, Cp, *ops)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = same((Yk, Ck), (Yp, Cp), name, "its plain version")
        Y1, C1 = Ya.clone(), Ca.clone()

        def singles():
            for b in range(B):
                run(Y1[b], C1[b], *(o[cut[b]] for o in ops))

        singles()
        same((Yk, Ck), (Y1, C1), name, f"{B} launches of one picture")
        Ys, Cs = Ya.clone(), Ca.clone()
        put(name, err, cuda_ms(lambda: run(Ys, Cs, *ops), reps), plain_ms,
            cuda_ms(singles, reps), bnd)
        return Yk, Ck

    Y1, C1 = wave(
        "K2_intra",
        lambda Y, C, *o: KW.intra_wavefront(Y, C, *o, w, h),
        lambda Y, C, *o: intra.intra_wavefront_plain(Y, C, *o, w, h),
        Y0, C0, (RY, RC, Pi), k2_bound(Pi, B * n)[0])
    wave("K3_deblock",
         lambda Y, C, *o: KW.deblock_wavefront(Y, C, *o, w, h),
         lambda Y, C, *o: deblock.deblock_wavefront_plain(Y, C, *o, w, h),
         Y1, C1, (Pd,), k3_bound(Pd, B * n)[0])
    for name, which in (("K2_intra", KW.INTRA), ("K3_deblock", KW.DEBLOCK)):
        out[name]["resident_ctas"] = KW.last_resident(which)
    return out


def scaling_phase(pics, idr, device, reps: int = 20) -> list:
    """How the batched step grows with the pictures in a round. For each
    B: the step (decode_pictures_packed_batch on B P pictures, `pics`
    taken in turn) as device ops and their device time in sum (one
    profiled call), host enqueue and device span; K1 / K2 /
    K3 alone on those operands and on B copies of the IDR picture (every
    MB intra: the whole hand-off chain); the grid of the K2 / K3 launch
    beside the CTAs the card holds resident; the hand-off probe at B."""
    import torch

    from broadway_tpu_torch.core.recon import decode_pictures_packed_batch
    from broadway_tpu_torch.ops.gpu import mc_kernel as K1
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW

    rows = []
    for B in SCALING_BATCHES:
        row = {"B": B}
        for mix, src in (("P", [pics[b % len(pics)] for b in range(B)]),
                         ("IDR", [idr] * B)):
            arrs, ref_y, ref_c, (w, h, co, R, bufs, BK) = _batch_operands(
                src, device, 40 + B)
            lay, ci = src[0][2], src[0][3]
            if mix == "P":
                sy = torch.zeros((B, R, 16 * h, 16 * w), dtype=torch.uint8,
                                 device=device)
                sc = torch.zeros((B, R, 2, 8 * h, 8 * w), dtype=torch.uint8,
                                 device=device)

                def step():
                    decode_pictures_packed_batch(bufs, sy, sc, [0] * B, lay,
                                                 BK, ci, co)

                host_ms, dev_ms = enqueue_and_span_ms(step, reps)
                n_ops, busy_ms = device_ops(step)
                row.update(device_ops=n_ops, device_busy_ms=busy_ms,
                           host_enqueue_ms=host_ms, device_span_ms=dev_ms)
            mv, rb = arrs["mv"], arrs["ref_blk"]
            Y0, C0, RY, RC, Pi, Pd = _wave_operands(arrs, ref_y, ref_c, w, h,
                                                    co, B)
            Ys, Cs = Y0.clone(), C0.clone()
            row[f"K1_ms_{mix}"] = cuda_ms(
                lambda: K1.mc_predict(ref_y, ref_c, mv, rb, w, h), K1_REPS,
                HOLD_MS)
            row[f"K2_ms_{mix}"] = cuda_ms(
                lambda: KW.intra_wavefront(Ys, Cs, RY, RC, Pi, w, h), reps)
            row[f"K3_ms_{mix}"] = cuda_ms(
                lambda: KW.deblock_wavefront(Ys, Cs, Pd, w, h), reps)
            # bytes and operations grow with the batch; the hand-off chain
            # (the probe below) keeps its length
            row[f"bound_ms_{mix}"] = {
                "K1": k1_batch_bound(
                    ref_y, ref_c, mv, rb,
                    K1.mc_predict(ref_y, ref_c, mv, rb, w, h), w, h,
                    B)["bound_ms"],
                "K2": k2_bound(Pi, B * w * h)[0]["bound_ms"],
                "K3": k3_bound(Pd, B * w * h)[0]["bound_ms"]}
        row.update(K2_grid=KW.last_grid(KW.INTRA),
                   K2_resident_ctas=KW.last_resident(KW.INTRA),
                   K3_grid=KW.last_grid(KW.DEBLOCK),
                   K3_resident_ctas=KW.last_resident(KW.DEBLOCK),
                   cluster=KW.last_cluster(KW.DEBLOCK))
        row["handoff_ms"] = cuda_ms(
            lambda: KW.handoff_probe(w, h, device, batch=B), reps)
        row["handoff_grid"] = KW.last_grid(KW.PROBE)
        row["per_stream"] = {
            k: row[k] / B for k in row
            if (k.endswith("_ms") or "_ms_" in k or k == "device_ops")
            and isinstance(row[k], (int, float))}
        log(f"  B={B}: step {row['device_ops']} device ops, host enqueue "
            f"{row['host_enqueue_ms']:.3f} ms, device span "
            f"{row['device_span_ms']:.3f} ms, device busy "
            f"{row['device_busy_ms']:.3f} ms; K1/K2/K3 on P pictures "
            f"{row['K1_ms_P']:.4f}/{row['K2_ms_P']:.4f}/{row['K3_ms_P']:.4f}"
            f" ms, on IDR pictures {row['K1_ms_IDR']:.4f}/"
            f"{row['K2_ms_IDR']:.4f}/{row['K3_ms_IDR']:.4f} ms; K2 grid "
            f"{row['K2_grid']} of {row['K2_resident_ctas']} resident, K3 "
            f"{row['K3_grid']} of {row['K3_resident_ctas']}; hand-off probe "
            f"{row['handoff_ms']:.4f} ms on {row['handoff_grid']} CTAs")
        rows.append(row)
    return rows


def step_phase(picture, device, reps: int = 20) -> dict:
    """The per-picture step (upload excluded) on one packed picture: host
    enqueue time, device span, and device kernels per step."""
    import torch

    from broadway_tpu_torch.core.recon import decode_picture_packed2

    buf, bk, lay, ci, co, R = picture
    dbuf = torch.from_numpy(buf).to(device)
    sy = torch.zeros((R, 16 * lay.h, 16 * lay.w), dtype=torch.uint8,
                     device=device)
    sc = torch.zeros((R, 2, 8 * lay.h, 8 * lay.w), dtype=torch.uint8,
                     device=device)

    def step():
        decode_picture_packed2(dbuf, sy, sc, 0, lay, bk, ci, co)

    host_ms, dev_ms = enqueue_and_span_ms(step, reps)
    kernels, busy_ms = device_ops(step)
    log(f"  per-picture step (P picture): host enqueue {host_ms:.3f} ms, "
        f"device span {dev_ms:.3f} ms, device ops per step "
        f"{kernels if kernels is not None else 'not measured'}, their "
        "device time in sum "
        + (f"{busy_ms:.3f} ms" if busy_ms is not None else "not measured"))
    out = {"step_host_enqueue_ms": host_ms, "step_device_span_ms": dev_ms,
           "step_device_ops": kernels, "step_device_busy_ms": busy_ms}
    out.update(graph_step(picture, device, reps, host_ms, dev_ms))
    return out


def graph_step(picture, device, reps: int, eager_host_ms: float,
               eager_dev_ms: float) -> dict:
    """The same per-picture step as a CUDA graph of one picture, as the
    default path captures it (core.graphs.GroupGraph.record_and_replay
    after the eager step, the key's warm-up): the capture's replay from
    zero stacks byte-equal to the eager step from zero stacks; the capture
    cost by part: what torch.cuda.graph does on entry and the capture did
    through PR 9 (synchronize after the warm-up, gc.collect, empty_cache;
    timed here, done no more), then the recorded enqueue and instantiate;
    the bytes the capture added to the graph's pool; host ms per replay
    (upload from the pinned staging buffer, replay, the copy of the
    output) and device span."""
    import gc as gcmod

    import torch

    from broadway_tpu_torch.core.graphs import GroupGraph
    from broadway_tpu_torch.core.recon import decode_picture_packed2

    buf, bk, lay, ci, co, R = picture

    def stacks():
        return (torch.zeros((R, 16 * lay.h, 16 * lay.w), dtype=torch.uint8,
                            device=device),
                torch.zeros((R, 2, 8 * lay.h, 8 * lay.w), dtype=torch.uint8,
                            device=device))

    want = decode_picture_packed2(torch.from_numpy(buf).to(device),
                                  *stacks(), 0, lay, bk, ci, co).tobytes()
    gy, gc = stacks()
    graph = GroupGraph(gy, gc, 1, buf.size, lay, bk, ci, co)
    decode_picture_packed2(torch.from_numpy(buf).to(device), gy, gc, 0, lay,
                           bk, ci, co)          # the key's eager warm-up
    parts = {}
    for part, fn in (("synchronize", torch.cuda.synchronize),
                     ("gc_collect", gcmod.collect),
                     ("empty_cache", torch.cuda.empty_cache)):
        t0 = time.perf_counter()
        fn()
        parts[f"{part}_ms"] = 1e3 * (time.perf_counter() - t0)
    gy.zero_()
    gc.zero_()
    got = graph.record_and_replay(buf[None], [0], torch.cuda.Stream(device),
                                  torch.cuda.graph_pool_handle())[0]
    parts.update(graph.capture_parts)
    if bytes(got.cpu().numpy()) != want:
        raise AssertionError("the graph of one picture differs from the "
                             "eager step")
    gy.zero_()
    gc.zero_()
    got = graph.replay(buf[None], [0])[0]
    if bytes(got.cpu().numpy()) != want:
        raise AssertionError("a replay of the graph of one picture differs "
                             "from the eager step")
    host_ms, dev_ms = enqueue_and_span_ms(
        lambda: graph.replay(buf[None], [0]), reps)
    # one replay from an idle card: what submitting it costs the host
    # (back to back, a replay waits for the previous upload, so host_ms
    # above follows the device)
    submit = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay(buf[None], [0])
        submit.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    submit_ms = _median(submit)
    n_ops, busy_ms = device_ops(lambda: graph.replay(buf[None], [0]))
    log(f"  the same step as a CUDA graph of one picture: byte-equal to the "
        f"eager step; capture + instantiate {graph.capture_ms:.3f} ms by "
        f"part {parts} (the first three: torch.cuda.graph's entry and PR "
        f"9's capture, no longer done), "
        f"{graph.pool_bytes} bytes added to the graph pool; one replay from "
        f"an idle card costs the host {submit_ms:.3f} ms (median of {reps}); "
        f"back to back host {host_ms:.3f} ms, device span {dev_ms:.3f} ms "
        f"per replay (eager: host enqueue {eager_host_ms:.3f} ms, device span "
        f"{eager_dev_ms:.3f} ms); device ops per replay "
        f"{n_ops if n_ops is not None else 'not measured'}, their device "
        "time in sum "
        + (f"{busy_ms:.3f} ms" if busy_ms is not None else "not measured"))
    return {"graph_capture_ms": graph.capture_ms,
            "graph_capture_parts_ms": parts,
            "graph_pool_bytes": graph.pool_bytes,
            "graph_submit_host_ms": submit_ms,
            "graph_host_ms": host_ms, "graph_device_span_ms": dev_ms,
            "graph_device_ops": n_ops, "graph_device_busy_ms": busy_ms}


def launch_counts():
    from broadway_tpu_torch.tools import bench
    return bench.launch_counts()


def reset_launch_counts() -> None:
    from broadway_tpu_torch.ops.gpu import mc_kernel as K1
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
    K1.mc_predict.launches = 0
    KW.intra_wavefront.launches = 0
    KW.deblock_wavefront.launches = 0
    KW.device_launches(KW.INTRA, reset=True)
    KW.device_launches(KW.DEBLOCK, reset=True)


def decode_port(data: bytes, device, parallel_slices: int = 8, **kw):
    """Decode with the port; returns (frames, seconds). The clock stops
    after one synchronize at the end (frames are not fetched to the
    host inside it)."""
    import torch

    from broadway_tpu_torch.core.decoder import Decoder
    dec = Decoder(device=device, parallel_slices=parallel_slices, **kw)
    try:
        t0 = time.perf_counter()
        outs = dec.decode_annexb(data)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    finally:
        dec.close()
    return [o.frame for o in outs], sec


def e2e_phase(data: bytes, device):
    """Port vs its NumPy path on the whole stream; returns (launch counts
    of the port's run, device launches per picture of K2/K3 on that run,
    median frames/s of the warm passes, the NumPy path's frames as
    bytes, NumPy seconds)."""
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW

    reset_launch_counts()
    frames, _ = decode_port(data, device)
    counts = launch_counts()
    dev = {"K1_mc": counts["K1_mc"],      # its wrapper launches one kernel
           "K2_intra": KW.device_launches(KW.INTRA),
           "K3_deblock": KW.device_launches(KW.DEBLOCK)}
    log(f"  wrapper launches on the main path: {counts}; device kernel "
        f"launches: {dev}")
    want_frames, numpy_s = decode_port(data, "cpu", parallel_slices=0,
                                       recon="numpy")
    want = [f.tobytes() for f in want_frames]
    log(f"  NumPy path: {len(want)} frames in {numpy_s:.1f} s")
    got = [f.tobytes() for f in frames]
    if len(got) != len(want) or not want:
        raise AssertionError(f"port gave {len(got)} frames, its NumPy path "
                             f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            off = next(j for j in range(len(w)) if g[j] != w[j])
            raise AssertionError(f"frame {i} differs from the NumPy path "
                                 f"at byte {off}: {g[off]} vs {w[off]}")
    log(f"  {len(got)} frames byte-equal to the NumPy path")
    per_pic = {}
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name} never launched on the main path")
        per_pic[name] = dev[name] / c
    for name in ("K2_intra", "K3_deblock"):
        if per_pic[name] != 1:
            raise AssertionError(f"{name}: {per_pic[name]} device launches "
                                 "per picture, expected 1")
    # a 4-frame pass lasts ~0.1 s on a shared host CPU: take the median of
    # a few warm passes, each printed
    rates = []
    for k in range(WARM_PASSES):
        _, sec = decode_port(data, device)
        rates.append(len(got) / sec)
        log(f"  warm pass {k}: {len(got)} frames in {sec:.4f} s = "
            f"{rates[-1]:.2f} frames/s")
    fps = sorted(rates)[len(rates) // 2]
    log(f"  median of {WARM_PASSES} warm passes: {fps:.2f} frames/s "
        f"(host probe: NumPy path {numpy_s:.1f} s for the same frames)")
    return counts, per_pic, fps, want, numpy_s


def step_graph_phase(data: bytes, want, pictures, device) -> dict:
    """Phase 3's stream twice, through two default decoders in turn, on an
    emptied stack pool: every frame equal to the NumPy path's (`want`),
    K1 / K2 / K3 once a picture, each picture's route and host ms (the
    eager step's enqueue, a graph's capture + replay, a replay), and what
    the pool holds after."""
    import torch

    from broadway_tpu_torch.core import decoder as DEC
    from broadway_tpu_torch.core import graphs as GR
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW

    keys = len({(p[1], p[3], p[4]) for p in pictures})
    GR.STACK_POOL.clear()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    eager, step = DEC.decode_picture_packed2, GR.GroupGraphs.step
    host = {"eager": [], "captured": [], "replayed": []}

    def eager_timed(*a, **k):
        t0 = time.perf_counter()
        r = eager(*a, **k)
        host["eager"].append(1e3 * (time.perf_counter() - t0))
        return r

    def step_timed(self, *a, **k):
        before = self.counts["captured"]
        t0 = time.perf_counter()
        r = step(self, *a, **k)
        if r is not None:
            route = "captured" if self.counts["captured"] > before \
                else "replayed"
            host[route].append(1e3 * (time.perf_counter() - t0))
        return r

    DEC.decode_picture_packed2, GR.GroupGraphs.step = eager_timed, step_timed
    runs = []
    try:
        for k in range(2):
            for v in host.values():
                v.clear()
            reset_launch_counts()
            dec = DEC.Decoder(device=device, parallel_slices=8)
            try:
                got = [o.frame.tobytes() for o in dec.decode_annexb(data)]
                torch.cuda.synchronize()
                routes = dict(dec.group_graphs.counts)
                graphs = dec.group_graphs.graphs()
            finally:
                dec.close()
            counts = launch_counts()
            counts_dev = {"K2_intra": KW.device_launches(KW.INTRA),
                          "K3_deblock": KW.device_launches(KW.DEBLOCK)}
            if got != list(want):
                i = next((i for i, (a, b) in enumerate(zip(got, want))
                          if a != b), min(len(got), len(want)))
                raise AssertionError(f"default decoder {k}: {len(got)} "
                                     f"frames; picture {i} differs from the "
                                     "NumPy path")
            _require_one_launch_per_picture(f"default decoder {k}", counts,
                                            len(want))
            _require_one_launch_per_picture(f"default decoder {k} (device)",
                                            counts_dev, len(want))
            runs.append({"steps": routes, "launches": counts,
                         "device_launches": counts_dev,
                         "host_ms": {r: list(v) for r, v in host.items()},
                         "graphs": [{"capture_ms": g.capture_ms,
                                     "capture_parts_ms": g.capture_parts,
                                     "pool_bytes": g.pool_bytes,
                                     "replays": g.replays}
                                    for g in graphs]})
            log(f"  default decoder {k}: {len(got)} frames byte-equal to the "
                f"NumPy path; steps by route {routes}; wrapper launches "
                f"{counts}, device {counts_dev}; host ms: eager enqueue "
                f"{[round(x, 3) for x in host['eager']]}, capture + replay "
                f"{[round(x, 3) for x in host['captured']]}, replay "
                f"{[round(x, 3) for x in host['replayed']]}")
    finally:
        DEC.decode_picture_packed2, GR.GroupGraphs.step = eager, step
    first, second = runs[0]["steps"], runs[1]["steps"]
    if first["captured"] < 1 or second["captured"] != 0 or \
            second["replayed"] < 1 or \
            second["eager"] + second["replayed"] != len(want):
        raise AssertionError(f"routes of the two decoders: {first}, {second}:"
                             " the first must capture, the second replay "
                             "and capture nothing")
    torch.cuda.synchronize()
    pool = GR.STACK_POOL.stats()
    out = {"pictures": len(want), "keys": keys, "runs": runs, "pool": pool,
           "reserved_bytes_added": torch.cuda.memory_reserved() - reserved}
    for g in runs[0]["graphs"]:
        log(f"  a capture: {g['capture_ms']:.3f} ms, by part "
            f"{g['capture_parts_ms']}; {g['pool_bytes']} bytes added to the "
            "graph pool")
    log(f"  {keys} keys in {len(want)} pictures; the pool after both: "
        f"{pool}; {out['reserved_bytes_added']} bytes reserved by the "
        "allocator since the phase began")
    return out


def rgba_int_numpy(frame: bytes, w: int, h: int):
    """The asm.js converter's integer formula (Player/Decoder.js
    yuv2rgbcalc) on one YUV420 frame, in NumPy: [h, w, 4] uint8."""
    import numpy as np
    a = np.frombuffer(frame, np.uint8).astype(np.int32)
    y = a[:w * h].reshape(h, w)
    u = a[w * h:w * h * 5 // 4].reshape(h // 2, w // 2)
    v = a[w * h * 5 // 4:].reshape(h // 2, w // 2)
    u = u.repeat(2, axis=0).repeat(2, axis=1) - 128
    v = v.repeat(2, axis=0).repeat(2, axis=1) - 128
    a0 = 1192 * (y - 16)
    r = (a0 + 1634 * v) >> 10
    g = (a0 - 832 * v - 400 * u) >> 10
    b = (a0 + 2066 * u) >> 10
    return np.stack([r, g, b, np.full_like(r, 255)],
                    axis=-1).clip(0, 255).astype(np.uint8)


def _require_one_launch_per_picture(path: str, counts: dict, n: int) -> None:
    for name, c in counts.items():
        if c != n:
            raise AssertionError(f"{name}: {c} launches on the {path} path "
                                 f"for {n} pictures")


def entry_phase(data: bytes, want, w: int, h: int, device, smi: str) -> dict:
    """The public entry points on the card, on the stream whose frames
    the NumPy path already decoded (`want`, bytes): the MP4 player with
    the integer RGBA converter, the OMX component, and the converters'
    times. Returns the launch counts of each path and the times."""
    import numpy as np
    import torch

    from broadway_tpu_torch.omx import Event, SoftAvc
    from broadway_tpu_torch.player.player import MP4Player
    from broadway_tpu_torch.player.yuv2rgb import (yuv420_to_rgba_int,
                                                   yuv_to_rgb_rec709)
    from broadway_tpu_torch.tools import mp4mux

    n = len(want)
    kind = torch.device(device).type
    mp4 = mp4mux.mux(data, w, h)
    reset_launch_counts()
    t0 = time.perf_counter()
    player = MP4Player(mp4, device=device, render="rgb_int").play()
    torch.cuda.synchronize()
    play_s = time.perf_counter() - t0
    player_counts = launch_counts()
    player.decoder.release()
    pics = player.frames
    if len(pics) != n or player.stats.total_frames != n:
        raise AssertionError(f"MP4Player gave {len(pics)} pictures, the "
                             f"NumPy path {n}")
    for i, (pic, ref) in enumerate(zip(pics, want)):
        rgba = pic["rgba"]
        if rgba.device.type != kind or rgba.dtype != torch.uint8:
            raise AssertionError(f"picture {i}: RGBA is {rgba.dtype} on "
                                 f"{rgba.device}, expected uint8 on {kind}")
        if pic["frame"].tobytes() != ref:
            raise AssertionError(f"MP4Player picture {i}: YUV differs from "
                                 "the NumPy path")
        if not np.array_equal(rgba.cpu().numpy(), rgba_int_numpy(ref, w, h)):
            raise AssertionError(f"MP4Player picture {i}: RGBA differs from "
                                 "the asm.js formula in NumPy")
    _require_one_launch_per_picture("MP4Player", player_counts, n)
    log(f"  MP4Player(device={device!r}, render='rgb_int'): {n} pictures in "
        f"{play_s:.3f} s, YUV byte-equal to the NumPy path, RGBA byte-equal "
        f"to the asm.js formula; wrapper launches {player_counts}")

    events = []
    reset_launch_counts()
    comp = SoftAvc(device=device,
                   event_cb=lambda ev, args: events.append((ev, args)))
    outs = []

    def drain():
        while True:
            if comp.output_port.enabled is False:
                comp.reconfigure_output()     # acknowledge the new size
            o = comp.dequeue_output()
            if o is None:
                return
            outs.append(o)

    chunk, pos = 64 * 1024, 0
    while pos < len(data):
        nxt = min(pos + chunk, len(data))
        if comp.queue_input(data[pos:nxt], eos=(nxt == len(data))):
            pos = nxt
        drain()
    drain()
    torch.cuda.synchronize()
    omx_counts = launch_counts()
    comp._dec.release()
    if not comp.eos_delivered:
        raise AssertionError("SoftAvc never delivered EOS")
    if [a for e, a in events if e is Event.PORT_SETTINGS_CHANGED] != [(w, h)]:
        raise AssertionError(f"SoftAvc events: {events}")
    if [o.data for o in outs] != list(want):
        raise AssertionError("SoftAvc output buffers differ from the NumPy "
                             "path's frames")
    if [o.eos for o in outs] != [False] * (n - 1) + [True]:
        raise AssertionError(f"SoftAvc EOS flags: {[o.eos for o in outs]}")
    if any(o.frame.yuv.device.type != kind for o in outs):
        raise AssertionError(f"a SoftAvc output frame is not on {kind}")
    _require_one_launch_per_picture("SoftAvc", omx_counts, n)
    log(f"  SoftAvc(device={device!r}): {-(-len(data) // chunk)} input "
        f"buffers of <= {chunk} B, {len(outs)} output buffers byte-equal to the "
        f"NumPy path, EOS on the last; wrapper launches {omx_counts}")

    f = pics[1]["frame"]
    planes = (f.dev_y, f.dev_cb, f.dev_cr)
    ms_int = cuda_ms(lambda: yuv420_to_rgba_int(*planes), 20, HOLD_MS)
    ms_709 = cuda_ms(lambda: yuv_to_rgb_rec709(*planes), 20, HOLD_MS)
    log(f"  YUV->RGB at {w}x{h} on {smi} (torch ops, CUDA events around 20 "
        f"calls queued behind a held stream): yuv420_to_rgba_int "
        f"{ms_int:.4f} ms, yuv_to_rgb_rec709 {ms_709:.4f} ms")
    return {"player_launches": player_counts, "omx_launches": omx_counts,
            "player_s": play_s, "rgba_int_ms": ms_int, "rec709_ms": ms_709}


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def round_keys(datas) -> list:
    """Each lockstep round's key (B, bucket triple, picture parameters),
    from the streams packed on the host as the lockstep packs them: the
    members are the streams with a picture left, the triple their
    largest."""
    from broadway_tpu_torch.core.packed import pack_stream
    packed = {}
    per = []
    for d in datas:
        if id(d) not in packed:
            packed[id(d)] = [(p[1], p[3], p[4]) for p in pack_stream(d)]
        per.append(packed[id(d)])
    keys = []
    for r in range(max(map(len, per))):
        mem = [p[r] for p in per if len(p) > r]
        keys.append((len(mem), tuple(max(m[0][j] for m in mem)
                                     for j in range(3)),
                     mem[0][1], mem[0][2]))
    return keys


def expected_routes(keys, graphs_exist: bool) -> dict:
    """A call's rounds by route under the capture policy: a key's first
    round eager, its second captured, the rest replayed; once its graphs
    exist (a later call on the same set), a key met once eager, the rest
    replayed."""
    met = {}
    for k in keys:
        met[k] = met.get(k, 0) + 1
    if graphs_exist:
        eager, captured = sum(1 for n in met.values() if n == 1), 0
    else:
        eager = len(met)
        captured = sum(1 for n in met.values() if n >= 2)
    return {"eager": eager, "captured": captured,
            "replayed": len(keys) - eager - captured}


class RouteTimes:
    """Around a step method (``owner.name``): each call's host ms by the
    route it took, read from its routes dict (`routes_of(obj, *args)`)
    before and after the call, and each graph captured meanwhile (the
    newest of `graphs_of(obj, *args)`, a ``GroupGraphs``)."""

    def __init__(self, owner, name: str, routes_of, graphs_of) -> None:
        self.owner, self.name = owner, name
        self.routes_of, self.graphs_of = routes_of, graphs_of

    def __enter__(self):
        self.host = {"eager": [], "captured": [], "replayed": []}
        self.graphs = []
        self._saved = getattr(self.owner, self.name)
        step = self._saved

        def timed(obj, *a, **k):
            routes = self.routes_of(obj, *a)
            before = dict(routes)
            t0 = time.perf_counter()
            r = step(obj, *a, **k)
            ms = 1e3 * (time.perf_counter() - t0)
            route = next(x for x in self.host if routes[x] > before[x])
            self.host[route].append(ms)
            if route == "captured":
                self.graphs.append(self.graphs_of(obj, *a).graphs()[-1])
            return r

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._saved)

    def take(self) -> dict:
        """The times and captures since the last take."""
        out = {"host_ms": {r: list(v) for r, v in self.host.items()},
               "graphs": [{"kind": g.kind, "pictures": g.group,
                           "capture_ms": g.capture_ms,
                           "capture_parts_ms": g.capture_parts,
                           "pool_bytes": g.pool_bytes} for g in self.graphs]}
        for v in self.host.values():
            v.clear()
        self.graphs = []
        return out


def log_route_times(label: str, t: dict) -> None:
    log(f"    {label} host ms: eager {_rounded(t['host_ms']['eager'])}, "
        f"capture + replay {_rounded(t['host_ms']['captured'])}, replay "
        f"{_rounded(t['host_ms']['replayed'])}")
    for g in t["graphs"]:
        log(f"    captured a {g['kind']} graph: {g['capture_ms']:.3f} ms, by "
            f"part {g['capture_parts_ms']}; {g['pool_bytes']} bytes added to "
            "the graph pool")


def _rounded(xs):
    return [round(x, 3) for x in xs]


def lockstep_call(datas, refs, device, label: str, times: RouteTimes,
                  want_routes: dict = None, **kw) -> dict:
    """One decode_streams_lockstep call with launch counts reset first:
    every stream byte-equal to its single-stream decode (`refs`), K1, K2
    and K3 once a round (wrapper and device counts; a declined picture's
    fallback is its round's launch), and the call's routes equal to
    `want_routes` when given. Returns its stats, launches and times."""
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
    from broadway_tpu_torch.parallel.streams import decode_streams_lockstep

    stats = {}
    reset_launch_counts()
    gots = decode_streams_lockstep(datas, device=device, parallel_slices=8,
                                   stats=stats, **kw)
    counts = launch_counts()
    counts_dev = {"K2_intra": KW.device_launches(KW.INTRA),
                  "K3_deblock": KW.device_launches(KW.DEBLOCK)}
    for i, (g, r) in enumerate(zip(gots, refs)):
        if g != r:
            k = next((k for k, (a, b) in enumerate(zip(g, r)) if a != b),
                     min(len(g), len(r)))
            raise AssertionError(f"{label} stream {i}: {len(g)} frames, "
                                 f"single-stream {len(r)}; first difference "
                                 f"at frame {k}")
    _require_one_launch_per_picture(f"{label} (per round)", counts,
                                    stats["rounds"])
    _require_one_launch_per_picture(f"{label} (per round, device)",
                                    counts_dev, stats["rounds"])
    if want_routes is not None and stats["routes"] != want_routes:
        raise AssertionError(f"{label}: routes {stats['routes']}, the "
                             f"capture policy gives {want_routes}")
    out = dict(stats, launches=counts, device_launches=counts_dev,
               **times.take())
    log(f"  {label}: {len(datas)} streams of "
        f"{[len(r) for r in refs]} pictures byte-equal to their "
        f"single-stream decodes; rounds {stats['rounds']}, batches "
        f"{stats['batches']}, fallbacks {stats['fallbacks']} (routes "
        f"{stats['fallback_routes']}), keys {stats['keys']}, routes "
        f"{stats['routes']}; launches {counts}, "
        f"device {counts_dev}; round host ms: eager "
        f"{_rounded(out['host_ms']['eager'])}, capture + replay "
        f"{_rounded(out['host_ms']['captured'])}, replay "
        f"{_rounded(out['host_ms']['replayed'])}")
    for g in out["graphs"]:
        log(f"    captured a B = {g['pictures']} round: "
            f"{g['capture_ms']:.3f} ms, by part {g['capture_parts_ms']}; "
            f"{g['pool_bytes']} bytes added to the graph pool")
    return out


def lockstep_phase(datas, want0, mixed, device, numpy_s: float,
                   passes: int = 3) -> dict:
    """The slice's path at full width: decode_streams_lockstep on four
    1920x1088 streams of unequal length, each stream byte-equal to the
    port's single-stream Decoder(device="cuda") on the same bytes
    (stream 0's are also the NumPy path's, `want0`), K1, K2 and K3 once a
    round. The rounds run as one CUDA graph per key on a lockstep set of
    the stack pool: call 1 captures the keys it meets twice; call 2 has one
    picture of the longest stream declined by a wrapped v2 packer (the
    unpacked fallback on the card) and captures nothing. Then B = 8: the
    eight streams `mixed` twice, the first call capturing its B = 8 P
    round and the second nothing. Every call's routes must be the
    capture policy's on the rounds' keys, packed on the host. Then the
    aggregate rate, lockstep beside four sequential single-stream
    decodes, warm, in this same call."""
    import torch

    from broadway_tpu_torch.core import graphs as GR
    from broadway_tpu_torch.core import packed as PK
    from broadway_tpu_torch.parallel import streams as LS
    from broadway_tpu_torch.parallel.streams import decode_streams_lockstep

    refs = [[f.tobytes() for f in decode_port(d, device)[0]] for d in datas]
    if refs[0] != list(want0):
        raise AssertionError("stream 0: the single-stream decode differs "
                             "from the NumPy path")
    lens = [len(r) for r in refs]
    rounds = max(lens)
    n_frames = sum(lens)
    keys = round_keys(datas)

    with RouteTimes(LS, "_round_step",
                    lambda stacks, *a: stacks.graphs.counts,
                    lambda stacks, *a: stacks.graphs) as times:
        first = lockstep_call(datas, refs, device, "call 1", times,
                              expected_routes(keys, False))

        # the third call from one thread declines: only the longest
        # stream's thread packs a third picture
        orig = PK.pack_picture_v2
        calls, lock = {}, threading.Lock()

        def declining(*a, **k):
            with lock:
                me = threading.get_ident()
                calls[me] = calls.get(me, 0) + 1
                decline = calls[me] == 3
            return None if decline else orig(*a, **k)

        PK.pack_picture_v2 = declining
        try:
            declined = lockstep_call(datas, refs, device,
                                     "call 2, a picture declined", times)
        finally:
            PK.pack_picture_v2 = orig
        want_batches = [sum(1 for n in lens if n > r) for r in range(rounds)]
        want_batches.pop(2)              # round 3 is the declined picture
        if (declined["rounds"], declined["fallbacks"],
                declined["batches"]) != (rounds, 1, want_batches):
            raise AssertionError(f"lockstep rounds: {declined}, expected "
                                 f"{rounds} rounds, batches {want_batches},"
                                 " 1 fallback")
        if declined["routes"]["captured"] != 0:
            raise AssertionError("the second lockstep call captured "
                                 f"{declined['routes']}")
        # the fallback's key (the stream's stacks) is met once in the call
        if declined["fallback_routes"] != {"eager": 1, "captured": 0,
                                           "replayed": 0}:
            raise AssertionError("the declined picture's fallback took "
                                 f"{declined['fallback_routes']}")

        mixed_refs = {}
        for d in mixed:
            if id(d) not in mixed_refs:
                mixed_refs[id(d)] = (
                    list(want0) if d is datas[0] else
                    [f.tobytes() for f in decode_port(d, device)[0]])
        refs8 = [mixed_refs[id(d)] for d in mixed]
        keys8 = round_keys(mixed)
        b8 = [lockstep_call(mixed, refs8, device, f"B = 8, call {k + 1}",
                            times, expected_routes(keys8, k > 0))
              for k in range(2)]
        if b8[0]["routes"]["captured"] < 1 or \
                b8[1]["routes"]["replayed"] < 1:
            raise AssertionError(f"B = 8: routes {b8[0]['routes']}, "
                                 f"{b8[1]['routes']}: the first call must "
                                 "capture and the second replay")
        if b8[0]["batches"][0] != 8:
            raise AssertionError(f"B = 8: batches {b8[0]['batches']}")
        torch.cuda.synchronize()
        pool = GR.STACK_POOL.stats(lockstep=True)
        log(f"  lockstep sets after the B = 4 and B = 8 calls: {pool}")

        lock_s, seq_s, warm = [], [], []
        for k in range(passes):
            torch.cuda.synchronize()
            st = {}
            t0 = time.perf_counter()
            decode_streams_lockstep(datas, device=device, parallel_slices=8,
                                    fetch=False, stats=st)
            lock_s.append(time.perf_counter() - t0)
            warm.append(dict(routes=st["routes"], **times.take()))
            if st["routes"]["captured"] != 0:
                raise AssertionError(f"warm pass {k} captured: {st}")
            seq_s.append(sum(decode_port(d, device)[1] for d in datas))
            log(f"  warm pass {k}: {n_frames} frames, lockstep "
                f"{lock_s[-1]:.4f} s = {n_frames / lock_s[-1]:.2f} frames/s "
                f"(routes {st['routes']}; round host ms: eager "
                f"{_rounded(warm[-1]['host_ms']['eager'])}, replay "
                f"{_rounded(warm[-1]['host_ms']['replayed'])}); four "
                f"sequential single-stream decodes {seq_s[-1]:.4f} s = "
                f"{n_frames / seq_s[-1]:.2f} frames/s")
    out = {"streams": len(datas), "pictures": lens, "rounds": rounds,
           "keys": len(set(keys)), "batches": declined["batches"],
           "fallbacks": declined["fallbacks"],
           "launches": declined["launches"],
           "calls": {"first": first, "declined": declined, "b8": b8,
                     "warm": warm},
           "stack_pool": pool,
           "lockstep_fps": n_frames / _median(lock_s),
           "sequential_fps": n_frames / _median(seq_s),
           "numpy_path_s": numpy_s}
    log(f"  median of {passes}: lockstep {out['lockstep_fps']:.2f} frames/s "
        f"in aggregate, sequential {out['sequential_fps']:.2f} (host probe: "
        f"NumPy path {numpy_s:.1f} s for stream 0's frames)")
    return out


def v1_keys(data: bytes) -> list:
    """Each picture's v1 key (bucket kb, picture parameters), from the
    stream parsed and packed on the host as Decoder(pack="v1") packs it."""
    from broadway_tpu_torch.core import decoder as DEC
    from broadway_tpu_torch.core import packed as PK

    keys = []

    def collect(dec, pic):
        lay = PK.get_packed_layout(pic.width_mbs, pic.height_mbs)
        kb = PK.pack_picture(pic, lay, PK.PackScratch(lay))[1]
        keys.append((kb, dec.pps.constrained_intra_pred,
                     dec.pps.chroma_qp_index_offset))
        return DEC.SKIP_RECON

    dec = DEC.Decoder(device="cpu", recon_strategy=collect)
    try:
        dec.decode_annexb(data)
    finally:
        dec.close()
    return keys


def pack_modes_phase(data: bytes, device) -> dict:
    """The single-stream v1 and unpacked paths on the card: Decoder(
    pack="v1") and Decoder(pack="none") on a 3-picture 1080p stream (IDR
    + 2 P), each through two decoders in turn, byte-equal to the v2
    decode, K1 / K2 / K3 once a picture; each picture's step is the graph
    of its key (v1: bucket and picture parameters; unpacked: the arrays'
    layout, one a geometry), so the routes must be the capture policy's
    on the keys counted on the host: the first decoder captures a key at
    its second picture, the second decoder replays. Host ms of each step
    by route and each capture are printed."""
    from broadway_tpu_torch.core.decoder import Decoder

    want = [f.tobytes() for f in decode_port(data, device, pack="v2")[0]]
    n = len(want)
    keys = {"v1": v1_keys(data), "none": [0] * n}
    out = {}
    for pack, method in (("v1", "_v1_step"), ("none", "_arrays_step")):
        runs = []
        with RouteTimes(Decoder, method,
                        lambda dec, stacks, *a: stacks.graphs.counts,
                        lambda dec, stacks, *a: stacks.graphs) as times:
            for k in range(2):
                reset_launch_counts()
                dec = Decoder(device=device, parallel_slices=8, pack=pack)
                try:
                    got = [o.frame.tobytes() for o in dec.decode_annexb(data)]
                    counts = dict(dec.group_graphs.counts)
                finally:
                    dec.close()
                if n != 3 or got != want:
                    raise AssertionError(f"Decoder(pack={pack!r}) run {k} "
                                         "differs from the v2 decode")
                _require_one_launch_per_picture(f"pack={pack}",
                                                launch_counts(), n)
                routes = expected_routes(keys[pack], k > 0)
                if counts != routes:
                    raise AssertionError(f"pack={pack} run {k}: routes "
                                         f"{counts}, the capture policy "
                                         f"gives {routes}")
                runs.append(dict(routes=counts, **times.take()))
                log(f"  Decoder(device={device!r}, pack={pack!r}) run {k}: "
                    f"{n} pictures byte-equal to the v2 decode; keys "
                    f"{len(set(keys[pack]))}, routes {counts}")
                log_route_times(f"pack={pack} step", runs[-1])
        if runs[0]["routes"]["captured"] + runs[1]["routes"]["replayed"] < 1:
            raise AssertionError(f"pack={pack}: nothing captured or replayed")
        out[pack] = runs
    return out


def group_phase(datas, device, numpy_s: float, passes: int = 3) -> dict:
    """Frame groups at 1080p: the lockstep streams back to back as one
    10-picture stream (IDRs at 0, 4, 6, 8), decoded with group_frames = 2
    and 4, each frame byte-equal to the default decode; K1 / K2 / K3 once per
    picture counted through the replays; the prefetch decode; graphs,
    capture ms, pool bytes, host ms per replayed group; frames/s of warm
    passes with one decoder per setting, kept across passes."""
    import torch

    from broadway_tpu_torch.core import graphs as GR
    from broadway_tpu_torch.core.decoder import Decoder
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW

    data = b"".join(datas)
    want = [f.tobytes() for f in decode_port(data, device)[0]]
    n = len(want)
    if n != sum(k for _, k in LOCKSTEP_STREAMS):
        raise AssertionError(f"the concatenated stream gave {n} frames")
    GR.STACK_POOL.clear()        # each decoder's graphs are its own
    decs = {0: Decoder(device=device, parallel_slices=8)}
    out = {"pictures": n, "groups": {}}
    replay_ms = {2: [], 4: []}
    run = GR.GroupGraphs.run
    try:
        for G in (2, 4):
            dec = Decoder(device=device, parallel_slices=8, group_frames=G)
            decs[G] = dec
            reset_launch_counts()
            got = [o.frame.tobytes() for o in dec.decode_annexb(data)]
            torch.cuda.synchronize()
            counts = launch_counts()
            counts_dev = {"K2_intra": KW.device_launches(KW.INTRA),
                          "K3_deblock": KW.device_launches(KW.DEBLOCK)}
            if got != want:
                k = next((k for k, (a, b) in enumerate(zip(got, want))
                          if a != b), min(len(got), len(want)))
                raise AssertionError(f"group_frames={G}: {len(got)} frames, "
                                     f"default {n}; first difference at "
                                     f"{k}")
            _require_one_launch_per_picture(f"group_frames={G}", counts, n)
            _require_one_launch_per_picture(f"group_frames={G} (device)",
                                            counts_dev, n)
            graphs = [g for g in dec.group_graphs.graphs() if g.group > 1]
            replayed = sum(g.replays * g.group for g in graphs)
            out["groups"][G] = {
                "launches": counts, "device_launches": counts_dev,
                "graphs_captured": len(graphs),
                "pictures_through_replays": replayed,
                "capture_ms": [g.capture_ms for g in graphs],
                "graph_sizes": [g.group for g in graphs],
                "pool_bytes": [g.pool_bytes for g in graphs]}
            log(f"  group_frames={G}: {n} frames byte-equal to the default "
                f"decode; wrapper launches {counts}, device {counts_dev}; "
                f"{len(graphs)} graphs of {[g.group for g in graphs]} "
                f"pictures captured in "
                f"{[round(g.capture_ms, 1) for g in graphs]} ms, adding "
                f"{[g.pool_bytes for g in graphs]} bytes to the pool; "
                f"{replayed} of {n} pictures ran in replays")
        out["launches"] = out["groups"][4]["launches"]
        # host ms of each replayed group of the two group decoders from
        # here on: their sets stay leased to them until the end
        owner = {id(decs[G].group_graphs): G for G in (2, 4)}

        def timed(self, *a, **k):
            before = self.counts["captured"]
            t0 = time.perf_counter()
            r = run(self, *a, **k)
            G = owner.get(id(self))
            if G is not None and self.counts["captured"] == before:
                replay_ms[G].append(1e3 * (time.perf_counter() - t0))
            return r

        GR.GroupGraphs.run = timed

        reset_launch_counts()
        pre = Decoder(device=device, parallel_slices=8, group_frames=4,
                      prefetch_outputs=True)
        try:
            got = [o.frame.tobytes() for o in pre.decode_annexb(data)]
        finally:
            pre.close()
        if got != want:
            raise AssertionError("prefetch_outputs=True changed the bytes")
        _require_one_launch_per_picture("prefetch", launch_counts(), n)
        log(f"  group_frames=4, prefetch_outputs=True: {n} frames byte-equal")

        secs = {G: [] for G in decs}
        decs[0].decode_annexb(data)      # the default decoder's warm-up
        for k in range(passes):
            for G, dec in decs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dec.decode_annexb(data)
                torch.cuda.synchronize()
                secs[G].append(time.perf_counter() - t0)
            log(f"  warm pass {k}: " + ", ".join(
                f"{'default' if G == 0 else f'G={G}'} {n / secs[G][-1]:.2f}"
                for G in decs) + " frames/s")
        out["fps"] = {("default" if G == 0 else f"G={G}"): n / _median(s)
                      for G, s in secs.items()}
        out["host_ms_per_replayed_group"] = {
            f"G={G}": _median(v) if v else None for G, v in replay_ms.items()}
        out["pictures_through_replays_in_warm_passes"] = {
            f"G={G}": sum(g.replays * g.group
                          for g in decs[G].group_graphs.graphs()
                          if g.group > 1)
            - out["groups"][G]["pictures_through_replays"] for G in (2, 4)}
        out["numpy_path_s"] = numpy_s
        log(f"  median of {passes} warm passes: " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["fps"].items())
            + f" frames/s; {out['pictures_through_replays_in_warm_passes']} "
            f"of {passes * n} pictures ran in replays; host ms per replayed "
            f"group (median) {out['host_ms_per_replayed_group']} (host "
            f"probe: NumPy path "
            f"{numpy_s:.1f} s for stream 0's frames)")
    finally:
        GR.GroupGraphs.run = run
        for dec in decs.values():
            dec.close()
    return out


def band_stream(gen: str, kw: dict) -> bytes:
    """A phase-11 stream from the port's generator (run in a side
    process)."""
    sys.path.insert(0, REPO)
    from broadway_tpu_torch.tools import streams
    return getattr(streams, gen)(**kw)[0]


def numpy_frames(data: bytes) -> list:
    """The port's NumPy path on a stream, as frame bytes (run in a side
    process)."""
    sys.path.insert(0, REPO)
    from broadway_tpu_torch.core.decoder import Decoder
    dec = Decoder(device="cpu", recon="numpy")
    try:
        return [o.frame.tobytes() for o in dec.decode_annexb(data)]
    finally:
        dec.close()


def _first_difference(got, want) -> str:
    k = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if k is None:
        return f"{len(got)} frames against {len(want)}"
    off = next(j for j in range(len(want[k])) if got[k][j] != want[k][j])
    return f"frame {k} differs at byte {off}"


def once_ms(fn, device):
    """(fn's result, its milliseconds): one call, between CUDA events on
    the card (the host's clock on the CPU)."""
    import torch
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        return fn(), 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    r = fn()
    end.record()
    torch.cuda.synchronize()
    return r, start.elapsed_time(end)


def band_kernel_phase(data: bytes, device, seed: int = 11,
                      reps: int = 10) -> dict:
    """K1, K2 and K3 as the band path runs them, on the IDR and the first P
    picture of phase 11's idc-0 stream, band by band: K1's band form
    (mb0 > 0 from band 1 on) at the band's global offset against
    full-height reference stacks, K2 over the band's 17 rows, K3 over 18
    rows with the ghost row (band k-1's K2 output, zeros for band 0), each
    byte-equal to its plain version on the same operands (that one call
    of the plain version timed), the kernel timed; beside them, timed
    only, K3 over the band's 17 rows without the ghost row, and each
    kernel on the whole picture (the same operands, 68 rows)."""
    import numpy as np
    import torch

    from broadway_tpu_torch.core.packed import pack_stream, unpack_arrs_v2
    from broadway_tpu_torch.core.recon import decode_picture
    from broadway_tpu_torch.ops.gpu import deblock, inter, intra
    from broadway_tpu_torch.ops.gpu import mc_kernel as K1
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
    from broadway_tpu_torch.ops.gpu.residual import residual_stage
    from broadway_tpu_torch.parallel import slices as SL

    U8 = torch.uint8
    rng = np.random.RandomState(seed)
    out = {name: {} for name in KERNELS}
    out["K3_deblock_17_rows"] = {}
    out["whole_picture"] = {}

    def held(name, label, band, run, run_plain, bnd, busy, hold=0.0,
             n=reps, timed=None):
        """run (the kernel) against one timed call of run_plain (the plain
        version); both return the planes or predictions they computed. The
        kernel's time is `timed`'s (default run), over n calls."""
        got = run()
        want, pms = once_ms(run_plain, device)
        if any(not torch.equal(g, w) for g, w in zip(got, want)):
            err = max(int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
                      for g, w in zip(got, want))
            raise AssertionError(f"{name} band {band} of the {label} picture "
                                 f"differs from its plain version: max |err| "
                                 f"{err}")
        out[name].setdefault(label, []).append({
            "band": band, "ms": cuda_ms(timed or run, n, hold),
            "plain_ms": pms,
            "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
            "busy_mbs": busy, "max_abs_err": 0})
        return got

    def in_place(kernel, Y, C, *args):
        """(a wavefront kernel on copies of (Y, C), returning its output
        planes; the same on one scratch copy, again and again, to time it
        without the copies)."""
        Ys, Cs = Y.clone(), C.clone()

        def run():
            Yc, Cc = Y.clone(), C.clone()
            kernel(Yc, Cc, *args)
            return Yc, Cc
        return run, lambda: kernel(Ys, Cs, *args)

    for label, (buf, bk, lay, ci, co, R) in zip(
            ("IDR", "P"), pack_stream(data, max_pics=2)):
        w, h = lay.w, lay.h
        hb = h // N_BANDS
        whole = unpack_arrs_v2(torch.from_numpy(buf).to(device), lay, bk, ci,
                               co)
        ref_y = torch.from_numpy(rng.randint(0, 256, (R, 16 * h, 16 * w),
                                             dtype=np.uint8)).to(device)
        ref_c = torch.from_numpy(rng.randint(
            0, 256, (R, 2, 8 * h, 8 * w), dtype=np.uint8)).to(device)
        halo = None
        for k in range(N_BANDS):
            arrs = SL.cut_band(whole, k, w, hb)
            garrs = SL.cut_band_ghost(whole, k, w, hb)
            mb0 = k * hb * w
            mv, rb = arrs["mv"].contiguous(), arrs["ref_blk"].contiguous()
            args = (ref_y, ref_c, mv, rb, w, hb)
            band = {"mb0": mb0, "ref_h_mbs": h}
            got = held("K1_mc", label, k,
                       lambda: K1.mc_predict(*args, **band),
                       lambda: inter.mc_predict_plain(*args, **band),
                       k1_bound(ref_y, ref_c, mv, rb,
                                (torch.empty((w * hb, 16, 16), dtype=U8),
                                 torch.empty((w * hb, 8, 16), dtype=U8)),
                                w, hb, mb0),
                       int((rb >= 0).sum()), HOLD_MS, K1_REPS)

            Y0, C0 = decode_picture(arrs, ref_y, ref_c, w, hb, co,
                                    run_stages=1, **band)
            RY, RC = residual_stage(arrs, co)
            Pi = intra.intra_params(arrs)
            bnd, busy = k2_bound(Pi, w * hb)
            run, timed = in_place(KW.intra_wavefront, Y0, C0, RY, RC, Pi, w,
                                  hb)
            Yk, Ck = held("K2_intra", label, k, run,
                          in_place(intra.intra_wavefront_plain, Y0, C0, RY,
                                   RC, Pi, w, hb)[0], bnd, busy, timed=timed)

            if halo is None:
                halo = (torch.zeros_like(Yk[:16]), torch.zeros_like(Ck[:, :8]))
            Yg = torch.cat([halo[0], Yk])
            Cg = torch.cat([halo[1], Ck], dim=1)
            halo = (Yk[-16:], Ck[:, -8:])
            Pg = deblock.deblock_params(garrs, w, hb + 1)
            bnd, busy = k3_bound(Pg, w * (hb + 1))
            run, timed = in_place(KW.deblock_wavefront, Yg, Cg, Pg, w,
                                  hb + 1)
            held("K3_deblock", label, k, run,
                 in_place(deblock.deblock_wavefront_plain, Yg, Cg, Pg, w,
                          hb + 1)[0], bnd, busy, timed=timed)
            Pd = deblock.deblock_params(arrs, w, hb)
            Ys, Cs = Yk.clone(), Ck.clone()
            out["K3_deblock_17_rows"].setdefault(label, []).append({
                "band": k, "ms": cuda_ms(lambda: KW.deblock_wavefront(
                    Ys, Cs, Pd, w, hb), reps)})
        # the same picture as one launch each (68 rows): what one card does
        # without bands, on these operands
        mv, rb = whole["mv"], whole["ref_blk"]
        Y0, C0 = decode_picture(whole, ref_y, ref_c, w, h, co, run_stages=1)
        RY, RC = residual_stage(whole, co)
        Pi, Pd = intra.intra_params(whole), deblock.deblock_params(whole, w, h)
        Ys, Cs = Y0.clone(), C0.clone()
        out["whole_picture"][label] = {
            "K1_mc": cuda_ms(lambda: K1.mc_predict(ref_y, ref_c, mv, rb, w, h),
                             K1_REPS, HOLD_MS),
            "K2_intra": cuda_ms(lambda: KW.intra_wavefront(
                Ys, Cs, RY, RC, Pi, w, h), reps),
            "K3_deblock": cuda_ms(lambda: KW.deblock_wavefront(
                Ys, Cs, Pd, w, h), reps)}
        for name in KERNELS:
            rows = out[name][label]
            log(f"  {name} {label}, per band (mb0 = "
                f"{[k * hb * w for k in range(N_BANDS)]}): kernel "
                f"{[round(r['ms'], 5) for r in rows]} ms, plain "
                f"{[round(r['plain_ms'], 3) for r in rows]} ms, bound "
                f"{[round(r['bound_ms'], 5) for r in rows]} ms "
                f"({rows[0]['bound_by']}), byte-equal to plain; the whole "
                f"picture in one launch {out['whole_picture'][label][name]:.5f}"
                " ms")
        log(f"  K3_deblock {label} per band without the ghost row (17 rows): "
            f"{[round(r['ms'], 5) for r in out['K3_deblock_17_rows'][label]]}"
            " ms")
    return out


def band_keys(data: bytes) -> list:
    """Each picture's band key (bucket triple, picture parameters), from
    the stream packed on the host as the band path packs it (a stream's
    pictures all take the idc-0 chain or none, and one n_bands)."""
    from broadway_tpu_torch.core.packed import pack_stream
    return [(p[1], p[3], p[4]) for p in pack_stream(data)]


def band_routes(keys, graphs_exist: bool) -> dict:
    """A one-card mesh's band routes: no step of a mesh over several."""
    return dict(expected_routes(keys, graphs_exist), multi_card_eager=0,
                multi_card_captured=0, multi_card_replayed=0)


def band_phase(streams_abc: dict, want_c, pool, device, smi: str,
               passes: int = BAND_PASSES) -> dict:
    """Band sharding at 1080p on a mesh of the card four times (every
    band's kernels on it, one after the other): (a) the 4-slice idc-0
    stream (the chained ghost-row deblock), (b) the 4-band idc-2 stream
    (independent bands), (c) phase 3's 8-slice stream (every picture
    declined to the per-picture step). With the stack pool emptied, each
    stream through decode_stream_sliced, byte-equal to the single-card
    decoder and to the NumPy path (run in side processes meanwhile); the
    band step as one CUDA graph per key on the decoder's pooled set, its
    routes those of the capture policy on the keys packed on the host;
    K1, K2 and K3 counted through the replays: once per band and picture
    on (a) and (b), once per picture on (c); each band step's host ms by
    route and each capture. Then decode_streams_sliced_dp on a [2, 2]
    grid of the card over (b) and (a), twice: each stream's routes the
    policy's, the second call capturing nothing; each kernel's band form
    against its plain version, per band; frames/s of each band path
    beside the single-card decoder, its warm passes capturing nothing."""
    import torch

    from broadway_tpu_torch.core import graphs as GR
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
    from broadway_tpu_torch.parallel import slices as SL

    t0 = time.perf_counter()
    jobs = {lab: pool.apply_async(numpy_frames, (streams_abc[lab],))
            for lab in ("a", "b")}
    mesh = SL.make_band_mesh(device, N_BANDS)
    singles, out = {}, {"mesh": [str(d) for d in mesh], "streams": {},
                        "card": smi}
    keys = {lab: band_keys(streams_abc[lab]) for lab in ("a", "b")}
    GR.STACK_POOL.clear()       # the phase's graphs, counted from none
    times = RouteTimes(SL.BandSlicer, "_one_device",
                       lambda slicer, *a: slicer.stats["routes"],
                       lambda slicer, dec, *a: dec.group_graphs)
    with times:
        for lab, data in streams_abc.items():
            single = [f.tobytes() for f in decode_port(data, device)[0]]
            n = len(single)
            st = {}
            reset_launch_counts()
            got = SL.decode_stream_sliced(data, mesh, N_BANDS,
                                          parallel_slices=8, stats=st)
            counts = launch_counts()
            counts_dev = {"K2_intra": KW.device_launches(KW.INTRA),
                          "K3_deblock": KW.device_launches(KW.DEBLOCK)}
            if got != single:
                raise AssertionError(f"band path, stream ({lab}): "
                                     f"{_first_difference(got, single)} "
                                     "from the single-card decoder")
            declined = lab == "c"
            want_st = {"pictures": 0 if declined else n,
                       "declined": n if declined else 0,
                       "cross": 0 if declined or lab == "b" else n,
                       "host_arrays": 0,
                       "routes": band_routes([] if declined else keys[lab],
                                             False)}
            if st != want_st:
                raise AssertionError(f"band path, stream ({lab}): {st}, "
                                     f"expected {want_st}")
            per = 1 if declined else N_BANDS
            _require_one_launch_per_picture(
                f"band ({lab}, {per} per picture)", counts, per * n)
            _require_one_launch_per_picture(f"band ({lab}, device)",
                                            counts_dev, per * n)
            singles[lab] = single
            out["streams"][lab] = {"pictures": n, "stats": st,
                                   "keys": len(set(keys.get(lab, []))),
                                   "launches": counts,
                                   "device_launches": counts_dev,
                                   "band_step": times.take()}
            log(f"  ({lab}) decode_stream_sliced over {N_BANDS} bands: {n} "
                f"frames byte-equal to Decoder(device={device!r}); {st}; "
                f"wrapper launches {counts}, device {counts_dev}")
            log_route_times(f"({lab}) band step",
                            out["streams"][lab]["band_step"])

        dp_keys = [keys["b"], keys["a"]]
        out["dp"] = {"grid": [2, 2], "streams": ["b", "a"], "calls": []}
        for k in range(2):
            st = {}
            reset_launch_counts()
            got = SL.decode_streams_sliced_dp(
                [streams_abc["b"], streams_abc["a"]], [[device] * 2] * 2, 2,
                parallel_slices=8, stats=st)
            counts = launch_counts()
            for g, lab in zip(got, ("b", "a")):
                if g != singles[lab]:
                    raise AssertionError(
                        f"2-D form, call {k + 1}, stream ({lab}): "
                        f"{_first_difference(g, singles[lab])}")
            n_dp = len(singles["a"]) + len(singles["b"])
            _require_one_launch_per_picture("2-D (2 bands a picture)",
                                            counts, 2 * n_dp)
            routes = [s["routes"] for s in st["streams"]]
            want_routes = [band_routes(kk, k > 0) for kk in dp_keys]
            if routes != want_routes:
                raise AssertionError(f"2-D form, call {k + 1}: routes "
                                     f"{routes}, the capture policy gives "
                                     f"{want_routes}")
            out["dp"]["calls"].append({"launches": counts,
                                       "rounds": st["rounds"],
                                       "stats": st["streams"],
                                       "band_step": times.take()})
            log(f"  decode_streams_sliced_dp on a [2, 2] grid of {device}, "
                f"call {k + 1}: (b) and (a) byte-equal to their single-card "
                f"decodes; rounds {st['rounds']}, routes {routes}; wrapper "
                f"launches {counts}")
            log_route_times(f"2-D call {k + 1} band step",
                            out["dp"]["calls"][-1]["band_step"])
    out["dp"]["launches"] = out["dp"]["calls"][0]["launches"]
    torch.cuda.synchronize()
    out["stack_pool"] = GR.STACK_POOL.stats(lockstep=False)
    log(f"  decoders' stack sets after the band calls: "
        f"{ {k: v for k, v in out['stack_pool'].items() if k != 'captures'} }"
        f"; graphs by kind "
        f"{[c['kind'] for c in out['stack_pool']['captures']]}")

    # the kernels while the side processes decode: CUDA events, and every
    # short timing queued behind a held stream
    out["kernels"] = band_kernel_phase(streams_abc["a"], device)

    for lab, job in jobs.items():
        want = job.get(timeout=900)
        if singles[lab] != want:
            raise AssertionError(f"stream ({lab}): the single-card decoder "
                                 f"{_first_difference(singles[lab], want)} "
                                 "from the NumPy path")
    if singles["c"] != list(want_c):
        raise AssertionError("stream (c): the single-card decoder differs "
                             "from the NumPy path")
    log("  (a), (b), (c): the band path, the single-card decoder and the "
        "NumPy path agree on every byte")

    for lab, data in streams_abc.items():
        n = out["streams"][lab]["pictures"]
        single_s, band_s = [], []
        for k in range(passes):
            single_s.append(decode_port(data, device)[1])
            st = {}
            band_s.append(decode_port(
                data, mesh[0], recon_strategy=SL.BandSlicer(mesh,
                                                            stats=st))[1])
            if lab != "c" and st["routes"] != band_routes(keys[lab], True):
                raise AssertionError(f"({lab}) warm pass {k}: routes "
                                     f"{st['routes']}, expected "
                                     f"{band_routes(keys[lab], True)}")
            log(f"  ({lab}) warm pass {k}: band path "
                f"{n / band_s[-1]:.2f} frames/s (routes {st['routes']}), "
                f"single-card {n / single_s[-1]:.2f} frames/s")
        rec = out["streams"][lab]
        rec["band_fps"] = n / _median(band_s)
        rec["single_fps"] = n / _median(single_s)
        log(f"  ({lab}) median of {passes}: band path {rec['band_fps']:.2f} "
            f"frames/s, single-card {rec['single_fps']:.2f} ({smi})")
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    out["singles"] = singles        # phases 15 and 16 hold to them
    return out


MP_TIMEOUT_S = 300           # phase 15: each rank's own time limit
_RANK = r"""
import json, pickle, sys
rank, port, path, sp = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                        int(sys.argv[4]))
sys.path.insert(0, %(repo)r)
import torch
import torch.distributed as dist
from broadway_tpu_torch.parallel import multihost as MH
MH.init_multihost(f"localhost:{port}", 2, rank)      # backend "nccl"
card = torch.cuda.current_device()
with open(path, "rb") as f:
    case = pickle.load(f)
backends, gather = [], dist.all_gather_object

def spy(out, obj, group=None):
    backends.append(dist.get_backend(group))
    return gather(out, obj, group=group)

dist.all_gather_object = spy
got = MH.decode_streams_multihost(case["datas"], sp_bands=sp,
                                  parallel_slices=8)
ok = got == case["wants"]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "broadway_tpu"))
print(json.dumps({"rank": rank, "world": dist.get_world_size(),
                  "card": card, "cards": [str(d) for d in
                                          MH.local_devices("cuda", sp)],
                  "backend": dist.get_backend(), "exchange": backends,
                  "byte_equal": ok, "jax_modules": bad}), flush=True)
dist.destroy_process_group()
sys.exit(0 if ok and not bad else 1)
"""


def multiprocess_phase(datas, wants, sp_bands: int = 1) -> dict:
    """Phase 15: the multi-process path on the card(s): two ranks (this
    script's Python in two processes, each with its own time limit) join
    one job with init_multihost's default backend (NCCL), each on the
    card rank_cards gives it (two ranks share a card when there is one),
    decode their share of `datas` with decode_streams_multihost
    (sp_bands bands a picture over the rank's cards), and the exchange
    over a gloo group gives both every stream: byte-equal to `wants`, the
    single-card decoder's frames. Returns each rank's report."""
    import pickle
    import socket
    import tempfile

    import torch

    from broadway_tpu_torch.parallel.multihost import rank_cards
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        path = os.path.join(tmp, "case.pkl")
        with open(path, "wb") as f:
            pickle.dump({"datas": list(datas), "wants": wants}, f)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
        procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK % {"repo": REPO}, str(r), str(port),
             path, str(sp_bands)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=tmp)
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MP_TIMEOUT_S))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    reports = []
    count = torch.cuda.device_count()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{so[-2000:]}\n{se[-4000:]}")
        rep = json.loads(so.strip().splitlines()[-1])
        want_cards = [f"cuda:{i}" for i in rank_cards(r, 2, count,
                                                      sp_bands)]
        if rep["card"] != rank_cards(r, 2, count)[0] or \
                rep["cards"] != want_cards or rep["exchange"] != ["gloo"]:
            raise AssertionError(f"rank {r}: {rep}, expected card "
                                 f"{rank_cards(r, 2, count)[0]}, cards "
                                 f"{want_cards}, exchange over gloo")
        reports.append(rep)
        log(f"    rank {r} of {rep['world']}: card cuda:{rep['card']}, band "
            f"cards {rep['cards']}, job backend {rep['backend']}, exchange "
            f"{rep['exchange']}; {len(datas)} streams byte-equal to the "
            "single-card decoder")
    sec = time.perf_counter() - t0
    log(f"    phase 15 (sp_bands={sp_bands}) took {sec:.1f} s")
    return {"ranks": reports, "sp_bands": sp_bands, "streams": len(datas),
            "seconds": sec}


def multicard_phase(streams_ab: dict, singles: dict, smi: str) -> dict:
    """Phase 16, with two cards or more: phase 11's streams (a) and (b)
    over a mesh of distinct cards (cards 0-3 with four or more, else 0-1;
    one band a card), twice: every frame byte-equal to the single-card
    decoder (`singles`), the band step as a graph per card (and a gather
    graph per card) on the decoders' pooled sets and mirrors, its routes
    those of the capture policy on the keys packed on the host (the
    second call capturing nothing), K1, K2 and K3 once a band and
    picture; host ms by route and by card, each capture by card. With
    one card it reports that it did not run."""
    import torch

    from broadway_tpu_torch.core import graphs as GR
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
    from broadway_tpu_torch.parallel import slices as SL
    from broadway_tpu_torch.tools import bandcheck

    count = torch.cuda.device_count()
    if count < 2:
        log(f"    not run: torch sees {count} card; a mesh of distinct cards "
            "needs two or more")
        return {"ran": False, "cards": count}
    t0 = time.perf_counter()
    n = 4 if count >= 4 else 2        # the streams' slices align with both
    mesh = [torch.device("cuda", i) for i in range(n)]
    out = {"ran": True, "cards": count, "mesh": [str(d) for d in mesh],
           "card": smi, "streams": {}}
    GR.STACK_POOL.clear()
    for lab, data in streams_ab.items():
        keys = band_keys(data)
        out["streams"][lab] = calls = []
        for k in range(2):
            st = {}
            reset_launch_counts()
            with bandcheck.step_times() as t:
                got = SL.decode_stream_sliced(data, mesh, n,
                                              parallel_slices=8, stats=st)
            for d in mesh:
                torch.cuda.synchronize(d)
            counts = launch_counts()
            counts_dev = {"K2_intra": KW.device_launches(KW.INTRA),
                          "K3_deblock": KW.device_launches(KW.DEBLOCK)}
            if got != singles[lab]:
                raise AssertionError(
                    f"mesh of {n} cards, stream ({lab}), call {k + 1}: "
                    f"{_first_difference(got, singles[lab])} from the "
                    "single-card decoder")
            want = dict.fromkeys(("eager", "captured", "replayed"), 0)
            want.update({"multi_card_" + r: v for r, v in
                         expected_routes(keys, k > 0).items()})
            if st["routes"] != want:
                raise AssertionError(f"mesh, stream ({lab}), call {k + 1}: "
                                     f"routes {st['routes']}, the capture "
                                     f"policy gives {want}")
            _require_one_launch_per_picture(
                f"mesh ({lab}, {n} a picture)", counts, n * len(got))
            _require_one_launch_per_picture(f"mesh ({lab}, device)",
                                            counts_dev, n * len(got))
            calls.append({"routes": st["routes"], "launches": counts,
                          "device_launches": counts_dev,
                          "step_host_ms": t["host_ms"],
                          "step_card_ms": t["card_ms"]})
            log(f"    ({lab}) over {n} cards, call {k + 1}: {len(got)} "
                f"frames byte-equal to the single-card decoder; routes "
                f"{st['routes']}; launches {counts}, device {counts_dev}; "
                f"host ms { {r: _rounded(v) for r, v in t['host_ms'].items()} }")
    out["captures"] = [
        {"capture_ms": g.capture_ms, "capture_parts_ms": g.capture_parts,
         "capture_card_ms": g.card_capture_ms,
         "pool_card_bytes": g.card_pool_bytes, "replays": g.replays}
        for s in GR.STACK_POOL._free.values() for st in s
        for g in st.graphs.graphs() if g.kind == "band_mesh"]
    for c in out["captures"]:
        log(f"    captured a band_mesh graph set: {c['capture_ms']:.3f} ms "
            f"({c['capture_parts_ms']}), by card {c['capture_card_ms']}, "
            f"pool bytes by card {c['pool_card_bytes']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"    phase 16 took {out['seconds']:.1f} s ({smi}; {count} cards)")
    return out


def mv_shares(mv, rb) -> dict:
    """Of the MBs that predict (any block with a reference): the share
    whose 16 blocks hold more than one (vector, reference), and more than
    one quarter-pel fraction."""
    n = rb.shape[0]
    mv, rb = mv.reshape(n, 16, 2), rb.reshape(n, 16)
    pred = (rb >= 0).any(dim=1)
    many_vec = ((mv != mv[:, :1]).any(dim=2) | (rb != rb[:, :1])).any(dim=1)
    frac = mv & 3
    many_frac = (frac != frac[:, :1]).any(dim=2).any(dim=1)
    n_pred = int(pred.sum())
    return {"predicting_mbs": n_pred, "mbs": n,
            "share_many_vectors": int((many_vec & pred).sum()) / n_pred,
            "share_many_fractions": int((many_frac & pred).sum()) / n_pred}


def first_p_picture(data: bytes, device):
    """The per-MB arrays of a stream's second picture (its first P
    picture, for the streams here), its layout and its stack slots."""
    import torch

    from broadway_tpu_torch.core.packed import pack_stream, unpack_arrs_v2
    buf, bk, lay, ci, co, R = pack_stream(data, max_pics=2)[1]
    return (unpack_arrs_v2(torch.from_numpy(buf).to(device), lay, bk, ci,
                           co), lay, R)


def x264_k1_phase(data: bytes, device, seed: int = 264) -> dict:
    """K1 on the x264 stream's first P picture (a real encoder's vectors:
    P_8x8 sub-partitions, three references): against its plain version,
    timed with CUDA events behind a held stream (as phase 4), its bound
    from this run's inputs, the empty launch of its grid, and the shares
    of MBs with more than one vector / fraction."""
    import numpy as np
    import torch

    from broadway_tpu_torch.ops.gpu import inter
    from broadway_tpu_torch.ops.gpu import mc_kernel as K1
    from broadway_tpu_torch.ops.gpu import probe

    arrs, lay, R = first_p_picture(data, device)
    w, h = lay.w, lay.h
    rng = np.random.RandomState(seed)
    ref_y = torch.from_numpy(rng.randint(0, 256, (R, 16 * h, 16 * w),
                                         dtype=np.uint8)).to(device)
    ref_c = torch.from_numpy(rng.randint(0, 256, (R, 2, 8 * h, 8 * w),
                                         dtype=np.uint8)).to(device)
    mv, rb = arrs["mv"], arrs["ref_blk"]
    args = (ref_y, ref_c, mv, rb, w, h)
    got = K1.mc_predict(*args)
    want = inter.mc_predict_plain(*args)
    err = max(int((g.to(torch.int32) - x.to(torch.int32)).abs().max())
              for g, x in zip(got, want))
    if err > TOL:
        raise AssertionError(f"K1_mc differs from its plain version on the "
                             f"x264 P picture: max |err| {err}")
    bnd = k1_bound(ref_y, ref_c, mv, rb, got, w, h)
    ms = cuda_ms(lambda: K1.mc_predict(*args), K1_REPS, HOLD_MS)
    plain_ms = cuda_ms(lambda: inter.mc_predict_plain(*args), 1)
    ctas, threads = K1.launch_shape(mv.shape[0])
    floor = cuda_ms(lambda: probe.launch_probe(ctas, threads, device),
                    K1_REPS, HOLD_MS)
    out = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
           "bound_bytes": bnd["bound_bytes"], "bound_launch_ms": floor,
           "ms_over_bound": ms / bnd["bound_ms"],
           "ms_over_bound_held_to": ms / max(bnd["bound_ms"], floor),
           **mv_shares(mv, rb)}
    log(f"  (b) K1_mc on the x264 P picture ({w}x{h} MBs, {R} slots): "
        f"kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}), empty launch of its "
        f"grid {floor:.5f} ms; {out['ms_over_bound']:.2f}x its bound; "
        f"{out['predicting_mbs']} of {out['mbs']} MBs predict, "
        f"{100 * out['share_many_vectors']:.1f}% of them with more than one "
        f"vector, {100 * out['share_many_fractions']:.1f}% with more than "
        "one fraction; byte-equal to plain")
    return out


def _md5s(frames) -> list:
    import hashlib
    return [hashlib.md5(f if isinstance(f, bytes) else f.tobytes())
            .hexdigest() for f in frames]


def pump_pair(data: bytes, device, label: str, want_md5s,
              passes: int) -> dict:
    """The stream through Decoder(device, parallel_slices=8) with the pump
    off and on: each run's picture md5s equal to `want_md5s`, K1 / K2 / K3
    once a picture (K2 / K3 also on the device), then frames/s of both,
    median of `passes` warm passes taken in turns."""
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW

    out = {}
    for pump in (False, True):
        reset_launch_counts()
        frames, _ = decode_port(data, device, async_pump=pump)
        counts = launch_counts()
        counts_dev = {"K2_intra": KW.device_launches(KW.INTRA),
                      "K3_deblock": KW.device_launches(KW.DEBLOCK)}
        got = _md5s(frames)
        if got != list(want_md5s):
            raise AssertionError(f"{label}, async_pump={pump}: "
                                 f"{_first_difference(got, want_md5s)}")
        n = len(got)
        _require_one_launch_per_picture(f"{label} pump={pump}", counts, n)
        _require_one_launch_per_picture(f"{label} pump={pump} (device)",
                                        counts_dev, n)
        out["on" if pump else "off"] = {"launches": counts,
                                        "device_launches": counts_dev}
    secs = {False: [], True: []}
    for k in range(passes):
        for pump in (False, True) if k % 2 == 0 else (True, False):
            secs[pump].append(decode_port(data, device, async_pump=pump)[1])
        log(f"  {label} warm pass {k}: pump off {n / secs[False][-1]:.2f}, "
            f"on {n / secs[True][-1]:.2f} frames/s")
    for pump in (False, True):
        rec = out["on" if pump else "off"]
        rec["fps"] = n / _median(secs[pump])
        rec["fps_passes"] = [n / x for x in secs[pump]]
    out["pictures"] = n
    log(f"  {label}: {n} pictures equal with the pump off and on, K1 / K2 / "
        f"K3 once a picture; median of {passes}: off {out['off']['fps']:.2f}"
        f", on {out['on']['fps']:.2f} frames/s")
    return out


def tools_phase(data: bytes, want_frames, k1_p_ms: float, x264: dict,
                numpy_s: float, story_job, device, smi: str,
                passes: int = PUMP_PASSES) -> dict:
    """Phase 12: the committed x264 1080p stream with the pump off and on
    (and phase 3's stream, `data`, whose NumPy frames are `want_frames`),
    K1 on the x264 P picture (beside phase 3's P picture: its shares, and
    K1's phase-4 time on it, `k1_p_ms`), demo.tree on its MP4 mux,
    demo.story on the CIF stream three times, and the conformance
    sweep."""
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
    from broadway_tpu_torch.tools import (bench, conformance_sweep, demo,
                                          mp4mux)

    t0 = time.perf_counter()
    xdata, info = x264["data"], x264["info"]
    out = {"card": smi, "numpy_path_s": numpy_s}
    out["x264"] = {"stream": os.path.relpath(bench.X264, REPO) + ".h264",
                   "made_with": info["made_with"], "settings": info["x264"],
                   "pump": pump_pair(xdata, device, "(a) x264 1080p",
                                     info["frames"], passes)}
    out["realistic_pump"] = pump_pair(data, device, "(a) phase 3's stream",
                                      _md5s(want_frames), passes)
    log(f"  (a) host probe beside them: the NumPy path took {numpy_s:.1f} s "
        f"for phase 3's frames ({smi})")

    out["x264"]["k1"] = x264_k1_phase(xdata, device)
    arrs = first_p_picture(data, device)[0]
    real = out["x264"]["k1"]["realistic_p"] = dict(
        mv_shares(arrs["mv"], arrs["ref_blk"]), ms=k1_p_ms)
    log(f"      beside it phase 3's P picture: K1 {k1_p_ms:.5f} ms (phase "
        f"4); {real['predicting_mbs']} of {real['mbs']} MBs predict, "
        f"{100 * real['share_many_vectors']:.1f}% with more than one "
        f"vector, {100 * real['share_many_fractions']:.1f}% with more than "
        "one fraction")

    reset_launch_counts()
    r = demo.tree(mp4mux.mux(xdata, info["width"], info["height"]), device)
    counts = launch_counts()
    if _md5s(r["yuv"]) != info["frames"]:
        raise AssertionError("(c) demo.tree: " + _first_difference(
            _md5s(r["yuv"]), info["frames"]))
    _require_one_launch_per_picture("demo.tree", counts, len(r["yuv"]))
    out["tree"] = {"frames": r["frames"], "seconds": r["seconds"],
                   "fps": r["fps"], "launches": counts}
    log(f"  (c) demo.tree on the port's MP4 mux of the x264 stream: "
        f"{r['frames']} frames in {r['seconds']:.3f} s, md5s equal to the "
        f"JSON's; wrapper launches {counts}")

    story_data, story_want = story_job.get(timeout=900)
    runs = []
    for k in range(STORY_RUNS):
        reset_launch_counts()
        ts = time.perf_counter()
        res = demo.story(story_data, device)
        sec = time.perf_counter() - ts
        counts = launch_counts()
        counts_dev = {"K2_intra": KW.device_launches(KW.INTRA),
                      "K3_deblock": KW.device_launches(KW.DEBLOCK)}
        for p in res:
            if p["yuv"] != story_want:
                raise AssertionError(
                    f"(d) story run {k}, {p['label']} ({p['device']}, "
                    f"{p['render']}): "
                    f"{_first_difference(p['yuv'], story_want)} from the "
                    "NumPy path")
        n_card = sum(p["device"] != "cpu" for p in res)
        _require_one_launch_per_picture(f"story ({n_card} card players)",
                                        counts, n_card * len(story_want))
        _require_one_launch_per_picture("story (device)", counts_dev,
                                        n_card * len(story_want))
        runs.append({"seconds": sec, "launches": counts,
                     "device_launches": counts_dev,
                     "players": [{key: p[key] for key in
                                  ("label", "device", "render", "frames",
                                   "seconds", "fps")} for p in res]})
        log(f"  (d) demo.story run {k}: 6 players at once ({n_card} on "
            f"{device}, pumped, on threads), {len(story_want)} pictures "
            f"each, every player byte-equal to the NumPy path, {sec:.2f} s; "
            "fps " + ", ".join(f"{p['device']}/{p['render']} {p['fps']:.1f}"
                              for p in res)
            + f"; launches {counts}, device {counts_dev}")
    out["story"] = {"stream": dict(STORY_STREAM[1],
                                   generator=STORY_STREAM[0]),
                    "pictures": len(story_want), "runs": runs}

    ts = time.perf_counter()
    count, seed = SWEEP
    res = conformance_sweep.run_sweep(device, count, seed)
    bad = [name for name, ok in res if not ok]
    if len(res) != count or bad:
        raise AssertionError(f"(e) conformance sweep: {bad} differ from the "
                             "NumPy path")
    out["sweep"] = {"streams": [name for name, _ in res], "equal": len(res),
                    "seconds": time.perf_counter() - ts}
    log(f"  (e) conformance_sweep.run_sweep({device!r}, {count}, {seed}): "
        f"{len(res)}/{count} byte-equal to the NumPy path "
        f"({out['sweep']['seconds']:.1f} s)")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 12 took {out['seconds']:.1f} s")
    return out


def _md5_flags(obj):
    """Every md5_ok flag of a bench line."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from ([v] if k == "md5_ok" else _md5_flags(v))
    elif isinstance(obj, list):
        for v in obj:
            yield from _md5_flags(v)


def bench_phase(device) -> dict:
    """Phase 13: tools.bench.run(plan="quick") in this process (its streams
    are phase 3's, phase 9's and the two generated at start-up, all in
    build/'s cache by now). Every section must be there, have run to its
    end and held every md5; K1, K2 and K3 must have launched in it."""
    from broadway_tpu_torch.tools import bench

    t0 = time.perf_counter()
    lines = []

    def emit(line: str) -> None:
        lines.append(json.loads(line))
        log(f"    {line}")

    reset_launch_counts()
    rc, last = bench.run(plan="quick", device=device, passes=2, emit=emit)
    counts = launch_counts()
    got = [r["section"] for r in lines]
    if got != list(bench.SECTIONS):
        raise AssertionError(f"bench sections {got}, expected "
                             f"{list(bench.SECTIONS)}")
    for r in lines:
        flags = list(_md5_flags(r))
        if not r["ok"] or not flags or not all(f is True for f in flags):
            raise AssertionError(f"bench section {r['section']}: ok "
                                 f"{r['ok']}, md5 checks {flags}, error "
                                 f"{r['error']}")
    if rc != 0:
        raise AssertionError(f"bench exit code {rc}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name} never launched in the benchmark")
    sec = time.perf_counter() - t0
    log(f"    {len(lines)} sections, every md5 held; launches {counts}; "
        f"e2e {last['value']:.2f} frames/s; host probe "
        f"{last['detail']['host_probe_parse_ms']}; phase 13 took {sec:.1f} s")
    return {"launches": counts, "seconds": sec, "e2e_fps": last["value"],
            "host_probe_parse_ms": last["detail"]["host_probe_parse_ms"],
            "fps": {k: last["detail"]["sections"][s].get(k)
                    for s, k in (("batch", "fps_batch_aggregate"),
                                 ("4k", "fps_4k_e2e"),
                                 ("pipeline", "fps_pipeline"),
                                 ("dense", "fps_dense_e2e"),
                                 ("fetch", "fps_e2e_fetch"))}}


def story_stream_and_frames() -> tuple:
    """Phase 12's CIF story stream and its NumPy path's frames (run in a
    side process)."""
    data = band_stream(*STORY_STREAM)
    return data, numpy_frames(data)


def check_no_jax() -> None:
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "broadway_tpu"))
    if bad:
        raise AssertionError(f"JAX or the JAX package was imported: {bad}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from broadway_tpu_torch.ops.gpu import _build

    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"    nvcc: {nvcc[-1]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"    card: {smi}; torch sees {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")

    # the three short streams of phase 9, the two of phase 11, phase 12's
    # story stream (with its NumPy decode) and phase 13's 4K and dense
    # streams are generated (pure Python,
    # some seconds each) in processes of their own beside the main stream,
    # and are all there before anything is timed; phase 11 runs its NumPy
    # decodes in the same pool
    pool = multiprocessing.get_context("spawn").Pool(
        len(LOCKSTEP_STREAMS) - 1 + len(BAND_STREAMS) + 1 + 2)
    try:
        return run_phases(torch, smi, pool)
    finally:
        pool.terminate()
        pool.join()


def run_phases(torch, smi: str, pool) -> int:
    from broadway_tpu_torch.bitstream import native as nat
    from broadway_tpu_torch.ops.gpu import _build
    from broadway_tpu_torch.tools import bench, bench_common

    extra = [pool.apply_async(bench_common.realistic_bench_stream,
                              (120, 68), {"n_frames": n, "seed": seed})
             for seed, n in LOCKSTEP_STREAMS[1:]]
    band_jobs = {lab: pool.apply_async(band_stream, (gen, kw))
                 for lab, gen, kw in BAND_STREAMS}
    story_job = pool.apply_async(story_stream_and_frames)
    quick = bench.PLANS["quick"]
    bench_jobs = [pool.apply_async(bench._generate, spec)
                  for spec in (quick.uhd, quick.dense)]
    x264 = bench.load_x264()
    t0 = time.perf_counter()
    fe_error = []

    def build_fe():
        try:
            nat.load()
        except BaseException as e:     # re-raised on the main thread
            fe_error.append(e)

    th = threading.Thread(target=build_fe)
    th.start()
    _build.load()
    th.join()
    if fe_error:
        raise fe_error[0]
    log(f"[2] both libraries built and loaded in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{os.path.relpath(_build.library_path(), REPO)}, "
        f"{os.path.relpath(_build.frontend_library_path(), REPO)}")

    t0 = time.perf_counter()
    data = bench_common.realistic_bench_stream(120, 68, n_frames=N_FRAMES)
    datas = [data] + [r.get(timeout=600) for r in extra]
    band_streams = {lab: r.get(timeout=600) for lab, r in band_jobs.items()}
    band_streams["c"] = data
    log(f"[3] stream 1920x1088 x{N_FRAMES}: {len(data)} bytes, and "
        f"{len(extra)} more of {[n for _, n in LOCKSTEP_STREAMS[1:]]} "
        f"pictures for phase 9, and phase 11's "
        f"{ {lab: len(d) for lab, d in band_streams.items()} } bytes "
        f"({time.perf_counter() - t0:.1f} s)")

    log("[4] kernels vs plain versions at 1080p shapes")
    from broadway_tpu_torch.core.packed import pack_stream
    pictures = pack_stream(data, max_pics=N_FRAMES)
    if len(pictures) < N_FRAMES:
        raise RuntimeError(f"the stream has fewer than {N_FRAMES} pictures")
    kres = kernel_phase(pictures[:2], "cuda")
    k1_synth = k1_synthetic_phase("cuda")
    probe = handoff_phase(120, 68, "cuda")
    log(f"    a batch of {N_FRAMES} pictures in one launch per kernel")
    batched = batched_kernel_phase(pictures, "cuda")
    log("    scaling with the pictures in a round")
    scaling = scaling_phase(pictures[1:], pictures[0], "cuda")

    log(f"[5] K2 and K3 at {16 * BIG[0]}x{16 * BIG[1]}")
    big = big_phase("cuda")

    log("[6] the per-picture step")
    step = step_phase(pictures[1], "cuda")

    log("[7] end to end")
    counts, per_pic, fps, want_frames, numpy_s = e2e_phase(data, "cuda")
    n = len(want_frames)

    log("[8] the entry points: MP4Player, SoftAvc, YUV->RGB")
    entry = entry_phase(data, want_frames, 1920, 1088, "cuda", smi)

    log("[9] lockstep: four 1920x1088 streams; the v1 and unpacked paths")
    mixed = [data, band_streams["a"], band_streams["b"]] * 2 + \
        [data, band_streams["a"]]
    lockstep = lockstep_phase(datas, want_frames, mixed, "cuda", numpy_s)
    pack_modes = pack_modes_phase(bench_common.annexb_prefix(data, 3),
                                  "cuda")

    log("[10] frame groups: one 10-picture 1920x1088 stream, G = 2 and 4")
    groups = group_phase(datas, "cuda", numpy_s)

    log(f"[11] band sharding: 1920x1088 over {N_BANDS} bands on the card")
    bands = band_phase(band_streams, want_frames, pool, "cuda", smi)

    log("[12] x264 1080p with the pump off and on, K1 on x264, demo tree "
        "and story, the conformance sweep")
    tools = tools_phase(data, want_frames,
                        kres["K1_mc"]["per_picture"]["P"]["ms"], x264,
                        numpy_s, story_job, "cuda", smi)
    for job in bench_jobs:
        job.get(timeout=600)
    pool.close()
    pool.join()

    log("[13] the benchmark's short form: every section, md5s held")
    bench_res = bench_phase(device="cuda")

    log("[14] the default path's graphs: two decoders in turn, the second "
        "capturing nothing")
    step_graphs = step_graph_phase(data, want_frames, pictures, "cuda")
    step_graphs["phase7_device_launches_per_picture"] = per_pic
    step_graphs["phase12_story_launches"] = [
        run["launches"] for run in tools["story"]["runs"]]
    log(f"    phase 7: device launches per picture {per_pic}; phase 12 "
        f"(d): launches per story run "
        f"{step_graphs['phase12_story_launches']}")

    log("[15] multi-process: two ranks, each on the card it picks, the "
        "exchange over gloo")
    short = datas[1:]
    multiproc = {"one_band": multiprocess_phase(
        short, [[f.tobytes() for f in decode_port(d, "cuda")[0]]
                for d in short])}
    if torch.cuda.device_count() >= 4:
        ab = [band_streams["a"], band_streams["b"]]
        multiproc["two_bands"] = multiprocess_phase(
            ab, [bands["singles"][lab] for lab in ("a", "b")], sp_bands=2)

    log("[16] band sharding over distinct cards")
    multicard = multicard_phase({lab: band_streams[lab] for lab in "ab"},
                                bands["singles"], smi)
    check_no_jax()
    log("    neither jax nor broadway_tpu in sys.modules")

    kernels = []
    for name, (src, tpu) in KERNELS.items():
        r = kres[name]
        wave = name != "K1_mc"
        # the floor beside the byte/operation bound: the hand-off chain
        # for the wavefront kernels, the empty launch of its grid for K1.
        # Each picture is held to the larger of ITS bound and the floor;
        # the ratios are per picture, never against a mean over pictures
        # whose work differs. The hand-off floor is the chain of a picture
        # with work in every MB (the IDR here); a picture whose idle MBs
        # wait for nothing can run under it.
        for label, pp in r["per_picture"].items():
            floor = (probe["handoff_floor_ms"] if wave
                     else pp["bound_launch_ms"])
            pp["bound_held_to_ms"] = max(pp["bound_ms"], floor)
            pp["bound_held_to_by"] = (
                ("hand-offs" if wave else "launch")
                if floor > pp["bound_ms"] else pp["bound_by"])
            pp["ms_over_bound_held_to"] = pp["ms"] / pp["bound_held_to_ms"]
            log(f"    {name} {label}: {pp['ms']:.5f} ms = "
                f"{pp['ms_over_bound_held_to']:.2f}x the bound it is held "
                f"to, {pp['bound_held_to_ms']:.5f} ms by "
                f"{pp['bound_held_to_by']} (bound_ms {pp['bound_ms']:.5f} by "
                f"{pp['bound_by']}, floor {floor:.5f})")
        floor = probe["handoff_floor_ms"] if wave else r["bound_launch_ms"]
        held = [pp["bound_held_to_ms"] for pp in r["per_picture"].values()]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,      # no single PyTorch call computes it
            "device_launches_per_picture": per_pic[name],
            "bound_bytes": r["bound_bytes"],
            "bound_handoff_ms": floor if wave else None,
            # K2 / K3 behind a held stream (device time alone), mean of
            # the pictures; ms above is timed back to back, as before
            "device_ms": r.get("device_ms"),
            "bound_launch_ms": None if wave else floor,
            # means over the pictures, like ms and bound_ms; what each
            # picture is held to, by what, and its ratio: per_picture
            "bound_held_to_ms": sum(held) / len(held),
            # one launch for a batch of pictures, timed beside one launch
            # per picture; and the lockstep path's launches (one a round)
            "batched": batched[name],
            "launches_lockstep_path": lockstep["launches"][name],
            "launches_player_path": entry["player_launches"][name],
            "launches_omx_path": entry["omx_launches"][name],
            "launches_group_path": groups["launches"][name],
            # phase 11: stream (a), 4 bands, the form of each band's
            # launch; (b), (c) and the 2-D form beside it
            "launches_band_path": bands["streams"]["a"]["launches"][name],
            "launches_band_paths": dict(
                {lab: r["launches"][name]
                 for lab, r in bands["streams"].items()},
                dp=bands["dp"]["launches"][name]),
            "band": {"form": ("mb0 = band * 17 * 120, ref_h_mbs = 68"
                              if name == "K1_mc" else
                              "18 rows with the ghost row"
                              if name == "K3_deblock" else "17 rows"),
                     "per_band": bands["kernels"][name],
                     "without_ghost_17_rows":
                         bands["kernels"]["K3_deblock_17_rows"]
                         if name == "K3_deblock" else None},
            "per_picture": r["per_picture"],
            # phase 12: the x264 stream with the pump off / on, demo.tree
            # on its MP4, each demo.story run (4 card players)
            "launches_x264_paths": {
                "pump_off": tools["x264"]["pump"]["off"]["launches"][name],
                "pump_on": tools["x264"]["pump"]["on"]["launches"][name],
                "tree": tools["tree"]["launches"][name],
                "story": [run["launches"][name]
                          for run in tools["story"]["runs"]]},
            "x264_p": None if wave else tools["x264"]["k1"],
            # phase 13: the benchmark's short form, all sections
            "launches_bench_path": bench_res["launches"][name],
            "synthetic": None if wave else k1_synth,
            "big": big.get(name),
            # the clustered launch at 1080p, and the hand-off floors of the
            # probe (phase 4: one step inside a cluster and across)
            "cluster": r.get("cluster"), "grid": r.get("grid"),
            "resident_clusters": (r["resident_ctas"] // r["cluster"]
                                  if wave else None),
            "handoff_in_cluster_us": probe["in_cluster_us"] if wave else None,
            "handoff_across_cluster_us": (probe["across_cluster_us"]
                                          if wave else None)})
    record = {"kernels": kernels, "handoff": probe,
              "big_handoff_floor_ms": big["handoff_floor_ms"],
              "step": step, "step_graphs": step_graphs,
              "lockstep": lockstep, "pack_modes": pack_modes,
              "groups": groups,
              "bands": {k: v for k, v in bands.items()
                        if k not in ("kernels", "singles")},
              "multiprocess": multiproc, "multicard": multicard,
              "pump": {"x264": tools["x264"]["pump"],
                       "realistic": tools["realistic_pump"]},
              "x264": {k: v for k, v in tools["x264"].items()
                       if k != "pump"},
              "tree": tools["tree"], "story": tools["story"],
              "sweep": tools["sweep"], "phase12_s": tools["seconds"],
              "bench": bench_res, "e2e_fps": fps, "frames": n,
              "numpy_path_s": numpy_s,
              "yuv2rgb": {"rgba_int_ms": entry["rgba_int_ms"],
                          "rec709_ms": entry["rec709_ms"],
                          "width": 1920, "height": 1088, "card": smi}}
    print(json.dumps({"scaling": scaling, "card": smi}))
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
