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
     operations); the wavefront hand-off floor (the scaffold of K2/K3
     with an empty MB body over 120x68 MBs); the kernels' record names
     the larger of the two as the bound each kernel is held to
  5. K2 and K3 at 4096x2176 (256x136 MBs, every MB with work, synthetic
     operands from a seed): kernel against plain over the whole picture
  6. the per-picture step on the P picture: host enqueue, device span,
     device kernels per step
  7. end to end: the port's Decoder(device="cuda", parallel_slices=8)
     over the stream, every frame byte-equal to the port's NumPy path
     (Decoder(recon="numpy")); every kernel must have launched on that
     run, K2 and K3 once per picture on the device; then timed warm
     passes (median frames/s); neither JAX nor the JAX package may load
The last three lines of stdout: the kernels' JSON record, the
nvidia-smi name/power-limit line, and {"ok": true, "device": ...}.
Exits non-zero and prints no result without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 4
WARM_PASSES = 5
TOL = 0      # decoding is integer-exact: every comparison is byte equality
BIG = (256, 136)             # 4096x2176: more rows than SMs, every MB busy
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


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA
    events around `reps` calls after one warm-up call)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def k1_distinct_ref_pels(ref_y, ref_c, mv, rb, w: int, h: int) -> int:
    """Reference pels that this picture's vectors point at, each counted
    once: per 4x4 block the 4x4 window at its integer vector, widened to
    9 columns / 9 rows where the vector has a horizontal / vertical
    fraction (a 5-wide cross where only the two half-pel lines are
    averaged); per 2x2 chroma block 2 or 3 columns and rows, in both
    planes."""
    import torch
    R, H, W = ref_y.shape
    dev = mv.device
    n = mv.shape[0]
    mb = torch.arange(n, device=dev)
    bx = torch.arange(4, device=dev)[None, None, :]
    by = torch.arange(4, device=dev)[None, :, None]
    px = ((mb % w) * 16)[:, None, None] + bx * 4 + 0 * by
    py = ((mb // w) * 16)[:, None, None] + by * 4 + 0 * bx
    px, py = px.reshape(-1), py.reshape(-1)
    mvx = mv[..., 0].reshape(-1).long()
    mvy = mv[..., 1].reshape(-1).long()
    slot = rb.reshape(-1).clamp(0, R - 1).long()
    fx, fy = mvx & 3, mvy & 3
    cross = (fx & 1).bool() & (fy & 1).bool()   # b and h averaged, no j
    x0, y0 = px + (mvx >> 2) - 2, py + (mvy >> 2) - 2
    mask = torch.zeros(R * H * W, dtype=torch.bool, device=dev)
    for dy in range(9):
        row_ok = (fy != 0) if not 2 <= dy <= 5 else torch.ones_like(cross)
        for dx in range(9):
            col_ok = (fx != 0) if not 2 <= dx <= 5 else torch.ones_like(cross)
            keep = row_ok & col_ok
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
            _mark(mask, slot, cy0 + dy, cx0 + dx, row_ok & col_ok, Hc, Wc)
    return luma + 2 * int(mask.sum())


def k1_bound(ref_y, ref_c, mv, rb, out, w: int, h: int):
    # the reference pels the vectors point at, once each; the vectors and
    # reference indices; one byte per predicted pel (values are 0..255:
    # that the port hands them on as int32 is its choice, not the
    # function's); ~40 integer operations per predicted pel (6-tap both
    # ways, rounding, clip)
    pels = out[0].numel() + out[1].numel()
    return bound(k1_distinct_ref_pels(ref_y, ref_c, mv, rb, w, h)
                 + _nbytes(mv, rb) + pels, 40 * pels)


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

    def record(name, got, want, run, run_plain, label, bnd, busy=None):
        err = max(int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
                  for g, w in zip(got, want))
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if err > TOL:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"on the {label} picture: max |err| {err}")
        r["bound_ms"].append(bnd["bound_ms"])
        r["bound_bytes"].append(bnd["bound_bytes"])
        r["bound_by"] = bnd["bound_by"]
        if on_cuda:
            ms, pms = cuda_ms(run, reps), cuda_ms(run_plain, plain_reps)
            r["ms"].append(ms)
            r["plain_ms"].append(pms)
            r["per_picture"][label] = {"ms": ms, "plain_ms": pms,
                                       "bound_ms": bnd["bound_ms"],
                                       "busy_mbs": busy}
            log(f"  {name} {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
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
               label, k1_bound(ref_y, ref_c, mv, rb, got, w, h))

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

    for r in res.values():
        for k in ("ms", "plain_ms", "bound_ms", "bound_bytes"):
            r[k] = sum(r[k]) / len(r[k]) if r[k] else None
    return res


def handoff_phase(w: int, h: int, device, reps: int = 20) -> dict:
    """The dependency floor of a wavefront kernel: the scaffold with an
    empty MB body over w x h MBs is w + 2 (h - 1) hand-offs in a row."""
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
    ms = cuda_ms(lambda: KW.handoff_probe(w, h, device), reps)
    chain = w + 2 * (h - 1)
    log(f"  hand-off floor {w}x{h}: {ms:.4f} ms for {chain} dependent "
        f"hand-offs = {1e3 * ms / chain:.3f} us each "
        f"({KW.last_grid(KW.PROBE)} CTAs)")
    return {"handoff_floor_ms": ms, "handoffs": chain,
            "handoff_us": 1e3 * ms / chain}


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
                       "grid": KW.last_grid(KW.INTRA)}

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
                         "grid": KW.last_grid(KW.DEBLOCK)}
    for k, v in out.items():
        log(f"  {k} {w}x{h} MBs, every MB busy: kernel {v['ms']:.4f} ms, "
            f"plain {v['plain_ms']:.1f} ms, {v['grid']} CTAs, byte-equal")
    probe = handoff_phase(w, h, device, reps=5)
    out["handoff_floor_ms"] = probe["handoff_floor_ms"]
    return out


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

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step()
    end.record()
    host_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    dev_ms = start.elapsed_time(end) / reps

    kernels = None
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if getattr(e, "device_type", None) is not None
            and "cuda" in str(e.device_type).lower())
    if n:
        kernels = n
    log(f"  per-picture step (P picture): host enqueue {host_ms:.3f} ms, "
        f"device span {dev_ms:.3f} ms, device ops per step "
        f"{kernels if kernels is not None else 'not measured'}")
    return {"step_host_enqueue_ms": host_ms, "step_device_span_ms": dev_ms,
            "step_device_ops": kernels}


def launch_counts():
    from broadway_tpu_torch.ops.gpu import mc_kernel as K1
    from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
    return {"K1_mc": K1.mc_predict.launches,
            "K2_intra": KW.intra_wavefront.launches,
            "K3_deblock": KW.deblock_wavefront.launches}


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
    median frames/s of the warm passes, frame count, NumPy seconds)."""
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
    return counts, per_pic, fps, len(got), numpy_s


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
    from broadway_tpu_torch.bitstream import native as nat
    from broadway_tpu_torch.ops.gpu import _build
    from broadway_tpu_torch.tools import bench_common

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
    log(f"[3] stream 1920x1088 x{N_FRAMES}: {len(data)} bytes "
        f"({time.perf_counter() - t0:.1f} s)")

    log("[4] kernels vs plain versions at 1080p shapes")
    from broadway_tpu_torch.core.packed import pack_stream
    pictures = pack_stream(data, max_pics=2)
    if len(pictures) < 2:
        raise RuntimeError("the stream has fewer than 2 pictures")
    kres = kernel_phase(pictures, "cuda")
    probe = handoff_phase(120, 68, "cuda")

    log(f"[5] K2 and K3 at {16 * BIG[0]}x{16 * BIG[1]}")
    big = big_phase("cuda")

    log("[6] the per-picture step")
    step = step_phase(pictures[1], "cuda")

    log("[7] end to end")
    counts, per_pic, fps, n, numpy_s = e2e_phase(data, "cuda")
    check_no_jax()
    log("    neither jax nor broadway_tpu in sys.modules")

    kernels = []
    for name, (src, tpu) in KERNELS.items():
        r = kres[name]
        wave = name != "K1_mc"
        floor = probe["handoff_floor_ms"]
        held = max(r["bound_ms"], floor) if wave else r["bound_ms"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,      # no single PyTorch call computes it
            "device_launches_per_picture": per_pic[name],
            "bound_bytes": r["bound_bytes"],
            "bound_handoff_ms": floor if wave else None,
            # the bound that binds, to which later work is held: the
            # larger of bound_ms and the hand-off floor. The floor is the
            # chain of a picture with work in every MB (the IDR here); a
            # picture whose idle MBs wait for nothing can run under it.
            "bound_held_to_ms": held,
            "bound_held_to_by": ("hand-offs" if wave and floor > r["bound_ms"]
                                 else r["bound_by"]),
            "ms_over_bound_held_to": r["ms"] / held,
            "idr_ms_over_bound_held_to":
                r["per_picture"]["IDR"]["ms"]
                / max(r["per_picture"]["IDR"]["bound_ms"],
                      floor if wave else 0.0),
            "per_picture": r["per_picture"],
            "big": big.get(name)})
    record = {"kernels": kernels, "handoff": probe,
              "big_handoff_floor_ms": big["handoff_floor_ms"],
              "step": step, "e2e_fps": fps, "frames": n,
              "numpy_path_s": numpy_s}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
