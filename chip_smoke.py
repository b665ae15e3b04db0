#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (broadway_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):
  1. toolchain: torch, CUDA, nvcc versions and the card's name/power limit
  2. build the port's CUDA kernels from broadway_tpu_torch/csrc
  3. the realistic 1920x1088 stream (8 slices, deblock idc 0, multi-ref;
     tools/bench_common.realistic_bench_stream, cached under build/)
  4. per kernel, on the stream's IDR and first P picture at 1080p
     shapes: the CUDA kernel against its plain torch version on the same
     inputs (byte equality), both timed with CUDA events
  5. end to end: the port's Decoder(device="cuda", parallel_slices=8)
     over the stream, every frame byte-equal to the NumPy decoder
     (Decoder(backend="cpu")); every kernel must have launched on that
     run; then timed warm passes (median frames/s); JAX must never load
The last three lines of stdout: the kernels' JSON record, the
nvidia-smi name/power-limit line, and {"ok": true, "device": ...}.
Exits non-zero and prints no result without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 4
WARM_PASSES = 5
TOL = 0      # decoding is integer-exact: every comparison is byte equality

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


def kernel_phase(pictures, device, seed: int = 0, reps: int = 10,
                 plain_reps: int = 1):
    """Each kernel against its plain version on the same inputs, at the
    pictures' shapes. Returns {name: {"max_abs_err", "ms", "plain_ms"}}
    (times are means over the pictures; None off CUDA)."""
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
    res = {k: {"max_abs_err": 0, "ms": [], "plain_ms": []} for k in KERNELS}

    def record(name, got, want, run, run_plain, label):
        err = max(int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
                  for g, w in zip(got, want))
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        if err > TOL:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"on the {label} picture: max |err| {err}")
        if on_cuda:
            ms, pms = cuda_ms(run, reps), cuda_ms(run_plain, plain_reps)
            res[name]["ms"].append(ms)
            res[name]["plain_ms"].append(pms)
            log(f"  {name} {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                f"max |err| {err}")
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
               label)

        Y0, C0 = decode_picture(arrs, ref_y, ref_c, w, h, co, run_stages=1)
        RY, RC = residual_stage(arrs, co)
        Pi = intra.intra_params(arrs)
        Yk, Ck, Yp, Cp = Y0.clone(), C0.clone(), Y0.clone(), C0.clone()
        KW.intra_wavefront(Yk, Ck, RY, RC, Pi, w, h)
        intra.intra_wavefront_plain(Yp, Cp, RY, RC, Pi, w, h)
        Ys, Cs = Y0.clone(), C0.clone()
        record("K2_intra", (Yk, Ck), (Yp, Cp),
               lambda: KW.intra_wavefront(Ys, Cs, RY, RC, Pi, w, h),
               lambda: intra.intra_wavefront_plain(Ys, Cs, RY, RC, Pi, w, h),
               label)

        Pd = deblock.deblock_params(arrs, w, h)
        Y1, C1 = Yk, Ck
        Yk, Ck, Yp, Cp = Y1.clone(), C1.clone(), Y1.clone(), C1.clone()
        KW.deblock_wavefront(Yk, Ck, Pd, w, h)
        deblock.deblock_wavefront_plain(Yp, Cp, Pd, w, h)
        Ys, Cs = Y1.clone(), C1.clone()
        record("K3_deblock", (Yk, Ck), (Yp, Cp),
               lambda: KW.deblock_wavefront(Ys, Cs, Pd, w, h),
               lambda: deblock.deblock_wavefront_plain(Ys, Cs, Pd, w, h),
               label)

    for r in res.values():
        for k in ("ms", "plain_ms"):
            r[k] = sum(r[k]) / len(r[k]) if r[k] else None
    return res


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


def decode_port(data: bytes, device, parallel_slices: int = 8):
    """Decode with the port; returns (frames, seconds). The clock stops
    after one synchronize at the end (frames are not fetched to the
    host inside it)."""
    import torch

    from broadway_tpu_torch.core.decoder import Decoder
    dec = Decoder(device=device, parallel_slices=parallel_slices)
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
    """Port vs NumPy decoder on the whole stream; returns (launch counts
    of the port's run, median frames/s of the warm passes, frame
    count)."""
    from broadway_tpu.core.decoder import Decoder as CpuDecoder

    reset_launch_counts()
    frames, _ = decode_port(data, device)
    counts = launch_counts()
    log(f"  launches on the main path: {counts}")
    t0 = time.perf_counter()
    want = [o.frame.tobytes()
            for o in CpuDecoder(backend="cpu").decode_annexb(data)]
    log(f"  NumPy decoder: {len(want)} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    got = [f.tobytes() for f in frames]
    if len(got) != len(want) or not want:
        raise AssertionError(f"port gave {len(got)} frames, NumPy decoder "
                             f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            off = next(j for j in range(len(w)) if g[j] != w[j])
            raise AssertionError(f"frame {i} differs from the NumPy decoder "
                                 f"at byte {off}: {g[off]} vs {w[off]}")
    log(f"  {len(got)} frames byte-equal to the NumPy decoder")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    # a 4-frame pass lasts ~0.1 s on a shared host CPU: take the median of
    # a few warm passes, each printed
    rates = []
    for k in range(WARM_PASSES):
        _, sec = decode_port(data, device)
        rates.append(len(got) / sec)
        log(f"  warm pass {k}: {len(got)} frames in {sec:.4f} s = "
            f"{rates[-1]:.2f} frames/s")
    fps = sorted(rates)[len(rates) // 2]
    log(f"  median of {WARM_PASSES} warm passes: {fps:.2f} frames/s")
    return counts, fps, len(got)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from broadway_tpu_torch.ops.gpu import _build
    import bench_common

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
    _build.load()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s: "
        f"{os.path.relpath(_build.library_path(), REPO)}")

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

    log("[5] end to end")
    counts, fps, n = e2e_phase(data, "cuda")
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    log("    jax not in sys.modules")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": counts[name], "max_abs_err": kres[name]["max_abs_err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"]}
        for name, (src, tpu) in KERNELS.items()],
        "e2e_fps": fps, "frames": n}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
