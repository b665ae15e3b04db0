"""Measure the wavefront hand-off designs and K3's per-MB split on a card.

    python3 -m broadway_tpu_torch.tools.wavefront_designs probes
    python3 -m broadway_tpu_torch.tools.wavefront_designs split --package DIR
    python3 -m broadway_tpu_torch.tools.wavefront_designs kernels --package DIR

``probes`` builds ``wavefront_designs.cu`` (a standalone program beside
this file) with nvcc into ``build/wavefront_designs/`` and runs it: the
cooperative + cluster launch and its capture, then each hand-off design
(a0, a1, b0, b1, c, a1pub, cpub) over 120x8, 120x16, 120x68 and 240x135
MBs, and 120x68 at batches 4 and 8, ms and us a step of the
w + 2 (h - 1) chain.

``split`` takes K3 of the counter design (one CTA a row, gpu-scope
counters): DIR holds a checkout of commit 758a139, its last commit
(``git archive 758a139 | tar -x -C DIR``). It copies DIR's
``broadway_tpu_torch`` into ``build/wavefront_designs/counter/``, adds
clock64() stamps to that copy's ``csrc/deblock.cu`` and runs K3 on the
IDR and the first P picture of the realistic 1920x1088 stream: cycles a
busy MB in each stage of the MB loop (thread 0; the fence on the last
thread), summed over the rows.

``kernels`` times K2 and K3 of the package in DIR (this checkout, or one
of commit 758a139, so that both designs run in one call on one card) on
the IDR and the first P picture of the same stream, and on synthetic
120x68 pictures with no work (idle), with work in half the MBs (mixed),
and a round of 8 pictures with work in every MB (intra x8: 544 rows, more
than the CTAs resident at once): CUDA events over 20 launches, back to back (as ``chip_smoke.py``
phase 4 times them) and behind a held stream (the device's time alone).

All three need a CUDA card and exit 2 without one. None is part of the
decoder: the kernels of ``csrc/`` are the cluster scaffold these
readings chose.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(REPO, "build", "wavefront_designs")

# clock64() stamps for K3 of the counter design (csrc/deblock.cu of
# 758a139):
# (text, replacement), each text found exactly once
_STAMPS = [
    ("__global__ void __launch_bounds__(THREADS)\ndeblock_rows_kernel(",
     "__device__ long long bw_db_stamps[1100 * 16];\n"
     "#define ST(k) do { const long long n_ = clock64(); acc[k] += n_ - T; "
     "T = n_; } while (0)\n"
     "__global__ void __launch_bounds__(THREADS)\ndeblock_rows_kernel("),
    ("  for (int row = blockIdx.x; row < batch * h_mbs; row += gridDim.x) {\n"
     "    // this row's picture",
     "  for (int row = blockIdx.x; row < batch * h_mbs; row += gridDim.x) {\n"
     "    long long acc[16] = {0};\n    const long long T_row = clock64();\n"
     "    long long T = T_row;\n    // this row's picture"),
    ("    while (true) {\n      if (nx > pub) {\n"
     "        bwwf::publish(progress, my, nx);\n        pub = nx;\n      }\n"
     "      if (nx >= w_mbs) break;",
     "    while (true) {\n      T = clock64();\n      if (nx > pub) {\n"
     "        __syncthreads();\n        if (t == THREADS - 1) {\n"
     "          const long long f0 = clock64();\n          __threadfence();\n"
     "          bwwf::st_release(progress + my, nx);\n"
     "          acc[10] += clock64() - f0;\n        }\n        pub = nx;\n"
     "      }\n      ST(0);\n      if (nx >= w_mbs) break;\n"
     "      acc[8] += 1;"),
    ("      // rows 12-15 of the upper neighbour (chroma 4-7): fetched ahead "
     "when",
     "      ST(1);\n      // rows 12-15 of the upper neighbour (chroma 4-7): "
     "fetched ahead when"),
    ("          if (t == 0) s_seen = seen;\n          __syncthreads();\n"
     "        }",
     "          if (t == 0) s_seen = seen;\n          __syncthreads();\n"
     "          acc[9] += 1;\n        }\n        ST(2);"),
    ("      if (up_ready && t < 32)\n"
     "        pre_u = ld_word(up_word(Y, C, t, nx, my, W, Wc, Hc).g);\n",
     "      if (up_ready && t < 32)\n"
     "        pre_u = ld_word(up_word(Y, C, t, nx, my, W, Wc, Hc).g);\n"
     "      ST(3);\n"),
    ("              (px[4 * c + 3] << 24);\n        }\n        __syncwarp();",
     "              (px[4 * c + 3] << 24);\n        }\n        __syncwarp();\n"
     "        ST(4);"),
    ("          for (int r = 1; r < 20; ++r) col[r * YP] = (uint8_t)px[r];\n"
     "        }\n      } else if",
     "          for (int r = 1; r < 20; ++r) col[r * YP] = (uint8_t)px[r];\n"
     "        }\n        ST(5);\n      } else if"),
    ("      __syncthreads();\n\n      // ---- store what the filter may have "
     "changed",
     "      __syncthreads();\n      ST(6);\n\n      // ---- store what the "
     "filter may have changed"),
    ("      last_mx = mx;\n      buf ^= 1;",
     "      ST(7);\n      last_mx = mx;\n      buf ^= 1;"),
    ("      // the loop's next turn publishes this MB (after a __syncthreads)\n"
     "    }\n  }\n}",
     "      // the loop's next turn publishes this MB (after a __syncthreads)\n"
     "    }\n    acc[11] = clock64() - T_row;\n    if (t == 0)\n"
     "      for (int k = 0; k < 16; ++k)\n"
     "        if (k != 10) bw_db_stamps[row * 16 + k] = acc[k];\n"
     "    if (t == THREADS - 1) bw_db_stamps[row * 16 + 10] = acc[10];\n"
     "  }\n}"),
]
_EXPORT = """
extern "C" int bw_deblock_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, bw_db_stamps,
                                   sizeof(long long) * (size_t)n);
}
"""
STAGES = {0: "publish barrier", 1: "stage operands", 2: "wait",
          3: "upper rows + barrier", 4: "luma vertical pass",
          5: "luma horizontal pass", 6: "filter barrier", 7: "stores",
          10: "fence + release (last thread)", 11: "row total"}

# run inside the stamped copy: K3 on the IDR and first P picture
_DRIVER = r"""
import ctypes as ct, sys
import numpy as np, torch
sys.path.insert(0, ".")
from broadway_tpu_torch.core.packed import pack_stream, unpack_arrs_v2
from broadway_tpu_torch.core.recon import decode_picture
from broadway_tpu_torch.ops.gpu import _build, deblock, intra
from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
from broadway_tpu_torch.ops.gpu.residual import residual_stage
from broadway_tpu_torch.tools import bench_common
STAGES = %r
lib = _build.load()
lib.bw_deblock_stamps.argtypes = [ct.c_void_p, ct.c_int]
data = bench_common.realistic_bench_stream(120, 68, n_frames=2)
rng = np.random.RandomState(0)
for label, (buf, bk, lay, ci, co, R) in zip(("IDR", "P"),
                                            pack_stream(data, max_pics=2)):
    w, h = lay.w, lay.h
    arrs = unpack_arrs_v2(torch.from_numpy(buf).cuda(), lay, bk, ci, co)
    ref_y = torch.from_numpy(rng.randint(0, 256, (R, 16 * h, 16 * w),
                                         dtype=np.uint8)).cuda()
    ref_c = torch.from_numpy(rng.randint(0, 256, (R, 2, 8 * h, 8 * w),
                                         dtype=np.uint8)).cuda()
    Y, C = decode_picture(arrs, ref_y, ref_c, w, h, co, run_stages=1)
    RY, RC = residual_stage(arrs, co)
    KW.intra_wavefront(Y, C, RY, RC, intra.intra_params(arrs), w, h)
    Pd = deblock.deblock_params(arrs, w, h)
    Yk, Ck, Yp, Cp = Y.clone(), C.clone(), Y.clone(), C.clone()
    KW.deblock_wavefront(Yk, Ck, Pd, w, h)
    deblock.deblock_wavefront_plain(Yp, Cp, Pd, w, h)
    torch.cuda.synchronize()
    same = torch.equal(Yk, Yp) and torch.equal(Ck, Cp)
    st = np.zeros(1100 * 16, dtype=np.int64)
    assert lib.bw_deblock_stamps(st.ctypes.data, st.size) == 0
    st = st[:h * 16].reshape(h, 16)
    tot = st.sum(0)
    busy = max(int(tot[8]), 1)
    print(f"K3 {label} (stamped): byte-equal to plain {same}, busy MBs "
          f"{busy}, waits taken {int(tot[9])}; cycles a busy MB:")
    for k, name in STAGES.items():
        print(f"  {name:30s} {tot[k] / busy:9.1f}")
    print(f"  row 0 {st[0, 11]} cycles, row {h - 1} {st[h - 1, 11]} cycles")
"""


# run inside a package root: K2 / K3 times, back to back and held
_TIMES = r"""
import os, sys
import numpy as np, torch
sys.path.insert(0, ".")
from broadway_tpu_torch.core.packed import pack_stream, unpack_arrs_v2
from broadway_tpu_torch.core.recon import decode_picture
from broadway_tpu_torch.ops.gpu import deblock, intra, probe
from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
from broadway_tpu_torch.ops.gpu.residual import residual_stage
from broadway_tpu_torch.tools import bench_common, synth


def ms(fn, held, reps=20):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if held:
        probe.hold_stream(int(40 * 1.98e6), "cuda")
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def both(name, fn):
    out[name] = (round(ms(fn, False), 5), round(ms(fn, True), 5))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


out = {}
rng = np.random.RandomState(0)
data = bench_common.realistic_bench_stream(120, 68, n_frames=2)
for label, (buf, bk, lay, ci, co, R) in zip(("IDR", "P"),
                                            pack_stream(data, max_pics=2)):
    w, h = lay.w, lay.h
    arrs = unpack_arrs_v2(torch.from_numpy(buf).cuda(), lay, bk, ci, co)
    ref_y = t(rng.randint(0, 256, (R, 16 * h, 16 * w), dtype=np.uint8))
    ref_c = t(rng.randint(0, 256, (R, 2, 8 * h, 8 * w), dtype=np.uint8))
    Y, C = decode_picture(arrs, ref_y, ref_c, w, h, co, run_stages=1)
    RY, RC = residual_stage(arrs, co)
    Pi = intra.intra_params(arrs)
    Ys, Cs = Y.clone(), C.clone()
    both(f"K2 {label}", lambda: KW.intra_wavefront(Ys, Cs, RY, RC, Pi, w, h))
    KW.intra_wavefront(Y, C, RY, RC, Pi, w, h)
    Pd = deblock.deblock_params(arrs, w, h)
    Ys, Cs = Y.clone(), C.clone()
    both(f"K3 {label}", lambda: KW.deblock_wavefront(Ys, Cs, Pd, w, h))
for kind in ("idle", "mixed"):
    Ys, Cs = (t(a) for a in synth.planes(120, 68, 5))
    ry, rc, P = (t(a) for a in synth.intra_operands(120, 68, 6, kind))
    both(f"K2 {kind}", lambda: KW.intra_wavefront(Ys, Cs, ry, rc, P, 120, 68))
    Pd = t(synth.deblock_operands(120, 68, 8, kind))
    both(f"K3 {kind}", lambda: KW.deblock_wavefront(Ys, Cs, Pd, 120, 68))
# a lockstep round of 8 pictures with work in every MB: 544 rows
B = 8
Yb = t(np.concatenate([synth.planes(120, 68, 9 + b, smooth=True)[0][None] for b in range(B)]))
Cb = t(np.concatenate([synth.planes(120, 68, 9 + b, smooth=True)[1][None] for b in range(B)]))
ops = [synth.intra_operands(120, 68, 20 + b, "intra") for b in range(B)]
ry, rc, P = (t(np.concatenate([o[k] for o in ops])) for k in range(3))
both("K2 intra x8", lambda: KW.intra_wavefront(Yb, Cb, ry, rc, P, 120, 68))
Pd = t(np.concatenate([synth.deblock_operands(120, 68, 30 + b, "intra")
                       for b in range(B)]))
both("K3 intra x8", lambda: KW.deblock_wavefront(Yb, Cb, Pd, 120, 68))
print("kernels", os.getcwd(), "ms (back to back, held):", out, flush=True)
"""


def _card() -> bool:
    try:
        import torch
    except ImportError:
        return False
    return torch.cuda.is_available()


def probes() -> int:
    sys.path.insert(0, REPO)
    from broadway_tpu_torch.ops.gpu import _build
    os.makedirs(OUT, exist_ok=True)
    exe = os.path.join(OUT, "wavefront_designs")
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-o", exe,
           os.path.join(HERE, "wavefront_designs.cu")]
    subprocess.run(cmd, check=True)
    return subprocess.run([exe], timeout=600).returncode


def split(package: str) -> int:
    src = os.path.join(package, "broadway_tpu_torch")
    root = os.path.join(OUT, "counter")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(src, os.path.join(root, "broadway_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "broadway_tpu_torch", "csrc", "deblock.cu")
    with open(path) as f:
        text = f.read()
    for old, new in _STAMPS:
        if text.count(old) != 1:
            raise SystemExit(f"{path} is not K3 of 758a139: "
                             f"{old.splitlines()[0]!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text + _EXPORT)
    return subprocess.run([sys.executable, "-c", _DRIVER % (STAGES,)],
                          cwd=root, timeout=900).returncode


def kernels(package: str) -> int:
    return subprocess.run([sys.executable, "-c", _TIMES],
                          cwd=os.path.abspath(package), timeout=900).returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("probes", "split", "kernels"))
    ap.add_argument("--package", help="split: a checkout of 758a139; "
                    "kernels: a checkout whose K2 / K3 to time")
    a = ap.parse_args(argv)
    if not _card():
        print("wavefront_designs: no CUDA card; nothing was run",
              file=sys.stderr)
        return 2
    if a.what == "probes":
        return probes()
    if not a.package:
        ap.error(f"{a.what} needs --package")
    return split(a.package) if a.what == "split" else kernels(a.package)


if __name__ == "__main__":
    sys.exit(main())
