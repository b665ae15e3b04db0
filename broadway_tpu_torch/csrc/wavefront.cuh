// Scaffold shared by the two wavefront kernels (K2 intra, K3 deblock):
// one persistent launch per picture, one CTA per macroblock row, rows kept
// in step by per-row progress counters in global memory.
//
// On the TPU the x + 2y diagonal is the sequential grid axis of the Pallas
// kernels (broadway_tpu/ops/tpu/wavefront_pallas.py). A CUDA grid has no
// order, and one launch per diagonal costs 254 dependent launches per
// 1080p picture. Here a CTA owns MB row y (rows y, y + gridDim.x, ... when
// the picture has more rows than CTAs that can be resident, taken in
// increasing order) and walks it left to right:
//
//   progress[y] = x + 1   once every MB (0..x, y) is final.
//   MB (x, y) may start once progress[y-1] >= min(x + 2, w): its up and
//   up-right neighbours are final, which is the x + 2y dependency. The
//   left neighbour is the CTA's own previous step.
//
// Hand-off: the MB's stores, __syncthreads(), then one thread fences and
// does one release store at gpu scope; the waiting CTA's thread 0 spins on
// an acquire load at gpu scope, then __syncthreads(). Pixels that another
// CTA may have written are read with __ldcg and written with __stcg (L2,
// never the read-only or L1 path).
//
// An MB with nothing to do never waits: each kernel scans its row once into
// a per-MB flag byte in shared memory (todo[x]: bit 0 work, bit 1 reads the
// row above) and a run of idle MBs is published in one step.
//
// Deadlock: row y waits only on row y - 1, so the launch is safe as long as
// every CTA of the grid is resident. The grid is min(rows, resident CTAs
// from the occupancy calculator) and goes through
// cudaLaunchCooperativeKernel, which refuses a grid that cannot be
// co-resident instead of letting it hang. The counters are zeroed by a
// cudaMemsetAsync on the same stream before each launch.
//
// wgmma and TMA have no use here: the work is 8-bit integer filters and
// predictions on 16x16 tiles with data-dependent control flow, no matrix
// product and no bulk tile traffic worth a descriptor.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace bwwf {

enum Which { INTRA = 0, DEBLOCK = 1, PROBE = 2, N_WHICH = 3 };

// defined in wavefront.cu
extern int max_ctas;                 // 0: no cap (tests cap the grid)
extern long long launches[N_WHICH];  // kernel launches made
extern int last_grid[N_WHICH];       // CTAs of the newest launch

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Thread 0 spins until progress[y] >= need. `seen` is the caller's copy of
// the newest value read from progress[y] (0 when the row starts): while it
// covers `need` there is nothing to poll. The caller's next __syncthreads()
// releases the other threads.
__device__ __forceinline__ void wait_row(const int* progress, int y, int need,
                                         int& seen) {
  if (threadIdx.x == 0) {
    while (seen < need) seen = ld_acquire(progress + y);
  }
}

// All threads call it after the stores of every MB (.., y) below x_done.
// The LAST thread fences and stores, so that the fence's round trip runs
// beside thread 0's poll for the next MB and not before it.
__device__ __forceinline__ void publish(int* progress, int y, int x_done) {
  __syncthreads();
  if (threadIdx.x == blockDim.x - 1) {
    __threadfence();
    st_release(progress + y, x_done);
  }
}

// first x' >= x with todo[x'] != 0, or w
__device__ __forceinline__ int next_todo(const uint8_t* todo, int x, int w) {
  while (x < w && todo[x] == 0) ++x;
  return x;
}

// CTAs of `kernel` that can be resident on the current device at once.
inline cudaError_t resident_ctas(const void* kernel, int threads,
                                 size_t smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

// Zero the counters and launch `kernel` once for the whole picture.
inline cudaError_t launch_rows(Which which, const void* kernel, int threads,
                               size_t smem, int* progress, int h_mbs,
                               void** args, cudaStream_t stream) {
  int cap = 0;
  cudaError_t e = resident_ctas(kernel, threads, smem, &cap);
  if (e != cudaSuccess) return e;
  if (cap < 1) return cudaErrorLaunchOutOfResources;
  int grid = h_mbs < cap ? h_mbs : cap;
  if (max_ctas > 0 && grid > max_ctas) grid = max_ctas;
  e = cudaMemsetAsync(progress, 0, sizeof(int) * (size_t)h_mbs, stream);
  if (e != cudaSuccess) return e;
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args,
                                  smem, stream);
  if (e != cudaSuccess) return e;
  launches[which] += 1;
  last_grid[which] = grid;
  return cudaGetLastError();
}

}  // namespace bwwf
