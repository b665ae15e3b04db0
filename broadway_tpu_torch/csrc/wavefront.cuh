// Scaffold shared by the two wavefront kernels (K2 intra, K3 deblock):
// one persistent launch per picture, or per round of `batch` pictures of
// one geometry (one per stream of a lockstep decode), one CTA per macroblock
// row, rows kept in step by per-row progress counters in global memory.
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
// A batch: the launch covers rows = batch * h_mbs rows. Row r belongs to
// picture r / h_mbs at picture row r % h_mbs (BatchRow below), with its own
// planes, params and counters; the first row of EVERY picture waits for
// nothing and reads no row above it, so the batch is `batch` independent
// chains of w + 2 (h - 1) hand-offs side by side, not one chain over a tall
// picture.
//
// Deadlock: row r waits only on row r - 1, and only when both belong to the
// same picture, so the launch is safe as long as every CTA of the grid is
// resident. The grid is min(rows, resident CTAs from the occupancy
// calculator) and goes through cudaLaunchCooperativeKernel, which refuses a
// grid that cannot be co-resident instead of letting it hang. With fewer
// CTAs than rows a CTA takes rows r, r + grid, ... in increasing order,
// whichever picture each lies in: by induction over r, the CTA of row r has
// finished its earlier rows (all below r) and row r - 1 finishes, so row r
// does; a batch changes nothing in that argument, it only removes waits.
// The counters are zeroed by a cudaMemsetAsync on the same stream before
// each launch. The memset and the launch are one unit in stream order: a
// process-wide mutex is held across both calls. Without it two host
// threads launching on one stream with one workspace (the wrappers' own
// per-stream counters, shared by every thread on the legacy default
// stream) could queue memset A, memset B, launch A, launch B: B would then
// find A's finished counters, and its rows would not wait for the row
// above. The calls under the mutex only enqueue, so one mutex for every
// (device, stream) costs microseconds and needs no table of locks.
//
// CUDA graphs (core/graphs.py): stream capture records the memset and the
// cudaLaunchCooperativeKernel call as they stand (CUDA 12.8 runtime, H100),
// and a replay launches the kernel node cooperatively again, with the grid
// and the counter workspace fixed at capture, so a graph owns its
// workspace. A launch recorded by a capture did not run: it is counted in
// the capturing thread's `captured`, which the graph takes once and adds to
// `launches` at every replay.
//
// wgmma and TMA have no use here: the work is 8-bit integer filters and
// predictions on 16x16 tiles with data-dependent control flow, no matrix
// product and no bulk tile traffic worth a descriptor.

#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace bwwf {

enum Which { INTRA = 0, DEBLOCK = 1, PROBE = 2, N_WHICH = 3 };

// defined in wavefront.cu; atomic, since any host thread may launch
extern std::atomic<int> max_ctas;               // 0: no cap (tests cap it)
extern std::atomic<long long> launches[N_WHICH];  // kernel launches that ran
// launches recorded by a stream capture on this thread, not yet taken
extern thread_local std::atomic<long long> captured[N_WHICH];
extern std::atomic<int> last_grid[N_WHICH];      // CTAs of the newest launch
extern std::atomic<int> last_resident[N_WHICH];  // CTAs resident for it
extern std::mutex launch_mutex;  // held across a memset and its launch

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

// Row `row` of a launch over `batch` pictures of h_mbs rows each: the
// picture it belongs to and its row there.
struct BatchRow {
  int b, my;
};

__device__ __forceinline__ BatchRow batch_row(int row, int h_mbs) {
  BatchRow r;
  r.b = row / h_mbs;
  r.my = row - r.b * h_mbs;
  return r;
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

// Zero the counters and launch `kernel` once for all `rows` rows (the rows
// of one picture, or of every picture of a batch).
inline cudaError_t launch_rows(Which which, const void* kernel, int threads,
                               size_t smem, int* progress, int rows,
                               void** args, cudaStream_t stream) {
  int cap = 0;
  cudaError_t e = resident_ctas(kernel, threads, smem, &cap);
  if (e != cudaSuccess) return e;
  if (cap < 1) return cudaErrorLaunchOutOfResources;
  if (rows < 1) return cudaErrorInvalidValue;
  int grid = rows < cap ? rows : cap;
  const int cap_tests = max_ctas.load();
  if (cap_tests > 0 && grid > cap_tests) grid = cap_tests;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  e = cudaStreamIsCapturing(stream, &capture);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> unit(launch_mutex);
    e = cudaMemsetAsync(progress, 0, sizeof(int) * (size_t)rows, stream);
    if (e != cudaSuccess) return e;
    e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args,
                                    smem, stream);
    if (e != cudaSuccess) return e;
  }
  if (capture == cudaStreamCaptureStatusActive)
    captured[which] += 1;
  else
    launches[which] += 1;
  last_grid[which] = grid;
  last_resident[which] = cap;
  return cudaGetLastError();
}

}  // namespace bwwf
