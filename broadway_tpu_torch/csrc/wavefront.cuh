// Scaffold shared by the two wavefront kernels (K2 intra, K3 deblock):
// one persistent launch per picture, or per round of `batch` pictures of
// one geometry (one per stream of a lockstep decode), one CTA per
// macroblock row, consecutive rows grouped into thread-block clusters
// (Hopper, sm_90).
//
// On the TPU the x + 2y diagonal is the sequential grid axis of the Pallas
// kernels (broadway_tpu/ops/tpu/wavefront_pallas.py). A CUDA grid has no
// order, so each CTA walks one MB row left to right, and MB (x, y) waits
// until the row above has passed MB x + 1: its up and up-right neighbours
// are final (the x + 2y dependency; the left neighbour is the CTA's own
// previous step).
//
// Rows and clusters. The grid is `clusters` clusters of C CTAs (C = 8, the
// portable maximum). Row r of the launch is CTA rank r mod C of its row
// block r / C, and cluster k takes row blocks k, k + clusters, ... in
// increasing order. So rows r and r + 1 lie in one cluster unless r + 1 is
// a multiple of C. Row r of the launch is picture r / h_mbs, row r % h_mbs
// (BatchRow), with that picture's planes, operands and counters; the first
// row of EVERY picture waits for nothing and reads no row above it.
//
// The hand-off inside a cluster (the row below is rank + 1): the upper CTA
// pushes the pels the lower row needs, once they are final, into a ring of
// slots (one a MB column) in the LOWER CTA's shared memory with st.async,
// each slot completing on an mbarrier of the lower CTA (complete_tx::bytes).
// The lower CTA's thread 0 posts the bytes it expects and waits on its own
// mbarrier; the pels are then in its shared memory. No fence, no counter
// and no L2 round trip: the only device-wide traffic on the in-cluster
// chain is gone. A slot is pushed only when the lower row will wait on it
// (each kernel decides that with one predicate on the lower row's
// operands, evaluated by both CTAs), so every phase of every mbarrier
// completes exactly once a row; a parity bit per slot follows its phase.
// Where a launch has more row blocks than resident clusters, a CTA takes a
// later row only after the CTA below has consumed the ring of the earlier
// one (a `done` count it writes into the upper CTA's shared memory).
//
// The hand-off across clusters (the row below is rank 0 of the next row
// block): per-row progress counters in global memory. progress[r] = x + 1
// once MBs 0..x of row r are stored; the waiting CTA's thread 0 spins on an
// acquire load at gpu scope, then reads the pels from L2 (__ldcg). The
// fence that orders the stores before the counter costs ~0.7 us (1335
// cycles of a K3 MB's ~5400 in the counter design, clock64 split of
// tools/wavefront_designs.py, NVIDIA H100 80GB HBM3, 700 W); it is
// taken off the MB chain by a PUBLISHER WARP: the compute warps sync among
// themselves on named barrier 1 (csync), thread 0 posts the stored MB
// count to shared memory with a release at CTA scope, and one lane of an
// extra warp acquires it, fences at gpu scope and stores the counter with
// a release. Only rank C - 1 publishes: 1 row in C pays the fence, and
// beside the MBs, not in front of the next one.
//
// Measured (tools/wavefront_designs.py, 120x68 MBs, empty MB body, NVIDIA H100
// 80GB HBM3, 700 W): gpu-scope counters 0.246 ms (0.97 us a step of the
// w + 2 (h - 1) chain); a DSMEM counter at cluster scope instead 0.215 ms
// (the fence, not the poll, is the cost); pushed pels + mbarrier 0.188 ms;
// with the publisher warp 0.137 ms (C = 8) and 0.120 ms (C = 16, not
// portable: not taken). The probe in wavefront.cu measures this scaffold.
//
// Deadlock. Every CTA of the grid is resident: the launch is cooperative
// AND clustered (cudaLaunchKernelEx with both attributes, which CUDA 12.8
// takes on the H100), so the driver refuses a grid that cannot be
// co-resident instead of letting it hang, and the grid is capped at
// cudaOccupancyMaxActiveClusters x C besides. Every wait points to a
// smaller row: row r waits on row r - 1 of the same picture; a CTA starts a
// row after its own earlier rows (all smaller); an upper CTA starts a later
// row after the lower CTA's previous row, r + 1 - C * clusters < r. By
// induction over r every row finishes. The cluster barriers at the start
// (every CTA's mbarriers are initialised before any push) and at the end
// (no CTA exits while another may still write its shared memory) wait for
// CTAs that wait on nothing but smaller rows.
//
// The counters are zeroed by a cudaMemsetAsync on the same stream before
// each launch. The memset and the launch are one unit in stream order: a
// process-wide mutex is held across both calls. Without it two host
// threads launching on one stream with one workspace (the wrappers' own
// per-stream counters, shared by every thread on the legacy default
// stream) could queue memset A, memset B, launch A, launch B: B would then
// find A's finished counters, and its rows would not wait for the row
// above. The calls under the mutex only enqueue.
//
// CUDA graphs (core/graphs.py): stream capture records the memset and the
// cudaLaunchKernelEx node with its cluster dimension and cooperative
// attribute as they stand (CUDA 12.8 runtime, H100; a captured launch
// replayed five times by tools/wavefront_designs.py), and a replay
// launches the same
// clustered cooperative grid with the counter workspace fixed at capture,
// so a graph owns its workspace. A launch recorded by a capture did not
// run: it is counted in the capturing thread's `captured`, which the graph
// takes once and adds to `launches` at every replay.
//
// The geometry (C, clusters, grid) is computed by the Python wrapper
// (ops/gpu/wavefront_kernels.py launch_geometry) from the resident
// clusters this file reports; launch_rows checks it and launches it.
//
// wgmma and TMA tiles have no use here: the work is 8-bit integer filters
// and predictions on 16x16 tiles with data-dependent control flow.

#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace bwwf {

enum Which { INTRA = 0, DEBLOCK = 1, PROBE = 2, N_WHICH = 3 };

// defined in wavefront.cu; atomic, since any host thread may launch
extern std::atomic<long long> launches[N_WHICH];  // kernel launches that ran
// launches recorded by a stream capture on this thread, not yet taken
extern thread_local std::atomic<long long> captured[N_WHICH];
extern std::atomic<int> last_grid[N_WHICH];      // CTAs of the newest launch
extern std::atomic<int> last_resident[N_WHICH];  // CTAs resident for it
extern std::atomic<int> last_cluster[N_WHICH];   // its cluster size C
extern std::mutex launch_mutex;  // held across a memset and its launch

constexpr int MAX_CLUSTER = 16;

// ---- memory operations ----------------------------------------------------

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

__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.s32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire_cluster(const int* p) {
  int v;
  asm volatile("ld.acquire.cluster.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cluster(int* p, int v) {
  asm volatile("st.release.cluster.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the shared::cluster address of `a` (this CTA's shared::cta address) in
// the CTA of cluster rank `rank`
__device__ __forceinline__ unsigned mapa(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(b)), "r"(count) : "memory");
}

// wait until the phase `parity` of barrier b completes
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  const unsigned a = smem_addr(b);
  unsigned ok = 0;
  while (!ok) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok) : "r"(a), "r"(parity) : "memory");
  }
}

// thread 0 of the lower CTA: expect `bytes` on slot barrier b, then wait
// until its phase `parity` completes
__device__ __forceinline__ void mbar_expect_wait(uint64_t* b, int bytes,
                                                 int parity) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(b)), "r"(bytes) : "memory");
  mbar_wait(b, parity);
}

// one 32-bit word into the lower CTA's shared memory (shared::cluster
// address dst), completing 4 bytes on its barrier (shared::cluster bar)
__device__ __forceinline__ void push_word(unsigned dst, unsigned v,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];"
      :: "r"(dst), "r"(v), "r"(bar) : "memory");
}

// barrier of the NT compute threads (the publisher warp is not in it)
template <int NT>
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;" :: "n"(NT) : "memory");
}

// ---- rows, clusters and the ring -------------------------------------------

// Row `row` of a launch over pictures of h_mbs rows each: the picture it
// belongs to and its row there.
struct BatchRow {
  int b, my;
};

__device__ __forceinline__ BatchRow batch_row(int row, int h_mbs) {
  BatchRow r;
  r.b = row / h_mbs;
  r.my = row - r.b * h_mbs;
  return r;
}

// first x' >= x with (flags[x'] & mask) != 0, or w. Every lane of a whole
// warp calls it with the same x (32 flags a step: an idle run costs one
// shared-memory read a 32 MBs, not one a MB).
__device__ __forceinline__ int next_flag(const uint8_t* flags, int x, int w,
                                         int mask) {
  const int lane = threadIdx.x & 31;
  for (; x < w; x += 32) {
    const int i = x + lane;
    const unsigned m =
        __ballot_sync(0xffffffffu, i < w && (flags[i] & mask) != 0);
    if (m) return x + __ffs(m) - 1;
  }
  return w;
}

// Dynamic shared memory of a wavefront CTA: flags [w] (the kernel's
// per-MB bits), parity [w] (each slot barrier's phase), scan [2][w] (the
// row scan's first pass), then 16-aligned the ring [w][slot] and its
// barriers [w].
__host__ __device__ __forceinline__ size_t ring_offset(int w) {
  return ((size_t)4 * w + 15) & ~(size_t)15;
}

__host__ __device__ __forceinline__ size_t dyn_smem(int w, int slot) {
  return ring_offset(w) + (size_t)w * slot + (size_t)8 * w;
}

// The CTA's place in the launch and its ring. Made once per kernel by
// every thread (start() holds a cluster barrier).
struct Wave {
  int C, rank, clusters, cid, rows, w, slot;
  uint8_t* flags;
  uint8_t* parity;
  uint8_t* scan;    // [2][w]: what the scan's first pass finds a MB
  uint8_t* ring;
  uint64_t* bars;
  int* s_done;      // rows the CTA below has consumed (it writes here)
  int* up_done;     // that count in the CTA above, or null (rank 0)
  int used, pushed;

  __device__ __forceinline__ void start(uint8_t* dyn, int* done, int w_,
                                        int rows_, int slot_) {
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    C = (int)cl.num_blocks();
    rank = (int)cl.block_rank();
    clusters = gridDim.x / C;
    cid = blockIdx.x / C;
    rows = rows_;
    w = w_;
    slot = slot_;
    flags = dyn;
    parity = dyn + w;
    scan = dyn + 2 * w;
    ring = dyn + ring_offset(w);
    bars = reinterpret_cast<uint64_t*>(ring + (size_t)w * slot);
    s_done = done;
    used = pushed = 0;
    for (int i = threadIdx.x; i < w; i += blockDim.x) {
      parity[i] = 0;
      mbar_init(&bars[i], 1);
    }
    if (threadIdx.x == 0) *s_done = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    cl.sync();
    up_done = rank > 0 ? cl.map_shared_rank(s_done, rank - 1) : nullptr;
  }

  // the launch row of this CTA's it-th row block, or -1 past the end
  __device__ __forceinline__ int row_at(int it) const {
    const int r = (cid + it * clusters) * C + rank;
    return r < rows ? r : -1;
  }

  // the row below is this cluster's next rank, in the same picture
  __device__ __forceinline__ bool down_in_cluster(int row, int h) const {
    return rank + 1 < C && row + 1 < rows && (row + 1) % h != 0;
  }

  // the row above is this cluster's previous rank, in the same picture
  __device__ __forceinline__ bool up_in_cluster(int my) const {
    return rank > 0 && my > 0;
  }

  // the row below waits on progress[row] in global memory
  __device__ __forceinline__ bool publishes(int row) const {
    return rank == C - 1 && row + 1 < rows;
  }

  // thread 0, before the first push of a row that pushes: the CTA below
  // has consumed every earlier row's ring
  __device__ __forceinline__ void wait_ring_free() const {
    if (threadIdx.x == 0 && pushed > 0)
      while (ld_acquire_cluster(s_done) < pushed) {
      }
  }

  // thread 0 of the lower CTA: slot x's pels are in the ring
  __device__ __forceinline__ void wait_slot(int x) {
    mbar_expect_wait(&bars[x], slot, parity[x]);
    parity[x] ^= 1;
  }

  // the same, split: thread 0 posts the bytes and waits; any other thread
  // may wait for the same phase (wait_phase); thread 0 flips the parity
  // once every waiter is past it (flip)
  __device__ __forceinline__ void expect_and_wait(int x) const {
    mbar_expect_wait(&bars[x], slot, parity[x]);
  }

  __device__ __forceinline__ void wait_phase(int x) const {
    mbar_wait(&bars[x], parity[x]);
  }

  __device__ __forceinline__ void flip(int x) { parity[x] ^= 1; }

  // warp 0 of the lower CTA: every slot x' in [from, to] whose flag has
  // `mask` has arrived (thread 0 waits on them in order); returns to + 1
  __device__ __forceinline__ int wait_slots(const uint8_t* fl, int from,
                                            int to, int mask) {
    for (int x = from; x <= to; x += 32) {
      const int i = x + (int)(threadIdx.x & 31);
      unsigned m = __ballot_sync(0xffffffffu,
                                 i <= to && (fl[i] & mask) != 0);
      for (; m; m &= m - 1)
        if (threadIdx.x == 0) wait_slot(x + __ffs(m) - 1);
    }
    return to + 1 > from ? to + 1 : from;
  }

  // word k of slot x of the CTA below
  __device__ __forceinline__ void push(int x, int k, unsigned v) const {
    push_word(mapa(smem_addr(ring + (size_t)x * slot + 4 * k), rank + 1), v,
              mapa(smem_addr(&bars[x]), rank + 1));
  }

  __device__ __forceinline__ const unsigned* slot_words(int x) const {
    return reinterpret_cast<const unsigned*>(ring + (size_t)x * slot);
  }

  // every thread, after the barrier that ends a row: count it, and tell
  // the CTA above once this CTA has read the row's ring
  __device__ __forceinline__ void end_row(bool consumed, bool pushed_row) {
    if (consumed) {
      ++used;
      if (threadIdx.x == 0) st_release_cluster(up_done, used);
    }
    if (pushed_row) ++pushed;
  }

  __device__ __forceinline__ void finish() const {
    cooperative_groups::this_cluster().sync();
  }
};

// The publisher warp's lane 0: publish progress[row] as the compute warps
// post stored MBs to *s_stored, until the whole row (w) is out.
__device__ __forceinline__ void publisher(int* progress_row, int w,
                                          const int* s_stored) {
  int done = 0;
  while (done < w) {
    const int v = ld_acquire_cta(s_stored);
    if (v > done) {
      __threadfence();
      st_release(progress_row, v);
      done = v;
    }
  }
}

// Thread 0 spins until the counter of the row above covers `need`. `seen`
// is its newest reading (0 when the row starts).
__device__ __forceinline__ void wait_global(const int* progress_up, int need,
                                            int& seen) {
  if (threadIdx.x == 0) {
    while (seen < need) seen = ld_acquire(progress_up);
  }
}

// ---- host side ---------------------------------------------------------------

// Clusters of C CTAs of `kernel` that can be resident on the current device
// at once (cached per device, kernel, block, shared memory and C).
inline cudaError_t resident_clusters(const void* kernel, int threads,
                                     size_t smem, int C, int* out) {
  static std::mutex m;
  static std::map<std::tuple<int, const void*, int, size_t, int>, int> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(dev, kernel, threads, smem, C);
  {
    std::lock_guard<std::mutex> g(m);
    auto it = cache.find(key);
    if (it != cache.end()) {
      *out = it->second;
      return cudaSuccess;
    }
  }
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (C > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> g(m);
  cache[key] = n;
  *out = n;
  return cudaSuccess;
}

// Zero the counters and launch `kernel` once for all `rows` rows (the rows
// of one picture, or of every picture of a batch) as `grid` CTAs in
// clusters of C, cooperatively. The geometry comes from the wrapper
// (launch_geometry); a grid that is no whole number of clusters, or has
// more clusters than can be resident, is refused here.
inline cudaError_t launch_rows(Which which, const void* kernel, int threads,
                               size_t smem, int* progress, int rows, int C,
                               int grid, void** args, cudaStream_t stream) {
  if (rows < 1 || C < 1 || C > MAX_CLUSTER || grid < C || grid % C != 0)
    return cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t e = resident_clusters(kernel, threads, smem, C, &resident);
  if (e != cudaSuccess) return e;
  if (resident < 1) return cudaErrorLaunchOutOfResources;
  if (grid / C > resident) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  e = cudaStreamIsCapturing(stream, &capture);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> unit(launch_mutex);
    e = cudaMemsetAsync(progress, 0, sizeof(int) * (size_t)rows, stream);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelExC(&cfg, kernel, args);
    if (e != cudaSuccess) return e;
  }
  if (capture == cudaStreamCaptureStatusActive)
    captured[which] += 1;
  else
    launches[which] += 1;
  last_grid[which] = grid;
  last_resident[which] = resident * C;
  last_cluster[which] = C;
  return cudaGetLastError();
}

}  // namespace bwwf
