// The hand-off designs measured before the cluster scaffold of
// csrc/wavefront.cuh was chosen: a standalone program (built and run by
// tools/wavefront_designs.py on a CUDA card), never part of the decoder.
// Each mode is the wavefront scaffold with an empty MB body over a w x h
// grid of MBs (one CTA a row; MB x waits until the row above has passed
// x + 1), timed with CUDA events over 20 launches:
//  a0  global counters at gpu scope, empty body (the counter scaffold)
//  a1  as a0, plus 128 bytes a MB written before the publish and read from
//      L2 after the wait (K3's upper rows)
//  b0  clusters of C rows: the counter of row r in the shared memory of
//      row r's CTA, written through DSMEM with st.release.cluster after a
//      cluster-scope fence, polled locally; across clusters as a0
//  b1  as b0, with a1's 128 bytes through L2
//  c   clusters: in-cluster pels PUSHED into the lower CTA's ring with
//      st.async, completing on its mbarrier (complete_tx::bytes); across
//      clusters as a1
//  a1pub, cpub  a1 and c with the gpu-scope fence and counter store moved
//      to a publisher warp (the compute warps sync on named barrier 1)
// It also checks that the cooperative attribute combines with a cluster
// dimension in one cudaLaunchKernelEx, and that stream capture records
// that launch and a graph replays it.
#include <cooperative_groups.h>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

#define CK(x)                                                              \
  do {                                                                     \
    cudaError_t e_ = (x);                                                  \
    if (e_ != cudaSuccess) {                                               \
      printf("ERR %s line %d: %s\n", #x, __LINE__, cudaGetErrorString(e_)); \
      return e_;                                                           \
    }                                                                      \
  } while (0)

constexpr int THREADS = 128;
constexpr long long SPIN_MAX = 1ll << 28;

__device__ __forceinline__ int ld_acq_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_rel_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_acq_cl(const int* p) {
  int v;
  asm volatile("ld.acquire.cluster.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_rel_cl(int* p, int v) {
  asm volatile("st.release.cluster.s32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned su32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned mapa(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(su32(b)), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(su32(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* b, int parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok) : "r"(su32(b)), "r"(parity) : "memory");
  return ok != 0;
}
__device__ __forceinline__ void st_async16(unsigned dst, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

template <int MODE>
__global__ void __launch_bounds__(160)
probe_kernel(int* progress, uint4* pels, int w, int h, int batch,
             unsigned* sink) {
  extern __shared__ __align__(16) unsigned char dyn[];  // c: ring, bars
  __shared__ int s_prog, s_done, s_stored;
  constexpr bool CL = MODE == 2 || MODE == 3 || MODE == 4 || MODE == 6;
  constexpr bool PUSH = MODE == 4 || MODE == 6;
  constexpr bool PUBW = MODE >= 5;
  constexpr bool STORES = MODE != 0 && MODE != 2;
  const int t = threadIdx.x;
  int C = 1, rank = 0;
  int* down_prog = nullptr;
  int* up_done = nullptr;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dyn + (size_t)w * 128);
  if constexpr (CL) {
    cg::cluster_group cl = cg::this_cluster();
    C = (int)cl.num_blocks();
    rank = (int)cl.block_rank();
    if (t == 0) { s_prog = 0; s_done = 0; }
    if constexpr (PUSH) {
      for (int i = t; i < w; i += blockDim.x) mbar_init(&bars[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cl.sync();
    if (rank + 1 < C) down_prog = cl.map_shared_rank(&s_prog, rank + 1);
    if (rank > 0) up_done = cl.map_shared_rank(&s_done, rank - 1);
  }
  const int ncl = gridDim.x / C, cid = blockIdx.x / C;
  const int rows = batch * h;
  unsigned acc = 0;
  uint4 prev = make_uint4(0, 0, 0, 0);
  int used = 0, pushed = 0;   // c: rows consumed from / pushed to the ring
  for (int it = 0, rb = cid; rb * C < rows; ++it, rb += ncl) {
    const int row = rb * C + rank;
    if (row >= rows) break;
    const int my = row % h;
    const int base = it * (w + 1);
    const bool push = PUSH && rank + 1 < C && row + 1 < rows &&
                      (row + 1) % h != 0;
    const bool pub_global = !CL || rank == C - 1;
    int seen = base, seen_g = 0;
    if (PUBW) {
      if (t == 0) s_stored = 0;
      __syncthreads();
    }
    if (PUSH && push && pushed > 0 && t == 0) {
      long long n = 0;
      while (ld_acq_cl(&s_done) < pushed)
        if (++n > SPIN_MAX) __trap();
    }
    if (PUBW && t >= 128) {
      // the publisher warp: fences and publishes what the others stored
      if (t == 128 && pub_global) {
        int done = 0;
        long long n = 0;
        while (done < w) {
          int v;
          asm volatile("ld.acquire.cta.s32 %0, [%1];" : "=r"(v) : "l"(&s_stored) : "memory");
          if (v > done) {
            __threadfence();
            st_rel_gpu(progress + row, v);
            done = v;
          } else if (++n > SPIN_MAX) {
            __trap();
          }
        }
      }
    } else {
      for (int x = 0; x < w; ++x) {
        const int need = x + 2 < w ? x + 2 : w;
        if (my > 0 && t == 0) {
          long long n = 0;
          if (!CL || rank == 0) {
            while (seen_g < need) {
              seen_g = ld_acq_gpu(progress + row - 1);
              if (++n > SPIN_MAX) __trap();
            }
          } else if (!PUSH) {
            while (seen < base + need) {
              seen = ld_acq_cl(&s_prog);
              if (++n > SPIN_MAX) __trap();
            }
          } else {
            mbar_expect(&bars[x], 128);
            while (!mbar_try(&bars[x], used & 1))
              if (++n > SPIN_MAX) __trap();
          }
        }
        if (PUBW) asm volatile("bar.sync 1, 128;" ::: "memory");
        else __syncthreads();
        if (my > 0 && t < 8) {
          uint4 v = make_uint4(0, 0, 0, 0);
          if (STORES && (!PUSH || rank == 0))
            v = __ldcg(pels + ((size_t)(row - 1) * w + x) * 8 + t);
          else if (PUSH)
            v = reinterpret_cast<const uint4*>(dyn + (size_t)x * 128)[t];
          acc += v.x ^ v.w;
        }
        uint4 mine = make_uint4(row, x, t, acc);
        if (STORES && t < 8)
          __stcg(pels + ((size_t)row * w + x) * 8 + t, mine);
        if (push && t < 8) {
          // deliver MB x-1 once MB x is done (K3's x + 2 wait), the last
          // MB with it
          if (x > 0)
            st_async16(mapa(su32(dyn + (size_t)(x - 1) * 128 + 16 * t), rank + 1),
                       prev, mapa(su32(&bars[x - 1]), rank + 1));
          if (x == w - 1)
            st_async16(mapa(su32(dyn + (size_t)x * 128 + 16 * t), rank + 1),
                       mine, mapa(su32(&bars[x]), rank + 1));
        }
        prev = mine;
        if (PUBW) {
          asm volatile("bar.sync 1, 128;" ::: "memory");
          if (t == 0 && pub_global)
            asm volatile("st.release.cta.s32 [%0], %1;" :: "l"(&s_stored), "r"(x + 1) : "memory");
        } else {
          __syncthreads();
          if (t == THREADS - 1) {
            if (!CL) {
              __threadfence();
              st_rel_gpu(progress + row, x + 1);
            } else {
              if (!PUSH && down_prog != nullptr) {
                asm volatile("fence.acq_rel.cluster;" ::: "memory");
                st_rel_cl(down_prog, base + x + 1);
              }
              if (rank == C - 1) {
                __threadfence();
                st_rel_gpu(progress + row, x + 1);
              }
            }
          }
        }
      }
    }
    if (PUBW) __syncthreads();
    if (CL && rank != C - 1 && t == THREADS - 1)
      progress[row] = w;                      // for the host's check only
    if (PUSH && up_done != nullptr && my > 0) {
      ++used;
      __syncthreads();        // every thread has read the ring
      if (t == 0) st_rel_cl(up_done, used);
    }
    if (push) ++pushed;
  }
  if (acc == 0xdeadbeefu) sink[blockIdx.x] = acc;
  if constexpr (CL) cg::this_cluster().sync();
}

struct Res {
  int grid, clusters, coop;
  float ms;
};

template <int MODE>
cudaError_t launch(int C, int w, int h, int batch, int* progress, uint4* pels,
                   unsigned* sink, cudaStream_t s, bool coop, Res* r) {
  auto k = probe_kernel<MODE>;
  const size_t smem = (MODE == 4 || MODE == 6) ? (size_t)w * 136 : 0;
  const int threads = MODE >= 5 ? 160 : THREADS;
  if (smem > 48 * 1024)
    CK(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem));
  if (C > 8)
    CK(cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                            1));
  const int rows = batch * h;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[2];
  int na = 0;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  int grid = 0, ncl = 0;
  if (MODE < 2 || MODE == 5) {
    int dev, sms, per;
    CK(cudaGetDevice(&dev));
    CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, threads, smem));
    grid = rows < per * sms ? rows : per * sms;
  } else {
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = C;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    na = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(((rows + C - 1) / C) * C);
    CK(cudaOccupancyMaxActiveClusters(&ncl, (void*)k, &cfg));
    const int want = (rows + C - 1) / C;
    grid = (want < ncl ? want : ncl) * C;
  }
  if (coop) {
    at[na].id = cudaLaunchAttributeCooperative;
    at[na].val.cooperative = 1;
    ++na;
  }
  cfg.attrs = at;
  cfg.numAttrs = na;
  cfg.gridDim = dim3(grid);
  r->grid = grid;
  r->clusters = ncl;
  r->coop = coop;
  CK(cudaMemsetAsync(progress, 0, sizeof(int) * rows, s));
  CK(cudaLaunchKernelEx(&cfg, k, progress, pels, w, h, batch, sink));
  return cudaGetLastError();
}

cudaError_t run(int mode, int C, int w, int h, int batch, int* prog,
                uint4* pels, unsigned* sink, cudaStream_t s, bool coop,
                Res* r) {
  switch (mode) {
    case 0: return launch<0>(C, w, h, batch, prog, pels, sink, s, coop, r);
    case 1: return launch<1>(C, w, h, batch, prog, pels, sink, s, coop, r);
    case 2: return launch<2>(C, w, h, batch, prog, pels, sink, s, coop, r);
    case 3: return launch<3>(C, w, h, batch, prog, pels, sink, s, coop, r);
    case 4: return launch<4>(C, w, h, batch, prog, pels, sink, s, coop, r);
    case 5: return launch<5>(C, w, h, batch, prog, pels, sink, s, coop, r);
    default: return launch<6>(C, w, h, batch, prog, pels, sink, s, coop, r);
  }
}

int check(int* prog, int rows, int w) {
  int* hp = (int*)malloc(sizeof(int) * rows);
  cudaMemcpy(hp, prog, sizeof(int) * rows, cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int i = 0; i < rows; ++i) bad += hp[i] != w;
  free(hp);
  return bad;
}

int main() {
  const char* names[] = {"a0", "a1", "b0", "b1", "c", "a1pub", "cpub"};
  int *prog;
  uint4* pels;
  unsigned* sink;
  cudaStream_t s;
  CK(cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking));
  CK(cudaMalloc(&prog, sizeof(int) * 8 * 1024));
  CK(cudaMalloc(&pels, sizeof(uint4) * 8 * 240 * 8 * 136));
  CK(cudaMalloc(&sink, 4 * 4096));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  // 1. does the cooperative attribute combine with a cluster dimension?
  bool coop_ok = true;
  {
    Res r;
    cudaError_t e = run(2, 8, 120, 68, 1, prog, pels, sink, s, true, &r);
    if (e == cudaSuccess) e = cudaStreamSynchronize(s);
    printf("coop+cluster launch C=8: %s grid %d clusters %d\n",
           cudaGetErrorString(e), r.grid, r.clusters);
    if (e != cudaSuccess) {
      coop_ok = false;
      cudaGetLastError();
    } else {
      printf("  rows not at w: %d\n", check(prog, 68, 120));
    }
  }
  // 2. stream capture of the cluster launch, replayed
  {
    Res r;
    cudaGraph_t g;
    cudaGraphExec_t ge;
    cudaError_t e = cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
    if (e == cudaSuccess) e = run(2, 8, 120, 68, 1, prog, pels, sink, s, coop_ok, &r);
    cudaError_t e2 = cudaStreamEndCapture(s, &g);
    printf("capture: launch %s, end %s\n", cudaGetErrorString(e),
           cudaGetErrorString(e2));
    if (e == cudaSuccess && e2 == cudaSuccess) {
      e = cudaGraphInstantiate(&ge, g, 0);
      printf("instantiate: %s\n", cudaGetErrorString(e));
      if (e == cudaSuccess) {
        for (int i = 0; i < 5; ++i) e = cudaGraphLaunch(ge, s);
        e2 = cudaStreamSynchronize(s);
        printf("replay x5: %s / %s, rows not at w: %d\n", cudaGetErrorString(e),
               cudaGetErrorString(e2), check(prog, 68, 120));
      }
    }
    cudaGetLastError();
  }
  // 3. timings
  const int geoms[][3] = {{120, 8, 1},  {120, 16, 1}, {120, 68, 1},
                          {240, 135, 1}, {120, 68, 4}, {120, 68, 8}};
  for (auto& gm : geoms) {
    const int w = gm[0], h = gm[1], B = gm[2];
    const int chain = w + 2 * (h - 1);
    for (int mode = 0; mode < 7; ++mode) {
      for (int C : {1, 8, 16}) {
        if ((mode < 2 || mode == 5) != (C == 1)) continue;
        Res r;
        cudaError_t e = cudaSuccess;
        for (int i = 0; i < 3 && e == cudaSuccess; ++i)
          e = run(mode, C, w, h, B, prog, pels, sink, s, coop_ok, &r);
        if (e == cudaSuccess) e = cudaStreamSynchronize(s);
        if (e != cudaSuccess) {
          printf("%s C=%d %dx%d B=%d: %s\n", names[mode], C, w, h, B,
                 cudaGetErrorString(e));
          cudaGetLastError();
          continue;
        }
        const int reps = 20;
        cudaEventRecord(e0, s);
        for (int i = 0; i < reps; ++i)
          run(mode, C, w, h, B, prog, pels, sink, s, coop_ok, &r);
        cudaEventRecord(e1, s);
        e = cudaStreamSynchronize(s);
        float ms = 0;
        cudaEventElapsedTime(&ms, e0, e1);
        ms /= reps;
        printf("PROBE %s C=%d %dx%d B=%d: %.5f ms, %.4f us/hand-off "
               "(chain %d), grid %d, resident clusters %d, coop %d, rows "
               "not at w %d, %s\n",
               names[mode], C, w, h, B, ms, 1e3 * ms / chain, chain, r.grid,
               r.clusters, r.coop, check(prog, B * h, w),
               cudaGetErrorString(e));
      }
    }
  }
  printf("done\n");
  return 0;
}
