// K3: the in-loop deblocking filter as an x + 2y wavefront over raster
// planes (Hopper).
//
// Replaces the Pallas TPU kernel broadway_tpu/ops/tpu/wavefront_pallas.py
// (_db_kernel with _luma_edge / _chroma_edge, launched by
// deblock_wavefront). The TPU kernel streams a diagonal-major packed
// picture through a 4-deep VMEM ring and filters vertical edges in a
// transposed space made by one-hot MXU matmuls.
//
// Here the planes stay raster uint8 and are filtered in place. The exported
// function loops over the S diagonals on the host and launches one small
// kernel per diagonal on the caller's stream (stream order replaces the
// TPU's sequential grid; for diagonal d the MBs are x = d - 2y). Per MB the
// order is raster-equivalent: the 4 vertical luma edges left to right, then
// the 4 horizontal edges top to bottom, a barrier between edges. The left
// MB edge writes columns 13-15 of the left neighbour and the top edge rows
// 13-15 of the upper neighbour; x + 2y order makes those writes disjoint
// across the MBs of one diagonal. One block of 32 threads per MB: threads
// 0..15 filter the 16 luma lines of an edge, 16..31 the 8 cb and 8 cr lines
// of chroma edges 0 and 2 each way (with the luma bS), alongside the luma.
// A block whose 32 bS are all 0 exits at once.
//
// bS and alpha/beta/tc0 come precomputed per MB (ops/gpu/deblock.py
// deblock_params, P [n, 64] int32), as on the TPU.
//
// What bounds it: launch latency (254 dependent launches per 1080p
// picture) and the serial edge chain inside an MB; the bytes are few.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P_BS_V = 0, P_BS_H = 16, P_THR_LUMA = 32, P_THR_CHROMA = 47;
constexpr int THR_INNER = 0, THR_TOP = 5, THR_LEFT = 10;
constexpr int NP = 64;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int absi(int v) { return v < 0 ? -v : v; }

// one luma line across an edge: pels at base + k * step, k = -4..3
__device__ void luma_line(uint8_t* base, int step, int bs, const int* thr) {
  const int alpha = thr[0], beta = thr[1];
  const int p3 = base[-4 * step], p2 = base[-3 * step], p1 = base[-2 * step],
            p0 = base[-step], q0 = base[0], q1 = base[step],
            q2 = base[2 * step], q3 = base[3 * step];
  if (!(absi(p0 - q0) < alpha && absi(p1 - p0) < beta &&
        absi(q1 - q0) < beta))
    return;
  const bool ap = absi(p2 - p0) < beta, aq = absi(q2 - q0) < beta;
  if (bs < 4) {
    const int tc0 = thr[2 + bs - 1];
    const int half = (p0 + q0 + 1) >> 1;
    const int tc = tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
    const int delta =
        clampi(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc);
    if (ap) base[-2 * step] =
        (uint8_t)(p1 + clampi((p2 + half - p1 * 2) >> 1, -tc0, tc0));
    if (aq) base[step] =
        (uint8_t)(q1 + clampi((q2 + half - q1 * 2) >> 1, -tc0, tc0));
    base[-step] = (uint8_t)clampi(p0 + delta, 0, 255);
    base[0] = (uint8_t)clampi(q0 - delta, 0, 255);
  } else {
    const bool strong = absi(p0 - q0) < ((alpha >> 2) + 2);
    const int tp = p1 + p0 + q0, tq = p0 + q0 + q1;
    if (strong && ap) {
      base[-step] = (uint8_t)((p2 + 2 * tp + q1 + 4) >> 3);
      base[-2 * step] = (uint8_t)((p2 + tp + 2) >> 2);
      base[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + tp + 4) >> 3);
    } else {
      base[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    }
    if (strong && aq) {
      base[0] = (uint8_t)((p1 + 2 * tq + q2 + 4) >> 3);
      base[step] = (uint8_t)((tq + q2 + 2) >> 2);
      base[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + tq + 4) >> 3);
    } else {
      base[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    }
  }
}

// one chroma line across an edge: pels at base + k * step, k = -2..1
__device__ void chroma_line(uint8_t* base, int step, int bs, const int* thr) {
  const int alpha = thr[0], beta = thr[1];
  const int p1 = base[-2 * step], p0 = base[-step], q0 = base[0],
            q1 = base[step];
  if (!(absi(p0 - q0) < alpha && absi(p1 - p0) < beta &&
        absi(q1 - q0) < beta))
    return;
  if (bs < 4) {
    const int tc = thr[2 + bs - 1] + 1;
    const int delta =
        clampi(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc);
    base[-step] = (uint8_t)clampi(p0 + delta, 0, 255);
    base[0] = (uint8_t)clampi(q0 - delta, 0, 255);
  } else {
    base[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    base[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

__global__ void deblock_kernel(uint8_t* __restrict__ Y,
                               uint8_t* __restrict__ C,
                               const int32_t* __restrict__ Pm, int w_mbs,
                               int h_mbs, int d, int y_lo) {
  __shared__ int p[NP];
  const int t = threadIdx.x;
  const int my = y_lo + blockIdx.x, mx = d - 2 * my;
  const int addr = my * w_mbs + mx;
  p[t] = Pm[addr * NP + t];
  p[t + 32] = Pm[addr * NP + t + 32];
  __syncthreads();
  // every edge of this MB has bS 0: nothing to filter
  if (!__syncthreads_or(p[P_BS_V + t] != 0)) return;

  const int W = 16 * w_mbs, Wc = 8 * w_mbs, Hc = 8 * h_mbs;
  for (int step = 0; step < 8; ++step) {
    if (t < 16) {
      const int e = step & 3;
      if (step < 4) {            // vertical edge e, line t
        const int bs = p[P_BS_V + 4 * e + (t >> 2)];
        if (bs > 0)
          luma_line(Y + (size_t)(16 * my + t) * W + 16 * mx + 4 * e, 1, bs,
                    p + P_THR_LUMA + (e == 0 ? THR_LEFT : THR_INNER));
      } else {                   // horizontal edge e, column t
        const int bs = p[P_BS_H + 4 * e + (t >> 2)];
        if (bs > 0)
          luma_line(Y + (size_t)(16 * my + 4 * e) * W + 16 * mx + t, W, bs,
                    p + P_THR_LUMA + (e == 0 ? THR_TOP : THR_INNER));
      }
    } else if (step < 4) {
      const int u = t - 16, plane = u >> 3, i = u & 7;
      const int k = step & 1;    // chroma edge 0 or 4 (luma edge 0 or 2)
      uint8_t* Pc = C + (size_t)plane * Hc * Wc;
      if (step < 2) {            // vertical, line i
        const int bs = p[P_BS_V + 8 * k + (i >> 1)];
        if (bs > 0)
          chroma_line(Pc + (size_t)(8 * my + i) * Wc + 8 * mx + 4 * k, 1, bs,
                      p + P_THR_CHROMA + (k == 0 ? THR_LEFT : THR_INNER));
      } else {                   // horizontal, column i
        const int bs = p[P_BS_H + 8 * k + (i >> 1)];
        if (bs > 0)
          chroma_line(Pc + (size_t)(8 * my + 4 * k) * Wc + 8 * mx + i, Wc,
                      bs, p + P_THR_CHROMA + (k == 0 ? THR_TOP : THR_INNER));
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int bw_deblock_wavefront(uint8_t* Y, uint8_t* C, const int32_t* P,
                                    int w_mbs, int h_mbs, void* stream) {
  const int S = (w_mbs - 1) + 2 * (h_mbs - 1) + 1;
  for (int d = 0; d < S; ++d) {
    const int y_lo = (d - w_mbs + 2 > 0 ? d - w_mbs + 2 : 0) / 2;
    const int y_hi = (d / 2 < h_mbs - 1) ? d / 2 : h_mbs - 1;
    deblock_kernel<<<y_hi - y_lo + 1, 32, 0, (cudaStream_t)stream>>>(
        Y, C, P, w_mbs, h_mbs, d, y_lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
