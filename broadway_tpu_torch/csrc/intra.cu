// K2: intra reconstruction as an x + 2y wavefront over raster planes
// (Hopper).
//
// Replaces the Pallas TPU kernel broadway_tpu/ops/tpu/wavefront_pallas.py
// (_intra_kernel / _intra_compute, launched by intra_wavefront). On the TPU
// the diagonal is the sequential grid axis, the MBs of one diagonal are the
// sublanes of a diagonal-major packed tensor, column access goes through
// one-hot MXU transposes and a 4..8-deep VMEM ring streams the rows.
//
// Here the planes stay raster uint8 and are updated in place. The exported
// function loops over the S = (w-1) + 2(h-1) + 1 diagonals on the host and
// launches one small kernel per diagonal on the caller's stream: stream
// order replaces the TPU's sequential grid, and for diagonal d the MBs are
// x = d - 2y. One CUDA block (256 threads) per MB; a block whose MB is not
// Intra4x4/Intra16x16 exits at once (that per-MB skip replaces the TPU's
// per-diagonal flags). Intra4x4 keeps its 16 z-order 4x4 blocks as a
// __syncthreads()-separated loop over a 17x25 context tile in shared
// memory (row 0: up-left, up 16 + up-right 4; column 0: left 16),
// exactly as the JAX scan builds it, with the 9 modes as the table-driven
// <= 3-tap sums of broadway_tpu/ops/tpu/intra.py.
//
// What bounds it: launch latency. A 1080p picture is 254 dependent
// launches of at most 68 small blocks, a few microseconds each, and the
// arithmetic per MB is tiny. A persistent kernel with per-row progress
// counters is the way past that (later work).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// intra params per MB (int32 [n, 32]); see ops/gpu/intra.py
constexpr int P_AV_A = 0, P_AV_B = 1, P_AV_C = 2, P_AV_D = 3, P_IS_I4 = 4,
              P_IS_I16 = 5, P_I16_MODE = 6, P_C_MODE = 7, P_I4_MODES = 9;
constexpr int NP = 32;
// table rows: 9*16 tap rows (idx0..2, coef0..2, rnd, shift), then 16
// z-order block rows (bx, by, up-right code, ...)
constexpr int TAB_BLK = 9 * 16;

__device__ __forceinline__ int clip8(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__device__ __forceinline__ int dc_value(int up_sum, int left_sum, bool au,
                                        bool al, int lg) {
  // DC of 2^(lg-1) up and left pels (lg 3: 4x4 blocks, 5: 16x16)
  const int r = 1 << (lg - 1);
  if (au && al) return (up_sum + left_sum + r) >> lg;
  if (au) return (up_sum + r / 2) >> (lg - 1);
  if (al) return (left_sum + r / 2) >> (lg - 1);
  return 128;
}

__global__ void intra_kernel(uint8_t* __restrict__ Y, uint8_t* __restrict__ C,
                             const int32_t* __restrict__ RY,
                             const int32_t* __restrict__ RC,
                             const int32_t* __restrict__ Pm,
                             const int32_t* __restrict__ tab, int w_mbs,
                             int h_mbs, int d, int y_lo) {
  __shared__ int p[NP];
  __shared__ int loc[17][25];
  __shared__ int up_row[21];
  __shared__ int left_col[16];

  const int t = threadIdx.x;
  const int my = y_lo + blockIdx.x, mx = d - 2 * my;
  const int addr = my * w_mbs + mx;
  const int W = 16 * w_mbs;
  if (t < NP) p[t] = Pm[addr * NP + t];
  __syncthreads();
  const bool is_i4 = p[P_IS_I4] != 0, is_i16 = p[P_IS_I16] != 0;
  if (!is_i4 && !is_i16) return;   // inter / I_PCM MB: passes through
  const bool av_a = p[P_AV_A] != 0, av_b = p[P_AV_B] != 0,
             av_c = p[P_AV_C] != 0, av_d = p[P_AV_D] != 0;

  // ---- cross-MB context (masked like the JAX up_row / left_col) -------
  const int x0 = 16 * mx, y0 = 16 * my;
  for (int i = t; i < 17 * 25; i += blockDim.x) (&loc[0][0])[i] = 0;
  if (t == 0) {
    up_row[0] = av_d ? Y[(size_t)(y0 - 1) * W + x0 - 1] : 0;
  } else if (t <= 16) {
    up_row[t] = av_b ? Y[(size_t)(y0 - 1) * W + x0 + t - 1] : 0;
  } else if (t <= 20) {
    // MB C's row: zero unless B is available too (JAX masks the whole
    // row by av_b); read only when C exists
    up_row[t] = (av_b && av_c) ? Y[(size_t)(y0 - 1) * W + x0 + t - 1] : 0;
  } else if (t >= 32 && t < 48) {
    left_col[t - 32] = av_a ? Y[(size_t)(y0 + t - 32) * W + x0 - 1] : 0;
  }
  __syncthreads();
  if (t < 21) loc[0][t] = up_row[t];
  if (t >= 32 && t < 48) loc[t - 31][0] = left_col[t - 32];
  __syncthreads();

  const int32_t* res = RY + (size_t)addr * 256;

  // ---- Intra4x4: 16 z-order blocks, each reading its predecessors -----
  if (is_i4) {
    for (int z = 0; z < 16; ++z) {
      const int bx = tab[(TAB_BLK + z) * 8 + 0];
      const int by = tab[(TAB_BLK + z) * 8 + 1];
      const int code = tab[(TAB_BLK + z) * 8 + 2];
      if (t < 16) {
        const int bx4 = 4 * bx, by4 = 4 * by;
        const int yy = t >> 2, xx = t & 3;
        const bool b_av_u = by == 0 ? av_b : true;
        const bool b_av_l = bx == 0 ? av_a : true;
        const bool b_av_ur =
            code == 0 ? av_b : (code == 1 ? av_c : code == 2);
        int v[13];
        v[0] = loc[by4][bx4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[1 + i] = loc[by4][bx4 + 1 + i];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[5 + i] = b_av_ur ? loc[by4][bx4 + 5 + i] : loc[by4][bx4 + 4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[9 + i] = loc[by4 + 1 + i][bx4];
        const int mode = p[P_I4_MODES + z];
        int pred;
        if (mode == 2) {
          pred = dc_value(v[1] + v[2] + v[3] + v[4],
                          v[9] + v[10] + v[11] + v[12], b_av_u, b_av_l, 3);
        } else {
          const int32_t* row = tab + ((mode * 4 + yy) * 4 + xx) * 8;
          const int lin = row[3] * v[row[0]] + row[4] * v[row[1]] +
                          row[5] * v[row[2]];
          pred = (lin + row[6]) >> row[7];
        }
        loc[by4 + 1 + yy][bx4 + 1 + xx] =
            clip8(pred + res[(by4 + yy) * 16 + bx4 + xx]);
      }
      __syncthreads();
    }
  }

  // ---- luma output ------------------------------------------------------
  {
    const int y = t >> 4, x = t & 15;
    int out;
    if (is_i4) {
      out = loc[1 + y][1 + x];
    } else {
      const int mode = p[P_I16_MODE];
      int pred;
      if (mode == 0) {
        pred = up_row[1 + x];
      } else if (mode == 1) {
        pred = left_col[y];
      } else if (mode == 2) {
        int us = 0, ls = 0;
        for (int k = 0; k < 16; ++k) {
          us += up_row[1 + k];
          ls += left_col[k];
        }
        pred = dc_value(us, ls, av_b, av_a, 5);
      } else {
        const int ul = up_row[0];
        int hs = 0, vs = 0;
        for (int k = 0; k < 8; ++k) {
          const int ue = k == 7 ? ul : up_row[1 + 6 - k];
          const int le = k == 7 ? ul : left_col[6 - k];
          hs += (k + 1) * (up_row[1 + 8 + k] - ue);
          vs += (k + 1) * (left_col[8 + k] - le);
        }
        const int b = (5 * hs + 32) >> 6, c = (5 * vs + 32) >> 6;
        const int a = 16 * (up_row[16] + left_col[15]);
        pred = clip8((a + b * (x - 7) + c * (y - 7) + 16) >> 5);
      }
      out = clip8(pred + res[t]);
    }
    Y[(size_t)(y0 + y) * W + x0 + x] = (uint8_t)out;
  }

  // ---- chroma (both planes, 64 threads each) ----------------------------
  if (t < 128) {
    const int plane = t >> 6, cy = (t & 63) >> 3, cx = t & 7;
    const int Wc = W / 2, Hc = 8 * h_mbs;
    const uint8_t* Pc = C + (size_t)plane * Hc * Wc;
    const int cx0 = 8 * mx, cy0 = 8 * my;
    int upc[8], leftc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      upc[k] = av_b ? Pc[(size_t)(cy0 - 1) * Wc + cx0 + k] : 0;
      leftc[k] = av_a ? Pc[(size_t)(cy0 + k) * Wc + cx0 - 1] : 0;
    }
    const int ulc = av_d ? Pc[(size_t)(cy0 - 1) * Wc + cx0 - 1] : 0;
    const int mode = p[P_C_MODE];
    int pred;
    if (mode == 0) {            // DC per 4x4 quadrant
      const int qx = cx >> 2, qy = cy >> 2;
      int us[2] = {0, 0}, ls[2] = {0, 0};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        us[k >> 2] += upc[k];
        ls[k >> 2] += leftc[k];
      }
      int both;
      if (qx == qy) both = (us[qx] + ls[qy] + 4) >> 3;
      else if (qx == 1) both = (us[1] + 2) >> 2;
      else both = (ls[1] + 2) >> 2;
      pred = (av_b && av_a) ? both
             : av_b         ? (us[qx] + 2) >> 2
             : av_a         ? (ls[qy] + 2) >> 2
                            : 128;
    } else if (mode == 1) {
      pred = leftc[cy];
    } else if (mode == 2) {
      pred = upc[cx];
    } else {
      int hs = 0, vs = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ue = k == 3 ? ulc : upc[2 - k];
        const int le = k == 3 ? ulc : leftc[2 - k];
        hs += (k + 1) * (upc[4 + k] - ue);
        vs += (k + 1) * (leftc[4 + k] - le);
      }
      const int b = (17 * hs + 16) >> 5, c = (17 * vs + 16) >> 5;
      const int a = 16 * (upc[7] + leftc[7]);
      pred = clip8((a + b * (cx - 3) + c * (cy - 3) + 16) >> 5);
    }
    const int r = RC[(size_t)addr * 128 + plane * 64 + cy * 8 + cx];
    C[(size_t)plane * Hc * Wc + (size_t)(cy0 + cy) * Wc + cx0 + cx] =
        (uint8_t)clip8(pred + r);
  }
}

}  // namespace

extern "C" int bw_intra_wavefront(uint8_t* Y, uint8_t* C, const int32_t* RY,
                                  const int32_t* RC, const int32_t* P,
                                  const int32_t* tab, int w_mbs, int h_mbs,
                                  void* stream) {
  const int S = (w_mbs - 1) + 2 * (h_mbs - 1) + 1;
  for (int d = 0; d < S; ++d) {
    const int y_lo = (d - w_mbs + 2 > 0 ? d - w_mbs + 2 : 0) / 2;
    const int y_hi = (d / 2 < h_mbs - 1) ? d / 2 : h_mbs - 1;
    intra_kernel<<<y_hi - y_lo + 1, 256, 0, (cudaStream_t)stream>>>(
        Y, C, RY, RC, P, tab, w_mbs, h_mbs, d, y_lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
