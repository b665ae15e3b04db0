// K2: intra reconstruction over raster planes as one persistent wavefront
// launch per picture (Hopper).
//
// Replaces the Pallas TPU kernel broadway_tpu/ops/tpu/wavefront_pallas.py
// (_intra_kernel / _intra_compute, launched by intra_wavefront). On the TPU
// the diagonal is the sequential grid axis, the MBs of one diagonal are the
// sublanes of a diagonal-major packed tensor, column access goes through
// one-hot MXU transposes and a 4..8-deep VMEM ring streams the rows.
//
// Here the planes stay raster uint8 and are updated in place by ONE launch:
// a CTA of 256 threads per MB row, rows ordered by the progress counters of
// wavefront.cuh. Per row the CTA scans the params once for the MBs that are
// Intra4x4/Intra16x16 (todo[x] bit 0) and for whether they read the row
// above at all (bit 1: any of av_b, av_c, av_d); inter and I_PCM MBs cost
// nothing, wait for nothing, and a run of them is published in one step, so
// a P picture with a handful of intra MBs is a few microseconds.
//
// Inside an MB: the params and residuals of the NEXT intra MB of the row
// are fetched into registers before the CTA waits on the counter, so the
// only global round trips on the dependent path are the counter poll, the
// neighbour pels (up row, left column, up-left, for luma and both chroma
// planes: one round trip, all started together) and the store + fence of
// the hand-off. The tap tables sit in shared memory. Intra4x4 keeps its 16
// z-order 4x4 blocks as a chain over a 17x25 context tile in shared memory
// (row 0: up-left, up 16 + up-right 4; column 0: left 16), exactly as the
// JAX scan builds it, with the 9 modes as the table-driven <= 3-tap sums
// of broadway_tpu/ops/tpu/intra.py; the chain runs in warp 0 with
// __syncwarp() between blocks while warps 4-7 predict chroma beside it.
//
// What bounds it: not bytes (about 20 MB per 1080p picture) and not
// arithmetic, but the w + 2 (h - 1) dependent hand-offs of an all-intra
// picture (the probe in wavefront.cu measures one) plus the serial I4x4
// chain inside each MB.

#include "wavefront.cuh"

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

constexpr int THREADS = 256;
constexpr int TAB_ROWS = TAB_BLK + 16;

__global__ void __launch_bounds__(THREADS)
intra_rows_kernel(uint8_t* Y, uint8_t* C, const int32_t* __restrict__ RY,
                  const int32_t* __restrict__ RC,
                  const int32_t* __restrict__ Pm,
                  const int32_t* __restrict__ tab, int* progress, int w_mbs,
                  int h_mbs) {
  extern __shared__ uint8_t todo[];      // [w_mbs]
  __shared__ __align__(16) int stab[TAB_ROWS * 8];
  __shared__ int p[NP];
  __shared__ int loc[17][25];
  __shared__ int up_row[21];
  __shared__ int left_col[16];
  __shared__ int res_y[256];
  __shared__ int upc[2][9];              // [plane]: up-left, up 8
  __shared__ int leftc[2][8];

  const int t = threadIdx.x;
  const int W = 16 * w_mbs, Wc = 8 * w_mbs, Hc = 8 * h_mbs;
  for (int i = t; i < TAB_ROWS * 8; i += THREADS) stab[i] = tab[i];

  for (int my = blockIdx.x; my < h_mbs; my += gridDim.x) {
    // ---- scan the row: which MBs are intra, which read the row above ---
    __syncthreads();
    for (int x = t; x < w_mbs; x += THREADS) {
      const int32_t* q = Pm + (size_t)(my * w_mbs + x) * NP;
      const int4 av = *reinterpret_cast<const int4*>(q);
      const int2 ii = *reinterpret_cast<const int2*>(q + P_IS_I4);
      todo[x] = (ii.x | ii.y) ? (1 | ((av.y | av.z | av.w) ? 2 : 0)) : 0;
    }
    __syncthreads();

    int pub = 0, seen = 0;
    int nx = bwwf::next_todo(todo, 0, w_mbs);
    int pre_p = 0, pre_y = 0, pre_c = 0;   // the next intra MB's operands
    if (nx < w_mbs) {
      const size_t a = (size_t)my * w_mbs + nx;
      if (t < NP) pre_p = Pm[a * NP + t];
      pre_y = RY[a * 256 + t];
      if (t >= 128) pre_c = RC[a * 128 + t - 128];
    }
    while (true) {
      if (nx > pub) {
        bwwf::publish(progress, my, nx);
        pub = nx;
      }
      if (nx >= w_mbs) break;
      const int mx = nx;
      if (t < NP) p[t] = pre_p;
      res_y[t] = pre_y;
      const int r_y = pre_y, r_c = pre_c;
      nx = bwwf::next_todo(todo, mx + 1, w_mbs);
      if (nx < w_mbs) {
        const size_t a = (size_t)my * w_mbs + nx;
        if (t < NP) pre_p = Pm[a * NP + t];
        pre_y = RY[a * 256 + t];
        if (t >= 128) pre_c = RC[a * 128 + t - 128];
      }
      if (my > 0 && (todo[mx] & 2))
        bwwf::wait_row(progress, my - 1, mx + 2 < w_mbs ? mx + 2 : w_mbs,
                       seen);
      __syncthreads();

      const bool is_i4 = p[P_IS_I4] != 0;
      const bool av_a = p[P_AV_A] != 0, av_b = p[P_AV_B] != 0,
                 av_c = p[P_AV_C] != 0, av_d = p[P_AV_D] != 0;
      const int x0 = 16 * mx, y0 = 16 * my, cx0 = 8 * mx, cy0 = 8 * my;

      // ---- cross-MB context (masked like the JAX up_row / left_col) ----
      for (int i = t; i < 17 * 25; i += THREADS) {
        const int r = i / 25, c = i - 25 * r;
        if (!((r == 0 && c < 21) || (c == 0 && r > 0))) (&loc[0][0])[i] = 0;
      }
      if (t <= 20) {
        // t 17..20 is MB C's row: zero unless B is available too (JAX
        // masks the whole row by av_b); read only when C exists
        const bool ok = t == 0 ? av_d : (t <= 16 ? av_b : (av_b && av_c));
        const int v = ok ? __ldcg(Y + (size_t)(y0 - 1) * W + x0 + t - 1) : 0;
        up_row[t] = v;
        loc[0][t] = v;
      } else if (t >= 32 && t < 48) {
        const int k = t - 32;
        const int v = av_a ? __ldcg(Y + (size_t)(y0 + k) * W + x0 - 1) : 0;
        left_col[k] = v;
        loc[k + 1][0] = v;
      } else if (t >= 64 && t < 82) {
        const int plane = (t - 64) / 9, k = (t - 64) % 9;
        const uint8_t* Pc = C + (size_t)plane * Hc * Wc;
        const bool ok = k == 0 ? av_d : av_b;
        upc[plane][k] =
            ok ? __ldcg(Pc + (size_t)(cy0 - 1) * Wc + cx0 + k - 1) : 0;
      } else if (t >= 96 && t < 112) {
        const int plane = (t - 96) >> 3, k = (t - 96) & 7;
        const uint8_t* Pc = C + (size_t)plane * Hc * Wc;
        leftc[plane][k] =
            av_a ? __ldcg(Pc + (size_t)(cy0 + k) * Wc + cx0 - 1) : 0;
      }
      __syncthreads();

      // ---- Intra4x4: 16 z-order blocks, each reading its predecessors,
      // in warp 0 -----------------------------------------------------
      if (is_i4 && t < 32) {
#pragma unroll
        for (int z = 0; z < 16; ++z) {
          // z-order block position (ops/gpu/tables.py BLK_ORDER), folded
          // at compile time; the up-right code stays in the table
          const int bx4 = 4 * ((z & 1) + 2 * ((z >> 2) & 1));
          const int by4 = 4 * (((z >> 1) & 1) + 2 * ((z >> 3) & 1));
          if (t < 16) {
            const int code = stab[(TAB_BLK + z) * 8 + 2];
            const int yy = t >> 2, xx = t & 3;
            const bool b_av_u = by4 == 0 ? av_b : true;
            const bool b_av_l = bx4 == 0 ? av_a : true;
            const bool b_av_ur =
                code == 0 ? av_b : (code == 1 ? av_c : code == 2);
            // neighbour pel i of the block (0 up-left, 1..8 up and
            // up-right, 9..12 left), read straight from the context tile
            auto pel = [&](int i) -> int {
              const int r = i <= 8 ? by4 : by4 + i - 8;
              const int c = i <= 8 ? ((i >= 5 && !b_av_ur) ? bx4 + 4
                                                           : bx4 + i)
                                   : bx4;
              return loc[r][c];
            };
            const int mode = p[P_I4_MODES + z];
            int pred;
            if (mode == 2) {
              pred = dc_value(pel(1) + pel(2) + pel(3) + pel(4),
                              pel(9) + pel(10) + pel(11) + pel(12), b_av_u,
                              b_av_l, 3);
            } else {
              const int4* row = reinterpret_cast<const int4*>(
                  stab + ((mode * 4 + yy) * 4 + xx) * 8);
              // a: idx0..2, coef0; b: coef1, coef2, rnd, shift
              const int4 a = row[0], b = row[1];
              const int lin =
                  a.w * pel(a.x) + b.x * pel(a.y) + b.y * pel(a.z);
              pred = (lin + b.z) >> b.w;
            }
            loc[by4 + 1 + yy][bx4 + 1 + xx] =
                clip8(pred + res_y[(by4 + yy) * 16 + bx4 + xx]);
          }
          __syncwarp();
        }
      }

      // ---- chroma (both planes, 64 threads each, warps 4-7) ------------
      if (t >= 128) {
        const int u = t - 128;
        const int plane = u >> 6, cy = (u & 63) >> 3, cx = u & 7;
        const int* upv = &upc[plane][1];
        const int* leftv = leftc[plane];
        const int ulc = upc[plane][0];
        const int mode = p[P_C_MODE];
        int pred;
        if (mode == 0) {            // DC per 4x4 quadrant
          const int qx = cx >> 2, qy = cy >> 2;
          int us[2] = {0, 0}, ls[2] = {0, 0};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            us[k >> 2] += upv[k];
            ls[k >> 2] += leftv[k];
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
          pred = leftv[cy];
        } else if (mode == 2) {
          pred = upv[cx];
        } else {
          int hs = 0, vs = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int ue = k == 3 ? ulc : upv[2 - k];
            const int le = k == 3 ? ulc : leftv[2 - k];
            hs += (k + 1) * (upv[4 + k] - ue);
            vs += (k + 1) * (leftv[4 + k] - le);
          }
          const int b = (17 * hs + 16) >> 5, c = (17 * vs + 16) >> 5;
          const int a = 16 * (upv[7] + leftv[7]);
          pred = clip8((a + b * (cx - 3) + c * (cy - 3) + 16) >> 5);
        }
        __stcg(C + (size_t)plane * Hc * Wc + (size_t)(cy0 + cy) * Wc + cx0 +
                   cx,
               (uint8_t)clip8(pred + r_c));
      }
      __syncthreads();

      // ---- luma output ---------------------------------------------------
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
          out = clip8(pred + r_y);
        }
        __stcg(Y + (size_t)(y0 + y) * W + x0 + x, (uint8_t)out);
      }
      // the loop's next turn publishes this MB (after a __syncthreads)
    }
  }
}

}  // namespace

extern "C" int bw_intra_wavefront(uint8_t* Y, uint8_t* C, const int32_t* RY,
                                  const int32_t* RC, const int32_t* P,
                                  const int32_t* tab, int* progress,
                                  int w_mbs, int h_mbs, void* stream) {
  void* args[] = {&Y, &C, &RY, &RC, &P, &tab, &progress, &w_mbs, &h_mbs};
  const size_t smem = (size_t)((w_mbs + 15) & ~15);
  return (int)bwwf::launch_rows(bwwf::INTRA, (const void*)intra_rows_kernel,
                                THREADS, smem, progress, h_mbs, args,
                                (cudaStream_t)stream);
}
