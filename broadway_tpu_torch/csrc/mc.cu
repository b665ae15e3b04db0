// K1: quarter-pel luma + eighth-pel chroma motion compensation (Hopper).
//
// Replaces the Pallas TPU kernel broadway_tpu/ops/tpu/mc_pallas.py
// (_mc_kernel, launched by mc_predict), which DMAs tile-aligned "slabs" of
// padded reference planes into VMEM and selects each block's window with
// one-hot MXU matmuls, because Mosaic only slices at (8, 128) tiles.
//
// On the H100 nothing forces tile alignment, so each thread computes one
// predicted pixel straight from the unpadded uint8 reference plane: it
// reads its <= 6x6 neighbourhood with every coordinate clamped into the
// picture (equal to the TPU's origin clip into its PAD-24 edge-replicated
// planes, and to the reference's h264bsdFillBlock). One block per MB:
// threads 0..255 are the 16x16 luma pixels, 256..383 the 8x8 cb and cr
// pixels, written in the JAX output layout (pred_y [n,16,16], pred_c
// [n,8,16] with lane 2k = cb column k, 2k+1 = cr column k).
//
// What bounds it: scattered byte reads of the reference planes (a 1080p
// luma plane is 2 MB, so the R slots of the stack stay in the 50 MB L2;
// neighbouring threads read neighbouring bytes) and the 6-tap arithmetic
// (36 loads, ~100 integer ops per luma pixel). Simple and exact first:
// shared-memory window reuse across the pixels of a 4x4 block is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int clip8(int v) { return clampi(v, 0, 255); }

__device__ __forceinline__ int avg(int a, int b) { return (a + b + 1) >> 1; }

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

__global__ void mc_kernel(const uint8_t* __restrict__ ref_y,
                          const uint8_t* __restrict__ ref_c,
                          const int32_t* __restrict__ mv,
                          const int32_t* __restrict__ ref_blk,
                          int32_t* __restrict__ pred_y,
                          int32_t* __restrict__ pred_c,
                          int w_mbs, int h_mbs, int R) {
  const int mb = blockIdx.x;
  const int t = threadIdx.x;
  const int W = 16 * w_mbs, H = 16 * h_mbs;
  const int mbx = mb % w_mbs, mby = mb / w_mbs;

  if (t < 256) {
    // ---- luma pixel (y, x) of the MB -----------------------------------
    const int y = t >> 4, x = t & 15;
    const int blk = (y >> 2) * 4 + (x >> 2);
    const int mvx = mv[(mb * 16 + blk) * 2 + 0];
    const int mvy = mv[(mb * 16 + blk) * 2 + 1];
    // ref_blk is -1 on intra MBs: clamp into the stack (JAX clamps too)
    const int r = clampi(ref_blk[mb * 16 + blk], 0, R - 1);
    const uint8_t* P = ref_y + (size_t)r * H * W;
    // integer position; >> and & split negative vectors correctly
    const int X = mbx * 16 + x + (mvx >> 2);
    const int Y = mby * 16 + y + (mvy >> 2);
    const int fx = mvx & 3, fy = mvy & 3;

    int cols[6], rows[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      cols[k] = clampi(X + k - 2, 0, W - 1);
      rows[k] = clampi(Y + k - 2, 0, H - 1) * W;
    }
    // win[i][j] = pel at (Y + i - 2, X + j - 2)
    int win[6][6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) win[i][j] = P[rows[i] + cols[j]];

    // unclipped horizontal half-pel sums of rows -2..3 (between x, x+1)
    int raw_h[6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      raw_h[i] = tap6(win[i][0], win[i][1], win[i][2], win[i][3], win[i][4],
                      win[i][5]);
    const int g00 = win[2][2], g01 = win[2][3], g10 = win[3][2];
    const int b0 = clip8((raw_h[2] + 16) >> 5);   // half-pel right
    const int b1 = clip8((raw_h[3] + 16) >> 5);   // one row down
    const int h0 = clip8((tap6(win[0][2], win[1][2], win[2][2], win[3][2],
                               win[4][2], win[5][2]) + 16) >> 5);
    const int h1 = clip8((tap6(win[0][3], win[1][3], win[2][3], win[3][3],
                               win[4][3], win[5][3]) + 16) >> 5);
    // centre j from the UNCLIPPED sums, rounded (+512) >> 10
    const int j0 = clip8((tap6(raw_h[0], raw_h[1], raw_h[2], raw_h[3],
                               raw_h[4], raw_h[5]) + 512) >> 10);
    int out;
    switch (fy * 4 + fx) {
      case 0: out = g00; break;
      case 1: out = avg(g00, b0); break;
      case 2: out = b0; break;
      case 3: out = avg(g01, b0); break;
      case 4: out = avg(g00, h0); break;
      case 5: out = avg(b0, h0); break;
      case 6: out = avg(j0, b0); break;
      case 7: out = avg(b0, h1); break;
      case 8: out = h0; break;
      case 9: out = avg(j0, h0); break;
      case 10: out = j0; break;
      case 11: out = avg(j0, h1); break;
      case 12: out = avg(g10, h0); break;
      case 13: out = avg(b1, h0); break;
      case 14: out = avg(j0, b1); break;
      default: out = avg(b1, h1); break;
    }
    pred_y[mb * 256 + t] = out;
  } else if (t < 384) {
    // ---- chroma: row cy, lane l = 2 * cx + plane -----------------------
    const int u = t - 256;
    const int cy = u >> 4, lane = u & 15;
    const int cx = lane >> 1, plane = lane & 1;
    const int blk = (cy >> 1) * 4 + (cx >> 1);
    const int mvx = mv[(mb * 16 + blk) * 2 + 0];
    const int mvy = mv[(mb * 16 + blk) * 2 + 1];
    const int r = clampi(ref_blk[mb * 16 + blk], 0, R - 1);
    const int Wc = W / 2, Hc = H / 2;
    const uint8_t* P = ref_c + ((size_t)r * 2 + plane) * Hc * Wc;
    const int X = mbx * 8 + cx + (mvx >> 3);
    const int Y = mby * 8 + cy + (mvy >> 3);
    const int dx = mvx & 7, dy = mvy & 7;
    const int x0 = clampi(X, 0, Wc - 1), x1 = clampi(X + 1, 0, Wc - 1);
    const int y0 = clampi(Y, 0, Hc - 1) * Wc;
    const int y1 = clampi(Y + 1, 0, Hc - 1) * Wc;
    const int A = P[y0 + x0], B = P[y0 + x1], C = P[y1 + x0], D = P[y1 + x1];
    pred_c[mb * 128 + u] = ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B +
                            (8 - dx) * dy * C + dx * dy * D + 32) >> 6;
  }
}

}  // namespace

extern "C" int bw_mc_predict(const uint8_t* ref_y, const uint8_t* ref_c,
                             const int32_t* mv, const int32_t* ref_blk,
                             int32_t* pred_y, int32_t* pred_c, int n,
                             int w_mbs, int h_mbs, int R, void* stream) {
  if (n <= 0) return 0;
  mc_kernel<<<n, 384, 0, (cudaStream_t)stream>>>(ref_y, ref_c, mv, ref_blk,
                                                 pred_y, pred_c, w_mbs,
                                                 h_mbs, R);
  return (int)cudaGetLastError();
}
