// K1: quarter-pel luma + eighth-pel chroma motion compensation (Hopper).
//
// Replaces the Pallas TPU kernel broadway_tpu/ops/tpu/mc_pallas.py
// (_mc_kernel, launched by mc_predict), which DMAs tile-aligned "slabs" of
// padded reference planes into VMEM and selects each block's window with
// one-hot MXU matmuls, because Mosaic only slices at (8, 128) tiles. None
// of that shape is kept: the function is (references, per-4x4-block
// vectors and slots) -> (pred_y [n,16,16], pred_c [n,8,16] with lane
// 2k = cb column k, 2k+1 = cr column k), uint8.
//
// What bounds it on this card: the arithmetic is ~40 integer operations
// per predicted pel and the distinct bytes are a few MB per 1080p picture,
// so both bounds are microseconds (chip_smoke.py computes them per run).
// What a kernel of this kind pays for is instructions issued per thread
// for addresses, loads and selection, the latency chain of one MB
// (indices -> window -> filter -> store), and the launch of its CTAs (an
// empty kernel of one CTA per MB costs 0.0067 ms at 1080p, of this grid
// 0.0030 ms; every time in this note: NVIDIA H100 80GB HBM3, 700 W, CUDA
// events around 50 launches queued behind a held stream). The design
// therefore:
//
//  * A WARP per MB, four MBs per CTA of 128 threads, no CTA barrier: all
//    8160 MBs of a 1080p picture are in flight at once or nearly (48-64
//    warps per SM), which hides the latency chain, and a lane carries 8
//    luma and 4 chroma pels, which spreads the per-thread overhead. Lane
//    2b + h takes the 4x4 block b (0..15, raster) and of it the column
//    pair h (luma) and the plane h (chroma).
//  * The reference window is staged in shared memory once, coordinates
//    clamped at staging only (the clamp is H.264's edge replication,
//    equal to the TPU's origin clip into its PAD-24 planes and to
//    h264bsdFillBlock). A warp vote finds the common case, 16 equal
//    vectors and slots: one 21x21 luma window (+ 9x9 per chroma plane),
//    lanes along the rows, instead of 16 windows of 9x9. Only the rows
//    and columns the fraction needs are loaded (16x16 for an integer
//    vector). A window wholly inside the picture loads without clamps.
//  * The filter reads shared memory only and computes per block just the
//    sums its fraction asks for: none for an integer vector, one 6-tap per
//    pel for a pure horizontal or vertical fraction, two for the diagonal
//    quarter positions; a lane walks down a column, so the nine pels of a
//    vertical line are loaded once for its four rows, and where the
//    centre half-pel j is needed the column's nine unclipped horizontal
//    sums are computed once, in registers, for the vertical pass and the
//    neighbouring half-pels b.
//  * A block with ref_blk < 0 (intra MB) predicts nothing: it writes 0 and
//    loads no window; a warp whose 16 blocks are all such leaves after
//    reading its indices (the whole IDR picture).
//  * Predictions leave as uint8 (they are 0..255), assembled in shared
//    memory and stored as 24 16-byte words per MB.
//
// Measured against the alternatives on one card in one call, ms per
// 1080p picture (PERF.md has the table): a CTA of 256 threads per MB with
// a thread per pel was bound by per-thread overhead (0.034 on the P
// picture, where this form takes 0.016 and the first form 0.044); a CTA
// of 64 threads per MB, equal to this form on the P picture, pays
// twice the launch (0.0070 against 0.0033 on the IDR) and is 20-37%
// ahead only where every MB carries 16 different vectors, which costs
// this form up to five divergent filter paths in a warp (0.040-0.045,
// the first form 0.056-0.062). Staging the per-block windows block after
// block with the lanes along the rows was slower and is not kept.
//
// What Hopper offers and this kernel does not use: TMA (its out-of-range
// fill is zeros, not the edge replication H.264 asks for, and a 9-byte
// wide box at a byte-aligned origin is below its 16-byte granularity);
// cp.async (4/8/16-byte aligned sources only; a window starts at any
// byte); wgmma (the TPU kernel's one-hot matrix gathers exist for
// Mosaic's tiling; here integer ALUs do 6 taps).
//
// The kernel's first form (one thread per pel reading its 6x6 window
// from global memory, int32 out) is kept in mc_pel.cu as the yardstick
// chip_smoke.py times beside this one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // 4 warps, a warp per MB
constexpr int MBS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WS = 24;    // row stride of the MB's shared 21x21 luma window
constexpr int BS = 12;    // row stride of one block's own 9x9 luma window
constexpr int CWS = 12;   // row stride of the MB's 9x9 chroma window (x2)

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int clip8(int v) { return clampi(v, 0, 255); }

__device__ __forceinline__ int avg(int a, int b) { return (a + b + 1) >> 1; }

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

// clipped horizontal half-pel between q[0] and q[1]
__device__ __forceinline__ int half_h(const uint8_t* q) {
  return clip8((tap6(q[-2], q[-1], q[0], q[1], q[2], q[3]) + 16) >> 5);
}

__global__ void __launch_bounds__(THREADS)
mc_kernel(const uint8_t* __restrict__ ref_y, const uint8_t* __restrict__ ref_c,
          const int32_t* __restrict__ mv, const int32_t* __restrict__ ref_blk,
          uint8_t* __restrict__ pred_y, uint8_t* __restrict__ pred_c,
          int n, int w_mbs, int h_mbs, int R) {
  __shared__ uint8_t s_win_all[MBS][16 * 9 * BS];
  __shared__ uint8_t s_cwin_all[MBS][16 * 2 * 3 * 4];
  __shared__ __align__(16) uint8_t s_out_all[MBS][384];

  const int wi = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int mb = blockIdx.x * MBS + wi;
  if (mb >= n) return;                         // whole warp
  uint8_t* s_win = s_win_all[wi];
  uint8_t* s_cwin = s_cwin_all[wi];
  uint8_t* s_out = s_out_all[wi];
  const int blk = t >> 1, half = t & 1;        // 4x4 block, its column pair
  const int by = blk >> 2, bx = blk & 3;
  uint4* out_y = reinterpret_cast<uint4*>(pred_y + (size_t)mb * 256);
  uint4* out_c = reinterpret_cast<uint4*>(pred_c + (size_t)mb * 128);

  const int r = ref_blk[mb * 16 + blk];
  const int mvx = mv[(mb * 16 + blk) * 2], mvy = mv[(mb * 16 + blk) * 2 + 1];
  const bool active = r >= 0;
  if (!__any_sync(FULL, active)) {             // nothing to predict here
    if (t < 24)
      (t < 16 ? out_y + t : out_c + (t - 16))[0] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  // every lane takes part in every shuffle: no && between them
  const int mvx0 = __shfl_sync(FULL, mvx, 0);
  const int mvy0 = __shfl_sync(FULL, mvy, 0);
  const int r0 = __shfl_sync(FULL, r, 0);
  const bool same = mvx == mvx0 && mvy == mvy0 && r == r0;
  const bool uniform = __all_sync(FULL, same);    // then every r == r0 >= 0

  const int W = 16 * w_mbs, H = 16 * h_mbs, Wc = W >> 1, Hc = H >> 1;
  const int mby = mb / w_mbs, mbx = mb - mby * w_mbs;
  const int slot = r < R ? r : R - 1;          // as the JAX slice clamps
  const int fx = mvx & 3, fy = mvy & 3;        // >> and & split negative
  const int dx = mvx & 7, dy = mvy & 7;        // vectors correctly
  const int lo_c = fx ? 0 : 2, lo_r = fy ? 0 : 2;

  const uint8_t* wp = s_win;    // this block's window origin, its strides
  const uint8_t* cp = s_cwin;
  int ws = WS, cs = CWS, cplane = 9 * CWS;

  if (uniform) {
    // ---- one window for the MB: 21x21 luma, 9x9 per chroma plane -------
    const uint8_t* P = ref_y + (size_t)slot * H * W;
    const int X0 = mbx * 16 + (mvx >> 2) - 2, Y0 = mby * 16 + (mvy >> 2) - 2;
    const int hi_c = fx ? 21 : 18, hi_r = fy ? 21 : 18;
    if (t >= lo_c && t < hi_c) {               // lane = column
      if (X0 + lo_c >= 0 && X0 + hi_c <= W && Y0 + lo_r >= 0 &&
          Y0 + hi_r <= H) {
        const uint8_t* q = P + (Y0 * W + X0 + t);
#pragma unroll 8
        for (int row = lo_r; row < hi_r; ++row)
          s_win[row * WS + t] = q[row * W];
      } else {
        const int xc = clampi(X0 + t, 0, W - 1);
#pragma unroll 8
        for (int row = lo_r; row < hi_r; ++row)
          s_win[row * WS + t] = P[clampi(Y0 + row, 0, H - 1) * W + xc];
      }
    }
    const int pl = t >> 4, ccol = t & 15;      // plane, column
    const uint8_t* Pc = ref_c + ((size_t)slot * 2 + pl) * Hc * Wc;
    const int CX0 = mbx * 8 + (mvx >> 3), CY0 = mby * 8 + (mvy >> 3);
    const int ncc = 8 + (dx != 0), nrc = 8 + (dy != 0);
    if (ccol < ncc) {
      const bool cin = CX0 >= 0 && CX0 + ncc <= Wc && CY0 >= 0 &&
                       CY0 + nrc <= Hc;
      const int xc = cin ? CX0 + ccol : clampi(CX0 + ccol, 0, Wc - 1);
#pragma unroll 9
      for (int row = 0; row < nrc; ++row) {
        const int yc = cin ? CY0 + row : clampi(CY0 + row, 0, Hc - 1);
        s_cwin[(pl * 9 + row) * CWS + ccol] = Pc[yc * Wc + xc];
      }
    }
    wp = s_win + by * 4 * WS + bx * 4;
    cp = s_cwin + by * 2 * CWS + bx * 2;
  } else if (active) {
    // ---- a window per block: 9x9 luma, 3x3 per chroma plane ------------
    const uint8_t* P = ref_y + (size_t)slot * H * W;
    const int X0 = mbx * 16 + bx * 4 + (mvx >> 2) - 2;
    const int Y0 = mby * 16 + by * 4 + (mvy >> 2) - 2;
    const int hi_c = fx ? 9 : 6, hi_r = fy ? 9 : 6;
    uint8_t* wb = s_win + blk * 9 * BS;
    const bool in = X0 + lo_c >= 0 && X0 + hi_c <= W && Y0 + lo_r >= 0 &&
                    Y0 + hi_r <= H;
    // the block's two lanes take alternate columns
    for (int col = lo_c + half; col < hi_c; col += 2) {
      const int xc = in ? X0 + col : clampi(X0 + col, 0, W - 1);
      for (int row = lo_r; row < hi_r; ++row) {
        const int yc = in ? Y0 + row : clampi(Y0 + row, 0, H - 1);
        wb[row * BS + col] = P[yc * W + xc];
      }
    }
    // chroma: lane `half` stages plane `half`
    const uint8_t* Pc = ref_c + ((size_t)slot * 2 + half) * Hc * Wc;
    const int CX0 = mbx * 8 + bx * 2 + (mvx >> 3);
    const int CY0 = mby * 8 + by * 2 + (mvy >> 3);
    uint8_t* cb = s_cwin + blk * 24;
    for (int crow = 0; crow < 2 + (dy != 0); ++crow)
      for (int ccol = 0; ccol < 2 + (dx != 0); ++ccol)
        cb[half * 12 + crow * 4 + ccol] =
            Pc[clampi(CY0 + crow, 0, Hc - 1) * Wc +
               clampi(CX0 + ccol, 0, Wc - 1)];
    wp = wb;
    cp = cb;
    ws = BS;
    cs = 4;
    cplane = 12;
  }
  __syncwarp();

  // ---- luma: two columns of the block, rows 0..3, sums in registers -----
#pragma unroll 1
  for (int c = 2 * half; c < 2 * half + 2; ++c) {
    int out[4] = {0, 0, 0, 0};
    if (active) {
      const uint8_t* g = wp + 2 * ws + c + 2;    // integer pel of row 0
      if ((fx | fy) == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) out[i] = g[i * ws];
      } else if (fy == 0) {                      // b, or its average with G
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint8_t* q = g + i * ws;
          const int b = half_h(q);
          out[i] = fx == 2 ? b : avg(q[fx >> 1], b);
        }
      } else if ((fx & 1) || fx == 0) {
        // one vertical 6-tap line per pel (h), from 9 pels of one column
        const uint8_t* qv = g + (fx >> 1) - 2 * ws;
        int col[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) col[i] = qv[i * ws];
        if (fy == 2 && fx != 0) {
          // cases 9, 11: average of j and h; j from 9 horizontal sums
          int hs[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) {
            const uint8_t* q = wp + i * ws + c;
            hs[i] = tap6(q[0], q[1], q[2], q[3], q[4], q[5]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = clip8((tap6(hs[i], hs[i + 1], hs[i + 2], hs[i + 3],
                                      hs[i + 4], hs[i + 5]) + 512) >> 10);
            const int h = clip8((tap6(col[i], col[i + 1], col[i + 2],
                                      col[i + 3], col[i + 4], col[i + 5]) + 16)
                                >> 5);
            out[i] = avg(j, h);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = clip8((tap6(col[i], col[i + 1], col[i + 2],
                                      col[i + 3], col[i + 4], col[i + 5]) + 16)
                                >> 5);
            if (fx == 0)                         // h, or its average with G
              out[i] = fy == 2 ? h : avg(g[(i + (fy >> 1)) * ws], h);
            else                                 // diagonal: average of b, h
              out[i] = avg(half_h(g + (i + (fy >> 1)) * ws), h);
          }
        }
      } else {
        int hs[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          const uint8_t* q = wp + i * ws + c;
          hs[i] = tap6(q[0], q[1], q[2], q[3], q[4], q[5]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = clip8((tap6(hs[i], hs[i + 1], hs[i + 2], hs[i + 3],
                                    hs[i + 4], hs[i + 5]) + 512) >> 10);
          const int b = fy == 1 ? hs[i + 2] : hs[i + 3];
          out[i] = fy == 2 ? j : avg(j, clip8((b + 16) >> 5));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s_out[(by * 4 + i) * 16 + bx * 4 + c] = (uint8_t)out[i];
  }

  // ---- chroma: lane `half` -> plane `half`, the block's 2x2 pels --------
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cy = k >> 1, cx = k & 1;
    int v = 0;
    if (active) {
      const uint8_t* q = cp + half * cplane + cy * cs + cx;
      v = (8 - dx) * (8 - dy) * q[0];
      if (dx) v += dx * (8 - dy) * q[1];
      if (dy) v += (8 - dx) * dy * q[cs];
      if (dx && dy) v += dx * dy * q[cs + 1];
      v = (v + 32) >> 6;
    }
    s_out[256 + (by * 2 + cy) * 16 + (bx * 2 + cx) * 2 + half] = (uint8_t)v;
  }
  __syncwarp();
  if (t < 24)
    (t < 16 ? out_y + t : out_c + (t - 16))[0] =
        reinterpret_cast<const uint4*>(s_out)[t];
}

}  // namespace

// K1's launch shape for n MBs (also for whoever times its launch floor).
extern "C" int bw_mc_ctas(int n) { return n <= 0 ? 0 : (n + MBS - 1) / MBS; }

extern "C" int bw_mc_threads(void) { return THREADS; }

extern "C" int bw_mc_predict(const uint8_t* ref_y, const uint8_t* ref_c,
                             const int32_t* mv, const int32_t* ref_blk,
                             uint8_t* pred_y, uint8_t* pred_c, int n,
                             int w_mbs, int h_mbs, int R, void* stream) {
  if (n <= 0) return 0;
  mc_kernel<<<bw_mc_ctas(n), THREADS, 0, (cudaStream_t)stream>>>(
      ref_y, ref_c, mv, ref_blk, pred_y, pred_c, n, w_mbs, h_mbs, R);
  return (int)cudaGetLastError();
}
