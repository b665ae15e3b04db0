// K3: the in-loop deblocking filter over raster planes as one persistent
// wavefront launch per picture (Hopper).
//
// Replaces the Pallas TPU kernel broadway_tpu/ops/tpu/wavefront_pallas.py
// (_db_kernel with _luma_edge / _chroma_edge, launched by
// deblock_wavefront). The TPU kernel streams a diagonal-major packed
// picture through a 4-deep VMEM ring and filters vertical edges in a
// transposed space made by one-hot MXU matmuls.
//
// Here the planes stay raster uint8 and are filtered in place by ONE
// launch: a CTA of 128 threads per MB row, rows ordered by the progress
// counters of wavefront.cuh. The left MB edge rewrites columns 13-15 of the
// left neighbour (the CTA's own previous step) and the top edge rows 13-15
// of the upper neighbour, which the upper-right MB's left edge has touched
// too: hence the wait for progress[y-1] >= min(x + 2, w), taken only by an
// MB whose top edge has a non-zero bS. An MB whose 32 bS are all 0 is never
// visited: the CTA scans its row's params once (todo[x]) and publishes a
// run of such MBs in one step.
//
// Inside an MB the pels live in shared memory: a 20x20 luma tile (the MB
// plus 4 columns of the left and 4 rows of the upper neighbour) and a 12x12
// tile per chroma plane, moved as 32-bit words through L2. The MB's own
// pels, which nothing changes before the MB itself, are fetched one busy MB
// ahead into registers together with its 64 params; the left neighbour's
// columns are carried over in shared memory when it was the CTA's previous
// MB (two sets of tiles used in turn); the upper neighbour's rows are
// fetched one MB ahead too whenever the last poll of the counter showed the
// row above far enough along, and only otherwise after a wait. Warp
// 0 filters luma: a thread takes one line of the MB through the 4 vertical
// edges left to right in registers, then, after a __syncwarp(), one column
// through the 4 horizontal edges top to bottom (the raster-equivalent
// order: lines do not meet at vertical edges, nor columns at horizontal
// ones), while warp 1 does the same for cb and cr (8 lines each, chroma
// edges 0 and 2 each way with the luma bS) beside it.
//
// bS and alpha/beta/tc0 come precomputed per MB (ops/gpu/deblock.py
// deblock_params, P [n, 64] int32), as on the TPU.
//
// What bounds it: the dependent hand-offs between rows (the probe in
// wavefront.cu measures one) and the serial edge chain inside an MB; the
// bytes are few (about 8 MB per 1080p picture).

#include "wavefront.cuh"

namespace {

constexpr int P_BS_V = 0, P_BS_H = 16, P_THR_LUMA = 32, P_THR_CHROMA = 47;
constexpr int THR_INNER = 0, THR_TOP = 5, THR_LEFT = 10;
constexpr int NP = 64;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int absi(int v) { return v < 0 ? -v : v; }

// One luma line across an edge, in registers: v[0..3] = p3..p0, v[4..7] =
// q0..q3, filtered in place (values stay 0..255).
__device__ __forceinline__ void luma_line(int* v, int bs, const int* thr) {
  const int alpha = thr[0], beta = thr[1];
  const int p3 = v[0], p2 = v[1], p1 = v[2], p0 = v[3], q0 = v[4], q1 = v[5],
            q2 = v[6], q3 = v[7];
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
    if (ap) v[2] = (p1 + clampi((p2 + half - p1 * 2) >> 1, -tc0, tc0)) & 255;
    if (aq) v[5] = (q1 + clampi((q2 + half - q1 * 2) >> 1, -tc0, tc0)) & 255;
    v[3] = clampi(p0 + delta, 0, 255);
    v[4] = clampi(q0 - delta, 0, 255);
  } else {
    const bool strong = absi(p0 - q0) < ((alpha >> 2) + 2);
    const int tp = p1 + p0 + q0, tq = p0 + q0 + q1;
    if (strong && ap) {
      v[3] = (p2 + 2 * tp + q1 + 4) >> 3;
      v[2] = (p2 + tp + 2) >> 2;
      v[1] = (2 * p3 + 3 * p2 + tp + 4) >> 3;
    } else {
      v[3] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (strong && aq) {
      v[4] = (p1 + 2 * tq + q2 + 4) >> 3;
      v[5] = (tq + q2 + 2) >> 2;
      v[6] = (2 * q3 + 3 * q2 + tq + 4) >> 3;
    } else {
      v[4] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
  }
}

// One chroma line across an edge: v[0..1] = p1, p0, v[2..3] = q0, q1.
__device__ __forceinline__ void chroma_line(int* v, int bs, const int* thr) {
  const int alpha = thr[0], beta = thr[1];
  const int p1 = v[0], p0 = v[1], q0 = v[2], q1 = v[3];
  if (!(absi(p0 - q0) < alpha && absi(p1 - p0) < beta &&
        absi(q1 - q0) < beta))
    return;
  if (bs < 4) {
    const int tc = thr[2 + bs - 1] + 1;
    const int delta =
        clampi(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc);
    v[1] = clampi(p0 + delta, 0, 255);
    v[2] = clampi(q0 - delta, 0, 255);
  } else {
    v[1] = (2 * p1 + p0 + q1 + 2) >> 2;
    v[2] = (2 * q1 + q0 + p1 + 2) >> 2;
  }
}

// The 4 luma edges that cross one line of 20 pels (the neighbour's 4 first),
// left to right, in registers: edge e lies before pel 4 + 4e.
__device__ __forceinline__ void luma_edges(int* px, const int* p, int bs0,
                                           int lane4, int outer) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int bs = p[bs0 + 4 * e + lane4];
    if (bs > 0)
      luma_line(px + 4 * e, bs, p + P_THR_LUMA + (e == 0 ? outer : THR_INNER));
  }
}

// The 2 chroma edges that cross one line of 12 pels (the neighbour's 4
// first): chroma edge k (luma edge 2k) lies before pel 4 + 4k.
__device__ __forceinline__ void chroma_edges(int* cx, const int* p, int bs0,
                                             int lane2, int outer) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int bs = p[bs0 + 8 * k + lane2];
    if (bs > 0)
      chroma_line(cx + 2 + 4 * k, bs,
                  p + P_THR_CHROMA + (k == 0 ? outer : THR_INNER));
  }
}

constexpr int THREADS = 128;
constexpr int YP = 20, CP = 12;        // tile pitches (bytes)
constexpr int YW = YP / 4, CW = CP / 4;  // ... in 32-bit words
constexpr int Y_WORDS = 20 * YW, C_WORDS = 12 * CW;

__device__ __forceinline__ unsigned ld_word(const uint8_t* p) {
  return __ldcg(reinterpret_cast<const unsigned*>(p));
}

__device__ __forceinline__ void st_word(uint8_t* p, unsigned v) {
  __stcg(reinterpret_cast<unsigned*>(p), v);
}

// The own-tile word of thread t: t < 64 luma (16 rows x 4 words), 64..95
// chroma (2 planes x 8 rows x 2 words). Returns the word's address in the
// planes of MB (mx, my) and its word index in the luma tile (plane -1) or
// in chroma tile `plane`.
struct OwnWord {
  uint8_t* g;
  int plane, idx;
};

__device__ __forceinline__ OwnWord own_word(uint8_t* Y, uint8_t* C, int t,
                                            int mx, int my, int W, int Wc,
                                            int Hc) {
  OwnWord o;
  if (t < 64) {
    const int r = t >> 2, c = t & 3;
    o.g = Y + (size_t)(16 * my + r) * W + 16 * mx + 4 * c;
    o.plane = -1;
    o.idx = (4 + r) * YW + 1 + c;
  } else {
    const int u = t - 64, k = u & 15, r = k >> 1, c = k & 1;
    o.plane = u >> 4;
    o.g = C + (size_t)o.plane * Hc * Wc + (size_t)(8 * my + r) * Wc +
          8 * mx + 4 * c;
    o.idx = (4 + r) * CW + 1 + c;
  }
  return o;
}

// The upper-neighbour word of thread t < 32: t < 16 luma (rows 12-15 x 4
// words), 16..31 chroma (2 planes x rows 4-7 x 2 words); as own_word.
__device__ __forceinline__ OwnWord up_word(uint8_t* Y, uint8_t* C, int t,
                                           int mx, int my, int W, int Wc,
                                           int Hc) {
  OwnWord o;
  if (t < 16) {
    const int r = t >> 2, c = t & 3;
    o.g = Y + (size_t)(16 * my - 4 + r) * W + 16 * mx + 4 * c;
    o.plane = -1;
    o.idx = r * YW + 1 + c;
  } else {
    const int u = t - 16, r = (u & 7) >> 1, c = u & 1;
    o.plane = u >> 3;
    o.g = C + (size_t)o.plane * Hc * Wc + (size_t)(8 * my - 4 + r) * Wc +
          8 * mx + 4 * c;
    o.idx = r * CW + 1 + c;
  }
  return o;
}

__global__ void __launch_bounds__(THREADS)
deblock_rows_kernel(uint8_t* Y, uint8_t* C, const int32_t* __restrict__ Pm,
                    int* progress, int w_mbs, int h_mbs) {
  extern __shared__ uint8_t todo[];      // [w_mbs]
  __shared__ int p[NP];
  __shared__ int s_seen;                 // thread 0's newest read of the
                                         // counter of the row above
  // two sets of tiles, used in turn: the next MB takes its left columns
  // from the set its left neighbour has just been filtered in
  __shared__ __align__(16) unsigned yt[2][Y_WORDS];
  __shared__ __align__(16) unsigned ct[2][2][C_WORDS];

  const int t = threadIdx.x;
  const int W = 16 * w_mbs, Wc = 8 * w_mbs, Hc = 8 * h_mbs;
  int buf = 0;

  for (int my = blockIdx.x; my < h_mbs; my += gridDim.x) {
    // ---- scan the row: MBs with any bS, and those with a top-edge bS ---
    __syncthreads();
    if (t == 0) s_seen = 0;
    for (int x = t; x < w_mbs; x += THREADS) {
      const int4* q =
          reinterpret_cast<const int4*>(Pm + (size_t)(my * w_mbs + x) * NP);
      int any = 0, top = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int4 v = q[k];
        const int o = v.x | v.y | v.z | v.w;
        any |= o;
        if (k == P_BS_H / 4) top = o;
      }
      todo[x] = any ? (1 | ((top && my > 0) ? 2 : 0)) : 0;
    }
    __syncthreads();

    int pub = 0, seen = 0, last_mx = -2;
    int nx = bwwf::next_todo(todo, 0, w_mbs);
    // the next busy MB's params and its own pels (which nothing changes
    // before the MB itself), fetched one MB ahead
    int pre_p = 0;
    unsigned pre_w = 0, pre_u = 0;
    bool up_ready = false;   // pre_u holds this MB's upper rows already
    if (nx < w_mbs) {
      if (t < NP) pre_p = Pm[((size_t)my * w_mbs + nx) * NP + t];
      if (t < 96) pre_w = ld_word(own_word(Y, C, t, nx, my, W, Wc, Hc).g);
    }
    while (true) {
      if (nx > pub) {
        bwwf::publish(progress, my, nx);
        pub = nx;
      }
      if (nx >= w_mbs) break;
      const int mx = nx;
      const bool has_up = (todo[mx] & 2) != 0, has_left = mx > 0;
      uint8_t* const ytb = reinterpret_cast<uint8_t*>(yt[buf]);
      uint8_t* const y_org = Y + (size_t)(16 * my - 4) * W + 16 * mx - 4;

      // ---- this MB's operands into shared memory ------------------------
      if (t < NP) p[t] = pre_p;
      if (t < 96) {
        const OwnWord o = own_word(Y, C, t, mx, my, W, Wc, Hc);
        (o.plane < 0 ? yt[buf] : ct[buf][o.plane])[o.idx] = pre_w;
      } else {
        // the left neighbour's columns 12-15 (chroma 4-7): from the tiles
        // it was filtered in when it was this CTA's previous MB, else from
        // the planes (no other CTA writes them before this MB is final)
        const bool carry = last_mx == mx - 1;
        if (t < 112) {
          const int j = t - 96;
          yt[buf][(4 + j) * YW] =
              carry ? yt[buf ^ 1][(4 + j) * YW + 4]
                    : (has_left ? ld_word(y_org + (ptrdiff_t)(4 + j) * W)
                                : 0u);
        } else {
          const int u = t - 112, plane = u >> 3, j = u & 7;
          ct[buf][plane][(4 + j) * CW] =
              carry ? ct[buf ^ 1][plane][(4 + j) * CW + 2]
                    : (has_left
                           ? ld_word(C + (size_t)plane * Hc * Wc +
                                     (size_t)(8 * my + j) * Wc + 8 * mx - 4)
                           : 0u);
        }
      }
      nx = bwwf::next_todo(todo, mx + 1, w_mbs);
      if (nx < w_mbs) {
        if (t < NP) pre_p = Pm[((size_t)my * w_mbs + nx) * NP + t];
        if (t < 96) pre_w = ld_word(own_word(Y, C, t, nx, my, W, Wc, Hc).g);
      }
      // rows 12-15 of the upper neighbour (chroma 4-7): fetched ahead when
      // the row above was known to be far enough, else after the wait
      if (has_up) {
        if (!up_ready) {
          bwwf::wait_row(progress, my - 1, mx + 2 < w_mbs ? mx + 2 : w_mbs,
                         seen);
          if (t == 0) s_seen = seen;
          __syncthreads();
        }
        if (t < 32) {
          const OwnWord o = up_word(Y, C, t, mx, my, W, Wc, Hc);
          (o.plane < 0 ? yt[buf] : ct[buf][o.plane])[o.idx] =
              up_ready ? pre_u : ld_word(o.g);
        }
      }
      __syncthreads();
      up_ready = nx < w_mbs && (todo[nx] & 2) &&
                 s_seen >= (nx + 2 < w_mbs ? nx + 2 : w_mbs);
      if (up_ready && t < 32)
        pre_u = ld_word(up_word(Y, C, t, nx, my, W, Wc, Hc).g);

      // ---- filter: warp 0 luma, warp 1 both chroma planes. A thread
      // takes one line through all the vertical edges in registers, then
      // one column through all the horizontal ones -------------------------
      if (t < 32) {
        int px[20];
        if (t < 16) {                // line t of the MB: tile row 4 + t
          unsigned* rw = yt[buf] + (4 + t) * YW;
#pragma unroll
          for (int c = 0; c < 5; ++c) {
            const unsigned wd = rw[c];
#pragma unroll
            for (int k = 0; k < 4; ++k) px[4 * c + k] = (wd >> (8 * k)) & 255;
          }
          luma_edges(px, p, P_BS_V, t >> 2, THR_LEFT);
#pragma unroll
          for (int c = 0; c < 5; ++c)
            rw[c] = px[4 * c] | (px[4 * c + 1] << 8) | (px[4 * c + 2] << 16) |
                    (px[4 * c + 3] << 24);
        }
        __syncwarp();
        if (t < 16) {                // column t of the MB: tile column 4 + t
          uint8_t* col = ytb + 4 + t;
#pragma unroll
          for (int r = 0; r < 20; ++r) px[r] = col[r * YP];
          luma_edges(px, p, P_BS_H, t >> 2, THR_TOP);
#pragma unroll
          for (int r = 1; r < 20; ++r) col[r * YP] = (uint8_t)px[r];
        }
      } else if (t < 64) {
        const int u = t - 32, plane = (u >> 3) & 1, i = u & 7;
        uint8_t* tile = reinterpret_cast<uint8_t*>(ct[buf][plane]);
        int cx[12];
        if (t < 48) {                // line i: tile row 4 + i
          unsigned* rw = ct[buf][plane] + (4 + i) * CW;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const unsigned wd = rw[c];
#pragma unroll
            for (int k = 0; k < 4; ++k) cx[4 * c + k] = (wd >> (8 * k)) & 255;
          }
          chroma_edges(cx, p, P_BS_V, i >> 1, THR_LEFT);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            rw[c] = cx[4 * c] | (cx[4 * c + 1] << 8) | (cx[4 * c + 2] << 16) |
                    (cx[4 * c + 3] << 24);
        }
        __syncwarp();
        if (t < 48) {                // column i: tile column 4 + i
          uint8_t* col = tile + 4 + i;
#pragma unroll
          for (int r = 0; r < 12; ++r) cx[r] = col[r * CP];
          chroma_edges(cx, p, P_BS_H, i >> 1, THR_TOP);
#pragma unroll
          for (int r = 3; r < 12; ++r) col[r * CP] = (uint8_t)cx[r];
        }
      }
      __syncthreads();

      // ---- store what the filter may have changed -----------------------
      if (t < 96) {
        const OwnWord o = own_word(Y, C, t, mx, my, W, Wc, Hc);
        st_word(o.g, (o.plane < 0 ? yt[buf] : ct[buf][o.plane])[o.idx]);
      } else if (has_left) {
        if (t < 112) {
          const int j = t - 96;
          st_word(y_org + (ptrdiff_t)(4 + j) * W, yt[buf][(4 + j) * YW]);
        } else {
          const int u = t - 112, plane = u >> 3, j = u & 7;
          st_word(C + (size_t)plane * Hc * Wc + (size_t)(8 * my + j) * Wc +
                      8 * mx - 4,
                  ct[buf][plane][(4 + j) * CW]);
        }
      }
      if (has_up) {
        // luma changes at most 3 pels each side of an edge (rows 13-15 of
        // the upper MB), chroma one (its row 7)
        if (t < 12) {
          const int r = 1 + t / 4, c = 1 + (t & 3);
          st_word(y_org + (ptrdiff_t)r * W + 4 * c, yt[buf][r * YW + c]);
        } else if (t >= 16 && t < 20) {
          const int u = t - 16, plane = u >> 1, c = 1 + (u & 1);
          st_word(C + (size_t)plane * Hc * Wc +
                      (size_t)(8 * my - 1) * Wc + 8 * mx - 4 + 4 * c,
                  ct[buf][plane][3 * CW + c]);
        }
      }
      last_mx = mx;
      buf ^= 1;
      // the loop's next turn publishes this MB (after a __syncthreads)
    }
  }
}

}  // namespace

extern "C" int bw_deblock_wavefront(uint8_t* Y, uint8_t* C, const int32_t* P,
                                    int* progress, int w_mbs, int h_mbs,
                                    void* stream) {
  void* args[] = {&Y, &C, &P, &progress, &w_mbs, &h_mbs};
  const size_t smem = (size_t)((w_mbs + 15) & ~15);
  return (int)bwwf::launch_rows(bwwf::DEBLOCK,
                                (const void*)deblock_rows_kernel, THREADS,
                                smem, progress, h_mbs, args,
                                (cudaStream_t)stream);
}
