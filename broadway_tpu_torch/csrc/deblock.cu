// K3: the in-loop deblocking filter over raster planes as one persistent
// wavefront launch per picture, or per batch of pictures of one geometry,
// in thread-block clusters (Hopper).
//
// Replaces the Pallas TPU kernel broadway_tpu/ops/tpu/wavefront_pallas.py
// (_db_kernel with _luma_edge / _chroma_edge, launched by
// deblock_wavefront). The TPU kernel streams a diagonal-major packed
// picture through a 4-deep VMEM ring and filters vertical edges in a
// transposed space made by one-hot MXU matmuls.
//
// Here the planes stay raster uint8 and are filtered in place by ONE
// launch: a CTA of 128 compute threads (and the scaffold's publisher warp)
// per MB row, consecutive rows in clusters of 8 (wavefront.cuh). The left
// MB edge rewrites columns 13-15 of the left neighbour (the CTA's own
// previous step) and the top edge rows 13-15 of the upper neighbour, which
// the upper-right MB's left edge has touched too: an MB whose top edge has
// a non-zero bS needs the upper row past MB x + 1. An MB whose 32 bS are
// all 0 is never visited: the CTA scans its row's params once (flags[x])
// and passes a run of such MBs in one step.
//
// The upper neighbour's rows 12-15 (chroma 4-7), final once the row above
// has filtered MB x + 1, reach the lower row in one of three ways:
// - inside a cluster, when the upper CTA filters MB x or MB x + 1, it
//   PUSHES them (32 words, 128 bytes) into slot x of the lower CTA's ring
//   (st.async onto the lower CTA's mbarrier): right after MB x + 1's
//   VERTICAL pass, the last to change MB x (its horizontal pass stays
//   inside MB x + 1), by the lanes 16-31 of warps 0 (luma) and 1 (chroma)
//   that the passes leave idle, so the lower row starts while the upper
//   one filters MB x + 1's horizontal edges; or at the next step if MB
//   x + 1 is idle. The lower MB's vertical pass does not read the row
//   above either: its two filter warps wait on their own mbarrier (thread
//   0 posts the bytes it expects) only between their vertical and
//   horizontal passes.
//   The upper CTA then leaves rows 13-15 (chroma 7) of MB x to the lower
//   CTA, which writes them after its top edge, so no byte has two writers
//   and no fence orders them;
// - inside a cluster, when the upper CTA visits neither MB x nor x + 1,
//   nobody has changed those rows: the lower CTA reads them from the
//   planes one MB ahead, without waiting;
// - across clusters (rank 0), after the counter of the row above covers
//   x + 2 (published by the publisher warp of rank 7, which alone pays the
//   gpu-scope fence), from L2, one MB ahead when the last poll showed the
//   row far enough along.
// Both CTAs decide which slots travel with the same predicate on the two
// rows' params (F_DOWN above, F_SLOT below).
//
// Inside an MB the pels live in shared memory: a 20x20 luma tile (the MB
// plus 4 columns of the left and 4 rows of the upper neighbour) and a 12x12
// tile per chroma plane, moved as 32-bit words. The MB's own pels, which
// nothing changes before the MB itself, are fetched one busy MB ahead into
// registers together with its 64 params; the left neighbour's columns are
// carried over in shared memory when it was the CTA's previous MB (two sets
// of tiles used in turn). Warp 0 filters luma: a thread takes one line of
// the MB through the 4 vertical edges left to right in registers, then,
// after a __syncwarp(), one column through the 4 horizontal edges top to
// bottom (the raster-equivalent order: lines do not meet at vertical edges,
// nor columns at horizontal ones), while warp 1 does the same for cb and cr
// (8 lines each, chroma edges 0 and 2 each way with the luma bS) beside it.
//
// bS and alpha/beta/tc0 come precomputed per MB (ops/gpu/deblock.py
// deblock_params, P [n, 64] int32), as on the TPU.
//
// A batch (Y [B, H, W], C [B, 2, H/2, W/2], P [B * n, 64]): row r of the
// launch is picture r / h_mbs, row r % h_mbs; every address below is taken
// from that picture's base, the top row of each picture waits for nothing
// and touches no row above it, and a picture whose skip[b] is not 0
// (wholly concealed: not deblocked) has all its rows idle.
//
// What bounds it (clock64() split of the counter design, one CTA a row
// and gpu-scope counters, on the 1080p IDR; tools/wavefront_designs.py,
// NVIDIA H100 80GB HBM3, 700 W, cycles a busy MB): the two luma passes
// (1689 + 1608), then the gpu-scope fence of every hand-off (1335, on the
// next barrier's path), the upper rows' L2 load after the wait (987 with
// its barrier), staging and stores (374 + 354). The clusters take the
// fence off every MB (the publisher warp carries it beside rank 7) and
// the L2 round trip off the chain for 7 rows in 8, and the row below
// starts after the upper row's vertical pass and waits only before its
// own horizontal one: 0.84 -> 0.60 ms on that IDR, 0.58 -> 0.39 ms on the
// P picture, behind a held stream (tools/wavefront_designs.py kernels,
// both designs in one call). What bounds it now is the edge chain of a
// line (4 dependent edges each way: the two luma passes take ~3300 of an
// MB's ~4700 cycles) and the x + 2 lag between rows; the bytes are few
// (about 8 MB per 1080p picture). 3 CTAs an SM (128 registers).

#include "wavefront.cuh"

namespace {

constexpr int P_BS_V = 0, P_BS_H = 16, P_THR_LUMA = 32, P_THR_CHROMA = 47;
constexpr int THR_INNER = 0, THR_TOP = 5, THR_LEFT = 10;
constexpr int NP = 64;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int absi(int v) { return v < 0 ? -v : v; }

// One edge's thresholds (alpha, beta, tc0 for bS 1..3), in registers: a
// thread loads the ones its line needs before the edge chain starts, so
// no shared-memory load sits between two dependent edges.
struct Thr {
  int alpha, beta, tc1, tc2, tc3;
};

__device__ __forceinline__ Thr thr_at(const int* p, int off) {
  return {p[off], p[off + 1], p[off + 2], p[off + 3], p[off + 4]};
}

__device__ __forceinline__ int tc0_of(const Thr& T, int bs) {
  return bs == 1 ? T.tc1 : (bs == 2 ? T.tc2 : T.tc3);
}

// One luma line across an edge, in registers: v[0..3] = p3..p0, v[4..7] =
// q0..q3, filtered in place (values stay 0..255).
__device__ __forceinline__ void luma_line(int* v, int bs, const Thr& T) {
  const int alpha = T.alpha, beta = T.beta;
  const int p3 = v[0], p2 = v[1], p1 = v[2], p0 = v[3], q0 = v[4], q1 = v[5],
            q2 = v[6], q3 = v[7];
  if (!(absi(p0 - q0) < alpha && absi(p1 - p0) < beta &&
        absi(q1 - q0) < beta))
    return;
  const bool ap = absi(p2 - p0) < beta, aq = absi(q2 - q0) < beta;
  if (bs < 4) {
    const int tc0 = tc0_of(T, bs);
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
__device__ __forceinline__ void chroma_line(int* v, int bs, const Thr& T) {
  const int alpha = T.alpha, beta = T.beta;
  const int p1 = v[0], p0 = v[1], q0 = v[2], q1 = v[3];
  if (!(absi(p0 - q0) < alpha && absi(p1 - p0) < beta &&
        absi(q1 - q0) < beta))
    return;
  if (bs < 4) {
    const int tc = tc0_of(T, bs) + 1;
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
// left to right, in registers: edge e lies before pel 4 + 4e, with bS
// bs[e] and the MB edge's thresholds (e = 0) or the inner ones.
__device__ __forceinline__ void luma_edges(int* px, const int* bs,
                                           const Thr& outer,
                                           const Thr& inner) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (bs[e] > 0) luma_line(px + 4 * e, bs[e], e == 0 ? outer : inner);
}

// The 2 chroma edges that cross one line of 12 pels (the neighbour's 4
// first): chroma edge k (luma edge 2k) lies before pel 4 + 4k.
__device__ __forceinline__ void chroma_edges(int* cx, const int* bs,
                                             const Thr& outer,
                                             const Thr& inner) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (bs[k] > 0) chroma_line(cx + 2 + 4 * k, bs[k], k == 0 ? outer : inner);
}

constexpr int NT = 128;                 // compute threads
constexpr int THREADS = NT + 32;        // and the publisher warp
constexpr int SLOT = 128;               // a delivery: 32 words
constexpr int YP = 20, CP = 12;         // tile pitches (bytes)
constexpr int YW = YP / 4, CW = CP / 4;  // ... in 32-bit words
constexpr int Y_WORDS = 20 * YW, C_WORDS = 12 * CW;
// flags[x]: MB x has a non-zero bS; its top edge has one (it needs the
// row above); the row below takes slot x from this CTA; this MB takes slot
// x from the CTA above
constexpr int F_BUSY = 1, F_UP = 2, F_DOWN = 4, F_SLOT = 8;
// the scan's first pass: MB x of the row above has a non-zero bS
constexpr int U_BUSY = 16;

__device__ __forceinline__ unsigned ld_word(const uint8_t* p) {
  return __ldcg(reinterpret_cast<const unsigned*>(p));
}

__device__ __forceinline__ void st_word(uint8_t* p, unsigned v) {
  __stcg(reinterpret_cast<unsigned*>(p), v);
}

// The bS of MB `mb` (its params' first half): whether any is non-zero,
// and whether one of the top edge's is.
struct BsAny {
  bool any, top;
};

__device__ __forceinline__ BsAny bs_any(const int32_t* Pm, size_t mb) {
  const int4* q = reinterpret_cast<const int4*>(Pm + mb * NP);
  int any = 0, top = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int4 v = q[k];
    const int o = v.x | v.y | v.z | v.w;
    any |= o;
    if (k == P_BS_H / 4) top = o;
  }
  return {any != 0, top != 0};
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

// Word t < 32 of MB (mx, my)'s bottom rows, as a slot holds them: t < 16
// luma (rows 12-15 x 4 words), 16..31 chroma (2 planes x rows 4-7 x 2
// words). g: its address in the planes; idx: its word index in the lower
// MB's tile (rows 0-3), or, with `own` set, in this MB's own tile (rows
// 16-19 luma, 8-11 chroma).
__device__ __forceinline__ OwnWord bottom_word(uint8_t* Y, uint8_t* C, int t,
                                               int mx, int my, int W, int Wc,
                                               int Hc, bool own) {
  OwnWord o;
  if (t < 16) {
    const int r = t >> 2, c = t & 3;
    o.g = Y + (size_t)(16 * my + 12 + r) * W + 16 * mx + 4 * c;
    o.plane = -1;
    o.idx = (own ? 16 + r : r) * YW + 1 + c;
  } else {
    const int u = t - 16, r = (u & 7) >> 1, c = u & 1;
    o.plane = u >> 3;
    o.g = C + (size_t)o.plane * Hc * Wc + (size_t)(8 * my + 4 + r) * Wc +
          8 * mx + 4 * c;
    o.idx = (own ? 8 + r : r) * CW + 1 + c;
  }
  return o;
}

__global__ void __launch_bounds__(THREADS, 3)
deblock_rows_kernel(uint8_t* Y0, uint8_t* C0,
                    const int32_t* __restrict__ Pm0, int* progress,
                    const int32_t* __restrict__ skip, int w_mbs, int h_mbs,
                    int batch) {
  extern __shared__ __align__(16) uint8_t dyn[];  // flags, ring (Wave)
  __shared__ int p[NP];
  __shared__ int s_seen;     // thread 0's newest read of the counter above
  __shared__ int s_done, s_stored;
  // two sets of tiles, used in turn: the next MB takes its left columns
  // from the set its left neighbour has just been filtered in
  __shared__ __align__(16) unsigned yt[2][Y_WORDS];
  __shared__ __align__(16) unsigned ct[2][2][C_WORDS];

  const int t = threadIdx.x;
  // the word of a left neighbour's slot this thread hands on (lanes 16-31
  // of warp 0: luma, of warp 1: chroma), or -1
  const int dk = (t >= 16 && t < 32) ? t - 16 : ((t >= 48 && t < 64) ? t - 32
                                                                    : -1);
  // the word of the upper neighbour's rows this thread brings into the
  // tile (lanes 0-15 of warp 0: luma, of warp 1: chroma), or -1
  const int uk = t < 16 ? t : ((t >= 32 && t < 48) ? t - 16 : -1);
  const int W = 16 * w_mbs, Wc = 8 * w_mbs, Hc = 8 * h_mbs;
  const size_t n_mbs = (size_t)w_mbs * h_mbs;
  bwwf::Wave wv;
  wv.start(dyn, &s_done, w_mbs, batch * h_mbs, SLOT);
  uint8_t* const flags = wv.flags;
  int buf = 0;

  for (int it = 0;; ++it) {
    const int row = wv.row_at(it);
    if (row < 0) break;
    // this row's picture: its planes, params and counters
    const bwwf::BatchRow br = bwwf::batch_row(row, h_mbs);
    const int my = br.my;
    uint8_t* const Y = Y0 + (size_t)br.b * n_mbs * 256;
    uint8_t* const C = C0 + (size_t)br.b * n_mbs * 128;
    const int32_t* const Pm = Pm0 + (size_t)br.b * n_mbs * NP;
    const bool skipped = skip != nullptr && skip[br.b] != 0;
    const bool up_ring = wv.up_in_cluster(my);
    const bool up_global = my > 0 && !up_ring;
    const bool down = wv.down_in_cluster(row, h_mbs);
    const bool pub = wv.publishes(row);
    if (down) wv.wait_ring_free();
    // ---- scan the row (and the neighbour rows' bS that decide the ring)
    __syncthreads();
    if (t == 0) {
      s_seen = 0;
      s_stored = 0;
    }
    // first pass: one round of loads a MB (its row, and the rows above
    // and below where the ring joins them)
    uint8_t* const own = wv.scan;
    uint8_t* const low = wv.scan + w_mbs;
    for (int x = t; x < w_mbs; x += THREADS) {
      int f = 0, lo = 0;
      if (!skipped) {
        const size_t mb = (size_t)my * w_mbs + x;
        const BsAny me = bs_any(Pm, mb);
        const BsAny up = bs_any(Pm, up_ring ? mb - w_mbs : mb);
        const int4 v = reinterpret_cast<const int4*>(
            Pm + (down ? mb + w_mbs : mb) * NP)[P_BS_H / 4];
        f = (me.any ? F_BUSY : 0) | (me.top && my > 0 ? F_UP : 0) |
            (up_ring && up.any ? U_BUSY : 0);
        lo = down && (v.x | v.y | v.z | v.w) != 0;
      }
      own[x] = (uint8_t)f;
      low[x] = (uint8_t)lo;
    }
    __syncthreads();
    // second pass: which slots travel (the same predicate for the CTA
    // above, F_DOWN, and the CTA below, F_SLOT): the lower MB's top edge
    // filters, and the upper CTA visits MB x or MB x + 1
    for (int x = t; x < w_mbs; x += THREADS) {
      const int b = own[x], br = x + 1 < w_mbs ? own[x + 1] : 0;
      int f = b & (F_BUSY | F_UP);
      if (low[x] && ((b | br) & F_BUSY)) f |= F_DOWN;
      if ((b & F_UP) && ((b | br) & U_BUSY)) f |= F_SLOT;
      flags[x] = (uint8_t)f;
    }
    __syncthreads();

    if (t >= NT) {
      if (t == NT && pub) bwwf::publisher(progress + row, w_mbs, &s_stored);
    } else {
      int pub_x = 0, seen = 0, last_mx = -2;
      int nx = bwwf::next_flag(flags, 0, w_mbs, F_BUSY);
      // the next busy MB's params and its own pels (which nothing changes
      // before the MB itself), fetched one MB ahead
      int pre_p = 0;
      unsigned pre_w = 0, pre_u = 0, pre_d = 0;
      bool up_ready = false;   // pre_u holds this MB's upper rows already
      if (nx < w_mbs) {
        if (t < NP) pre_p = Pm[((size_t)my * w_mbs + nx) * NP + t];
        if (t < 96) pre_w = ld_word(own_word(Y, C, t, nx, my, W, Wc, Hc).g);
        up_ready = up_ring && (flags[nx] & (F_UP | F_SLOT)) == F_UP;
        if (up_ready && uk >= 0)
          pre_u = ld_word(bottom_word(Y, C, uk, nx, my - 1, W, Wc, Hc,
                                      false).g);
      }
      while (true) {
        bwwf::csync<NT>();
        // MB last_mx is final once MB last_mx + 1 is idle (or there is
        // none): its bottom rows go to the row below now
        if (last_mx >= 0 && (flags[last_mx] & F_DOWN) &&
            (last_mx == w_mbs - 1 || !(flags[last_mx + 1] & F_BUSY)) &&
            t < 32) {
          const OwnWord o = bottom_word(Y, C, t, last_mx, my, W, Wc, Hc,
                                        true);
          wv.push(last_mx, t,
                  (o.plane < 0 ? yt[buf ^ 1] : ct[buf ^ 1][o.plane])[o.idx]);
        }
        if (nx > pub_x) {
          if (pub && t == 0) bwwf::st_release_cta(&s_stored, nx);
          pub_x = nx;
        }
        if (nx >= w_mbs) break;
        const int mx = nx;
        const int f = flags[mx];
        const bool has_up = (f & F_UP) != 0, has_left = mx > 0;
        const bool left_down = has_left && (flags[mx - 1] & F_DOWN);
        // word dk of the left neighbour's slot, final after this MB's
        // vertical pass: its columns 12-15 (chroma 4-7) from this MB's
        // tile, the rest from its own tile (when this CTA filtered it) or
        // from the planes (prefetched: nobody changed them)
        auto left_bottom = [&](int k) -> unsigned {
          const OwnWord o = bottom_word(Y, C, k, mx - 1, my, W, Wc, Hc, true);
          if (o.plane < 0)
            return (o.idx % YW == 4) ? yt[buf][o.idx - 4]
                   : (last_mx == mx - 1 ? yt[buf ^ 1][o.idx] : pre_d);
          return (o.idx % CW == 2) ? ct[buf][o.plane][o.idx - 2]
                 : (last_mx == mx - 1 ? ct[buf ^ 1][o.plane][o.idx] : pre_d);
        };
        uint8_t* const ytb = reinterpret_cast<uint8_t*>(yt[buf]);
        uint8_t* const y_org = Y + (size_t)(16 * my - 4) * W + 16 * mx - 4;

        // ---- this MB's operands into shared memory ----------------------
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
        // an idle left neighbour whose bottom rows the row below takes:
        // its unchanged words, sent with this MB's left column after the
        // filter
        if (left_down && last_mx != mx - 1 && dk >= 0)
          pre_d = ld_word(bottom_word(Y, C, dk, mx - 1, my, W, Wc, Hc,
                                      false).g);
        nx = bwwf::next_flag(flags, mx + 1, w_mbs, F_BUSY);
        if (nx < w_mbs) {
          if (t < NP) pre_p = Pm[((size_t)my * w_mbs + nx) * NP + t];
          if (t < 96) pre_w = ld_word(own_word(Y, C, t, nx, my, W, Wc, Hc).g);
        }
        // rows 12-15 of the upper neighbour (chroma 4-7), when they came
        // one MB ahead; else the filter warps fetch them between their
        // passes (the vertical pass does not read them)
        const bool fetch_up = has_up && !up_ready;
        if (has_up && up_ready && uk >= 0) {
          const OwnWord o = bottom_word(Y, C, uk, mx, my - 1, W, Wc, Hc,
                                        false);
          (o.plane < 0 ? yt[buf] : ct[buf][o.plane])[o.idx] = pre_u;
        }
        bwwf::csync<NT>();

        // ---- filter: warp 0 luma, warp 1 both chroma planes. A thread
        // takes one line through all the vertical edges in registers, then
        // one column through all the horizontal ones. The left neighbour's
        // bottom rows are final after the vertical pass (the horizontal
        // one stays inside this MB): the idle lanes 16-31 of both warps
        // hand them to the row below before the horizontal pass, luma and
        // chroma onto the same slot barrier. Only the horizontal pass
        // (the top edge) reads the row above: each warp waits for it, and
        // brings its words into the tile, between the passes ------------
        // the upper rows' words, once the row above has handed them on
        auto fetch = [&]() {
          __syncwarp();
          if (uk >= 0) {
            const OwnWord o = bottom_word(Y, C, uk, mx, my - 1, W, Wc, Hc,
                                          false);
            (o.plane < 0 ? yt[buf] : ct[buf][o.plane])[o.idx] =
                (f & F_SLOT) ? wv.slot_words(mx)[uk] : ld_word(o.g);
          }
          __syncwarp();
        };
        const int need = mx + 2 < w_mbs ? mx + 2 : w_mbs;
        if (t < 32) {
          const int l4 = (t & 15) >> 2;
          int bsv[4], bsh[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bsv[e] = p[P_BS_V + 4 * e + l4];
            bsh[e] = p[P_BS_H + 4 * e + l4];
          }
          const Thr t_left = thr_at(p, P_THR_LUMA + THR_LEFT),
                    t_top = thr_at(p, P_THR_LUMA + THR_TOP),
                    t_in = thr_at(p, P_THR_LUMA + THR_INNER);
          int px[20];
          if (t < 16) {                // line t of the MB: tile row 4 + t
            unsigned* rw = yt[buf] + (4 + t) * YW;
#pragma unroll
            for (int c = 0; c < 5; ++c) {
              const unsigned wd = rw[c];
#pragma unroll
              for (int k = 0; k < 4; ++k) px[4 * c + k] = (wd >> (8 * k)) & 255;
            }
            luma_edges(px, bsv, t_left, t_in);
#pragma unroll
            for (int c = 0; c < 5; ++c)
              rw[c] = px[4 * c] | (px[4 * c + 1] << 8) |
                      (px[4 * c + 2] << 16) | (px[4 * c + 3] << 24);
          }
          __syncwarp();
          if (t >= 16 && left_down) wv.push(mx - 1, dk, left_bottom(dk));
          if (fetch_up) {
            if (t == 0) {
              if (up_global) {
                while (seen < need) seen = bwwf::ld_acquire(progress + row - 1);
                s_seen = seen;
              } else {
                wv.expect_and_wait(mx);
              }
            }
            fetch();
          }
          if (t < 16) {                // column t of the MB: tile column 4 + t
            uint8_t* col = ytb + 4 + t;
#pragma unroll
            for (int r = 0; r < 20; ++r) px[r] = col[r * YP];
            luma_edges(px, bsh, t_top, t_in);
#pragma unroll
            for (int r = 1; r < 20; ++r) col[r * YP] = (uint8_t)px[r];
          }
        } else if (t < 64) {
          const int u = t - 32, plane = (u >> 3) & 1, i = u & 7;
          const int l2 = i >> 1;
          const int bsv[2] = {p[P_BS_V + l2], p[P_BS_V + 8 + l2]};
          const int bsh[2] = {p[P_BS_H + l2], p[P_BS_H + 8 + l2]};
          const Thr t_left = thr_at(p, P_THR_CHROMA + THR_LEFT),
                    t_top = thr_at(p, P_THR_CHROMA + THR_TOP),
                    t_in = thr_at(p, P_THR_CHROMA + THR_INNER);
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
            chroma_edges(cx, bsv, t_left, t_in);
#pragma unroll
            for (int c = 0; c < 3; ++c)
              rw[c] = cx[4 * c] | (cx[4 * c + 1] << 8) |
                      (cx[4 * c + 2] << 16) | (cx[4 * c + 3] << 24);
          }
          __syncwarp();
          if (t >= 48 && left_down) wv.push(mx - 1, dk, left_bottom(dk));
          if (fetch_up) {
            if (t == 32) {
              if (up_global) {
                while (seen < need) seen = bwwf::ld_acquire(progress + row - 1);
              } else {
                wv.wait_phase(mx);
              }
            }
            fetch();
          }
          if (t < 48) {                // column i: tile column 4 + i
            uint8_t* col = tile + 4 + i;
#pragma unroll
            for (int r = 0; r < 12; ++r) cx[r] = col[r * CP];
            chroma_edges(cx, bsh, t_top, t_in);
#pragma unroll
            for (int r = 3; r < 12; ++r) col[r * CP] = (uint8_t)cx[r];
          }
        }
        bwwf::csync<NT>();
        if (t == 0 && fetch_up && (f & F_SLOT)) wv.flip(mx);
        // the next MB's upper rows one MB ahead: inside a cluster when no
        // slot brings them (nobody changed them), across clusters when the
        // last poll showed the row above far enough
        if (nx < w_mbs) {
          const int fn = flags[nx];
          up_ready = up_ring ? (fn & (F_UP | F_SLOT)) == F_UP
                             : ((fn & F_UP) && up_global &&
                                s_seen >= (nx + 2 < w_mbs ? nx + 2 : w_mbs));
        } else {
          up_ready = false;
        }
        if (up_ready && uk >= 0)
          pre_u = ld_word(bottom_word(Y, C, uk, nx, my - 1, W, Wc, Hc,
                                      false).g);

        // ---- store what the filter may have changed; rows 13-15 (chroma
        // 7) of an MB whose lower neighbour takes its slot are that
        // neighbour's to write --------------------------------------------
        if (t < 96) {
          const OwnWord o = own_word(Y, C, t, mx, my, W, Wc, Hc);
          const bool below = o.plane < 0 ? t >= 52 : (t - 64) % 16 >= 14;
          if (!(below && (f & F_DOWN)))
            st_word(o.g, (o.plane < 0 ? yt[buf] : ct[buf][o.plane])[o.idx]);
        } else if (has_left) {
          if (t < 112) {
            const int j = t - 96;
            if (!(j >= 13 && left_down))
              st_word(y_org + (ptrdiff_t)(4 + j) * W, yt[buf][(4 + j) * YW]);
          } else {
            const int u = t - 112, plane = u >> 3, j = u & 7;
            if (!(j == 7 && left_down))
              st_word(C + (size_t)plane * Hc * Wc +
                          (size_t)(8 * my + j) * Wc + 8 * mx - 4,
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
        // the loop's next turn hands this MB on (after a barrier)
      }
    }
    __syncthreads();
    wv.end_row(up_ring, down);
  }
  wv.finish();
}

size_t deblock_smem(int w_mbs) { return bwwf::dyn_smem(w_mbs, SLOT); }

}  // namespace

// Clusters of C CTAs of K3 that can be resident for a w_mbs-wide picture;
// negative: a CUDA error.
extern "C" int bw_deblock_resident_clusters(int w_mbs, int C) {
  int n = 0;
  const cudaError_t e = bwwf::resident_clusters(
      (const void*)deblock_rows_kernel, THREADS, deblock_smem(w_mbs), C, &n);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int bw_deblock_wavefront(uint8_t* Y, uint8_t* C, const int32_t* P,
                                    int* progress, const int32_t* skip,
                                    int w_mbs, int h_mbs, int batch,
                                    int cluster, int grid, void* stream) {
  void* args[] = {&Y, &C, &P, &progress, &skip, &w_mbs, &h_mbs, &batch};
  return (int)bwwf::launch_rows(bwwf::DEBLOCK,
                                (const void*)deblock_rows_kernel, THREADS,
                                deblock_smem(w_mbs), progress, batch * h_mbs,
                                cluster, grid, args, (cudaStream_t)stream);
}
