// K2: intra reconstruction over raster planes as one persistent wavefront
// launch per picture, or per batch of pictures of one geometry, in
// thread-block clusters (Hopper).
//
// Replaces the Pallas TPU kernel broadway_tpu/ops/tpu/wavefront_pallas.py
// (_intra_kernel / _intra_compute, launched by intra_wavefront). On the TPU
// the diagonal is the sequential grid axis, the MBs of one diagonal are the
// sublanes of a diagonal-major packed tensor, column access goes through
// one-hot MXU transposes and a 4..8-deep VMEM ring streams the rows.
//
// Here the planes stay raster uint8 and are updated in place by ONE launch:
// a CTA of 256 compute threads (and the scaffold's publisher warp) per MB
// row, consecutive rows in clusters of 8 (wavefront.cuh). Per row the CTA
// scans the params once for the MBs that are Intra4x4/Intra16x16 (F_BUSY)
// and for whether they read the row above at all (F_UP: any of av_b, av_c,
// av_d); inter and I_PCM MBs cost nothing and wait for nothing, so a P
// picture with a handful of intra MBs is a few microseconds.
//
// The row above: pels of inter and I_PCM MBs are final before K2 starts
// and are read from the planes (L2) without a wait. The bottom row of an
// intra MB (16 luma, 8 + 8 chroma pels: one 32-byte slot) reaches the row
// below
// - inside a cluster, PUSHED by the upper CTA into slot x of the lower
//   CTA's ring (st.async onto the lower CTA's mbarrier) as soon as the MB
//   is reconstructed, when the lower row reads it: as up (av_b) of MB x,
//   up-right (av_b and av_c) of MB x - 1, or up-left (av_d) of MB x + 1
//   (F_DOWN above and F_SLOT below, one predicate on the two rows'
//   params). An MB that reads the row above waits, on thread 0, for every
//   such slot up to x + 1 (the x + 2 dependency), then reads them from its
//   own shared memory;
// - across clusters (rank 0), after the counter of the row above covers
//   x + 2 (published by the publisher warp of rank 7), from L2.
// The left column (luma column 15, chroma column 7) stays in shared memory
// when this CTA made it (the left MB was intra), else comes from the planes.
//
// Inside an MB: the params and residuals of the NEXT intra MB of the row
// are fetched into registers before the CTA waits. The tap tables sit in
// shared memory. Intra4x4 keeps its 16 z-order 4x4 blocks as a chain over a
// 17x25 context tile in shared memory (row 0: up-left, up 16 + up-right 4;
// column 0: left 16), exactly as the JAX scan builds it, with the 9 modes
// as the table-driven <= 3-tap sums of broadway_tpu/ops/tpu/intra.py; the
// chain runs in warp 0 with __syncwarp() between blocks while warps 4-7
// predict chroma beside it.
//
// A batch (Y [B, H, W], C [B, 2, H/2, W/2], operands [B * n, ...]): row r
// of the launch is picture r / h_mbs, row r % h_mbs; every address below is
// taken from that picture's base and the top row of each picture waits for
// nothing.
//
// What bounds it: not bytes (about 20 MB per 1080p picture) and not
// arithmetic, but the w + 2 (h - 1) dependent steps of an all-intra
// picture, each an MB's serial I4x4 chain plus its hand-off. The counter
// design (one CTA a row, gpu-scope counters) took ~1.0 us a hand-off (gpu-scope fence and counter, then the
// context from L2); inside a cluster the hand-off is now a push onto an
// mbarrier (tools/wavefront_designs.py, 120x68 MBs, 0.137 ms for the chain
// against 0.246; NVIDIA H100 80GB HBM3, 700 W). K2 itself went 0.37 ->
// 0.35 ms on the 1080p IDR and 0.058 -> 0.048 ms on the P picture (held
// stream, same tool, both designs in one call): the MB's own serial
// chain (16 z-order 4x4 blocks, one __syncwarp() each) sets its pace, not
// the hand-off. 3 CTAs an SM (72 registers).

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

constexpr int NT = 256;                 // compute threads
constexpr int THREADS = NT + 32;        // and the publisher warp
constexpr int TAB_ROWS = TAB_BLK + 16;
constexpr int SLOT = 32;                // luma row 15, cb row 7, cr row 7
// flags[x]: MB x is intra; it reads the row above; the row below takes
// slot x (MB x's bottom row) from this CTA; slot x comes from the CTA above
constexpr int F_BUSY = 1, F_UP = 2, F_DOWN = 4, F_SLOT = 8;
// the scan's first pass: MB x reads up, up-right, up-left (of its own row
// and of the row below); MB x of the row above is intra
constexpr int R_UP = 16, R_UR = 32, R_UL = 64, U_INTRA = 128;

// What the row below reads of MB `mb`'s neighbours above.
struct Reads {
  bool intra, up, up_right, up_left;
};

__device__ __forceinline__ Reads reads(const int32_t* Pm, size_t mb) {
  const int32_t* q = Pm + mb * NP;
  const int4 av = *reinterpret_cast<const int4*>(q);
  const int2 ii = *reinterpret_cast<const int2*>(q + P_IS_I4);
  Reads r;
  r.intra = (ii.x | ii.y) != 0;
  r.up = r.intra && av.y != 0;
  r.up_right = r.up && av.z != 0;
  r.up_left = r.intra && av.w != 0;
  return r;
}

__device__ __forceinline__ int read_bits(const Reads& r) {
  return (r.up ? R_UP : 0) | (r.up_right ? R_UR : 0) |
         (r.up_left ? R_UL : 0);
}

// Does a row whose first-pass bits are `b` (w_mbs wide) read slot x of the
// row above, i.e. MB x's bottom row: as up of x, up-right of x - 1 or
// up-left of x + 1?
__device__ __forceinline__ bool reads_slot(const uint8_t* b, int x,
                                           int w_mbs) {
  return (b[x] & R_UP) || (x > 0 && (b[x - 1] & R_UR)) ||
         (x + 1 < w_mbs && (b[x + 1] & R_UL));
}

__global__ void __launch_bounds__(THREADS, 3)
intra_rows_kernel(uint8_t* Y0, uint8_t* C0, const int32_t* __restrict__ RY0,
                  const int32_t* __restrict__ RC0,
                  const int32_t* __restrict__ Pm0,
                  const int32_t* __restrict__ tab, int* progress, int w_mbs,
                  int h_mbs, int batch) {
  extern __shared__ __align__(16) uint8_t dyn[];  // flags, ring (Wave)
  __shared__ __align__(16) int stab[TAB_ROWS * 8];
  __shared__ int p[NP];
  __shared__ int loc[17][25];
  __shared__ int up_row[21];
  __shared__ int left_col[16];
  __shared__ int res_y[256];
  __shared__ int upc[2][9];              // [plane]: up-left, up 8
  __shared__ int leftc[2][8];
  // what this MB leaves: its bottom row (a slot) and right column
  __shared__ __align__(16) uint8_t s_bot[SLOT];
  __shared__ int c_left[16];
  __shared__ int c_leftc[2][8];
  __shared__ int s_done, s_stored;

  const int t = threadIdx.x;
  const int W = 16 * w_mbs, Wc = 8 * w_mbs, Hc = 8 * h_mbs;
  for (int i = t; i < TAB_ROWS * 8; i += THREADS) stab[i] = tab[i];
  bwwf::Wave wv;
  wv.start(dyn, &s_done, w_mbs, batch * h_mbs, SLOT);
  uint8_t* const flags = wv.flags;

  const size_t n_mbs = (size_t)w_mbs * h_mbs;
  for (int it = 0;; ++it) {
    const int row = wv.row_at(it);
    if (row < 0) break;
    // this row's picture: its planes, operands and counters
    const bwwf::BatchRow br = bwwf::batch_row(row, h_mbs);
    const int my = br.my;
    uint8_t* const Y = Y0 + (size_t)br.b * n_mbs * 256;
    uint8_t* const C = C0 + (size_t)br.b * n_mbs * 128;
    const int32_t* const RY = RY0 + (size_t)br.b * n_mbs * 256;
    const int32_t* const RC = RC0 + (size_t)br.b * n_mbs * 128;
    const int32_t* const Pm = Pm0 + (size_t)br.b * n_mbs * NP;
    const bool up_ring = wv.up_in_cluster(my);
    const bool up_global = my > 0 && !up_ring;
    const bool down = wv.down_in_cluster(row, h_mbs);
    const bool pub = wv.publishes(row);
    if (down) wv.wait_ring_free();
    // ---- scan the row: intra MBs, which read the row above, and which
    // bottom rows travel through the ring ---------------------------------
    __syncthreads();
    if (t == 0) s_stored = 0;
    // first pass: one round of loads a MB (its row, and the rows above
    // and below where the ring joins them)
    uint8_t* const own = wv.scan;
    uint8_t* const low = wv.scan + w_mbs;
    for (int x = t; x < w_mbs; x += THREADS) {
      const size_t mb = (size_t)my * w_mbs + x;
      const Reads me = reads(Pm, mb);
      const Reads up = reads(Pm, up_ring ? mb - w_mbs : mb);
      const Reads lo = reads(Pm, down ? mb + w_mbs : mb);
      const int32_t* q = Pm + mb * NP;
      const int4 av = *reinterpret_cast<const int4*>(q);
      own[x] = (uint8_t)((me.intra ? F_BUSY : 0) |
                         (me.intra && (av.y | av.z | av.w) ? F_UP : 0) |
                         read_bits(me) | (up_ring && up.intra ? U_INTRA : 0));
      low[x] = (uint8_t)(down ? read_bits(lo) : 0);
    }
    __syncthreads();
    // second pass: which slots travel (the same predicate for the CTA
    // above, F_SLOT, and the CTA below, F_DOWN)
    for (int x = t; x < w_mbs; x += THREADS) {
      const int b = own[x];
      int f = b & (F_BUSY | F_UP);
      if ((b & F_BUSY) && reads_slot(low, x, w_mbs)) f |= F_DOWN;
      if ((b & U_INTRA) && reads_slot(own, x, w_mbs)) f |= F_SLOT;
      flags[x] = (uint8_t)f;
    }
    __syncthreads();

    if (t >= NT) {
      if (t == NT && pub) bwwf::publisher(progress + row, w_mbs, &s_stored);
    } else {
      int pub_x = 0, seen = 0, last_mx = -2;
      int next_w = 0;                      // warp 0: first slot not waited
      int nx = bwwf::next_flag(flags, 0, w_mbs, F_BUSY);
      int pre_p = 0, pre_y = 0, pre_c = 0;   // the next intra MB's operands
      if (nx < w_mbs) {
        const size_t a = (size_t)my * w_mbs + nx;
        if (t < NP) pre_p = Pm[a * NP + t];
        pre_y = RY[a * 256 + t];
        if (t >= 128) pre_c = RC[a * 128 + t - 128];
      }
      while (true) {
        bwwf::csync<NT>();
        // the MB just reconstructed: its bottom row to the row below
        if (last_mx >= 0 && (flags[last_mx] & F_DOWN) && t < SLOT / 4)
          wv.push(last_mx, t, reinterpret_cast<const unsigned*>(s_bot)[t]);
        if (nx > pub_x) {
          if (pub && t == 0) bwwf::st_release_cta(&s_stored, nx);
          pub_x = nx;
        }
        if (nx >= w_mbs) break;
        const int mx = nx;
        if (t < NP) p[t] = pre_p;
        res_y[t] = pre_y;
        const int r_y = pre_y, r_c = pre_c;
        nx = bwwf::next_flag(flags, mx + 1, w_mbs, F_BUSY);
        if (nx < w_mbs) {
          const size_t a = (size_t)my * w_mbs + nx;
          if (t < NP) pre_p = Pm[a * NP + t];
          pre_y = RY[a * 256 + t];
          if (t >= 128) pre_c = RC[a * 128 + t - 128];
        }
        if (my > 0 && (flags[mx] & F_UP)) {
          if (up_global) {
            bwwf::wait_global(progress + row - 1,
                              mx + 2 < w_mbs ? mx + 2 : w_mbs, seen);
          } else if (t < 32) {
            next_w = wv.wait_slots(flags, next_w,
                                   mx + 1 < w_mbs ? mx + 1 : w_mbs - 1,
                                   F_SLOT);
          }
        }
        bwwf::csync<NT>();

        const bool is_i4 = p[P_IS_I4] != 0;
        const bool av_a = p[P_AV_A] != 0, av_b = p[P_AV_B] != 0,
                   av_c = p[P_AV_C] != 0, av_d = p[P_AV_D] != 0;
        const int x0 = 16 * mx, y0 = 16 * my, cx0 = 8 * mx, cy0 = 8 * my;
        const bool carry = last_mx == mx - 1;

        // ---- cross-MB context (masked like the JAX up_row / left_col);
        // a pel of an intra MB above comes from its slot when the ring
        // brought it, else from the planes ---------------------------------
        for (int i = t; i < 17 * 25; i += NT) {
          const int r = i / 25, c = i - 25 * r;
          if (!((r == 0 && c < 21) || (c == 0 && r > 0))) (&loc[0][0])[i] = 0;
        }
        if (t <= 20) {
          // t 17..20 is MB C's row: zero unless B is available too (JAX
          // masks the whole row by av_b); read only when C exists
          const bool ok = t == 0 ? av_d : (t <= 16 ? av_b : (av_b && av_c));
          int v = 0;
          if (ok) {
            const int s = t == 0 ? mx - 1 : (t <= 16 ? mx : mx + 1);
            const int c = t == 0 ? 15 : (t <= 16 ? t - 1 : t - 17);
            v = (up_ring && (flags[s] & F_SLOT))
                    ? wv.ring[(size_t)s * SLOT + c]
                    : __ldcg(Y + (size_t)(y0 - 1) * W + x0 + t - 1);
          }
          up_row[t] = v;
          loc[0][t] = v;
        } else if (t >= 32 && t < 48) {
          const int k = t - 32;
          const int v =
              av_a ? (carry ? c_left[k]
                            : __ldcg(Y + (size_t)(y0 + k) * W + x0 - 1))
                   : 0;
          left_col[k] = v;
          loc[k + 1][0] = v;
        } else if (t >= 64 && t < 82) {
          const int plane = (t - 64) / 9, k = (t - 64) % 9;
          const uint8_t* Pc = C + (size_t)plane * Hc * Wc;
          const bool ok = k == 0 ? av_d : av_b;
          int v = 0;
          if (ok) {
            const int s = k == 0 ? mx - 1 : mx;
            const int c = k == 0 ? 7 : k - 1;
            v = (up_ring && (flags[s] & F_SLOT))
                    ? wv.ring[(size_t)s * SLOT + 16 + 8 * plane + c]
                    : __ldcg(Pc + (size_t)(cy0 - 1) * Wc + cx0 + k - 1);
          }
          upc[plane][k] = v;
        } else if (t >= 96 && t < 112) {
          const int plane = (t - 96) >> 3, k = (t - 96) & 7;
          const uint8_t* Pc = C + (size_t)plane * Hc * Wc;
          leftc[plane][k] =
              av_a ? (carry ? c_leftc[plane][k]
                            : __ldcg(Pc + (size_t)(cy0 + k) * Wc + cx0 - 1))
                   : 0;
        }
        bwwf::csync<NT>();
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
          const int pel = clip8(pred + r_c);
          __stcg(C + (size_t)plane * Hc * Wc + (size_t)(cy0 + cy) * Wc + cx0 +
                     cx,
                 (uint8_t)pel);
          if (cy == 7) s_bot[16 + 8 * plane + cx] = (uint8_t)pel;
          if (cx == 7) c_leftc[plane][cy] = pel;
        }
        bwwf::csync<NT>();

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
          if (y == 15) s_bot[x] = (uint8_t)out;
          if (x == 15) c_left[y] = out;
        }
        last_mx = mx;
        // the loop's next turn hands this MB on (after a barrier)
      }

      // every slot of this row has arrived (each is read by some MB, so
      // this waits for nothing, but every barrier phase completes)
      if (up_ring && t < 32)
        wv.wait_slots(flags, next_w, w_mbs - 1, F_SLOT);
    }
    __syncthreads();
    wv.end_row(up_ring, down);
  }
  wv.finish();
}

size_t intra_smem(int w_mbs) { return bwwf::dyn_smem(w_mbs, SLOT); }

}  // namespace

// Clusters of C CTAs of K2 that can be resident for a w_mbs-wide picture;
// negative: a CUDA error.
extern "C" int bw_intra_resident_clusters(int w_mbs, int C) {
  int n = 0;
  const cudaError_t e = bwwf::resident_clusters(
      (const void*)intra_rows_kernel, THREADS, intra_smem(w_mbs), C, &n);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int bw_intra_wavefront(uint8_t* Y, uint8_t* C, const int32_t* RY,
                                  const int32_t* RC, const int32_t* P,
                                  const int32_t* tab, int* progress,
                                  int w_mbs, int h_mbs, int batch,
                                  int cluster, int grid, void* stream) {
  void* args[] = {&Y,   &C,        &RY,    &RC,    &P,
                  &tab, &progress, &w_mbs, &h_mbs, &batch};
  return (int)bwwf::launch_rows(bwwf::INTRA, (const void*)intra_rows_kernel,
                                THREADS, intra_smem(w_mbs), progress,
                                batch * h_mbs, cluster, grid, args,
                                (cudaStream_t)stream);
}
