// The wavefront scaffold's own translation unit: its host-side state, the
// exported counters, and the hand-off probe.
//
// The probe is the scaffold of wavefront.cuh with an empty MB body: every
// MB of a row below the first waits on the row above, and every MB hands
// 128 bytes on to the row below (K3's delivery: MB x - 1's once MB x is
// done). Inside a cluster that is the st.async push onto the lower CTA's
// mbarrier; across clusters the counter published by the publisher warp.
// Its time over a w x h grid is the dependency floor of a wavefront kernel
// on this card: w + 2 (h - 1) sequential steps that no arithmetic tuning
// removes. The cluster size C is an argument of the probe only (C = 1:
// every hand-off crosses clusters, through global memory); with a batch it
// runs `batch` such chains side by side, as K2 and K3 do.

#include "wavefront.cuh"

namespace bwwf {
std::atomic<long long> launches[N_WHICH]{};
thread_local std::atomic<long long> captured[N_WHICH]{};
std::atomic<int> last_grid[N_WHICH]{};
std::atomic<int> last_resident[N_WHICH]{};
std::atomic<int> last_cluster[N_WHICH]{};
std::mutex launch_mutex;
}  // namespace bwwf

namespace {

constexpr int NT = 128;              // compute threads
constexpr int THREADS = NT + 32;     // and the publisher warp
constexpr int SLOT = 128;            // bytes handed on a MB

__global__ void __launch_bounds__(THREADS)
handoff_probe_kernel(int* progress, int w_mbs, int h_mbs, int batch) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ int s_done, s_stored;
  const int t = threadIdx.x;
  bwwf::Wave wv;
  wv.start(dyn, &s_done, w_mbs, batch * h_mbs, SLOT);
  unsigned acc = 0, prev = 0;
  for (int it = 0;; ++it) {
    const int row = wv.row_at(it);
    if (row < 0) break;
    const int my = row % h_mbs;
    const bool up_ring = wv.up_in_cluster(my);
    const bool up_global = my > 0 && !up_ring;
    const bool down = wv.down_in_cluster(row, h_mbs);
    const bool pub = wv.publishes(row);
    if (down) wv.wait_ring_free();
    if (t == 0) s_stored = 0;
    __syncthreads();
    if (t >= NT) {
      if (t == NT && pub) bwwf::publisher(progress + row, w_mbs, &s_stored);
    } else {
      int seen = 0;
      for (int x = 0; x < w_mbs; ++x) {
        if (up_global)
          bwwf::wait_global(progress + row - 1,
                            x + 2 < w_mbs ? x + 2 : w_mbs, seen);
        else if (up_ring && t == 0)
          wv.wait_slot(x);
        bwwf::csync<NT>();
        if (up_ring && t < SLOT / 4) acc += wv.slot_words(x)[t];
        const unsigned mine = acc + (unsigned)x;
        if (down && t < SLOT / 4) {
          if (x > 0) wv.push(x - 1, t, prev);
          if (x == w_mbs - 1) wv.push(x, t, mine);
        }
        prev = mine;
        bwwf::csync<NT>();
        if (pub && t == 0) bwwf::st_release_cta(&s_stored, x + 1);
      }
    }
    __syncthreads();
    wv.end_row(up_ring, down);
  }
  wv.finish();
  if (acc == 0xdeadbeefu) progress[0] = 0;    // keeps the ring reads
}

size_t probe_smem(int w_mbs) { return bwwf::dyn_smem(w_mbs, SLOT); }

}  // namespace

// C x (resident clusters) CTAs of the probe: cudaOccupancyMaxActiveClusters
// for a w_mbs-wide row; negative: a CUDA error.
extern "C" int bw_handoff_resident_clusters(int w_mbs, int C) {
  int n = 0;
  const cudaError_t e = bwwf::resident_clusters(
      (const void*)handoff_probe_kernel, THREADS, probe_smem(w_mbs), C, &n);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int bw_handoff_probe(int* progress, int w_mbs, int h_mbs,
                                int batch, int C, int grid, void* stream) {
  void* args[] = {&progress, &w_mbs, &h_mbs, &batch};
  return (int)bwwf::launch_rows(bwwf::PROBE,
                                (const void*)handoff_probe_kernel, THREADS,
                                probe_smem(w_mbs), progress, batch * h_mbs, C,
                                grid, args, (cudaStream_t)stream);
}

// Kernel launches made so far by wavefront `which` (0 intra, 1 deblock,
// 2 probe); reset != 0 zeroes the count after reading it.
extern "C" int bw_wavefront_device_launches(int which, int reset) {
  if (which < 0 || which >= bwwf::N_WHICH) return -1;
  return (int)(reset ? bwwf::launches[which].exchange(0)
                     : bwwf::launches[which].load());
}

// Launches of wavefront `which` that stream captures on the calling thread
// recorded since the last call (zeroed by this read): what one replay of
// the graph just captured launches.
extern "C" int bw_wavefront_take_captured(int which) {
  if (which < 0 || which >= bwwf::N_WHICH) return -1;
  return (int)bwwf::captured[which].exchange(0);
}

// Add n launches to wavefront `which`'s count: the launches of a graph
// replay, which runs kernels without calling launch_rows.
extern "C" int bw_wavefront_add_launches(int which, int n) {
  if (which < 0 || which >= bwwf::N_WHICH) return -1;
  bwwf::launches[which] += n;
  return 0;
}

// CTAs in the newest launch of wavefront `which`.
extern "C" int bw_wavefront_last_grid(int which) {
  if (which < 0 || which >= bwwf::N_WHICH) return -1;
  return bwwf::last_grid[which].load();
}

// CTAs of wavefront `which` that the card could hold resident at once, in
// whole clusters, as the occupancy calculator said at its newest launch.
extern "C" int bw_wavefront_last_resident(int which) {
  if (which < 0 || which >= bwwf::N_WHICH) return -1;
  return bwwf::last_resident[which].load();
}

// The cluster size C of the newest launch of wavefront `which`.
extern "C" int bw_wavefront_last_cluster(int which) {
  if (which < 0 || which >= bwwf::N_WHICH) return -1;
  return bwwf::last_cluster[which].load();
}
