// The wavefront scaffold's own translation unit: its host-side state, the
// exported counters, and the hand-off probe.
//
// The probe is the scaffold of wavefront.cuh with an empty MB body: every
// MB waits on the row above and publishes at once. Its time over a
// w x h grid is the dependency floor of a wavefront kernel on this card:
// w + 2 (h - 1) sequential hand-offs that no amount of arithmetic tuning
// removes. With a batch it runs `batch` such chains side by side, as K2
// and K3 do.

#include "wavefront.cuh"

namespace bwwf {
std::atomic<int> max_ctas{0};
std::atomic<long long> launches[N_WHICH]{};
thread_local std::atomic<long long> captured[N_WHICH]{};
std::atomic<int> last_grid[N_WHICH]{};
std::atomic<int> last_resident[N_WHICH]{};
std::mutex launch_mutex;
}  // namespace bwwf

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
handoff_probe_kernel(int* progress, int w_mbs, int h_mbs, int batch) {
  for (int row = blockIdx.x; row < batch * h_mbs; row += gridDim.x) {
    const int my = bwwf::batch_row(row, h_mbs).my;
    int seen = 0;
    for (int mx = 0; mx < w_mbs; ++mx) {
      if (my > 0)
        bwwf::wait_row(progress, row - 1, mx + 2 < w_mbs ? mx + 2 : w_mbs,
                       seen);
      bwwf::publish(progress, row, mx + 1);
    }
  }
}

}  // namespace

extern "C" int bw_handoff_probe(int* progress, int w_mbs, int h_mbs,
                                int batch, void* stream) {
  void* args[] = {&progress, &w_mbs, &h_mbs, &batch};
  return (int)bwwf::launch_rows(bwwf::PROBE,
                                (const void*)handoff_probe_kernel, THREADS, 0,
                                progress, batch * h_mbs, args,
                                (cudaStream_t)stream);
}

// A TEST-ONLY knob, not part of the decoding interface: cap the grid of
// every wavefront launch at n CTAs (0 lifts the cap), so that a test can
// drive the rows-beyond-resident-CTAs stride on a small picture, which a
// card with more SMs than rows never reaches otherwise. The cap is one
// value for the whole process, read by every launch: a decoder launching
// from another thread meanwhile is capped too, so set it only while
// nothing else decodes. No decoding path calls this. Returns the previous
// cap.
extern "C" int bw_wavefront_set_max_ctas(int n) {
  return bwwf::max_ctas.exchange(n < 0 ? 0 : n);
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

// CTAs of wavefront `which` that the card could hold resident at once, as
// the occupancy calculator said at its newest launch.
extern "C" int bw_wavefront_last_resident(int which) {
  if (which < 0 || which >= bwwf::N_WHICH) return -1;
  return bwwf::last_resident[which].load();
}
