// The wavefront scaffold's own translation unit: its host-side state, the
// exported counters, and the hand-off probe.
//
// The probe is the scaffold of wavefront.cuh with an empty MB body: every
// MB waits on the row above and publishes at once. Its time over a
// w x h grid is the dependency floor of a wavefront kernel on this card:
// w + 2 (h - 1) sequential hand-offs that no amount of arithmetic tuning
// removes.

#include "wavefront.cuh"

namespace bwwf {
int max_ctas = 0;
long long launches[N_WHICH] = {0, 0, 0};
int last_grid[N_WHICH] = {0, 0, 0};
}  // namespace bwwf

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
handoff_probe_kernel(int* progress, int w_mbs, int h_mbs) {
  for (int my = blockIdx.x; my < h_mbs; my += gridDim.x) {
    int seen = 0;
    for (int mx = 0; mx < w_mbs; ++mx) {
      if (my > 0)
        bwwf::wait_row(progress, my - 1, mx + 2 < w_mbs ? mx + 2 : w_mbs,
                       seen);
      bwwf::publish(progress, my, mx + 1);
    }
  }
}

}  // namespace

extern "C" int bw_handoff_probe(int* progress, int w_mbs, int h_mbs,
                                void* stream) {
  void* args[] = {&progress, &w_mbs, &h_mbs};
  return (int)bwwf::launch_rows(bwwf::PROBE,
                                (const void*)handoff_probe_kernel, THREADS, 0,
                                progress, h_mbs, args, (cudaStream_t)stream);
}

// A TEST-ONLY knob, not part of the decoding interface: cap the grid of
// every wavefront launch at n CTAs (0 lifts the cap), so that a test can
// drive the rows-beyond-resident-CTAs stride on a small picture, which a
// card with more SMs than rows never reaches otherwise. The cap is one
// plain int for the whole process, read without a lock by every launch:
// it is not safe beside the decoder's slice-pool threads or a second
// decoder launching from another thread, so set it only while nothing
// else decodes. No decoding path calls this. Returns the previous cap.
extern "C" int bw_wavefront_set_max_ctas(int n) {
  const int old = bwwf::max_ctas;
  bwwf::max_ctas = n < 0 ? 0 : n;
  return old;
}

// Kernel launches made so far by wavefront `which` (0 intra, 1 deblock,
// 2 probe); reset != 0 zeroes the count after reading it.
extern "C" int bw_wavefront_device_launches(int which, int reset) {
  if (which < 0 || which >= bwwf::N_WHICH) return -1;
  const int n = (int)bwwf::launches[which];
  if (reset) bwwf::launches[which] = 0;
  return n;
}

// CTAs in the newest launch of wavefront `which`.
extern "C" int bw_wavefront_last_grid(int which) {
  if (which < 0 || which >= bwwf::N_WHICH) return -1;
  return bwwf::last_grid[which];
}
