// Timing aids for the card: no decoding path launches anything here.
//
//  * An empty kernel of a given grid and block: what launching that many
//    CTAs costs on this card whatever they compute (a kernel's launch
//    floor; chip_smoke.py asks for K1's grid).
//  * One thread that spins for a number of SM clocks. A short kernel's
//    launch takes less time on the card than the host takes to enqueue
//    the next one, so a timing of back-to-back launches would read the
//    host; with this ahead of them in the stream the launches queue up
//    and the events around them read the device.
//
// The wavefront kernels' hand-off probe needs their scaffold and lives
// beside it in wavefront.cu.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void hold_kernel(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

}  // namespace

extern "C" int bw_launch_probe(int ctas, int threads, void* stream) {
  if (ctas <= 0 || threads <= 0) return (int)cudaErrorInvalidValue;
  empty_kernel<<<ctas, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int bw_hold_stream(long long cycles, void* stream) {
  hold_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(cycles);
  return (int)cudaGetLastError();
}
