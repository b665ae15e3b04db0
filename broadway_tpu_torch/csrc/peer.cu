// Copies between two cards of one host, for the band-sharded decode over
// several cards (parallel/slices.py): the counterpart of the JAX
// package's ppermute halos and all_gather, which XLA runs as collectives
// over the chips' interconnect. No kernel: a copy is one cudaMemcpyAsync
// between peer addresses on the receiver's stream, so that a stream
// capture records it as a memcpy node of the receiver's graph (PyTorch's
// copy_ between cards runs on the SENDER's current stream and records
// events on both cards' streams, which a capture of one card refuses).
//
// Peer access is enabled once per ordered pair before any copy: without
// it the runtime would stage a copy through host memory, which this port
// never does quietly (ops/gpu/peer.py raises where a pair has none).

#include <cuda_runtime.h>

// Let `device`'s context read and write `peer`'s memory directly. Returns
// 0 when enabled (or already), else the CUDA error. The calling thread's
// current device is restored.
extern "C" int bw_peer_enable(int device, int peer) {
  int old = 0;
  cudaError_t e = cudaGetDevice(&old);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();       // not an error here: clear it
      e = cudaSuccess;
    }
  }
  cudaError_t r = cudaSetDevice(old);
  return (int)(e != cudaSuccess ? e : r);
}

// bytes from src (on one card) to dst (on another, or the same) on
// `stream`, the receiver's. Returns the CUDA error of the enqueue.
extern "C" int bw_peer_copy(void* dst, const void* src, long long bytes,
                            void* stream) {
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyAsync(dst, src, (size_t)bytes,
                              cudaMemcpyDeviceToDevice,
                              (cudaStream_t)stream);
}
