// K13: the read-only weight-stream probe for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_touch_kernel` of bench.py (pallas_call in
// `dma_pass`), which streamed every int8 decode weight buffer once so that
// the loop time was the device-memory floor the decode step is held
// against. Here one launch reads every byte of a list of device buffers once
// with 16-byte loads and sums the bytes (dp4a against 0x01010101), so the
// loads cannot be elided; each CTA writes its one 64-bit sum and the caller
// adds them. The byte sum equals the plain version's torch reduction.
//
// What bounds it on this card: it does ~1 op per byte, so it is bound by
// reading the buffers (4 GB of int4 Llama-3.1-8B weights: 1.19 ms at
// 3.35 TB/s). The buffers are cut into chunks of at most 1 MB on the host;
// CTAs take chunks in a grid-stride loop, 256 threads each with four
// 16-byte loads in flight per iteration, and no shared memory beyond the
// final reduction.
//
// Layout: `chunks` is a device array of (base pointer, number of 16-byte
// units) pairs; every base is 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Chunk {
  const uint4* p;
  long long n;  // 16-byte units
};

__device__ __forceinline__ unsigned int byte_sum(uint4 v) {
  unsigned int s = __dp4a(v.x, 0x01010101u, 0u);
  s = __dp4a(v.y, 0x01010101u, s);
  s = __dp4a(v.z, 0x01010101u, s);
  return __dp4a(v.w, 0x01010101u, s);
}

__global__ void __launch_bounds__(kThreads) stream_probe_kernel(const Chunk* chunks, int n_chunks,
                                                               unsigned long long* out) {
  __shared__ unsigned long long red[kThreads / 32];
  unsigned long long acc = 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const uint4* p = chunks[c].p;
    const long long n = chunks[c].n;
    long long i = threadIdx.x;
    for (; i + 3 * kThreads < n; i += 4 * kThreads) {
      const uint4 a = __ldg(p + i), b = __ldg(p + i + kThreads);
      const uint4 d = __ldg(p + i + 2 * kThreads), e = __ldg(p + i + 3 * kThreads);
      acc += byte_sum(a) + byte_sum(b) + byte_sum(d) + byte_sum(e);
    }
    for (; i < n; i += kThreads) acc += byte_sum(__ldg(p + i));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    out[blockIdx.x] = s;
  }
}

}  // namespace

// One launch over `n_chunks` chunks with `n_ctas` CTAs; out holds n_ctas
// 64-bit byte sums. Returns the CUDA error code of the launch.
extern "C" int stream_probe(const void* chunks, int n_chunks, void* out, int n_ctas, void* stream) {
  if (n_chunks <= 0 || n_ctas <= 0) return int(cudaErrorInvalidValue);
  stream_probe_kernel<<<n_ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Chunk*>(chunks), n_chunks, static_cast<unsigned long long*>(out));
  return int(cudaGetLastError());
}
