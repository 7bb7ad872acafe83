// IVF probed-tile kernels for Hopper (sm_90a), plain C interface:
//   K4  score_tiles_kernel          one probed [128, D] tile per CTA
//   K12 score_tiles_grouped_kernel  FL_TG = 4 probed tiles per CTA, staged with cp.async
//   K5a adc_tiles_kernel<1>         one probed [128, m] code tile per CTA
//   K5b adc_tiles_kernel<8>         PQ_TG = 8 probed code tiles per CTA
//
// They replace the Pallas TPU kernels of retrieval_scaling_tpu/ops/ivf_gather.py:
// `_kernel` (K4, pallas_call in `gather_score_tiles`), `_flat_group_kernel` (K12,
// `gather_score_tiles_grouped`), `_pq_kernel_t` (K5a, `gather_adc_tiles`) and
// `_pq_group_kernel_t` (K5b, `gather_adc_tiles_grouped`). What they compute:
//   K4/K12: out[b, t, r] = sum_d q[b, d] * tiles[ids[b, t], r, d]        (f32 sums)
//   K5a/K5b: out[b, t, r] = sum_{s=0..m-1} lut[b, s, codes[ids[b, t], r, s]]
// with out [B, T, 128] f32. An id outside [0, n_tiles) reads tile 0, as the
// TPU kernels' callers map invalid slots to tile 0; the caller masks them.
//
// What bounds them on this card. The flat scan reads each probed tile once per
// query and does 2 flops per element it reads (1 flop/byte at bf16, 2 at int8):
// far below the H100's ~20 f32 flop/byte ridge, so K4/K12 are bound by the
// bytes of the gathered tiles. K4's design: a CTA per (query, tile slot), the
// query staged once in shared memory as f32, each warp reading whole rows with
// 16-byte coalesced loads (four rows at a time, so four loads are in flight per
// lane) and reducing with shuffles. K12 keeps four tiles' copies in flight
// together with cp.async into a double-buffered shared-memory ring, the
// analogue of the TPU kernel's concurrent DMAs. The ADC scan reads m bytes per
// row and does m table lookups: the code bytes are small (16 B/row at m = 16),
// so at serving batch sizes K5a/K5b are bound by launch and by staging the
// query's LUT (m * ksub * 4 B = 16 KB at m = 16, 8 bits) into shared memory:
// K5a stages it per tile, K5b once per 8 tiles. Each thread owns one row,
// reads its code with one 16-byte shared load and sums the m lookups in f32
// in the order s = 0..m-1.
//
// Layouts (all contiguous): q [B, D] f32 (the caller rounds it to the tiles'
// type first where the TPU kernel did); tiles [n_tiles, 128, D] of f32, bf16
// or int8 with D * sizeof(elem) a multiple of 16; ids [B, T] int32;
// lut [B, m, ksub] f32 with m * ksub a multiple of 4; codes [n_tiles, 128, m]
// uint8, the on-disk row layout.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kFlatGroup = 4;   // FL_TG
constexpr int kPqGroup = 8;     // PQ_TG
constexpr int kFlatThreads = 256;
constexpr int kSmemCap = 200 * 1024;     // dynamic shared memory a launch may ask for
constexpr int kStageBudget = 96 * 1024;  // K12's double-buffered ring

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// acc + dot(16-byte chunk of a row, the matching f32 query slice)
template <int DT>
struct Chunk;

template <>
struct Chunk<kF32> {
  static constexpr int N = 4;
  static __device__ __forceinline__ float dot(const uint4 v, const float* q, float acc) {
    acc = fmaf(__uint_as_float(v.x), q[0], acc);
    acc = fmaf(__uint_as_float(v.y), q[1], acc);
    acc = fmaf(__uint_as_float(v.z), q[2], acc);
    return fmaf(__uint_as_float(v.w), q[3], acc);
  }
};

template <>
struct Chunk<kBF16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ float dot(const uint4 v, const float* q, float acc) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half, 2i + 1 in the high
      acc = fmaf(__uint_as_float(w[i] << 16), q[2 * i], acc);
      acc = fmaf(__uint_as_float(w[i] & 0xffff0000u), q[2 * i + 1], acc);
    }
    return acc;
  }
};

template <>
struct Chunk<kI8> {
  static constexpr int N = 16;
  static __device__ __forceinline__ float dot(const uint4 v, const float* q, float acc) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = float(int8_t((w[i] >> (8 * e)) & 0xffu));
        acc = fmaf(x, q[4 * i + e], acc);
      }
    }
    return acc;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int tile_or_zero(int id, int n_tiles) {
  return (id < 0 || id >= n_tiles) ? 0 : id;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// ------------------------------------------------------------------ K4
template <int DT>
__global__ void __launch_bounds__(kFlatThreads)
    score_tiles_kernel(const float* __restrict__ q, const uint4* __restrict__ tiles,
                       const int* __restrict__ ids, float* __restrict__ out, int T, int n_tiles,
                       int D) {
  extern __shared__ float q_s[];  // D floats
  const int bt = blockIdx.x;       // b * T + t
  const int b = bt / T;
  for (int i = threadIdx.x; i < D; i += blockDim.x) q_s[i] = q[size_t(b) * D + i];
  const int tile = tile_or_zero(ids[bt], n_tiles);
  __syncthreads();

  const int cpr = D / Chunk<DT>::N;  // 16-byte chunks per row
  const uint4* base = tiles + size_t(tile) * kTile * cpr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kRowsPerWarp = kTile / (kFlatThreads / 32);  // 16
  for (int r0 = warp * kRowsPerWarp; r0 < (warp + 1) * kRowsPerWarp; r0 += 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = lane; c < cpr; c += 32) {
      uint4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __ldg(base + size_t(r0 + i) * cpr + c);
      const float* qc = q_s + c * Chunk<DT>::N;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = Chunk<DT>::dot(v[i], qc, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = warp_sum(acc[i]);
      if (lane == 0) out[size_t(bt) * kTile + r0 + i] = s;
    }
  }
}

// ------------------------------------------------------------------ K12
// Per stage, `rows` rows of each of the CTA's four tiles (four contiguous
// pieces of device memory) are copied into one half of the ring while the
// other half is scored.
template <int DT>
__global__ void __launch_bounds__(kFlatThreads)
    score_tiles_grouped_kernel(const float* __restrict__ q, const uint4* __restrict__ tiles,
                               const int* __restrict__ ids, float* __restrict__ out, int T,
                               int n_tiles, int D, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  uint4* ring = reinterpret_cast<uint4*>(smem + align16(D * 4));
  const int groups = T / kFlatGroup;
  const int b = blockIdx.x / groups, g = blockIdx.x % groups;
  const int cpr = D / Chunk<DT>::N;
  const int piece = rows * cpr;                // chunks of one tile in a stage
  const int stage_chunks = kFlatGroup * piece;
  int tile[kFlatGroup];
#pragma unroll
  for (int j = 0; j < kFlatGroup; ++j)
    tile[j] = tile_or_zero(ids[size_t(b) * T + g * kFlatGroup + j], n_tiles);

  auto issue = [&](int step, int buf) {
    uint4* dst = ring + buf * stage_chunks;
    for (int i = threadIdx.x; i < stage_chunks; i += blockDim.x) {
      const int j = i / piece, off = i - j * piece;
      cp_async16(dst + i, tiles + (size_t(tile[j]) * kTile + size_t(step) * rows) * cpr + off);
    }
    cp_async_commit();
  };

  issue(0, 0);
  for (int i = threadIdx.x; i < D; i += blockDim.x) q_s[i] = q[size_t(b) * D + i];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int steps = kTile / rows;
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      issue(step + 1, (step + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* cur = ring + (step & 1) * stage_chunks;
    for (int rr = warp; rr < kFlatGroup * rows; rr += kFlatThreads / 32) {
      const uint4* row = cur + rr * cpr;
      float acc = 0.f;
      for (int c = lane; c < cpr; c += 32) acc = Chunk<DT>::dot(row[c], q_s + c * Chunk<DT>::N, acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        const int j = rr / rows, r = step * rows + rr % rows;
        out[(size_t(b) * T + g * kFlatGroup + j) * kTile + r] = acc;
      }
    }
    __syncthreads();  // the next stage's copy reuses this half of the ring
  }
}

// ------------------------------------------------------------------ K5a / K5b
template <int TG>
__global__ void __launch_bounds__(TG == 1 ? kTile : 2 * kTile)
    adc_tiles_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                     const int* __restrict__ ids, float* __restrict__ out, int T, int n_tiles,
                     int m, int ksub) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);
  uint8_t* codes_s = smem + align16(m * ksub * 4);
  const int groups = T / TG;
  const int b = blockIdx.x / groups, g = blockIdx.x % groups;

  // the query's LUT and the TG code tiles: every copy in flight together
  const int lut_chunks = m * ksub / 4;
  const uint4* lut4 = reinterpret_cast<const uint4*>(lut + size_t(b) * m * ksub);
  for (int i = threadIdx.x; i < lut_chunks; i += blockDim.x)
    cp_async16(reinterpret_cast<uint4*>(lut_s) + i, lut4 + i);
  const int tile_chunks = kTile * m / 16;
  const uint4* codes4 = reinterpret_cast<const uint4*>(codes);
  const int* slot_ids = ids + size_t(b) * T + g * TG;
  for (int i = threadIdx.x; i < TG * tile_chunks; i += blockDim.x) {
    const int j = i / tile_chunks;
    const int tile = tile_or_zero(slot_ids[j], n_tiles);
    cp_async16(reinterpret_cast<uint4*>(codes_s) + i,
               codes4 + size_t(tile) * tile_chunks + (i - j * tile_chunks));
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // thread -> (tile j, row r) = i / 128, i % 128; out rows of the TG tiles are contiguous
  float* out_g = out + (size_t(b) * T + size_t(g) * TG) * kTile;
  for (int i = threadIdx.x; i < TG * kTile; i += blockDim.x) {
    const uint8_t* code = codes_s + size_t(i) * m;
    float acc = 0.f;
    int s = 0;
    if ((m & 15) == 0) {
      for (; s < m; s += 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(code + s);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          acc += lut_s[(s + e) * ksub + ((w[e >> 2] >> (8 * (e & 3))) & 0xffu)];
      }
    } else if ((m & 7) == 0) {
      for (; s < m; s += 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(code + s);
        const uint32_t w[2] = {v.x, v.y};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc += lut_s[(s + e) * ksub + ((w[e >> 2] >> (8 * (e & 3))) & 0xffu)];
      }
    } else {
      for (; s < m; ++s) acc += lut_s[s * ksub + code[s]];
    }
    out_g[i] = acc;
  }
}

template <typename Kernel>
int configure(Kernel kernel) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap));
}

template <int DT>
int launch_score(const float* q, const void* tiles, const int* ids, float* out, int B, int T,
                 int n_tiles, int D, int grouped, cudaStream_t stream) {
  const uint4* t4 = static_cast<const uint4*>(tiles);
  if (!grouped) {
    const int smem = D * 4;
    if (smem > kSmemCap) return int(cudaErrorInvalidValue);
    static const int configured = configure(score_tiles_kernel<DT>);
    if (configured) return configured;
    score_tiles_kernel<DT><<<B * T, kFlatThreads, smem, stream>>>(q, t4, ids, out, T, n_tiles, D);
    return int(cudaGetLastError());
  }
  if (T % kFlatGroup) return int(cudaErrorInvalidValue);
  const int row_bytes = D * 16 / Chunk<DT>::N;
  int rows = 16;
  while (rows > 1 && 2 * kFlatGroup * rows * row_bytes > kStageBudget) rows /= 2;
  const int smem = align16(D * 4) + 2 * kFlatGroup * rows * row_bytes;
  if (smem > kSmemCap) return int(cudaErrorInvalidValue);
  static const int configured = configure(score_tiles_grouped_kernel<DT>);
  if (configured) return configured;
  score_tiles_grouped_kernel<DT><<<B * (T / kFlatGroup), kFlatThreads, smem, stream>>>(
      q, t4, ids, out, T, n_tiles, D, rows);
  return int(cudaGetLastError());
}

template <int TG>
int launch_adc(const float* lut, const uint8_t* codes, const int* ids, float* out, int B, int T,
               int n_tiles, int m, int ksub, cudaStream_t stream) {
  if (T % TG) return int(cudaErrorInvalidValue);
  const int smem = align16(m * ksub * 4) + TG * kTile * m;
  if (smem > kSmemCap) return int(cudaErrorInvalidValue);
  static const int configured = configure(adc_tiles_kernel<TG>);
  if (configured) return configured;
  adc_tiles_kernel<TG><<<B * (T / TG), TG == 1 ? kTile : 2 * kTile, smem, stream>>>(
      lut, codes, ids, out, T, n_tiles, m, ksub);
  return int(cudaGetLastError());
}

}  // namespace

// K4 (grouped = 0) or K12 (grouped = 1). dtype: 0 f32, 1 bf16, 2 int8.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int ivf_score_tiles(const float* q, const void* tiles, const int* ids, float* out,
                               int B, int T, int n_tiles, int D, int dtype, int grouped,
                               void* stream) {
  if (B <= 0 || T <= 0 || n_tiles <= 0 || D <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return D % Chunk<kF32>::N ? int(cudaErrorInvalidValue)
                                : launch_score<kF32>(q, tiles, ids, out, B, T, n_tiles, D, grouped, s);
    case kBF16:
      return D % Chunk<kBF16>::N ? int(cudaErrorInvalidValue)
                                 : launch_score<kBF16>(q, tiles, ids, out, B, T, n_tiles, D, grouped, s);
    case kI8:
      return D % Chunk<kI8>::N ? int(cudaErrorInvalidValue)
                               : launch_score<kI8>(q, tiles, ids, out, B, T, n_tiles, D, grouped, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// K5a (grouped = 0) or K5b (grouped = 1, T a multiple of 8). ksub <= 256.
extern "C" int ivf_adc_tiles(const float* lut, const uint8_t* codes, const int* ids, float* out,
                             int B, int T, int n_tiles, int m, int ksub, int grouped, void* stream) {
  if (B <= 0 || T <= 0 || n_tiles <= 0 || m <= 0 || ksub <= 0 || ksub > 256 || (m * ksub) % 4)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grouped) return launch_adc<kPqGroup>(lut, codes, ids, out, B, T, n_tiles, m, ksub, s);
  return launch_adc<1>(lut, codes, ids, out, B, T, n_tiles, m, ksub, s);
}
