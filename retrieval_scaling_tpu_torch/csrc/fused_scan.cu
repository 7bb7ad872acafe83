// K11: the fused exact-MIPS scan with a segment-max epilogue, for Hopper
// (sm_90a), plain C interface.
//
// It replaces the Pallas TPU kernel `_segmax_kernel` of
// retrieval_scaling_tpu/ops/fused_scan.py (pallas_call in `segmax_scan`).
// What it computes, for q [B, D] already rounded to the database's type:
//   out[b, s] = max over rows n of segment s (128 rows) of
//               (n < n_valid ? sum_d f32(q[b, d]) * f32(db[n, d]) : -1e30)
// with out [B, N_pad / 128] f32 and N_pad a multiple of 2048. A segment with
// no valid row gives exactly -1e30.
//
// What bounds it on this card. The scan reads the whole database once:
// N_pad * D * 2 bytes in bf16 (1.61 GB at 1M x 768, 0.481 ms at 3.35 TB/s)
// and does 2 * B * N_pad * D operations (103 GFLOP at b64: 0.104 ms on the
// bf16 tensor cores, 1.54 ms as f32 FMA). So it is bound by bytes at every
// batch, provided the products run on the tensor cores; the [B, N] score
// matrix that a matmul route writes and reads back never leaves the chip.
//
// Design (bf16 / fp16, `segmax_mma_kernel`): one CTA of 8 warps per block of
// 2,048 rows, and per group of up to 64 queries (grid.y). The group's queries
// are staged once in shared memory. The block's rows stream through a
// three-stage ring of [128 rows x 128 columns] tiles filled by 16-byte
// cp.async, two stages ahead of the tensor cores. Each warp owns 16 rows of
// the segment in flight: mma.sync m16n8k16 with the database rows as A and
// 8 queries as each B tile (so a single query wastes 7/8 of a product, not
// 15/16), f32 accumulators over the columns. At the segment's last columns
// the warp masks rows >= n_valid, takes the max over its 16 rows with
// shuffles, and the eight warps' maxima meet in shared memory. A float32
// database takes `segmax_f32_kernel`, plain FMA (tests and small shapes).
// wgmma, TMA and a persistent grid are later work.
//
// Layouts (all contiguous): q [B, D] and db [N_pad, D] of one type
// (f32, bf16 or fp16), D a multiple of 8 (16-bit) or 4 (f32); out [B, N_pad/128].

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 128;                     // SEG
constexpr int kBlock = 2048;                  // BLOCK
constexpr int kSegsPerBlock = kBlock / kSeg;  // 16
constexpr int kWarps = 8;                     // each owns 16 rows of a segment
constexpr int kThreads = kWarps * 32;
constexpr int kKc = 128;                      // columns per stage
constexpr int kPad = 8;                       // elements of padding per shared row
constexpr int kStages = 3;
constexpr int kStageElems = kSeg * (kKc + kPad);
constexpr int kF32Queries = 8;                // queries per CTA of the FMA route
constexpr int kSmemCap = 227 * 1024;          // dynamic shared memory a block may use
constexpr float kNegInf = -1e30f;             // NEG_INF

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8x8 16-bit matrices; lane l gives the address of row l % 8 of matrix l / 8
// and receives, of each matrix, row lane / 4, columns 2 * (lane % 4) and +1:
// the mma.sync A / B fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max_over_rows(float v) {
  // lanes with the same lane % 4 hold the same query column of a C fragment
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// bytes of dynamic shared memory of segmax_mma_kernel<T, NT>
__host__ __device__ constexpr int mma_smem_bytes(int nt, int n_k) {
  return (8 * nt * (n_k * kKc + kPad) + kStages * kStageElems) * 2 + kWarps * 8 * nt * 4;
}

// ------------------------------------------------------------------ K11, 16-bit rows
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
    segmax_mma_kernel(const T* __restrict__ q, const T* __restrict__ db, float* __restrict__ out, int B,
                      int D, int n_valid, int n_seg) {
  constexpr int QG = 8 * NT;  // queries of this CTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_k = (D + kKc - 1) / kKc;
  const int qstride = n_k * kKc + kPad;  // elements per staged query row
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* ring = q_s + QG * qstride;
  float* red = reinterpret_cast<float*>(ring + kStages * kStageElems);  // [kWarps][QG]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.y * QG;
  const size_t row0 = size_t(blockIdx.x) * kBlock;
  const int n_steps = kSegsPerBlock * n_k;

  // stage `step` = segment step / n_k, columns (step % n_k) * kKc ..: 128 rows
  // x kKc / 8 sixteen-byte pieces, 8 per thread; columns >= D are zero-filled
  auto load_stage = [&](int step) {
    T* dst = ring + (step % kStages) * kStageElems;
    const T* src = db + (row0 + size_t(step / n_k) * kSeg) * D;
    const int k0 = (step % n_k) * kKc;
#pragma unroll
    for (int i = 0; i < kSeg * (kKc / 8) / kThreads; ++i) {
      const int p = tid + i * kThreads;
      const int r = p / (kKc / 8), c = (p % (kKc / 8)) * 8;
      const bool ok = k0 + c < D;
      cp_async16(dst + r * (kKc + kPad) + c, ok ? src + size_t(r) * D + k0 + c : src, ok);
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_stage(s);
    cp_async_commit();
  }

  // the group's queries, zero beyond B and D (their products are 0)
  const int pieces = n_k * kKc / 8;
  for (int p = tid; p < QG * pieces; p += kThreads) {
    const int r = p / pieces, c = (p % pieces) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + r < B && c < D) v = *reinterpret_cast<const uint4*>(q + size_t(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(q_s + r * qstride + c) = v;
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `step` landed; stage step - 1 is free to refill
    if (step + kStages - 1 < n_steps) load_stage(step + kStages - 1);
    cp_async_commit();

    const T* a_s = ring + (step % kStages) * kStageElems + (warp * 16 + (lane & 15)) * (kKc + kPad) +
                   (lane >> 4) * 8;
    const T* b_s = q_s + (step % n_k) * kKc + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kKc; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, a_s + kk);
#pragma unroll
      for (int j = 0; j + 1 < NT; j += 2) {  // two query tiles per ldmatrix
        uint32_t bq[4];
        ldmatrix_x4(bq, b_s + (j * 8 + (lane & 7) + (lane >> 4) * 8) * qstride + kk);
        Mma<T>::run(acc[j], a, bq[0], bq[1]);
        Mma<T>::run(acc[j + 1], a, bq[2], bq[3]);
      }
      if (NT % 2) {
        uint32_t bq[2];
        ldmatrix_x2(bq, b_s + ((NT - 1) * 8 + (lane & 7)) * qstride + kk);
        Mma<T>::run(acc[NT - 1], a, bq[0], bq[1]);
      }
    }

    if (step % n_k == n_k - 1) {  // the segment's last columns: mask, max, reduce
      const int seg = step / n_k;
      const size_t r_lo = row0 + size_t(seg) * kSeg + warp * 16 + (lane >> 2);
      const bool ok_lo = r_lo < size_t(n_valid), ok_hi = r_lo + 8 < size_t(n_valid);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float m0 = fmaxf(ok_lo ? acc[j][0] : kNegInf, ok_hi ? acc[j][2] : kNegInf);
        float m1 = fmaxf(ok_lo ? acc[j][1] : kNegInf, ok_hi ? acc[j][3] : kNegInf);
        m0 = warp_max_over_rows(m0);
        m1 = warp_max_over_rows(m1);
        if (lane < 4) {
          red[warp * QG + j * 8 + 2 * lane] = m0;
          red[warp * QG + j * 8 + 2 * lane + 1] = m1;
        }
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
      __syncthreads();
      if (tid < QG && q0 + tid < B) {
        float m = red[tid];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w * QG + tid]);
        out[size_t(q0 + tid) * n_seg + size_t(blockIdx.x) * kSegsPerBlock + seg] = m;
      }
      // the next write of `red` comes after the next step's __syncthreads
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ K11, f32 rows (FMA)
__global__ void __launch_bounds__(kThreads)
    segmax_f32_kernel(const float* __restrict__ q, const float* __restrict__ db, float* __restrict__ out,
                      int B, int D, int n_valid, int n_seg) {
  extern __shared__ __align__(16) float qf[];  // [kF32Queries][D]
  const int q0 = blockIdx.y * kF32Queries;
  for (int i = threadIdx.x; i < kF32Queries * D; i += kThreads) {
    const int r = i / D;
    qf[i] = q0 + r < B ? q[size_t(q0) * D + i] : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int seg = warp; seg < kSegsPerBlock; seg += kWarps) {
    const size_t base = size_t(blockIdx.x) * kBlock + size_t(seg) * kSeg;
    float acc[4][kF32Queries];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < kF32Queries; ++b) acc[i][b] = 0.f;
    for (int d = 0; d < D; d += 4) {  // lane owns rows lane, +32, +64, +96
      float4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(db + (base + lane + 32 * i) * D + d);
#pragma unroll
      for (int b = 0; b < kF32Queries; ++b) {
        const float4 qv = *reinterpret_cast<const float4*>(qf + b * D + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][b] = fmaf(x[i].x, qv.x, acc[i][b]);
          acc[i][b] = fmaf(x[i].y, qv.y, acc[i][b]);
          acc[i][b] = fmaf(x[i].z, qv.z, acc[i][b]);
          acc[i][b] = fmaf(x[i].w, qv.w, acc[i][b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kF32Queries; ++b) {
      float m = kNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (base + lane + 32 * i < size_t(n_valid)) m = fmaxf(m, acc[i][b]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0 && q0 + b < B)
        out[size_t(q0 + b) * n_seg + size_t(blockIdx.x) * kSegsPerBlock + seg] = m;
    }
  }
}

template <typename Kernel>
int configure(Kernel kernel) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap));
}

template <typename T, int NT>
int launch_mma(const T* q, const T* db, float* out, int B, int D, int n_pad, int n_valid, cudaStream_t s) {
  const int smem = mma_smem_bytes(NT, (D + kKc - 1) / kKc);
  static const int configured = configure(segmax_mma_kernel<T, NT>);
  if (configured) return configured;
  const dim3 grid(n_pad / kBlock, (B + 8 * NT - 1) / (8 * NT));
  segmax_mma_kernel<T, NT><<<grid, kThreads, smem, s>>>(q, db, out, B, D, n_valid, n_pad / kSeg);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_mma(const void* q, const void* db, float* out, int B, int D, int n_pad, int n_valid,
                 cudaStream_t s) {
  if (D % 8) return int(cudaErrorInvalidValue);
  // queries per CTA: the fewest 8-query tiles that hold B, at most 64, and
  // fewer where D leaves no room for them beside the ring
  const int n_k = (D + kKc - 1) / kKc;
  int nt = B <= 8 ? 1 : B <= 16 ? 2 : B <= 32 ? 4 : 8;
  while (nt > 1 && mma_smem_bytes(nt, n_k) > kSmemCap) nt /= 2;
  if (mma_smem_bytes(nt, n_k) > kSmemCap) return int(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  const T* dbt = static_cast<const T*>(db);
  switch (nt) {
    case 1: return launch_mma<T, 1>(qt, dbt, out, B, D, n_pad, n_valid, s);
    case 2: return launch_mma<T, 2>(qt, dbt, out, B, D, n_pad, n_valid, s);
    case 4: return launch_mma<T, 4>(qt, dbt, out, B, D, n_pad, n_valid, s);
    default: return launch_mma<T, 8>(qt, dbt, out, B, D, n_pad, n_valid, s);
  }
}

int launch_f32(const float* q, const float* db, float* out, int B, int D, int n_pad, int n_valid,
               cudaStream_t s) {
  if (D % 4) return int(cudaErrorInvalidValue);
  const int smem = kF32Queries * D * 4;
  if (smem > kSmemCap) return int(cudaErrorInvalidValue);
  static const int configured = configure(segmax_f32_kernel);
  if (configured) return configured;
  const dim3 grid(n_pad / kBlock, (B + kF32Queries - 1) / kF32Queries);
  segmax_f32_kernel<<<grid, kThreads, smem, s>>>(q, db, out, B, D, n_valid, n_pad / kSeg);
  return int(cudaGetLastError());
}

}  // namespace

// K11: segment maxima [B, n_pad / 128] f32 of q [B, D] against db [n_pad, D].
// dtype: 0 f32, 1 bf16, 2 fp16. n_pad a multiple of 2048, 0 <= n_valid.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int fused_segmax_scan(const void* q, const void* db, float* out, int B, int D, int n_pad,
                                 int n_valid, int dtype, void* stream) {
  if (B <= 0 || D <= 0 || n_pad <= 0 || n_pad % kBlock || n_valid < 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_f32(static_cast<const float*>(q), static_cast<const float*>(db), out, B, D, n_pad, n_valid, s);
    case kBF16:
      return dispatch_mma<__nv_bfloat16>(q, db, out, B, D, n_pad, n_valid, s);
    case kF16:
      return dispatch_mma<__half>(q, db, out, B, D, n_pad, n_valid, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
