// K6, K7, K8 and K9: the decode and prefill matmuls of int8, int4 (or bf16)
// reader weights, and K10, the int8 FFN tail of the encoder, for Hopper
// (sm_90a), plain C interface.
//
// Replaces five Pallas TPU kernels of retrieval_scaling_tpu/ops/quant_matmul.py:
//   * K6 `_w8_decode_kernel` (pallas_call in `_int8_decode_stream_jit`):
//       y = bf16(x) @ bf16(W) * scale[n], f32 sums, m <= 128 rows;
//     with two inputs (`q8_dual_in_dot`) the column blocks below n_split read
//     x1 and the others x2;
//   * K7 `_w8_splitk_kernel` (pallas_call in `_w8_splitk_stream_jit`):
//       y = xa @ Wa * sa + xb @ Wb * sb from one row-concatenated [Wa; Wb];
//   * K9 `_int8_matmul_kernel` (both pallas_calls of `_int8_matmul_jit`):
//       y = act(int32(rowquant(x) . Wq) * row_scale * scale[n] + bias[n]);
//   * K8 `_int4_decode_kernel` (pallas_call in `int4_decode_matmul`):
//       y = row_scale * sum_g scale[g, n] * int32(rowquant(x)[:, g] . W4[g])
//     over K groups g of 128 rows, W4 in [-7, 7] packed two per byte;
//   * K10 `_int8_res_ln_kernel` (pallas_call in `_int8_res_ln_jit`):
//       y = LayerNorm(int32(rowquant(h) . Wq) * row_scale * scale[n] + bias[n]
//                     + x) * gamma + beta.
//
// What bounds them on this card. K6/K7 at decode (m = 8 to 64 rows) do
// 2m flops per weight byte (int8) or m per byte (bf16): far below the H100's
// ~295 flop/byte ridge, so they are bound by the weight stream (Pythia-1B's
// qkv|mlp_in block, 29.4 MB int8, is 8.8 us at 3.35 TB/s). The design streams
// W once: each CTA owns 64 output columns and a K range, and a 3-stage
// cp.async ring of [64 x 64] weight tiles (16-byte copies) and [m x 64] bf16
// activation tiles keeps copies in flight while the tensor cores (mma.sync
// m16n8k16 bf16, f32 accumulate) consume the previous stage. int8 weights are
// widened to bf16 (exact) as the B fragments are built from shared memory.
// N = 2048 (K7's attn_out|mlp_out) gives only 32 column blocks, so K is split
// across CTAs until about 264 run (two per SM): each split writes f32 partials
// times its part's scale, and a second small kernel sums the splits in a fixed
// order and casts. The TPU's resident 32-row activation block, its sublane
// padding and the stacked dual-input rows are not needed: the dual input is a
// per-column-block choice of the A operand.
//
// K9 runs at prefill (m > 128): 2 ops per weight element and row, so at
// m = 1024 it is bound by int8 tensor-core work (60 GOP for qkv|mlp_in, 30 us
// at 1,979 TOP/s). A pre-pass quantises each row of x (absmax, round to nearest
// even, the JAX arithmetic in f32), then a tiled GEMM (64 x 64 CTA tile, four
// warps of 32 x 32, 3-stage cp.async ring) runs mma.sync m16n8k32 s8 x s8 ->
// s32 and applies row scale, column scale, bias and the activation in f32
// (no fused multiply-add, so the result equals the plain version's bit for
// bit before the activation). mma.sync, not wgmma/TMA: later work.
//
// K8 (W4A8, group-128 scales) is built for decode like K6: at m = 8 it does
// 32 int8 ops per packed weight byte, far below the card's int8 ridge, so it
// is bound by the packed stream (Llama-3.1-8B's gate_w, 29.4 MB packed plus
// 1.8 MB of scales, is 9.3 us at 3.35 TB/s). The JAX layout is kept: byte
// [r, n] of the [K/2, N] array holds row r (low nibble) and row r + K/2 (high
// nibble) as value + 8, so the two nibbles of one byte belong to groups r/128
// and (r + K/2)/128. A CTA owns 64 columns, up to 64 rows of x and a range of
// packed rows; a 3-stage cp.async ring brings [64 x 64] packed tiles (16-byte
// copies) and, for each, the two [rows x 64] int8 activation tiles that the
// low and the high nibbles multiply. Each byte read from shared memory is
// unpacked in registers into an s8 B fragment for the low rows and one for
// the high rows ((v | 0x80) - 8) ^ 0x80 per byte), and mma.sync m16n8k32
// s8 x s8 -> s32 runs on both. The int32 sums of a group are exact; when the
// group's rows are done they become f32 and are added as acc += part * scale[g]
// (no fused multiply-add). Order of the f32 sums: within a CTA, groups in the
// order their last tile arrives (low and high interleaved), then the K
// splits in order; the plain version sums groups 0..G-1, so the two agree to
// rounding (the stated limit is 1e-5 of max |y|). Split-K as in K6 where N is
// small; every m runs here (prefill and scoring too, in chunks of 64 rows on
// the third grid axis): the JAX package's XLA route above 128 rows was a VMEM
// limit. The row quantisation pre-pass is K9's.
//
// K10 is the BERT FFN's output projection (h [m, 3072] -> [m, 768] at
// BERT-base) with the residual add and the LayerNorm in its epilogue. At the
// encoder's m = 2048 x 256 rows the function moves 4.8 GB (h in bf16, x and
// y) and does 2.4 T int8 ops: 1.44 ms of memory and 1.25 ms of tensor-core
// work at the card's peaks, so it must keep y on the chip and its products
// on the tensor cores. A LayerNorm needs whole rows, so a CTA owns 32 rows and
// ALL N output columns (eight warps of 32 rows x N/8 columns, the int32 sums
// in registers: 96 a thread at N = 768), and the row mean and variance never
// leave the chip, as on the TPU. The weight comes transposed ([N, K], made
// once when the model is quantized, 2.4 MB at BERT-base) so that its B
// fragments load with ldmatrix like the A fragments; a 3-stage cp.async ring (2 at N = 1,024)
// brings [32 x 64] h tiles and [N x 64] weight tiles. Every CTA reads the whole weight (from
// L2: 16,384 CTAs x 2.4 MB at m = 2048 x 256), which is what a 32-row tile
// costs; wider tiles need the weight shared across CTAs (clusters, TMA
// multicast): later work. The epilogue runs in f32 with the plain version's
// operation order (no fused multiply-add): (acc * row_scale) * scale + bias +
// x, the mean, the mean of (y - mean)^2 (two passes over the row in
// registers, not E[y^2] - E[y]^2), then (y - mean) * rsqrt(var + eps) * gamma
// + beta, cast to x's dtype. N takes 128 to 1,024 columns (the encoders'
// widths); a reader-width N does not fit one CTA and is refused.
//
// Layouts: W is [K, N] row-major (the JAX package's), given by its row stride;
// x is [m, K] row-major (bf16 for K6/K7, f32/bf16/f16 for K9 and K8). K10
// takes h [m, K], x [m, N] and out [m, N] contiguous.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kMaxSplits = 64;
// streaming kernels (K6/K7)
constexpr int kBK = 64;   // K rows per stage
constexpr int kBN = 64;   // output columns per CTA (16 per warp)
constexpr int kXLD = kBK + 8;  // bf16 elements per staged activation row
// K9
constexpr int kGM = 64, kGN = 64, kGK = 64;
constexpr int kGLD = kGK + 16;  // bytes per staged row (A and B tiles)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat16 as_bf16(int8_t v) { return __float2bfloat16_rn(float(v)); }
__device__ __forceinline__ __nv_bfloat16 as_bf16(__nv_bfloat16 v) { return v; }

// store a pair of f32 values in the output kind: 0 f32, 1 bf16, 2 f16
__device__ __forceinline__ void store2(void* out, size_t idx, float a, float b, int kind) {
  if (kind == 0) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(a, b);
  } else if (kind == 1) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + idx) = __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<__half2*>(static_cast<__half*>(out) + idx) = __floats2half2_rn(a, b);
  }
}

__device__ __forceinline__ float load1(const void* p, size_t idx, int kind) {
  if (kind == 0) return static_cast<const float*>(p)[idx];
  if (kind == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[idx]);
  return __half2float(static_cast<const __half*>(p)[idx]);
}

// ------------------------------------------------------------------ K6 / K7
struct StreamParams {
  const __nv_bfloat16* xa;  // [m, K] activations of column blocks < n_split
  const __nv_bfloat16* xb;  // [m, K] activations of the other column blocks
  const void* w;            // [K, N] int8 or bf16, row stride ldw
  const float* sa;          // [N] scale of K part 0
  const float* sb;          // [N] scale of K part 1
  float* part;              // [n_splits, m, N] f32 partial sums (scaled)
  int m, K, N, ldw, n_split;
  int split_begin[kMaxSplits], split_end[kMaxSplits], split_part[kMaxSplits];
};

template <typename TW, int MT>
__global__ void __launch_bounds__(kThreads) w8_stream_kernel(const __grid_constant__ StreamParams p) {
  constexpr int WROW = kBN * int(sizeof(TW)) + 16;  // bytes per staged weight row
  constexpr int XSTAGE = MT * 16 * kXLD;            // bf16 elements per activation stage
  constexpr int WSTAGE = kBK * WROW;                // bytes per weight stage
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ws = smem + kStages * XSTAGE * sizeof(__nv_bfloat16);

  const int n0 = blockIdx.x * kBN;
  const int z = blockIdx.y;
  const int kb = p.split_begin[z], ke = p.split_end[z];
  const __nv_bfloat16* x = n0 < p.n_split ? p.xa : p.xb;
  const float* scale = p.split_part[z] == 0 ? p.sa : p.sb;
  const unsigned char* wg = static_cast<const unsigned char*>(p.w);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m = p.m, N = p.N, K = p.K;
  const long long ldw_bytes = (long long)p.ldw * sizeof(TW);

  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* xd = xs + stage * XSTAGE;
    // activation tile [MT*16, kBK]: 8 chunks of 16 bytes per row
    for (int c = tid; c < MT * 16 * 8; c += kThreads) {
      const int r = c >> 3, col = (c & 7) * 8;
      const bool valid = r < m;
      cp_async16(xd + r * kXLD + col, valid ? x + (size_t)r * K + k0 + col : x, valid);
    }
    // weight tile [kBK, kBN]
    constexpr int CPR = kBN * int(sizeof(TW)) / 16;  // chunks per row
    unsigned char* wd = ws + stage * WSTAGE;
    for (int c = tid; c < kBK * CPR; c += kThreads) {
      const int r = c / CPR, cb = (c % CPR) * 16;
      const int col = n0 + cb / int(sizeof(TW));
      const bool valid = col < N;
      cp_async16(wd + r * WROW + cb, valid ? wg + (k0 + r) * ldw_bytes + (long long)col * sizeof(TW) : wg, valid);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int n_kt = (ke - kb) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_stage(s, kb + s * kBK);
    cp_async_commit();
  }
  const int lm = lane >> 3, lr = lane & 7;
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < n_kt) load_stage(nk % kStages, kb + nk * kBK);
    cp_async_commit();

    const __nv_bfloat16* xd = xs + (kt % kStages) * XSTAGE;
    const unsigned char* wd = ws + (kt % kStages) * WSTAGE;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = warp * 16 + nt * 8 + g;
        const TW* r0 = reinterpret_cast<const TW*>(wd + (kk + 2 * t) * WROW) + c;
        const TW* r1 = reinterpret_cast<const TW*>(wd + (kk + 2 * t + 1) * WROW) + c;
        const TW* r8 = reinterpret_cast<const TW*>(wd + (kk + 2 * t + 8) * WROW) + c;
        const TW* r9 = reinterpret_cast<const TW*>(wd + (kk + 2 * t + 9) * WROW) + c;
        b[nt][0] = pack_bf16(as_bf16(*r0), as_bf16(*r1));
        b[nt][1] = pack_bf16(as_bf16(*r8), as_bf16(*r9));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, xd + (mt * 16 + (lm & 1) * 8 + lr) * kXLD + kk + (lm >> 1) * 8);
        mma_bf16(acc[mt][0], a, b[0][0], b[0][1]);
        mma_bf16(acc[mt][1], a, b[1][0], b[1][1]);
      }
    }
  }
  cp_async_wait<0>();

  float* part = p.part + (size_t)z * m * N;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int c = n0 + warp * 16 + nt * 8 + 2 * t;
    if (c >= N) continue;
    const float s0 = scale[c], s1 = scale[c + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int ra = mt * 16 + g, rb = ra + 8;
      if (ra < m)
        *reinterpret_cast<float2*>(part + (size_t)ra * N + c) = make_float2(acc[mt][nt][0] * s0, acc[mt][nt][1] * s1);
      if (rb < m)
        *reinterpret_cast<float2*>(part + (size_t)rb * N + c) = make_float2(acc[mt][nt][2] * s0, acc[mt][nt][3] * s1);
    }
  }
}

// out[i] = sum over splits of part[z][i] (z ascending), in the output kind
__global__ void split_sum_kernel(const float* part, void* out, int n_splits, size_t n_pairs, int kind) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n_pairs; i += (size_t)gridDim.x * blockDim.x) {
    float2 s = reinterpret_cast<const float2*>(part)[i];
    for (int z = 1; z < n_splits; ++z) {
      const float2 v = reinterpret_cast<const float2*>(part + (size_t)z * n_pairs * 2)[i];
      s.x += v.x;
      s.y += v.y;
    }
    store2(out, 2 * i, s.x, s.y, kind);
  }
}

template <typename TW, int MT>
int launch_stream(const StreamParams& p, int n_splits, cudaStream_t stream) {
  constexpr size_t smem = size_t(kStages) * (MT * 16 * kXLD * 2 + kBK * (kBN * sizeof(TW) + 16));
  auto kernel = w8_stream_kernel<TW, MT>;
  // set once per instantiation: above 48 KB a kernel needs the attribute
  static const cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (configured != cudaSuccess) return int(configured);
  dim3 grid((p.N + kBN - 1) / kBN, n_splits);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename TW>
int dispatch_mt(const StreamParams& p, int n_splits, cudaStream_t stream) {
  const int mt = (p.m + 15) / 16;
  if (mt <= 1) return launch_stream<TW, 1>(p, n_splits, stream);
  if (mt <= 2) return launch_stream<TW, 2>(p, n_splits, stream);
  if (mt <= 4) return launch_stream<TW, 4>(p, n_splits, stream);
  if (mt <= 8) return launch_stream<TW, 8>(p, n_splits, stream);
  return int(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------ K9
// one CTA per row: absmax over K, then round(x * (127 / absmax)) to int8
__global__ void rowquant_kernel(const void* x, int8_t* xq, float* row_scale, int K, int kind) {
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * K;
  float mx = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x) mx = fmaxf(mx, fabsf(load1(x, base + i, kind)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x < 32) {
    mx = threadIdx.x < blockDim.x / 32 ? red[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (threadIdx.x == 0) red[0] = mx;
  }
  __syncthreads();
  const float absmax = fmaxf(red[0], 1e-12f);
  const float inv = __fdiv_rn(127.0f, absmax);
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    xq[base + i] = static_cast<int8_t>(rintf(__fmul_rn(load1(x, base + i, kind), inv)));
  if (threadIdx.x == 0) row_scale[blockIdx.x] = __fdiv_rn(absmax, 127.0f);
}

struct GemmParams {
  const int8_t* xq;        // [m, K]
  const int8_t* w;         // [K, N], row stride ldw
  const float* row_scale;  // [m]
  const float* scale;      // [N]
  const float* bias;       // [N] or null
  void* out;               // [m, N]
  int m, K, N, ldw, activation, out_kind;
};

__device__ __forceinline__ float activate(float v, int activation) {
  // the operation order of PyTorch's CUDA gelu, so both round alike
  if (activation == 1) {
    const float cube = v * v * v;
    const float inner = 0.7978845608028654f * (v + 0.044715f * cube);
    return 0.5f * v * (1.f + tanhf(inner));
  }
  if (activation == 2) return v * 0.5f * (1.f + erff(v * 0.7071067811865476f));
  return v;
}

__global__ void __launch_bounds__(kThreads) int8_gemm_kernel(const __grid_constant__ GemmParams p) {
  __shared__ __align__(16) int8_t As[kStages][kGM * kGLD];
  __shared__ __align__(16) int8_t Bs[kStages][kGK * kGLD];
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps of 32 x 32
  const int m = p.m, N = p.N, K = p.K;

  auto load_stage = [&](int stage, int k0) {
    for (int c = tid; c < kGM * 4; c += kThreads) {  // A: 64 rows x 4 chunks
      const int r = c >> 2, cb = (c & 3) * 16;
      const bool valid = m0 + r < m;
      cp_async16(&As[stage][r * kGLD + cb], valid ? p.xq + (size_t)(m0 + r) * K + k0 + cb : p.xq, valid);
    }
    for (int c = tid; c < kGK * 4; c += kThreads) {  // B: 64 k rows x 4 chunks of columns
      const int r = c >> 2, cb = (c & 3) * 16;
      const bool valid = n0 + cb < N;
      cp_async16(&Bs[stage][r * kGLD + cb], valid ? p.w + (size_t)(k0 + r) * p.ldw + n0 + cb : p.w, valid);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int n_kt = K / kGK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_stage(s, s * kGK);
    cp_async_commit();
  }
  const int lm = lane >> 3, lr = lane & 7;
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < n_kt) load_stage(nk % kStages, nk * kGK);
    cp_async_commit();
    const int8_t* a_s = As[kt % kStages];
    const int8_t* b_s = Bs[kt % kStages];
#pragma unroll
    for (int ks = 0; ks < kGK; ks += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], a_s + (wm * 32 + mt * 16 + (lm & 1) * 8 + lr) * kGLD + ks + (lm >> 1) * 16);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + g;
        uint32_t b0 = 0, b1 = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          b0 |= uint32_t(uint8_t(b_s[(ks + 4 * t + i) * kGLD + c])) << (8 * i);
          b1 |= uint32_t(uint8_t(b_s[(ks + 16 + 4 * t + i) * kGLD + c])) << (8 * i);
        }
        mma_s8(acc[0][nt], a[0], b0, b1);
        mma_s8(acc[1][nt], a[1], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = n0 + wn * 32 + nt * 8 + 2 * t;
    if (c >= N) continue;
    const float cs0 = p.scale[c], cs1 = p.scale[c + 1];
    const float b0 = p.bias ? p.bias[c] : 0.f, b1 = p.bias ? p.bias[c + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm * 32 + mt * 16 + g + half * 8;
        if (r >= m) continue;
        const float rs = p.row_scale[r];
        float v0 = __fmul_rn(__fmul_rn(float(acc[mt][nt][2 * half]), rs), cs0);
        float v1 = __fmul_rn(__fmul_rn(float(acc[mt][nt][2 * half + 1]), rs), cs1);
        if (p.bias) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        store2(p.out, (size_t)r * N + c, activate(v0, p.activation), activate(v1, p.activation), p.out_kind);
      }
    }
  }
}

// ------------------------------------------------------------------ K8
constexpr int kQBK = 64;            // packed rows per stage: 64 low and 64 high rows of W
constexpr int kQXLD = kQBK + 16;    // bytes per staged activation row
constexpr int kQWLD = kBN + 16;     // bytes per staged packed row

struct Int4Params {
  const int8_t* xq;        // [m, K] row-quantised activations
  const float* row_scale;  // [m]
  const uint8_t* w;        // [K/2, N] packed nibbles, row stride ldw bytes
  const float* scale;      // [K/128, N] group scales, row stride lds
  float* part;             // [n_splits, m, N] f32 partials, or null: write out directly
  void* out;               // [m, N]
  int m, K, N, ldw, lds, out_kind;
  int split_begin[kMaxSplits], split_end[kMaxSplits];  // packed-row ranges
};

// four offset nibbles (0..15, one per byte) -> four s8 values in [-8, 7]
__device__ __forceinline__ uint32_t nibbles_to_s8(uint32_t v) {
  return ((v | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

template <int MT>
__global__ void __launch_bounds__(kThreads) int4_gemm_kernel(const __grid_constant__ Int4Params p) {
  constexpr int XTILE = MT * 16 * kQXLD;  // bytes of one activation tile
  constexpr int XSTAGE = 2 * XTILE;       // the low and the high tile
  constexpr int WSTAGE = kQBK * kQWLD;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);
  unsigned char* ws = smem + kStages * XSTAGE;

  const int n0 = blockIdx.x * kBN, z = blockIdx.y, m0 = blockIdx.z * MT * 16;
  const int kb = p.split_begin[z], ke = p.split_end[z];
  const int m = p.m, N = p.N, K = p.K, K2 = p.K / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  auto load_stage = [&](int stage, int r0) {  // packed rows [r0, r0 + kQBK)
    int8_t* xd = xs + stage * XSTAGE;
    // activation columns [r0, r0 + 64) (low rows) and [K2 + r0, ...) (high rows)
    for (int c = tid; c < 2 * MT * 16 * 4; c += kThreads) {
      const int half = c / (MT * 64), rc = c % (MT * 64);
      const int r = rc >> 2, cb = (rc & 3) * 16;
      const bool valid = m0 + r < m;
      const int8_t* src = p.xq + (size_t)(m0 + r) * K + half * K2 + r0 + cb;
      cp_async16(xd + half * XTILE + r * kQXLD + cb, valid ? src : p.xq, valid);
    }
    unsigned char* wd = ws + stage * WSTAGE;
    for (int c = tid; c < kQBK * (kBN / 16); c += kThreads) {
      const int r = c / (kBN / 16), cb = (c % (kBN / 16)) * 16;
      const bool valid = n0 + cb < N;
      cp_async16(wd + r * kQWLD + cb, valid ? p.w + (size_t)(r0 + r) * p.ldw + n0 + cb : p.w, valid);
    }
  };

  int acc_lo[MT][2][4], acc_hi[MT][2][4];
  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_lo[i][j][e] = acc_hi[i][j][e] = 0;
        acc[i][j][e] = 0.f;
      }

  // a group's exact int32 sums -> acc += float(sum) * scale[grp] (two roundings)
  auto flush = [&](int (&ai)[MT][2][4], int grp) {
    const float* srow = p.scale + (size_t)grp * p.lds;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = n0 + warp * 16 + nt * 8 + 2 * t;
      const float s0 = c < N ? srow[c] : 0.f, s1 = c < N ? srow[c + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], __fmul_rn(float(ai[mt][nt][e]), (e & 1) ? s1 : s0));
          ai[mt][nt][e] = 0;
        }
    }
  };

  const int n_kt = (ke - kb) / kQBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_stage(s, kb + s * kQBK);
    cp_async_commit();
  }
  const int lm = lane >> 3, lr = lane & 7;
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < n_kt) load_stage(nk % kStages, kb + nk * kQBK);
    cp_async_commit();

    const int8_t* x_lo = xs + (kt % kStages) * XSTAGE;
    const int8_t* x_hi = x_lo + XTILE;
    const unsigned char* wd = ws + (kt % kStages) * WSTAGE;
#pragma unroll
    for (int ks = 0; ks < kQBK; ks += 32) {
      uint32_t b_lo[2][2], b_hi[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = warp * 16 + nt * 8 + g;
        uint32_t u0 = 0, u1 = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          u0 |= uint32_t(wd[(ks + 4 * t + i) * kQWLD + c]) << (8 * i);
          u1 |= uint32_t(wd[(ks + 16 + 4 * t + i) * kQWLD + c]) << (8 * i);
        }
        b_lo[nt][0] = nibbles_to_s8(u0 & 0x0F0F0F0Fu);
        b_lo[nt][1] = nibbles_to_s8(u1 & 0x0F0F0F0Fu);
        b_hi[nt][0] = nibbles_to_s8((u0 >> 4) & 0x0F0F0F0Fu);
        b_hi[nt][1] = nibbles_to_s8((u1 >> 4) & 0x0F0F0F0Fu);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a_lo[4], a_hi[4];
        const int off = (mt * 16 + (lm & 1) * 8 + lr) * kQXLD + ks + (lm >> 1) * 16;
        ldmatrix_x4(a_lo, x_lo + off);
        ldmatrix_x4(a_hi, x_hi + off);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_s8(acc_lo[mt][nt], a_lo, b_lo[nt][0], b_lo[nt][1]);
          mma_s8(acc_hi[mt][nt], a_hi, b_hi[nt][0], b_hi[nt][1]);
        }
      }
    }
    // a group's rows are done when its last tile has arrived (or the split ends)
    const int r0 = kb + kt * kQBK;
    const bool last = kt == n_kt - 1;
    if (last || (r0 + kQBK) % 128 == 0) flush(acc_lo, r0 / 128);
    if (last || (K2 + r0 + kQBK) % 128 == 0) flush(acc_hi, (K2 + r0) / 128);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int c = n0 + warp * 16 + nt * 8 + 2 * t;
    if (c >= N) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + mt * 16 + g + half * 8;
        if (r >= m) continue;
        const float rs = p.row_scale[r];
        const float v0 = __fmul_rn(acc[mt][nt][2 * half], rs), v1 = __fmul_rn(acc[mt][nt][2 * half + 1], rs);
        if (p.part)
          *reinterpret_cast<float2*>(p.part + ((size_t)z * m + r) * N + c) = make_float2(v0, v1);
        else
          store2(p.out, (size_t)r * N + c, v0, v1, p.out_kind);
      }
    }
  }
}

template <int MT>
int launch_int4(const Int4Params& p, int n_splits, cudaStream_t stream) {
  constexpr size_t smem = size_t(kStages) * (2 * MT * 16 * kQXLD + kQBK * kQWLD);
  auto kernel = int4_gemm_kernel<MT>;
  static const cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (configured != cudaSuccess) return int(configured);
  dim3 grid((p.N + kBN - 1) / kBN, n_splits, (p.m + MT * 16 - 1) / (MT * 16));
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}


// ------------------------------------------------------------------ K10
constexpr int kRBM = 32;             // rows per CTA
constexpr int kRBK = 64;             // K per stage (two m16n8k32 steps)
constexpr int kRLD = kRBK + 16;      // bytes per staged row: 80, the 8 rows of an ldmatrix in distinct banks
constexpr int kRWarps = 8;
// stages of the cp.async ring: as many as 227 KB of shared memory hold
template <int NT>
__host__ __device__ constexpr int res_ln_stages() { return 64 * NT <= 768 ? 3 : 2; }
constexpr int kRThreads = kRWarps * 32;

struct ResLnParams {
  const int8_t* hq;        // [m, K] row-quantised FFN hidden
  const float* row_scale;  // [m]
  const int8_t* wt;        // [N, K] transposed weight
  const float* scale;      // [N]
  const float* bias;       // [N]
  const void* x;           // [m, N] residual, kind x_kind
  const float* gamma;      // [N]
  const float* beta;       // [N]
  void* out;               // [m, N], kind x_kind
  int m, K, N, x_kind;
  float eps;
};

template <int NT>  // n-tiles of 8 columns per warp: N = 64 * NT
__global__ void __launch_bounds__(kRThreads) int8_res_ln_kernel(const __grid_constant__ ResLnParams p) {
  constexpr int N = 64 * NT;
  constexpr int kStageBytes = (kRBM + N) * kRLD;
  constexpr int kRStages = res_ln_stages<NT>();
  extern __shared__ __align__(16) int8_t rsm[];
  __shared__ float red[kRWarps][kRBM];
  const int m0 = blockIdx.x * kRBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int m = p.m, K = p.K;
  const int nbase = warp * NT * 8;

  auto load_stage = [&](int stage, int k0) {
    int8_t* a_s = rsm + stage * kStageBytes;
    int8_t* b_s = a_s + kRBM * kRLD;
    for (int c = tid; c < (kRBM + N) * (kRBK / 16); c += kRThreads) {  // 16-byte chunks: four per row
      const int r = c / (kRBK / 16), cb = (c % (kRBK / 16)) * 16;
      if (r < kRBM) {
        const bool valid = m0 + r < m;
        cp_async16(a_s + r * kRLD + cb, valid ? p.hq + (size_t)(m0 + r) * K + k0 + cb : p.hq, valid);
      } else {
        const int n = r - kRBM;
        cp_async16(b_s + n * kRLD + cb, p.wt + (size_t)n * K + k0 + cb, true);
      }
    }
  };

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int n_kt = K / kRBK;
#pragma unroll
  for (int s = 0; s < kRStages - 1; ++s) {
    if (s < n_kt) load_stage(s, s * kRBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kRStages - 2>();
    __syncthreads();
    const int nk = kt + kRStages - 1;
    if (nk < n_kt) load_stage(nk % kRStages, nk * kRBK);
    cp_async_commit();
    const int8_t* a_s = rsm + (kt % kRStages) * kStageBytes;
    const int8_t* b_s = a_s + kRBM * kRLD;
#pragma unroll
    for (int ks = 0; ks < kRBK; ks += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], a_s + (mt * 16 + (lm & 1) * 8 + lr) * kRLD + ks + (lm >> 1) * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {  // n-tiles 2np and 2np + 1: rows of the transposed weight
        uint32_t bf[4];
        ldmatrix_x4(bf, b_s + (nbase + np * 16 + (lm >> 1) * 8 + lr) * kRLD + ks + (lm & 1) * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(acc[mt][2 * np], a[mt], bf[0], bf[1]);
          mma_s8(acc[mt][2 * np + 1], a[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // y = (acc * row_scale) * scale + bias + x in f32, in place of the sums.
  // This thread holds rows mt * 16 + half * 8 + g (four of them) and, of
  // each, columns nbase + nt * 8 + 2t and + 1.
  float y[2][NT][4];
  float rsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + mt * 16 + half * 8 + g;
      const bool live = r < m;
      const float rs = live ? p.row_scale[r] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nbase + nt * 8 + 2 * t;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v = __fmul_rn(__fmul_rn(float(acc[mt][nt][2 * half + j]), rs), p.scale[c + j]);
          v = __fadd_rn(__fadd_rn(v, p.bias[c + j]), live ? load1(p.x, (size_t)r * N + c + j, p.x_kind) : 0.f);
          y[mt][nt][2 * half + j] = v;
          rsum[mt][half] += v;
        }
      }
    }
  }
  // row sums over the CTA: the four threads of a row in the warp, then the
  // eight warps in a fixed order
  auto row_total = [&](float (&part)[2][2], float (&total)[2][2]) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = part[mt][half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) red[warp][mt * 16 + half * 8 + g] = v;
      }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kRWarps; ++w) v += red[w][mt * 16 + half * 8 + g];
        total[mt][half] = v;
      }
    __syncthreads();  // red is reused
  };
  float mean[2][2], var[2][2];
  row_total(rsum, mean);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mean[mt][half] = __fdiv_rn(mean[mt][half], float(N));
      float sq = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float d = __fsub_rn(y[mt][nt][2 * half + j], mean[mt][half]);
          sq += __fmul_rn(d, d);
        }
      rsum[mt][half] = sq;
    }
  row_total(rsum, var);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + mt * 16 + half * 8 + g;
      if (r >= m) continue;
      const float inv = rsqrtf(__fadd_rn(__fdiv_rn(var[mt][half], float(N)), p.eps));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nbase + nt * 8 + 2 * t;
        float o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float d = __fsub_rn(y[mt][nt][2 * half + j], mean[mt][half]);
          o[j] = __fadd_rn(__fmul_rn(__fmul_rn(d, inv), p.gamma[c + j]), p.beta[c + j]);
        }
        store2(p.out, (size_t)r * N + c, o[0], o[1], p.x_kind);
      }
    }
}

template <int NT>
int launch_res_ln(const ResLnParams& p, cudaStream_t stream) {
  constexpr size_t smem = size_t(res_ln_stages<NT>()) * (kRBM + 64 * NT) * kRLD;
  auto kernel = int8_res_ln_kernel<NT>;
  // set once per instantiation: above 48 KB a kernel needs the attribute
  static const cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (configured != cudaSuccess) return int(configured);
  kernel<<<(p.m + kRBM - 1) / kRBM, kRThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// K6 / K7. `table` holds n_splits triples (k_begin, k_end, part); each range
// is a multiple of 64 rows long. Returns the CUDA error code of the launches.
extern "C" int w8_stream(const void* xa, const void* xb, const void* w, const void* sa, const void* sb,
                         void* part, void* out, int m, int K, int N, int ldw, int n_split, int w_is_int8,
                         int out_kind, int n_splits, const int* table, void* stream) {
  if (m <= 0 || m > 128 || K <= 0 || N <= 0 || N % 16 || n_splits <= 0 || n_splits > kMaxSplits)
    return int(cudaErrorInvalidValue);
  StreamParams p;
  p.xa = static_cast<const __nv_bfloat16*>(xa);
  p.xb = static_cast<const __nv_bfloat16*>(xb);
  p.w = w;
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.part = static_cast<float*>(part);
  p.m = m;
  p.K = K;
  p.N = N;
  p.ldw = ldw;
  p.n_split = n_split;
  for (int z = 0; z < n_splits; ++z) {
    p.split_begin[z] = table[3 * z];
    p.split_end[z] = table[3 * z + 1];
    p.split_part[z] = table[3 * z + 2];
    if ((p.split_end[z] - p.split_begin[z]) % kBK) return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = w_is_int8 ? dispatch_mt<int8_t>(p, n_splits, s) : dispatch_mt<__nv_bfloat16>(p, n_splits, s);
  if (err != 0) return err;
  const size_t n_pairs = (size_t)m * N / 2;
  const int blocks = int((n_pairs + 255) / 256 < 1024 ? (n_pairs + 255) / 256 : 1024);
  split_sum_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(part), out, n_splits, n_pairs, out_kind);
  return int(cudaGetLastError());
}

// K9 pre-pass: xq [m, K] int8 and row_scale [m] f32 from x [m, K] of kind
// x_kind (0 f32, 1 bf16, 2 f16).
extern "C" int int8_rowquant(const void* x, void* xq, void* row_scale, int m, int K, int x_kind, void* stream) {
  if (m <= 0 || K <= 0) return int(cudaErrorInvalidValue);
  rowquant_kernel<<<m, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<int8_t*>(xq), static_cast<float*>(row_scale), K, x_kind);
  return int(cudaGetLastError());
}

// K9 GEMM: activation 0 none, 1 gelu_tanh, 2 gelu_exact; bias may be null.
extern "C" int int8_gemm(const void* xq, const void* w, const void* row_scale, const void* scale,
                         const void* bias, void* out, int m, int K, int N, int ldw, int activation,
                         int out_kind, void* stream) {
  if (m <= 0 || K <= 0 || K % kGK || N <= 0 || N % 16) return int(cudaErrorInvalidValue);
  GemmParams p;
  p.xq = static_cast<const int8_t*>(xq);
  p.w = static_cast<const int8_t*>(w);
  p.row_scale = static_cast<const float*>(row_scale);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.m = m;
  p.K = K;
  p.N = N;
  p.ldw = ldw;
  p.activation = activation;
  p.out_kind = out_kind;
  dim3 grid((N + kGN - 1) / kGN, (m + kGM - 1) / kGM);
  int8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

// K8 GEMM after the K9 row-quantisation pre-pass: xq [m, K] int8, row_scale
// [m], w [K/2, N] packed (row stride ldw bytes), scale [K/128, N] (row stride
// lds). `table` holds n_splits packed-row ranges (begin, end), multiples of
// 64; with one split the kernel writes `out` directly, with more it writes
// f32 partials to `part` ([n_splits, m, N]) and a second kernel sums them in
// split order. Returns the CUDA error code of the launches.
extern "C" int int4_gemm(const void* xq, const void* row_scale, const void* w, const void* scale, void* part,
                         void* out, int m, int K, int N, int ldw, int lds, int out_kind, int n_splits,
                         const int* table, void* stream) {
  if (m <= 0 || K <= 0 || K % 128 || N <= 0 || N % 16 || n_splits <= 0 || n_splits > kMaxSplits ||
      (n_splits > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);
  Int4Params p;
  p.xq = static_cast<const int8_t*>(xq);
  p.row_scale = static_cast<const float*>(row_scale);
  p.w = static_cast<const uint8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.part = n_splits > 1 ? static_cast<float*>(part) : nullptr;
  p.out = out;
  p.m = m;
  p.K = K;
  p.N = N;
  p.ldw = ldw;
  p.lds = lds;
  p.out_kind = out_kind;
  for (int z = 0; z < n_splits; ++z) {
    p.split_begin[z] = table[2 * z];
    p.split_end[z] = table[2 * z + 1];
    if (p.split_begin[z] < 0 || p.split_end[z] > K / 2 || p.split_end[z] <= p.split_begin[z] ||
        p.split_begin[z] % kQBK || p.split_end[z] % kQBK)
      return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mt = (m + 15) / 16;
  int err;
  if (mt <= 1)
    err = launch_int4<1>(p, n_splits, s);
  else if (mt <= 2)
    err = launch_int4<2>(p, n_splits, s);
  else
    err = launch_int4<4>(p, n_splits, s);  // 64-row chunks on the grid's third axis
  if (err != 0 || n_splits == 1) return err;
  const size_t n_pairs = (size_t)m * N / 2;
  const int blocks = int((n_pairs + 255) / 256 < 1024 ? (n_pairs + 255) / 256 : 1024);
  split_sum_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(part), out, n_splits, n_pairs, out_kind);
  return int(cudaGetLastError());
}

// K10 after the K9 row-quantisation pre-pass: hq [m, K] int8 and row_scale
// [m] of the FFN hidden h, wt [N, K] the transposed int8 weight, x and out
// [m, N] of kind x_kind (0 f32, 1 bf16, 2 f16), scale, bias, gamma and beta
// [N] f32. K % 64 == 0; N in {128, 256, 384, 512, 768, 1024}. Returns the
// CUDA error code of the launch.
extern "C" int int8_res_ln(const void* hq, const void* row_scale, const void* wt, const void* scale,
                           const void* bias, const void* x, const void* gamma, const void* beta, void* out,
                           int m, int K, int N, int x_kind, float eps, void* stream) {
  if (m <= 0 || K <= 0 || K % kRBK || !bias || !gamma || !beta) return int(cudaErrorInvalidValue);
  ResLnParams p;
  p.hq = static_cast<const int8_t*>(hq);
  p.row_scale = static_cast<const float*>(row_scale);
  p.wt = static_cast<const int8_t*>(wt);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.x = x;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.out = out;
  p.m = m;
  p.K = K;
  p.N = N;
  p.x_kind = x_kind;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 128:
      return launch_res_ln<2>(p, s);
    case 256:
      return launch_res_ln<4>(p, s);
    case 384:
      return launch_res_ln<6>(p, s);
    case 512:
      return launch_res_ln<8>(p, s);
    case 768:
      return launch_res_ln<12>(p, s);
    case 1024:
      return launch_res_ln<16>(p, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
