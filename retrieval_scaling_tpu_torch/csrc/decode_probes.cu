// S1, S2 and S5: the decode probes for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of three measurement scripts, which time
// the pieces of a Pythia-1B decode step (D 2048, FF 8192, qkv 6144, vocab
// 50304, 16 layers, a batch of M = 8 rows):
//   * S1, scripts/ablate_decode.py: `stream_cur` (:147, kern_cur), `stream_preq`
//     (:162, kern_preq), `stream_w8bf16` (:213, kern_w8bf16) and `stream_bf16`
//     (:287, kern_preq_bf16) are instances of `weight_stream` below;
//     `stream_dual` (:178, kern_dual) and `stream_dual_bf16` (:301,
//     kern_dual_bf16) of `dual_stream`; `stream_touch` (:233) is K13
//     (csrc/stream_probe.cu), see ops/decode_probes.py;
//   * S2, scripts/ablate_launch_overhead.py: `stream_one` (:57, 16 launches of
//     one [2048, 6144] int8 weight) and `one16` (:84, one launch over the 16
//     weights stacked) are `weight_stream` in its w8bf16 mode with L = 1 and
//     L = 16: they differ only in the number of launches;
//   * S5, scripts/profile_decode_gap.py: `launch_loop` (:144), near-empty
//     launches, is `tiny_copy`, a [8, 128] f32 copy.
//
// weight_stream computes, for each of L stacked weights W[l] [K, N],
//     out[l] = act(x) @ W[l] * s[l]   (f32 sums, bf16 or f32 out)
// in one of four modes:
//   0 cur     x bf16 [M, K]; each CTA quantises the rows of x itself (row
//             absmax * (1/127) clamped at 1e-30, x / scale rounded to even,
//             clipped to +-127), once per column block as kern_cur does:
//             that redundancy is what the variant measures; int8 W,
//             s8 x s8 -> s32, then (acc * row scale) * s[n];
//   1 preq    x already quantised once per matmul (xq int8 [M, K], xs f32
//             [M]); the same product and scaling;
//   2 w8bf16  x bf16, int8 W widened to bf16 (exact), f32 sums, acc * s[n];
//   3 bf16    x bf16, bf16 W, no scale.
// dual_stream computes res + a @ Wo (scaled) + h @ W2 (scaled) in one pass
// over both weights: mode 1 (int8, pre-quantised a and h with their row
// scales and the weights' column scales: ((res + (acc_o * as) * so) +
// (acc_2 * hs) * s2) and mode 3 (bf16: (res + acc_o) + acc_2). The scaling
// runs with explicit rounding (no fused multiply-add), in the plain
// version's order, so an s8 variant equals its plain version before the
// final rounding to bf16.
//
// What bounds them on this card: at M = 8 a weight byte feeds 16 int8 ops
// (or 8 bf16 flops per bf16 element), far below the card's ridge, so each
// is bound by the weight stream (Pythia-1B's 0.91 GB of int8 weights per
// step: 0.27 ms at 3.35 TB/s). The design: x stays resident in shared
// memory for the whole K (its 8 rows; the mma tile's rows 8-15 are zero
// registers, not memory), the weight streams through a 4-stage cp.async
// ring of [128 x 32] tiles in 16-byte units, and each of four warps owns 8
// of the CTA's 32 output columns over the whole K (mma.sync m16n8k32 s8 or
// m16n8k16 bf16, s32 / f32 accumulators in registers; no split K and no
// cross-warp sum). The grid is (N / 32, L): the layer axis is a grid axis,
// the TPU kernel's `one16` layout. The TPU's 32-row sublane padding (MPAD)
// is not carried over: the decode batch is 8 rows. A correct first design,
// not a fast one: the B fragments are built from shared memory byte by
// byte, and N = 2048 gives only 64 CTAs.
//
// tiny_copy copies n floats with one CTA: the least work a launch can do,
// so a run of them measures the cost of a launch.
//
// Layouts: x [M, K] row-major (M <= 8), W [L, K, N] row-major, s [L, N],
// res [M, N] bf16, out [L, M, N] (bf16 or f32). K % 128 == 0, N % 32 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;     // resident activation rows (the decode batch)
constexpr int kBN = 32;      // output columns per CTA, 8 per warp
constexpr int kBK = 128;     // weight rows per stage
constexpr int kStages = 4;
constexpr int kMaxSmem = 232448;

enum Mode { kCur = 0, kPreq = 1, kW8Bf16 = 2, kBf16 = 3 };

struct Params {
  const void* x0;     // activation of weight 0: [M, K0] bf16 (modes 0, 2, 3) or int8 (mode 1)
  const float* xs0;   // [M] row scales of x0 (mode 1)
  const void* x1;     // activation of weight 1 (dual): [M, K1]
  const float* xs1;   // [M] row scales of x1 (dual, mode 1)
  const void* w0;     // [L, K0, N]
  const float* s0;    // [L, N] column scales of w0, or null (mode 3)
  const void* w1;     // [K1, N] (dual) or null
  const float* s1;    // [N] (dual, mode 1) or null
  const __nv_bfloat16* res;  // [M, N] residual (dual) or null
  void* out;          // [L, M, N]
  int M, K0, K1, N, out_f32;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0, uint32_t b1) {
  const uint32_t z = 0;  // rows 8-15 of the A tile
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(z), "r"(a2), "r"(z), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0, uint32_t b1) {
  const uint32_t z = 0;
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(z), "r"(a2), "r"(z), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint16_t bf16_bits(__nv_bfloat16 v) { return *reinterpret_cast<uint16_t*>(&v); }
__device__ __forceinline__ uint16_t as_bf16_bits(int8_t v) { return bf16_bits(__float2bfloat16_rn(float(v))); }
__device__ __forceinline__ uint16_t as_bf16_bits(__nv_bfloat16 v) { return bf16_bits(v); }

// Element sizes: activations in shared memory (int8 for the s8 modes, bf16
// otherwise) and the weight.
template <int MODE>
struct Traits {
  static constexpr bool kS8 = MODE == kCur || MODE == kPreq;
  static constexpr int kXElt = kS8 ? 1 : 2;
  using W = typename std::conditional<MODE == kBf16, __nv_bfloat16, int8_t>::type;
  static constexpr int kWRow = kBN * int(sizeof(W)) + 16;  // bytes per staged weight row
  static constexpr int kWStage = kBK * kWRow;
};

template <int MODE>
__host__ __device__ constexpr int x_row_bytes(int k) {
  return k * Traits<MODE>::kXElt + 16;  // padded: rows fall on different banks
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) stream_kernel(const __grid_constant__ Params p) {
  using T = Traits<MODE>;
  using W = typename T::W;
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = blockIdx.y, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int M = p.M, N = p.N, K0 = p.K0, K1 = p.K1;
  const int xrow0 = x_row_bytes<MODE>(K0), xrow1 = x_row_bytes<MODE>(K1);
  unsigned char* xs_0 = smem;                          // [8][xrow0]
  unsigned char* xs_1 = xs_0 + kRows * xrow0;          // [8][xrow1]
  float* row_scale = reinterpret_cast<float*>(xs_1 + kRows * xrow1);  // [8] (mode 0)
  unsigned char* ring = reinterpret_cast<unsigned char*>(row_scale + kRows);

  const W* w0 = static_cast<const W*>(p.w0) + (size_t)l * K0 * N;
  const W* w1 = static_cast<const W*>(p.w1);
  const int n_kt0 = K0 / kBK, n_kt = n_kt0 + K1 / kBK;

  // weight tile kt: rows [kt * kBK, +kBK) of w0, then of w1
  auto load_stage = [&](int stage, int kt) {
    const W* src = kt < n_kt0 ? w0 + (size_t)kt * kBK * N : w1 + (size_t)(kt - n_kt0) * kBK * N;
    unsigned char* dst = ring + stage * T::kWStage;
    constexpr int CPR = kBN * int(sizeof(W)) / 16;  // 16-byte chunks per row
    for (int c = tid; c < kBK * CPR; c += kThreads) {
      const int r = c / CPR, cb = (c % CPR) * 16;
      cp_async16(dst + r * T::kWRow + cb, reinterpret_cast<const unsigned char*>(src + (size_t)r * N + n0) + cb);
    }
  };

  // the resident activations: real rows by cp.async (group 0 with the first
  // weight tile), rows M..7 zero; mode 0 quantises x0 below instead
  auto load_rows = [&](unsigned char* dst, int row_bytes, const void* src, int k) {
    const int chunks = k * T::kXElt / 16;
    for (int c = tid; c < kRows * chunks; c += kThreads) {
      const int r = c / chunks, cb = (c % chunks) * 16;
      if (r < M)
        cp_async16(dst + r * row_bytes + cb, static_cast<const unsigned char*>(src) + (size_t)r * k * T::kXElt + cb);
      else
        *reinterpret_cast<uint4*>(dst + r * row_bytes + cb) = make_uint4(0, 0, 0, 0);
    }
  };
  if (MODE != kCur) load_rows(xs_0, xrow0, p.x0, K0);
  if (K1 > 0) load_rows(xs_1, xrow1, p.x1, K1);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_stage(s, s);
    cp_async_commit();
  }
  if (MODE == kCur) {
    // kern_cur's row quantisation, by this CTA (warp w: rows w and w + 4)
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x0);
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float amax = 0.f;
      if (r < M)
        for (int k = lane; k < K0; k += 32) amax = fmaxf(amax, fabsf(__bfloat162float(x[(size_t)r * K0 + k])));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float sc = fmaxf(__fmul_rn(amax, 1.f / 127.f), 1e-30f);
      int8_t* dst = reinterpret_cast<int8_t*>(xs_0 + r * xrow0);
      for (int k = lane; k < K0; k += 32) {
        float q = 0.f;
        if (r < M) q = fminf(fmaxf(rintf(__fdiv_rn(__bfloat162float(x[(size_t)r * K0 + k]), sc)), -127.f), 127.f);
        dst[k] = int8_t(q);
      }
      if (lane == 0) row_scale[r] = sc;
    }
  }

  float accf0[4] = {0.f, 0.f, 0.f, 0.f}, accf1[4] = {0.f, 0.f, 0.f, 0.f};  // per weight
  int acci0[4] = {0, 0, 0, 0}, acci1[4] = {0, 0, 0, 0};
  const int col = warp * 8 + g;  // this lane's B column within the tile

  // one staged [kBK x kBN] tile against the resident rows xr from k_base
  auto tile_s8 = [&](int (&acc)[4], const unsigned char* wt, const unsigned char* xr, int k_base) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xr + k_base + kk + 4 * t);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xr + k_base + kk + 16 + 4 * t);
      uint32_t b0 = 0, b1 = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b0 |= uint32_t(wt[(kk + 4 * t + i) * T::kWRow + col]) << (8 * i);
        b1 |= uint32_t(wt[(kk + 16 + 4 * t + i) * T::kWRow + col]) << (8 * i);
      }
      mma_s8(acc, a0, a2, b0, b1);
    }
  };
  auto tile_bf16 = [&](float (&acc)[4], const unsigned char* wt, const unsigned char* xr, int k_base) {
    const W* w = reinterpret_cast<const W*>(wt);
    constexpr int WE = T::kWRow / int(sizeof(W));  // elements per staged row
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xr + 2 * (k_base + kk + 2 * t));
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xr + 2 * (k_base + kk + 8 + 2 * t));
      const uint32_t b0 = uint32_t(as_bf16_bits(w[(kk + 2 * t) * WE + col])) |
                          (uint32_t(as_bf16_bits(w[(kk + 2 * t + 1) * WE + col])) << 16);
      const uint32_t b1 = uint32_t(as_bf16_bits(w[(kk + 2 * t + 8) * WE + col])) |
                          (uint32_t(as_bf16_bits(w[(kk + 2 * t + 9) * WE + col])) << 16);
      mma_bf16(acc, a0, a2, b0, b1);
    }
  };

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < n_kt) load_stage(nk % kStages, nk);
    cp_async_commit();

    const unsigned char* wt = ring + (kt % kStages) * T::kWStage;
    if constexpr (T::kS8) {
      if (kt < n_kt0)
        tile_s8(acci0, wt, xs_0 + g * xrow0, kt * kBK);
      else
        tile_s8(acci1, wt, xs_1 + g * xrow1, (kt - n_kt0) * kBK);
    } else {
      if (kt < n_kt0)
        tile_bf16(accf0, wt, xs_0 + g * xrow0, kt * kBK);
      else
        tile_bf16(accf1, wt, xs_1 + g * xrow1, (kt - n_kt0) * kBK);
    }
  }
  cp_async_wait<0>();

  // epilogue: this lane holds rows g (fragments 0, 1) at columns c, c + 1
  if (g >= M) return;
  const int c = n0 + warp * 8 + 2 * t;
  float y[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float v0, v1 = 0.f;
    if constexpr (T::kS8) {
      const float rs0 = MODE == kCur ? row_scale[g] : p.xs0[g];
      v0 = __fmul_rn(__fmul_rn(float(acci0[e]), rs0), p.s0[(size_t)l * N + c + e]);
      if (K1 > 0) v1 = __fmul_rn(__fmul_rn(float(acci1[e]), p.xs1[g]), p.s1[c + e]);
    } else {
      v0 = p.s0 ? __fmul_rn(accf0[e], p.s0[(size_t)l * N + c + e]) : accf0[e];
      v1 = accf1[e];
    }
    y[e] = p.res ? __fadd_rn(__fadd_rn(__bfloat162float(p.res[(size_t)g * N + c + e]), v0), v1) : v0;
  }
  const size_t o = ((size_t)l * M + g) * N + c;
  if (p.out_f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(y[0], y[1]);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) = __floats2bfloat162_rn(y[0], y[1]);
  }
}

template <int MODE>
size_t smem_bytes(int k0, int k1) {
  return size_t(kRows) * (x_row_bytes<MODE>(k0) + x_row_bytes<MODE>(k1)) + kRows * sizeof(float) +
         size_t(kStages) * Traits<MODE>::kWStage;
}

template <int MODE>
int launch(const Params& p, int L, cudaStream_t stream) {
  const size_t smem = smem_bytes<MODE>(p.K0, p.K1);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  static const cudaError_t configured =
      cudaFuncSetAttribute(stream_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (configured != cudaSuccess) return int(configured);
  stream_kernel<MODE><<<dim3(p.N / kBN, L), kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

int dispatch(int mode, const Params& p, int L, cudaStream_t stream) {
  switch (mode) {
    case kCur:
      return launch<kCur>(p, L, stream);
    case kPreq:
      return launch<kPreq>(p, L, stream);
    case kW8Bf16:
      return launch<kW8Bf16>(p, L, stream);
    case kBf16:
      return launch<kBf16>(p, L, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

bool bad_shape(int M, int K, int N) { return M < 1 || M > kRows || K <= 0 || K % kBK || N <= 0 || N % kBN; }

__global__ void tiny_copy_kernel(const float* __restrict__ src, float* __restrict__ dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

// out[l] = act(x) @ W[l] * s[l] for l < L (see the modes above). xs: row
// scales of a pre-quantised x (mode 1), else null; s null in mode 3.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int weight_stream(int mode, const void* x, const void* xs, const void* w, const void* s, void* out,
                             int M, int K, int N, int L, int out_f32, void* stream) {
  if (bad_shape(M, K, N) || L < 1 || L > 65535 || (mode == kPreq && xs == nullptr) ||
      (mode != kBf16 && s == nullptr))
    return int(cudaErrorInvalidValue);
  Params p{};
  p.x0 = x;
  p.xs0 = static_cast<const float*>(xs);
  p.w0 = w;
  p.s0 = static_cast<const float*>(s);
  p.out = out;
  p.M = M;
  p.K0 = K;
  p.K1 = 0;
  p.N = N;
  p.out_f32 = out_f32;
  return dispatch(mode, p, L, static_cast<cudaStream_t>(stream));
}

// out = res + a @ Wo (* as * so) + h @ W2 (* hs * s2): mode 1 (int8, with
// the scales) or 3 (bf16, no scales). Returns the CUDA error code.
extern "C" int dual_stream(int mode, const void* a, const void* as, const void* h, const void* hs, const void* res,
                           const void* wo, const void* so, const void* w2, const void* s2, void* out, int M, int KA,
                           int KH, int N, int out_f32, void* stream) {
  if (bad_shape(M, KA, N) || bad_shape(M, KH, N) || (mode != kPreq && mode != kBf16) || res == nullptr ||
      (mode == kPreq && (as == nullptr || hs == nullptr || so == nullptr || s2 == nullptr)))
    return int(cudaErrorInvalidValue);
  Params p{};
  p.x0 = a;
  p.xs0 = static_cast<const float*>(as);
  p.x1 = h;
  p.xs1 = static_cast<const float*>(hs);
  p.w0 = wo;
  p.s0 = static_cast<const float*>(so);
  p.w1 = w2;
  p.s1 = static_cast<const float*>(s2);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = out;
  p.M = M;
  p.K0 = KA;
  p.K1 = KH;
  p.N = N;
  p.out_f32 = out_f32;
  return dispatch(mode, p, 1, static_cast<cudaStream_t>(stream));
}

// dst[:n] = src[:n] with one CTA of 128 threads. Returns the CUDA error code.
extern "C" int tiny_copy(const void* src, void* dst, int n, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  tiny_copy_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(src),
                                                                     static_cast<float*>(dst), n);
  return int(cudaGetLastError());
}
