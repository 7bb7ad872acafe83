// K3: flash-decoding attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU flash kernel on its decode route: the pallas_call of
// retrieval_scaling_tpu/ops/flash_attention.py reached through
// `flash_attention_sharded` from `models/generate.py::_attention_with_cache`
// (generate.py:118-143), and the XLA attention over a filled cache that the
// JAX package runs for a speculative verify segment (generate.py:145-173,
// `all_visible` false). It computes, for every (batch b, query head h) and
// each of Sq query rows,
//     O = softmax(mask(q K^T * sm_scale)) V
// against an M-slot KV cache with a [B, M] key mask, GQA (query head h reads
// kv head h / n_rep), f32 sums and softmax statistics, and a row with no
// visible key exactly 0 (the convention of K1 and the Pallas kernels). With
// `logit_cap` > 0 each scaled score becomes cap * tanh(s / cap) before the
// online max (Gemma-2's attention soft-cap).
//
// Per-query bounds (a decode step and a verify segment). With `q_pos`
// ([B, Sq] int32) query j of row b sees slot s only where mask[b, s] and
// s <= q_pos[b, j], and, with `window` > 0, s > q_pos[b, j] - window: causal
// by position over the cache, the sliding window moving with j. Each row
// reads its own bound in the kernel; no [B, Sq, M] mask is built. Without
// q_pos every row sees the whole key mask (not causal).
//
// What bounds it on this card: each cache element is read once and used for
// n_rep * Sq multiply-adds, about 1 flop per byte (n_rep * Sq up to 64 for a
// Llama verify segment: still far below the ridge), so it is bound by reading
// the valid K and V rows (b8, h8, d256, 1,024 f32 slots: 134 MB, 40 us at
// 3.35 TB/s); a masked slot is never read. B x H is small at decode (64 at
// b8 for Pythia-1B), far fewer than the card's 132 SMs need, so the cache is
// split along M into splits of a FIXED number of keys (128, the wrapper's
// `_DECODE_KEYS_PER_SPLIT`): the grid is (B * Hkv, splits, row groups of up to
// 8 rows). In a CTA each of four warps streams its share of the keys four
// at a time (each lane reads D/32 contiguous elements of a K and a V row,
// 16-byte loads for bf16 at d256), reduces the dot products with shuffles
// and keeps an online softmax (m, l and its D/32 slice of the output) in
// registers; the warps then merge in shared memory, and a second small
// kernel merges the splits in a fixed order.
//
// Why the split size is fixed: a row's arithmetic (which keys each warp
// takes, in which order, and the order of the warp and split merges) then
// depends only on the absolute key positions, never on M, on Sq or on the
// row group the row lands in. A key hidden from a row, or a split with no
// visible key, adds exactly 0. So a verify row j at positions n .. n + g sums
// its keys in the same order as a one-token step at cache length n + j + 1,
// whatever the two caches' capacities: the verify forward and the sequential
// step agree bit for bit where their other kernels do. The TPU's >= 256-slot
// threshold and its shard_map wrapper are not carried over: every attention
// over a float cache runs this kernel.
//
// Layout: q [B, H, Sq, D], k/v [B, Hkv, M, D], out [B, H, Sq, D], all
// contiguous, one dtype (f32, bf16 or f16). D in {64, 96, 128, 256}; at
// D = 96 each lane reads its three elements one by one.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKU = 4;  // keys per warp per step

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // [B, M] bytes (nonzero = visible) or null
  const int* q_pos;     // [B, Sq] positions of the query rows, or null
  void* out;
  float* part_acc;  // [B * Hkv, splits, rows, D] unnormalised outputs
  float* part_ml;   // [B * Hkv, splits, rows, 2] running max and sum
  int H, Hkv, Sq, M, n_rep, rows, keys_per_split, n_splits, window;  // window 0 = none
  float sm_scale, logit_cap;  // logit_cap 0 = none
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// E contiguous elements of T (vector loads when E * sizeof(T) is 4, 8, 16
// or 32 bytes, so aligned; element by element otherwise, as at D = 96)
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[E]) {
  constexpr int BYTES = E * int(sizeof(T));
  if constexpr (BYTES != 4 && BYTES != 8 && BYTES % 16 != 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = to_f(p[e]);
  } else {
    alignas(16) uint32_t w[BYTES / 4];
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i) reinterpret_cast<uint4*>(w)[i] = reinterpret_cast<const uint4*>(p)[i];
    } else if constexpr (BYTES == 8) {
      *reinterpret_cast<uint2*>(w) = *reinterpret_cast<const uint2*>(p);
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
    const T* t = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = to_f(t[e]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(const __grid_constant__ Params p) {
  constexpr int E = D / 32;
  __shared__ float s_m[kWarps][R], s_l[kWarps][R];
  __shared__ __align__(16) float s_acc[kWarps][R][D];

  const int bh = blockIdx.x, split = blockIdx.y, r0 = blockIdx.z * R;
  const int b = bh / p.Hkv, hk = bh % p.Hkv;
  const int nr = min(R, p.rows - r0);  // rows of this group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* kg = static_cast<const T*>(p.k) + (size_t)bh * p.M * D + lane * E;
  const T* vg = static_cast<const T*>(p.v) + (size_t)bh * p.M * D + lane * E;
  const uint8_t* mg = p.mask ? p.mask + (size_t)b * p.M : nullptr;

  // this lane's slice of each query row: row r = rep * Sq + sq; the row
  // sees keys j with lo[r] < j <= hi[r]
  float q[R][E];
  int lo[R], hi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lo[r] = -1;
    hi[r] = p.M;
    if (r < nr) {
      const int rr = r0 + r, rep = rr / p.Sq, sq = rr % p.Sq;
      const int h = hk * p.n_rep + rep;
      load_vec<T, E>(static_cast<const T*>(p.q) + (((size_t)b * p.H + h) * p.Sq + sq) * D + lane * E, q[r]);
      if (p.q_pos) {
        hi[r] = p.q_pos[(size_t)b * p.Sq + sq];
        if (p.window > 0) lo[r] = hi[r] - p.window;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) q[r][e] = 0.f;
    }
  }
  float m_run[R], l_run[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const int kb = split * p.keys_per_split;
  const int ke = min(p.M, kb + p.keys_per_split);
  for (int j0 = kb + warp * kKU; j0 < ke; j0 += kWarps * kKU) {
    float kr[kKU][E], vr[kKU][E];
    bool valid[kKU];
#pragma unroll
    for (int u = 0; u < kKU; ++u) {
      const int j = j0 + u;
      valid[u] = j < ke && (mg == nullptr || mg[j] != 0);
      if (valid[u]) {  // a masked slot is never read
        load_vec<T, E>(kg + (size_t)j * D, kr[u]);
        load_vec<T, E>(vg + (size_t)j * D, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s[kKU];
      float mx = m_run[r];
#pragma unroll
      for (int u = 0; u < kKU; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(q[r][e], kr[u][e], d);
        d = warp_sum(d) * p.sm_scale;
        if (p.logit_cap > 0.f) d = p.logit_cap * tanhf(d / p.logit_cap);
        const int j = j0 + u;
        s[u] = valid[u] && j <= hi[r] && j > lo[r] ? d : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      // masked keys underflow to exactly 0 against the clamped reference
      const float m_safe = fmaxf(mx, kNegInf * 0.5f);
      const float alpha = __expf(m_run[r] - mx);
      float ps = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kKU; ++u) {
        const float pu = __expf(s[u] - m_safe);
        ps += pu;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pu, vr[u][e], acc[r][e]);
      }
      l_run[r] = l_run[r] * alpha + ps;
      m_run[r] = mx;
    }
  }

  // merge the four warps
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      s_m[warp][r] = m_run[r];
      s_l[warp][r] = l_run[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) s_acc[warp][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][r]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(s_m[w][r] - mx);
      o += c * s_acc[w][r][d];
      l += c * s_l[w][r];
    }
    const int rr = r0 + r;
    if (p.n_splits == 1) {
      const int rep = rr / p.Sq, sq = rr % p.Sq, h = hk * p.n_rep + rep;
      static_cast<T*>(p.out)[(((size_t)b * p.H + h) * p.Sq + sq) * D + d] = from_f<T>(o / fmaxf(l, 1e-30f));
    } else {
      const size_t row = ((size_t)bh * p.n_splits + split) * p.rows + rr;
      p.part_acc[row * D + d] = o;
      if (d == 0) {
        p.part_ml[row * 2] = mx;
        p.part_ml[row * 2 + 1] = l;
      }
    }
  }
}

// one CTA per (b * Hkv + hk, row): merge the splits in order
template <typename T>
__global__ void combine_kernel(const __grid_constant__ Params p, int D) {
  const int bh = blockIdx.x, rr = blockIdx.y;
  const int b = bh / p.Hkv, hk = bh % p.Hkv;
  float mx = kNegInf;
  for (int s = 0; s < p.n_splits; ++s)
    mx = fmaxf(mx, p.part_ml[(((size_t)bh * p.n_splits + s) * p.rows + rr) * 2]);
  const int rep = rr / p.Sq, sq = rr % p.Sq, h = hk * p.n_rep + rep;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f, l = 0.f;
    for (int s = 0; s < p.n_splits; ++s) {
      const size_t row = ((size_t)bh * p.n_splits + s) * p.rows + rr;
      const float c = __expf(p.part_ml[row * 2] - mx);
      o += c * p.part_acc[row * D + d];
      l += c * p.part_ml[row * 2 + 1];
    }
    static_cast<T*>(p.out)[(((size_t)b * p.H + h) * p.Sq + sq) * D + d] = from_f<T>(o / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D, int R>
int launch(const Params& p, int B, cudaStream_t stream) {
  dim3 grid(B * p.Hkv, p.n_splits, (p.rows + R - 1) / R);
  flash_decode_kernel<T, D, R><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return int(err);
  combine_kernel<T><<<dim3(B * p.Hkv, p.rows), D, 0, stream>>>(p, D);
  return int(cudaGetLastError());
}

template <typename T, int D>
int dispatch_r(const Params& p, int B, cudaStream_t stream) {
  if (p.rows <= 1) return launch<T, D, 1>(p, B, stream);
  if (p.rows <= 2) return launch<T, D, 2>(p, B, stream);
  if (p.rows <= 4) return launch<T, D, 4>(p, B, stream);
  return launch<T, D, 8>(p, B, stream);  // row groups of 8
}

template <typename T>
int dispatch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64:
      return dispatch_r<T, 64>(p, B, stream);
    case 96:
      return dispatch_r<T, 96>(p, B, stream);
    case 128:
      return dispatch_r<T, 128>(p, B, stream);
    case 256:
      return dispatch_r<T, 256>(p, B, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the CUDA error code of the launches (0 = launched). dtype: 0 f32,
// 1 bf16, 2 f16. q_pos ([B, Sq] int32) may be null; window > 0 needs it.
// part_acc / part_ml are scratch of B * Hkv * n_splits * (n_rep * Sq) * D
// and * 2 floats (unused at one split).
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* mask, const void* q_pos,
                            void* out, void* part_acc, void* part_ml, int B, int H, int Hkv, int Sq, int M, int D,
                            int keys_per_split, int n_splits, int window, float sm_scale, float logit_cap,
                            int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || M <= 0 || n_splits <= 0 || logit_cap < 0.f ||
      keys_per_split <= 0 || (long long)keys_per_split * n_splits < M || window < 0 ||
      (window > 0 && q_pos == nullptr) || (long long)B * Hkv > 2147483647LL || n_splits > 65535 ||
      (H / Hkv * Sq + 7) / 8 > 65535)
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.q_pos = static_cast<const int*>(q_pos);
  p.window = window;
  p.out = out;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.H = H;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.M = M;
  p.n_rep = H / Hkv;
  p.rows = p.n_rep * Sq;
  p.keys_per_split = keys_per_split;
  p.n_splits = n_splits;
  p.sm_scale = sm_scale;
  p.logit_cap = logit_cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(p, B, D, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(p, B, D, s);
  return dispatch_d<__half>(p, B, D, s);
}
