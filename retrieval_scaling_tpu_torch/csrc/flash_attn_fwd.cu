// K1 and K2: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of retrieval_scaling_tpu/ops/flash_attention.py
// (`_flash_oneshot_kernel` and `_flash_kernel`, launched by the pallas_call in
// `flash_attention`). It computes, for every (batch b, query head h),
//     O = softmax(mask(cap(Q K^T * sm_scale))) V
// with the JAX kernels' semantics:
//   * an optional key-padding mask [B, Sk] (1 = keep) and/or causal masking,
//     causal rows aligned to the END of the key row (seq_delta = Sk - Sq);
//   * K2, the kernel's window and soft-cap features (Mistral, Phi-3 and
//     Gemma-2): with `window` > 0 key j is visible to row i iff
//     i + seq_delta - window < j <= i + seq_delta (implies causal), and key
//     tiles wholly below a q tile's band are skipped, as `_flash_kernel`
//     skips key blocks below `first_q - window + 1`, so the work is
//     O(S * window); with `logit_cap` > 0 every scaled score becomes
//     cap * tanh(s / cap) BEFORE the mask, so masked keys still get NEG_INF.
//     Interior tiles (every row sees every key of the tile, no padding mask)
//     skip the per-element mask;
//   * K2s, packed rows (the kernel's `segment_ids` feature, `segmented=True`
//     of `_flash_kernel`): segment ids [B, S] (contiguous runs, 0 = pad,
//     Sq == Sk) with each token's run [lo, hi) from `segment_bounds`. Key j is
//     visible to row i only if seg[i] == seg[j] != 0, so a pad row is exactly
//     0. A q tile runs only the key tiles inside [min lo, max hi) over its
//     non-pad rows (the JAX loop bound, `_flash_kernel` :248-254), so packed
//     rows cost O(S * segment length), not O(S^2); a tile whose rows all lie
//     in one run that covers the whole key tile (and whose key mask, if any,
//     is all ones) skips the per-element test. Window, cap, key mask and
//     segments compose in the one kernel;
//   * masked scores are NEG_INF = -1e30, the exp reference is clamped at
//     NEG_INF / 2 and the normaliser floored at 1e-30, so a row that sees
//     no key at all comes out exactly 0;
//   * GQA: query head h reads kv head h / (H / Hkv), K/V never repeated;
//   * f32 accumulation of both products and of the softmax statistics.
// The TPU's one-shot/looped split was a VMEM device; here one online-softmax
// loop over key tiles covers every length, and under causal masking it stops
// at the last key tile that the q tile's last row can see.
//
// What bounds it on this card: at the reader's lengths (S >= 1024, d = 256)
// the two causal products are ~2*S*S*d flops per (b, h) against ~8*S*d bytes
// of bf16 Q/K/V/O, i.e. S/4 flop per byte (256 at S = 1024, 512 at 2048): at
// or above the H100's ~295 flop/byte bf16 ridge, so the kernel is bound by
// the tensor-core work of QK^T and PV. The design therefore keeps both products on
// the tensor cores (mma.sync m16n8k16, bf16/fp16 in, f32 accumulate), keeps
// the score tile and the output accumulator in registers (the QK^T
// accumulator fragments are re-packed in place as the A operand of PV, so the
// [S, S] scores never touch shared or device memory), reads Q once and each
// K/V tile once per CTA with cp.async, and feeds the tensor cores from shared
// memory with ldmatrix. The V tile's copy overlaps QK^T and the softmax; the
// K tile's copy is not yet overlapped (no double buffer), and the products
// use mma.sync rather than wgmma/TMA: both are later work. Two CTAs fit on an
// SM at d = 256, so one CTA's copies also overlap the other's products.
//
// Layout: q [B, H, Sq, D], k/v [B, Hkv, Sk, D], out [B, H, Sq, D], each
// given by its batch, head and row strides (elements; multiples of 8, the
// last dim contiguous), so the models pass Q/K/V as views of their fused
// projection and take the output in [B, S, H, D] order without copies.
// D in {64, 96, 128, 256} (96: Phi-3-mini's heads). One CTA of 4 warps per (q tile of 64 rows, h, b);
// each warp owns 16 query rows.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;                 // query rows per CTA
constexpr int kBK = 64;                 // key rows per shared-memory tile
constexpr int kWarps = kBQ / 16;        // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                 // elements of padding per smem row

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 16-bit matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of each matrix, row lane/4, columns 2*(lane%4) and +1:
// the mma.sync A/B fragment layout. `.trans` delivers the transpose.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Stage rows [r0, r0 + rows) of an [n, D] matrix with row stride `stride`
// into smem (row stride LD); rows at or past n are zero.
template <int D, int LD, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long stride, int r0, int rows,
                                           int n, int tid) {
  constexpr int CHUNKS = D / 8;                     // 16-byte chunks per row
  constexpr int ROWS_PER_PASS = kThreads / CHUNKS;  // each thread keeps one column chunk
  if constexpr (ROWS_PER_PASS * CHUNKS < kThreads) {  // D = 96: 120 of the 128 threads copy
    if (tid >= ROWS_PER_PASS * CHUNKS) return;
  }
  const int c = (tid % CHUNKS) * 8;
  int r = tid / CHUNKS;
  const T* row = src + (r0 + r) * stride + c;
  const long long step = ROWS_PER_PASS * stride;
  for (; r < rows; r += ROWS_PER_PASS, row += step) {
    const bool valid = r0 + r < n;
    cp_async16(dst + r * LD + c, valid ? row : src, valid);
  }
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* kv_mask;  // [B, Sk] contiguous or null
  const int* seg;          // K2s: [B, S] segment ids (0 = pad), contiguous, or null
  const int* seg_lo;       // [B, S] first token of each token's run (0 for pad)
  const int* seg_hi;       // [B, S] one past its last token (0 for pad)
  void* out;
  long long q_stride[3], k_stride[3], v_stride[3], o_stride[3];  // batch, head, row
  int H, n_rep, Sq, Sk, causal, window;  // window 0 = none
  float sm_scale, logit_cap;             // logit_cap 0 = none
};

template <int D, typename T, bool SEG>
constexpr size_t smem_bytes() {
  return size_t(kBQ + 2 * kBK) * (D + kPad) * sizeof(T) + kBK + (SEG ? kBK * sizeof(int) : 0);
}

// CAP / WINDOW: the soft-cap and sliding-window instances (K2); K1's own
// instances carry neither the tanh nor the band compares. MASKED: a key
// mask is given; its tiles are never interior, so its instances carry no
// interior test and mask every element, as the first K1 did (on an H100
// the encoder's masked d64 shape ran 17-19 % slower with the test in).
// SEG: packed rows (K2s); its masked instances do test for interior tiles,
// with the tile's key mask folded in by one barrier vote
template <typename T, int D, bool CAP, bool WINDOW, bool MASKED, bool SEG>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const __grid_constant__ Params p) {
  constexpr int LD = D + kPad;  // smem row stride (elements): 16-byte aligned rows, and the
                                // 8 rows of an ldmatrix fall in distinct bank groups
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * LD;
  T* Vs = Ks + kBK * LD;
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + kBK * LD);  // key-visible flags of the tile
  int* Kseg = reinterpret_cast<int*>(Ms + kBK);                // K2s: the tile's key segment ids

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.n_rep;
  const int Sq = p.Sq, Sk = p.Sk, causal = p.causal, window = p.window;
  const float sm_scale = p.sm_scale, cap = p.logit_cap;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int seq_delta = Sk - Sq;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_stride[0] + h * p.q_stride[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.k_stride[0] + hk * p.k_stride[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.v_stride[0] + hk * p.v_stride[1];
  const uint8_t* mg = MASKED ? p.kv_mask + size_t(b) * Sk : nullptr;

  // Stage the Q tile once (copy group 0); rows past Sq are zero and never stored.
  stage_rows<D, LD>(Qs, qg, p.q_stride[2], q0, kBQ, Sq, tid);
  cp_async_commit();

  int n_kt = (Sk + kBK - 1) / kBK;
  const int first_pos = q0 + seq_delta;                 // end-aligned position of the tile's first row
  const int last_pos = min(q0 + kBQ, Sq) - 1 + seq_delta;
  if (causal) {
    // the last row of this q tile sees keys up to last_pos; later tiles are skipped
    n_kt = last_pos < 0 ? 0 : min(n_kt, last_pos / kBK + 1);
  }
  // K2's window: the first row sees keys above first_pos - window, later
  // rows higher ones; tiles wholly below that are skipped
  int kt_begin = WINDOW ? max(first_pos - window + 1, 0) / kBK : 0;

  // K2s: the tile's segment span over its non-pad rows. one_run: every row
  // of the tile lies in the one run [run_lo, run_hi)
  const int* sg = SEG ? p.seg + size_t(b) * Sk : nullptr;
  int qs_a = 0, qs_b = 0, run_lo = 0, run_hi = 0;
  bool one_run = false;
  if constexpr (SEG) {
    __shared__ int span[5];  // min lo, max lo, min hi, max hi, pad or past-the-end rows
    if (tid == 0) {
      span[0] = span[2] = 0x7fffffff;
      span[1] = span[3] = span[4] = 0;
    }
    __syncthreads();
    if (tid < kBQ) {  // warps 0 and 1: one query row each
      const int r = q0 + tid;
      const bool real = r < Sq && sg[r] != 0;
      const int lo = real ? p.seg_lo[size_t(b) * Sk + r] : 0x7fffffff;
      const int hi = real ? p.seg_hi[size_t(b) * Sk + r] : 0;
      const int mn_lo = __reduce_min_sync(0xffffffffu, lo), mx_lo = __reduce_max_sync(0xffffffffu, real ? lo : 0);
      const int mn_hi = __reduce_min_sync(0xffffffffu, real ? hi : 0x7fffffff);
      const int mx_hi = __reduce_max_sync(0xffffffffu, hi);
      const unsigned pads = __ballot_sync(0xffffffffu, !real);
      if (lane == 0) {
        atomicMin(&span[0], mn_lo);
        atomicMax(&span[1], mx_lo);
        atomicMin(&span[2], mn_hi);
        atomicMax(&span[3], mx_hi);
        if (pads) atomicOr(&span[4], 1);
      }
    }
    __syncthreads();
    // keys outside [min lo, max hi) belong to no row of this tile; a tile of
    // pad rows only has max hi = 0 and runs no key tile (its rows stay 0)
    kt_begin = max(kt_begin, span[3] > 0 ? span[0] / kBK : n_kt);
    n_kt = min(n_kt, (span[3] + kBK - 1) / kBK);
    one_run = span[4] == 0 && span[0] == span[1] && span[2] == span[3];
    run_lo = span[0];
    run_hi = span[3];
  }

  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // rows g and g + 8 of this warp
  float l_run[2] = {0.f, 0.f};          // this lane's partial row sums
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  if constexpr (SEG) {
    qs_a = row_a < Sq ? sg[row_a] : 0;
    qs_b = row_b < Sq ? sg[row_b] : 0;
  }
  // ldmatrix row addresses of this lane: matrix lane/8, row lane%8
  const int lm = lane >> 3, lr = lane & 7;
  const T* q_frag = Qs + (warp * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;
  const T* k_frag = Ks + ((lm >> 1) * 8 + lr) * LD + (lm & 1) * 8;
  const T* v_frag = Vs + ((lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;

  for (int kt = kt_begin; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous K, V tile
    // K and V go in two copy groups, so the V copy overlaps QK^T and softmax.
    stage_rows<D, LD>(Ks, kg, p.k_stride[2], k0, kBK, Sk, tid);
    cp_async_commit();
    stage_rows<D, LD>(Vs, vg, p.v_stride[2], k0, kBK, Sk, tid);
    cp_async_commit();
    bool keys_all = true;  // this thread's keys of the tile are all visible
    for (int i = tid; i < kBK; i += kThreads) {
      const bool vis = (k0 + i < Sk) && (!MASKED || mg[k0 + i] != 0);
      Ms[i] = vis;
      keys_all = keys_all && vis;
      if constexpr (SEG) Kseg[i] = k0 + i < Sk ? sg[k0 + i] : -1;
    }
    cp_async_wait<1>();  // this thread's Q and K copies have landed
    // ... and every other thread's; K2s also votes on the tile's key mask
    bool tile_full = false;
    if constexpr (SEG) {
      tile_full = __syncthreads_and(keys_all) != 0;
    } else {
      __syncthreads();
    }
    // every row of the tile sees every key of it: no per-element mask
    const bool interior = (SEG ? tile_full : !MASKED && k0 + kBK <= Sk) &&
                          (!causal || k0 + kBK - 1 <= first_pos) && (!WINDOW || k0 > last_pos - window) &&
                          (!SEG || (one_run && k0 >= run_lo && k0 + kBK <= run_hi));

    // S = Q K^T for this warp's 16 rows: kBK / 8 accumulator fragments.
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_frag + kk * 16);
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {  // key n-tiles 2np and 2np + 1
        uint32_t kf[4];
        ldmatrix_x4(kf, k_frag + np * 16 * LD + kk * 16);
        const uint32_t b0[2] = {kf[0], kf[1]}, b1[2] = {kf[2], kf[3]};
        Mma<T>::run(s[2 * np], a, b0);
        Mma<T>::run(s[2 * np + 1], a, b1);
      }
    }

    // Scale, soft-cap, mask, and the online-softmax update of rows g and g + 8.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[nt][e] * sm_scale;
        if constexpr (CAP) val = cap * tanhf(val / cap);
        if (!interior) {
          const int c = nt * 8 + 2 * t + (e & 1);
          const int pos = ((e < 2) ? row_a : row_b) + seq_delta;
          const int qs = (e < 2) ? qs_a : qs_b;
          const bool keep = Ms[c] && (!causal || k0 + c <= pos) && (!WINDOW || k0 + c > pos - window) &&
                            (!SEG || (qs != 0 && Kseg[c] == qs));
          if (!keep) val = kNegInf;
        }
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      // masked entries underflow to exactly 0 against the clamped reference
      m_safe[i] = fmaxf(m_new, kNegInf * 0.5f);
      alpha[i] = __expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[nt][e] - m_safe[e >> 1]);
        s[nt][e] = pe;
        rs[e >> 1] += pe;
      }
    }
    l_run[0] = alpha[0] * l_run[0] + rs[0];
    l_run[1] = alpha[1] * l_run[1] + rs[1];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    cp_async_wait<0>();  // this thread's V copies have landed
    __syncthreads();     // ... and every other thread's
    // O += P V: the score fragments, packed to 16 bits, are the A operand.
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t a[4];
      a[0] = Mma<T>::pack(s[2 * j][0], s[2 * j][1]);
      a[1] = Mma<T>::pack(s[2 * j][2], s[2 * j][3]);
      a[2] = Mma<T>::pack(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = Mma<T>::pack(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {  // output n-tiles 2np and 2np + 1
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, v_frag + j * 16 * LD + np * 16);
        const uint32_t b0[2] = {vf[0], vf[1]}, b1[2] = {vf[2], vf[3]};
        Mma<T>::run(o[2 * np], a, b0);
        Mma<T>::run(o[2 * np + 1], a, b1);
      }
    }
  }
  cp_async_wait<0>();  // a tile loop that never ran leaves the Q copy pending

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
  }
  T* og = static_cast<T*>(p.out) + b * p.o_stride[0] + h * p.o_stride[1];
  const long long os = p.o_stride[2];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (row_a < Sq)
      *reinterpret_cast<uint32_t*>(og + row_a * os + c) =
          Mma<T>::pack(o[nt][0] * inv[0], o[nt][1] * inv[0]);
    if (row_b < Sq)
      *reinterpret_cast<uint32_t*>(og + row_b * os + c) =
          Mma<T>::pack(o[nt][2] * inv[1], o[nt][3] * inv[1]);
  }
}

template <typename T, int D, bool CAP, bool WINDOW, bool MASKED, bool SEG>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, T, SEG>();
  auto kernel = flash_fwd_kernel<T, D, CAP, WINDOW, MASKED, SEG>;
  // Above 48 KB a kernel needs this attribute; set once per instantiation
  // (the call costs host time on every launch otherwise). It binds to the
  // device current at the first launch: one device per process for now.
  static const cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (configured != cudaSuccess) return int(configured);
  dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T, int D, bool MASKED, bool SEG>
int dispatch_cap_window(const Params& p, int B, cudaStream_t stream) {
  const bool cap = p.logit_cap > 0.f, window = p.window > 0;
  if (cap)
    return window ? launch<T, D, true, true, MASKED, SEG>(p, B, stream)
                  : launch<T, D, true, false, MASKED, SEG>(p, B, stream);
  return window ? launch<T, D, false, true, MASKED, SEG>(p, B, stream)
                : launch<T, D, false, false, MASKED, SEG>(p, B, stream);
}

template <typename T, int D, bool MASKED>
int dispatch_features(const Params& p, int B, cudaStream_t stream) {
  return p.seg ? dispatch_cap_window<T, D, MASKED, true>(p, B, stream)
               : dispatch_cap_window<T, D, MASKED, false>(p, B, stream);
}

template <typename T, int D>
int dispatch_mask(const Params& p, int B, cudaStream_t stream) {
  return p.kv_mask ? dispatch_features<T, D, true>(p, B, stream) : dispatch_features<T, D, false>(p, B, stream);
}

template <typename T>
int dispatch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64:
      return dispatch_mask<T, 64>(p, B, stream);
    case 96:
      return dispatch_mask<T, 96>(p, B, stream);
    case 128:
      return dispatch_mask<T, 128>(p, B, stream);
    case 256:
      return dispatch_mask<T, 256>(p, B, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the CUDA error code of the launch (0 = launched). kv_mask may be
// null; otherwise it is [B, Sk] bytes, nonzero = key visible. `strides`
// holds 12 element strides: (batch, head, row) of q, k, v and out. window
// 0 and logit_cap 0 turn K2's features off; a window implies causal. seg
// (K2s) may be null; otherwise seg, seg_lo and seg_hi are [B, S] int32
// (contiguous, S = Sq = Sk): segment ids with 0 = pad and each token's run.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* kv_mask,
                              const void* seg, const void* seg_lo, const void* seg_hi,
                              void* out, int B, int H, int Hkv, int Sq, int Sk, int D,
                              int causal, float sm_scale, int window, float logit_cap, int is_fp16,
                              const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk < 0 || window < 0 || logit_cap < 0.f ||
      (seg && (Sq != Sk || !seg_lo || !seg_hi)))
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.seg = static_cast<const int*>(seg);
  p.seg_lo = static_cast<const int*>(seg_lo);
  p.seg_hi = static_cast<const int*>(seg_hi);
  p.out = out;
  for (int i = 0; i < 3; ++i) {
    p.q_stride[i] = strides[i];
    p.k_stride[i] = strides[3 + i];
    p.v_stride[i] = strides[6 + i];
    p.o_stride[i] = strides[9 + i];
  }
  p.H = H;
  p.n_rep = H / Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal || window > 0;
  p.window = window;
  p.sm_scale = sm_scale;
  p.logit_cap = logit_cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp16) return dispatch_d<__half>(p, B, D, s);
  return dispatch_d<__nv_bfloat16>(p, B, D, s);
}
