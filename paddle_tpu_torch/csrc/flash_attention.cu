// Flash attention forward and backward for Hopper (sm_90a): kernel K3.
//
// Replaces the TPU kernel of the reference package:
//   K3  paddle_tpu/ops/flash_attention.py::flash_attention, which calls the
//       library Pallas TPU kernel jax.experimental.pallas.ops.tpu
//       .flash_attention, forward and backward (custom_vjp).
//
// What it computes, per (batch b, head h), query row i < Lq, key j < Lk:
//   s_ij = (q_i . k_j) * sm_scale, REPLACED by finfo(float32).min where the
//          key is masked (causal: j > i, top-left aligned; segments:
//          qseg[b,i] != kseg[b,j]), and only then + bias[b,h,i,j];
//   o_i  = sum_j softmax_j(s_i) v_j.
// A row whose every key is masked therefore attends uniformly (the mean of
// V), exactly as the reference's _reference_attention.  The forward also
// writes per-row softmax statistics stats[b,h,i] = (m_i, log l_i) in fp32:
// the log-sum-exp is m + log l, kept as its two terms because for a fully
// masked row m ~ finfo.min swallows log l in one float.
//
// The backward recomputes P = exp(s - m - log l) tile by tile (P is never
// stored), delta_i = rowsum(dO_i * o_i), dS = P * (dO V^T - delta), and
//   dV = P^T dO,   dK = scale * dS~^T Q,   dQ = scale * dS~ K,
// where dS~ is dS with masked entries zeroed (a replaced score carries no
// gradient to q or k).  dS itself is the bias gradient, written to device
// memory only when the caller asks for it.
//
// Kernels (grid.y = b * H + h):
//   flash_fwd        a CTA owns a Q tile and loops over K/V tiles
//   flash_bwd_delta  one warp per query row
//   flash_bwd_dkdv   a CTA owns a K/V tile and loops over Q/dO tiles
//   flash_bwd_dq     a CTA owns a Q/dO tile and loops over K/V tiles
// Two passes instead of atomics keep the gradients deterministic: every
// sum is taken in one fixed order, so two calls agree bit for bit.  Both
// passes recompute S and dO V^T (14 D flops per visible pair against the
// 10 D the work needs); the dK/dV pass has no way to hand dS to the dQ
// pass without writing it to device memory.  Every [B,H,L,D] operand is
// addressed through its own (batch, head, row) strides with unit stride
// over D, so the transposed head views of the attention layer are read and
// written in place, and a broadcast bias is read through stride 0.
//
// Bound: at the training shape (B 2, H 16, L 2048, D 128, causal) the
// forward does 4 D flops and the backward 10 D flops per visible pair
// (3.4e10 and 8.6e10) against ~34 MB and ~68 MB of operands, far above the
// card's flop-per-byte ratio: both are bound by the tensor cores (fp32:
// three TF32 products each, so 495 / 3 TFLOP/s; bf16: 989 TFLOP/s).
//
// Design (FlashAttention-2 layout on mma.sync):
// - Every product runs on the tensor cores with mma.sync: m16n8k8 TF32 for
//   fp32 inputs, m16n8k16 bf16 for bf16 inputs, fp32 accumulation.  A warp
//   owns 16 rows of its CTA's tile; the products of a tile leave S (or S^T
//   in the dK/dV pass) in the accumulator layout, where each row is spread
//   over the 4 lanes of a quad, so the row max and sum are two shuffles and
//   P is fed back to the second product from registers, never through
//   shared memory.  For TF32 the contraction index of P V is permuted
//   (mma k index t <-> key 2t, t + 4 <-> key 2t + 1) so that the
//   accumulator's two adjacent columns are exactly the A fragment a thread
//   needs; the B fragment is read from shared memory with the same
//   permutation (see Mma below for the 16-byte fragment loads).
// - fp32 as 3xTF32: each operand x is split into hi + lo, both TF32
//   (split() below), and a product accumulates lo*hi + hi*lo + hi*hi in
//   fp32 (lo*lo dropped), which keeps about fp32's accuracy; plain
//   single-pass TF32 keeps ~3 digits and misses the fp32 tolerances.
//   Softmax, exp, the masks and the statistics stay fp32 on the CUDA
//   cores.  Built without --use_fast_math.
// - The tensor cores truncate when they add into an accumulator, so the
//   fp32 products of each tile sum into fresh fragments and are added to
//   the running sums in fp32 with rounding: a chain of ~800 mma on one
//   accumulator drifted dK/dV by ~1e-4 at L 2048.
// - bf16: the forward rounds P to bf16 before P V, as the Pallas kernel
//   rounds p.astype(v.dtype).  The backward passes P and dS~ to its second
//   products as two bf16 terms (hi and the rest, two products each): one
//   rounding put a gradient of magnitude ~4 one bf16 ulp (0.031) away from
//   the fp32 twin, past the 2e-2 tolerance.  The N-major B operand of those
//   products (V, dO, Q, K with D contiguous) is read with ldmatrix.trans.
// - mma.sync rather than wgmma: wgmma's .tf32 form takes both operands
//   K-major only, and in P V, P^T dO, dS~^T Q and dS~ K the B operand has D
//   contiguous (N-major); it would need a transposed copy in shared memory,
//   which TMA cannot make.  mma.sync takes its fragments from registers,
//   loaded from shared memory in any layout.
// - Tiles are staged by cp.async (16 bytes, .cg) in two stages: the next
//   K/V (forward, dQ pass) or Q/dO tile with its row statistics (dK/dV
//   pass) is in flight while the current one is multiplied.  K and V have
//   separate buffers.  Rows past L and columns past D are zero-filled by
//   the copy (source size 0).  An operand whose base or strides are not
//   16-byte aligned is staged by plain loads instead, in the same kernel.
// - Rows are padded by 16 bytes, so the fragment loads of a warp (and the
//   8 row addresses of an ldmatrix phase) fall in distinct banks.
// - Causal tiles wholly above the diagonal are skipped when causality is
//   the only mask: every row then sees key 0, so a skipped key's
//   exp(finfo.min - m) is exactly 0.  The forward and the dQ pass start
//   the CTAs with the most key tiles first.
// Not yet done: wgmma + TMA with warp specialisation, one backward pass
// without the recompute, a split over keys for short Lq.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDeltaThreads = 256;
constexpr int kDeltaWarps = kDeltaThreads / 32;
constexpr int kMaxD = 256;
constexpr float kMasked = -FLT_MAX;  // finfo(float32).min

enum DType { kF32 = 0, kBF16 = 1 };
enum Op { kFwd = 0, kDelta = 1, kDkdv = 2, kDq = 3 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// element strides of a [B, H, L, D] operand; the stride over D is 1
struct Str {
  long long b, h, l;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* bias;
  const int* qseg;
  const int* kseg;
  float* stats;  // [B, H, Lq, 2] (m, log l)
  float* delta;  // [B, H, Lq]
  void* out;     // the forward's output, through the strides so
  void* dq;
  void* dk;
  void* dv;
  float* ds;  // [B, H, Lq, Lk] or null
  Str sq, sk, sv, so, sdo, sdq, sdk, sdv;
  long long bias_b, bias_h, bias_q, bias_k;
  int B, H, Lq, Lk, D;
  int causal, skip;
  int masked;               // a bias or segment ids: every tile is masked
  int vq, vk, vv, vdo;      // the operand may be staged by 16-byte copies
  float scale;
};

// ---- asynchronous copies --------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + R) of one (b, h) slice into tile[R][kS] (kS = DMAX
// plus 16 bytes), zero past L and past D: by 16-byte cp.async when the
// operand is aligned, else by plain loads (visible after the next barrier).
template <typename T, int R, int DMAX, int NT>
__device__ __forceinline__ void copy_tile(T* tile, const T* base,
                                          long long sl, int r0, int L, int D,
                                          bool vec) {
  constexpr int kV = 16 / (int)sizeof(T);  // elements per 16 bytes
  constexpr int kS = DMAX + kV;
  if (vec) {
    constexpr int CH = DMAX / kV;
#pragma unroll 4
    for (int e = threadIdx.x; e < R * CH; e += NT) {
      const int r = e / CH, c = (e % CH) * kV;
      const bool in = r0 + r < L && c < D;  // D is a multiple of 8
      const T* src = in ? base + (long long)(r0 + r) * sl + c : base;
      cp_async16(tile + r * kS + c, src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < R * DMAX; e += NT) {
      const int r = e / DMAX, c = e % DMAX;
      tile[r * kS + c] = (r0 + r < L && c < D)
                             ? base[(long long)(r0 + r) * sl + c]
                             : from_float<T>(0.f);
    }
  }
}

// The dK/dV pass's per-query-row (m, log l, delta) of rows [q0, q0 + C),
// zero past Lq, by 4-byte cp.async (a row's offset has no 16-byte
// alignment): rs[0, C) m, rs[C, 2C) log l, rs[2C, 3C) delta.
template <int C, int NT>
__device__ __forceinline__ void copy_row_stats(float* rs, const Args& a,
                                               int bh, int q0) {
  for (int r = threadIdx.x; r < C; r += NT) {
    const bool in = q0 + r < a.Lq;
    const long long row = (long long)bh * a.Lq + (in ? q0 + r : 0);
    const int n = in ? 4 : 0;
    cp_async4(rs + r, a.stats + 2 * row, n);
    cp_async4(rs + C + r, a.stats + 2 * row + 1, n);
    cp_async4(rs + 2 * C + r, a.delta + row, n);
  }
}

// ---- tensor-core products ---------------------------------------------------

// x = hi + lo for the 3xTF32 products: hi is x with the low 13 of its 23
// mantissa bits cleared (a TF32 value), lo = x - hi exactly (at most 13
// significant bits).  The tensor core reads the top 19 bits of each
// register, so lo enters with 11 of its bits and hi + lo stands for x to
// 2^-21 relative.  Two integer/fp32 operations, no conversion: cvt.rna
// for hi and for lo (2^-22) made the forward miss its 1.25x target.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: c += a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the rounding error of pack_bf16(lo, hi), packed the same way
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return pack_bf16(lo - __low2float(v), hi - __high2float(v));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ld4(float* r, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

template <int N> __device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// e^x as 2^(x log2 e): the callers pass a difference (s - m), so the
// product's rounding is relative to a small number
__device__ __forceinline__ float fexp(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// acc += c in fp32 with rounding to nearest.  The tensor cores add a
// product into their accumulator with truncation, so a long chain of mma
// on one accumulator drifts by up to an ulp of the sum per step (~1e-4 on
// dK/dV at L 2048); the TF32 products therefore sum a few k-steps into a
// fresh fragment and add it here.
__device__ __forceinline__ void add_to(float (&acc)[4], const float (&c)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

// The two products every kernel is made of, per warp, with acc in the
// m16n8 accumulator layout (lane = 4 g + t holds rows g and g + 8, columns
// 2t and 2t + 1 of each 8-wide tile):
//   rows: acc[16 x 8 NT] += A[16 x DMAX] B[8 NT x DMAX]^T, A and B staged
//         tiles (row stride kS, D contiguous): S = Q K^T, dP = dO V^T, ...
//   regs: acc[16 x 8 NO] += P[16 x 8 NK] X[8 NK x 8 NO], P in registers in
//         the accumulator layout, X a staged tile: O += P V, dQ += dS~ K...
// A contraction index may be permuted at will, as long as A and B agree;
// an output column's place in the tile is col(j, t, c), c in {0, 1}, for
// the value acc[j][c] (row g) and acc[j][c + 2] (row g + 8).
template <typename T, int DMAX> struct Mma;

// TF32 (3xTF32).  Rows are padded to kS = DMAX + 4 floats, and every
// fragment load is 16 bytes: the 8 lanes of a load phase then read 8
// distinct 16-byte bank groups.
//   rows: a round covers 32 columns; lane t reads columns 8t..8t+7 of its
//         rows, which hold mma k index t (even places) and t + 4 (odd) of
//         the round's four k-steps, as two 16-byte loads of two k-steps.
//   regs: the mma k index t is tile column 2t and t + 4 is 2t + 1 (so P's
//         accumulator pair is its A fragment); output columns are permuted
//         in groups of 32 so that lane g reads tile index g of four n-tiles
//         from one 16-byte word: col = 32 (j / 4) + 4 (2t + c) + j % 4.
template <int DMAX> struct Mma<float, DMAX> {
  static constexpr int kS = DMAX + 4;

  static __device__ __forceinline__ int col(int j, int t, int c) {
    return 32 * (j / 4) + 4 * (2 * t + c) + j % 4;
  }

  template <int NT>
  static __device__ __forceinline__ void rows(float (&acc)[NT][4],
                                              const float* A, const float* B,
                                              int lane) {
    const int g = lane / 4, t = lane % 4;
    // half a round a pass: columns 8t + 4h .. 8t + 4h + 3 hold k-steps
    // 2h and 2h + 1 (k index t, then t + 4)
#pragma unroll 1  // registers: no fragments of the next pass in flight
    for (int k = 0; k < DMAX; k += 16) {
      const int at = (k / 32) * 32 + 8 * t + (k % 32) / 4;
      uint32_t ah[2][4], al[2][4];
      {
        float r0[4], r1[4];  // rows g and g + 8
        ld4(r0, A + g * kS + at);
        ld4(r1, A + (g + 8) * kS + at);
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          split(r0[2 * st], ah[st][0], al[st][0]);
          split(r1[2 * st], ah[st][1], al[st][1]);
          split(r0[2 * st + 1], ah[st][2], al[st][2]);
          split(r1[2 * st + 1], ah[st][3], al[st][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float bv[4], c[4] = {0.f, 0.f, 0.f, 0.f};
        ld4(bv, B + (8 * j + g) * kS + at);
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          uint32_t bh[2], bl[2];
          split(bv[2 * st], bh[0], bl[0]);
          split(bv[2 * st + 1], bh[1], bl[1]);
          mma3(c, ah[st], al[st], bh, bl);
        }
        add_to(acc[j], c);
      }
    }
  }

  // G output tiles at a time: their products over the whole tile of P sum
  // into G fresh fragments (G independent mma chains), then into acc
  template <int NK, int NO, int G, bool TWO>
  static __device__ __forceinline__ void regs(float (&acc)[NO][4],
                                              const float (&p)[NK][4],
                                              const float* X, int lane) {
    static_assert(G % 4 == 0 && NO % G == 0, "n-tiles in fours");
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j0 = 0; j0 < NO; j0 += G) {
      float c[G][4];
      zero(c);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t ah[4], al[4];
        split(p[kk][0], ah[0], al[0]);
        split(p[kk][2], ah[1], al[1]);
        split(p[kk][1], ah[2], al[2]);
        split(p[kk][3], ah[3], al[3]);
        const float* x = X + (8 * kk + 2 * t) * kS + 4 * g + 8 * j0;
#pragma unroll
        for (int q = 0; q < G / 4; ++q) {
          float u[4], w[4];  // tile rows 2t and 2t + 1
          ld4(u, x + 32 * q);
          ld4(w, x + kS + 32 * q);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t bh[2], bl[2];
            split(u[jj], bh[0], bl[0]);
            split(w[jj], bh[1], bl[1]);
            mma3(c[4 * q + jj], ah, al, bh, bl);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) add_to(acc[j0 + j], c[j]);
    }
  }
};

// bf16.  Rows are padded to kS = DMAX + 8 elements, so the 8 row addresses
// of an ldmatrix phase fall in distinct bank groups; fragments come from
// ldmatrix (.trans for the N-major X of regs), columns are not permuted.
// regs rounds P to bf16 (TWO false), or passes it as two bf16 terms,
// hi = bf16(P) and lo = bf16(P - hi), which keep ~16 bits (TWO true).
template <int DMAX> struct Mma<bf16, DMAX> {
  static constexpr int kS = DMAX + 8;

  static __device__ __forceinline__ int col(int j, int t, int c) {
    return 8 * j + 2 * t + c;
  }

  template <int NT>
  static __device__ __forceinline__ void rows(float (&acc)[NT][4],
                                              const bf16* A, const bf16* B,
                                              int lane) {
    static_assert(NT % 2 == 0, "n-tiles come in pairs");
    // A: lanes 0-15 address rows 0-15 at column k, lanes 16-31 at k + 8;
    // B: lanes 0-7 / 8-15 rows 8j + 0..7 at k / k + 8, lanes 16-31 the
    // same for tile j + 1
    const bf16* a_at = A + (lane & 15) * kS + (lane >> 4) * 8;
    const bf16* b_at = B + ((lane & 7) + (lane >> 4) * 8) * kS +
                       ((lane >> 3) & 1) * 8;
#pragma unroll 1  // registers: no fragments of the next round in flight
    for (int k = 0; k < DMAX; k += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_at + k);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, b_at + 8 * j * kS + k);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
  }

  template <int NK, int NO, int G, bool TWO>
  static __device__ __forceinline__ void regs(float (&acc)[NO][4],
                                              const float (&p)[NK][4],
                                              const bf16* X, int lane) {
    static_assert(NK % 2 == 0 && NO % 2 == 0, "16-wide k, pairs of n");
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      const float(&p0)[4] = p[2 * kk];
      const float(&p1)[4] = p[2 * kk + 1];
      const uint32_t ah[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                              pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
      uint32_t al[4] = {0u, 0u, 0u, 0u};
      if (TWO) {
        al[0] = pack_bf16_rest(p0[0], p0[1]);
        al[1] = pack_bf16_rest(p0[2], p0[3]);
        al[2] = pack_bf16_rest(p1[0], p1[1]);
        al[3] = pack_bf16_rest(p1[2], p1[3]);
      }
      // lanes 0-15 address rows 16 kk + lane at column 8 j, lanes 16-31
      // the same rows at column 8 j + 8
      const bf16* x = X + (16 * kk + (lane & 15)) * kS + (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, x + 8 * j);
        if (TWO) {
          mma_bf16(acc[j], al, b[0], b[1]);
          mma_bf16(acc[j + 1], al, b[2], b[3]);
        }
        mma_bf16(acc[j], ah, b[0], b[1]);
        mma_bf16(acc[j + 1], ah, b[2], b[3]);
      }
    }
  }
};

// Whether query i sees key j: inside [0, Lq) x [0, Lk), not above the
// diagonal when causal, and of the same segment.
__device__ __forceinline__ bool key_visible(const Args& a, int b, int i,
                                            int j) {
  if (i >= a.Lq || j >= a.Lk || (a.causal && j > i)) return false;
  return a.qseg == nullptr || a.qseg[(long long)b * a.Lq + i] ==
                                  a.kseg[(long long)b * a.Lk + j];
}

// The score of (i, j) after masking and bias; -inf (no weight at all)
// outside [0, Lq) x [0, Lk).  allow says whether the raw score stood.
__device__ __forceinline__ float finish_score(const Args& a, int b, int h,
                                              int i, int j, float dot,
                                              bool& allow) {
  if (i >= a.Lq || j >= a.Lk) {
    allow = false;
    return -INFINITY;
  }
  allow = key_visible(a, b, i, j);
  float s = allow ? dot * a.scale : kMasked;
  if (a.bias != nullptr)
    s += a.bias[b * a.bias_b + h * a.bias_h + (long long)i * a.bias_q +
                (long long)j * a.bias_k];
  return s;
}

// Whether the tile of query rows [i0, i0 + RI) and keys [j0, j0 + RJ)
// needs finish_score, or every raw score stands (dot * scale).
__device__ __forceinline__ bool tile_masked(const Args& a, int i0, int RI,
                                            int j0, int RJ) {
  return a.masked || i0 + RI > a.Lq || j0 + RJ > a.Lk ||
         (a.causal && j0 + RJ - 1 > i0);
}

// Write rows r and r + 8 (< L) of acc * mul, the warp's output columns
// c0 + M::col(n, t, c), into one (b, h) slice.
template <typename T, typename M, int NO>
__device__ __forceinline__ void store_rows(T* base, long long sl, int r,
                                           int L, int c0, int D, int t,
                                           const float (&acc)[NO][4],
                                           float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= L) continue;
    T* p = base + (long long)row * sl;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = c0 + M::col(n, t, c);
        if (d < D) p[d] = from_float<T>(acc[n][2 * half + c] * mul);
      }
  }
}

// A CTA of ROWS / 16 row-warps x NSPLIT column-warps: warp (rw, cw) owns
// rows 16 rw.. of the CTA's tile and output columns [cw DW, (cw + 1) DW),
// DW = DMAX / NSPLIT (the warps of one row group compute the same scores).
template <int ROWS, int NSPLIT>
__host__ __device__ constexpr int threads_of() {
  return ROWS / 16 * NSPLIT * 32;
}

// ---- forward --------------------------------------------------------------

template <typename T, int DMAX, int ROWS, int COLS, int NSPLIT>
__global__ void __launch_bounds__(threads_of<ROWS, NSPLIT>())
    flash_fwd(const Args a) {
  using M = Mma<T, DMAX>;
  constexpr int kS = M::kS, NWR = ROWS / 16, NT = threads_of<ROWS, NSPLIT>();
  constexpr int NK = COLS / 8, DW = DMAX / NSPLIT, NO = DW / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + ROWS * kS;      // two stages
  T* Vs = Ks + 2 * COLS * kS;  // two stages
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4, rw = warp % NWR, cw = warp / NWR;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // longest first
  const int r0 = q0 + 16 * rw + lane / 4;              // rows r0, r0 + 8
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const int k_end = a.skip ? min(a.Lk, q0 + ROWS) : a.Lk;
  const int n_tiles = (k_end + COLS - 1) / COLS;
  copy_tile<T, ROWS, DMAX, NT>(Qs, q, a.sq.l, q0, a.Lq, a.D, a.vq);
  copy_tile<T, COLS, DMAX, NT>(Ks, k, a.sk.l, 0, a.Lk, a.D, a.vk);
  copy_tile<T, COLS, DMAX, NT>(Vs, v, a.sv.l, 0, a.Lk, a.D, a.vv);
  cp_commit();

  float o[NO][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * COLS;
    const T* Kt = Ks + (it & 1) * COLS * kS;
    const T* Vt = Vs + (it & 1) * COLS * kS;
    if (it + 1 < n_tiles) {  // the next tile into the other stage
      const int nxt = ((it + 1) & 1) * COLS * kS;
      copy_tile<T, COLS, DMAX, NT>(Ks + nxt, k, a.sk.l, k0 + COLS, a.Lk, a.D,
                                   a.vk);
      copy_tile<T, COLS, DMAX, NT>(Vs + nxt, v, a.sv.l, k0 + COLS, a.Lk, a.D,
                                   a.vv);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[NK][4];
    zero(s);
    M::template rows<NK>(s, Qs + 16 * rw * kS, Kt, lane);
    const bool need = tile_masked(a, q0, ROWS, k0, COLS);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool allow;
        s[j][e] = need ? finish_score(a, b, h, r0 + 8 * (e / 2),
                                      k0 + 8 * j + 2 * t + (e & 1), s[j][e],
                                      allow)
                       : s[j][e] * a.scale;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row that has seen only -inf so far keeps p = 0 and alpha = 0
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = fexp(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= alpha;  // this lane's share of the row sum
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fexp(s[j][e] - m_use[e / 2]);
        l[e / 2] += s[j][e];
      }
        M::template regs<NK, NO, NO, false>(o, s, Vt + cw * DW, lane);  // P V
    __syncthreads();  // the stage is read out before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / l[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * r] *= inv;
      o[n][2 * r + 1] *= inv;
    }
  }
  store_rows<T, M, NO>(static_cast<T*>(a.out) + b * a.so.b + h * a.so.h,
                    a.so.l, r0, a.Lq, cw * DW, a.D, t, o, 1.f);
  if (t == 0 && cw == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + 8 * r;
      if (i >= a.Lq) continue;
      float* st = a.stats + ((long long)bh * a.Lq + i) * 2;
      st[0] = m[r];
      st[1] = logf(l[r]);
    }
  }
}

// ---- backward -----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads) flash_bwd_delta(const Args a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kDeltaWarps + warp;
  if (row >= (long long)a.B * a.H * a.Lq) return;
  const int i = (int)(row % a.Lq);
  const int bh = (int)(row / a.Lq), b = bh / a.H, h = bh % a.H;
  const T* o = static_cast<const T*>(a.o) + b * a.so.b + h * a.so.h +
               (long long)i * a.so.l;
  const T* g = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h +
               (long long)i * a.sdo.l;
  float acc = 0.f;
  for (int d = lane; d < a.D; d += 32) acc += to_float(o[d]) * to_float(g[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// A CTA owns ROWS keys; it loops over COLS-query tiles of Q, dO and their
// row statistics, computing S^T = K Q^T and dP^T = V dO^T with the keys as
// the warp's rows, then dV += P^T dO and dK += dS~^T Q.  With NSPLIT 2 the
// two warps of a row group share the work instead of repeating it: one
// computes S^T (and P^T), the other dP^T, they swap the two through shared
// memory, and each accumulates dK and dV over its half of D -- 2 x 32
// accumulator registers a thread at D 128 instead of 2 x 64.
template <typename T, int DMAX, int ROWS, int COLS, int NSPLIT>
__global__ void __launch_bounds__(threads_of<ROWS, NSPLIT>())
    flash_bwd_dkdv(const Args a) {
  static_assert(NSPLIT == 1 || NSPLIT == 2, "one warp or a pair a row group");
  using M = Mma<T, DMAX>;
  constexpr int kS = M::kS, NWR = ROWS / 16, NT = threads_of<ROWS, NSPLIT>();
  constexpr int NK = COLS / 8, DW = DMAX / NSPLIT, NO = DW / 8;
  constexpr int G = NO <= 8 ? NO : NO / 2;  // fresh output tiles at a time
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + ROWS * kS;
  T* Qs = Vs + ROWS * kS;       // two stages
  T* dOs = Qs + 2 * COLS * kS;  // two stages
  float* Rs = reinterpret_cast<float*>(dOs + 2 * COLS * kS);  // two stages
  float* Xs = Rs + 6 * COLS;  // NSPLIT 2: [NWR][2][NK * 4][32] swap space
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4, rw = warp % NWR, cw = warp / NWR;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * ROWS;        // the most query tiles first
  const int c0 = k0 + 16 * rw + lane / 4;  // key rows c0, c0 + 8
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* g = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  // causal-only: query rows below k0 see none of these keys
  const int q_begin = a.skip ? k0 : 0;
  const int n_tiles = q_begin < a.Lq ? (a.Lq - q_begin + COLS - 1) / COLS : 0;
  copy_tile<T, ROWS, DMAX, NT>(Ks, k, a.sk.l, k0, a.Lk, a.D, a.vk);
  copy_tile<T, ROWS, DMAX, NT>(Vs, v, a.sv.l, k0, a.Lk, a.D, a.vv);
  if (n_tiles > 0) {
    copy_tile<T, COLS, DMAX, NT>(Qs, q, a.sq.l, q_begin, a.Lq, a.D, a.vq);
    copy_tile<T, COLS, DMAX, NT>(dOs, g, a.sdo.l, q_begin, a.Lq, a.D, a.vdo);
    copy_row_stats<COLS, NT>(Rs, a, bh, q_begin);
  }
  cp_commit();

  float dk[NO][4], dv[NO][4];
  zero(dk);
  zero(dv);
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * COLS;
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = cur ^ 1;
      copy_tile<T, COLS, DMAX, NT>(Qs + nxt * COLS * kS, q, a.sq.l,
                                   q0 + COLS, a.Lq, a.D, a.vq);
      copy_tile<T, COLS, DMAX, NT>(dOs + nxt * COLS * kS, g, a.sdo.l,
                                   q0 + COLS, a.Lq, a.D, a.vdo);
      copy_row_stats<COLS, NT>(Rs + nxt * 3 * COLS, a, bh, q0 + COLS);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + cur * COLS * kS;
    const T* dOt = dOs + cur * COLS * kS;
    const float* rowm = Rs + cur * 3 * COLS;
    const float* rowl = rowm + COLS;
    const float* rowd = rowl + COLS;
    const bool need = tile_masked(a, q0, COLS, k0, ROWS);
    float p[NK][4], ds[NK][4];  // S^T, then P^T; dP^T, then dS~^T
    zero(p);
    zero(ds);
    if (NSPLIT == 1 || cw == 0) {
      M::template rows<NK>(p, Ks + 16 * rw * kS, Qt, lane);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);  // query q0 + c
          bool allow;
          const float s = need ? finish_score(a, b, h, q0 + c,
                                              c0 + 8 * (e / 2), p[j][e], allow)
                               : p[j][e] * a.scale;
          // (s - m) first: for a fully masked row it is exactly 0
          p[j][e] = fexp((s - rowm[c]) - rowl[c]);
        }
    }
    if (NSPLIT == 1) {  // dV first: dS~ is not live during its product
      M::template regs<NK, NO, G, true>(dv, p, dOt, lane);  // P^T dO
    }
    if (NSPLIT == 1 || cw == 1)
      M::template rows<NK>(ds, Vs + 16 * rw * kS, dOt, lane);
    if (NSPLIT == 2) {  // swap P^T and dP^T within the row group
      float* mine = Xs + ((rw * 2 + cw) * NK * 4) * 32 + lane;
      float* other = Xs + ((rw * 2 + (cw ^ 1)) * NK * 4) * 32 + lane;
      if (cw == 0) {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = p[j][e];
      } else {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = ds[j][e];
      }
      __syncthreads();
      if (cw == 0) {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[j][e] = other[(4 * j + e) * 32];
      } else {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[j][e] = other[(4 * j + e) * 32];
      }
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const bool allow = !need || key_visible(a, b, q0 + c, c0 + 8 * (e / 2));
        ds[j][e] = allow ? p[j][e] * (ds[j][e] - rowd[c]) : 0.f;
      }
    if (NSPLIT == 2)
      M::template regs<NK, NO, G, true>(dv, p, dOt + cw * DW, lane);  // P^T dO
    M::template regs<NK, NO, G, true>(dk, ds, Qt + cw * DW, lane);  // dS~^T Q
    __syncthreads();  // the stage is read out before it is refilled
  }
  cp_wait<0>();  // nothing left in flight when no query tile was visited
  store_rows<T, M, NO>(static_cast<T*>(a.dk) + b * a.sdk.b + h * a.sdk.h,
                       a.sdk.l, c0, a.Lk, cw * DW, a.D, t, dk, a.scale);
  store_rows<T, M, NO>(static_cast<T*>(a.dv) + b * a.sdv.b + h * a.sdv.h,
                       a.sdv.l, c0, a.Lk, cw * DW, a.D, t, dv, 1.f);
}

// A CTA owns ROWS queries; it loops over COLS-key tiles of K and V,
// computing S = Q K^T and dP = dO V^T, then dQ += dS~ K (and dS to device
// memory for the bias gradient).
template <typename T, int DMAX, int ROWS, int COLS, int NSPLIT>
__global__ void __launch_bounds__(threads_of<ROWS, NSPLIT>())
    flash_bwd_dq(const Args a) {
  using M = Mma<T, DMAX>;
  constexpr int kS = M::kS, NWR = ROWS / 16, NT = threads_of<ROWS, NSPLIT>();
  constexpr int NK = COLS / 8, DW = DMAX / NSPLIT, NO = DW / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + ROWS * kS;
  T* Ks = dOs + ROWS * kS;     // two stages
  T* Vs = Ks + 2 * COLS * kS;  // two stages
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4, rw = warp % NWR, cw = warp / NWR;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // longest first
  const int r0 = q0 + 16 * rw + lane / 4;              // rows r0, r0 + 8
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* g = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const int k_end = a.skip ? min(a.Lk, q0 + ROWS) : a.Lk;
  const int n_tiles = (k_end + COLS - 1) / COLS;
  copy_tile<T, ROWS, DMAX, NT>(Qs, q, a.sq.l, q0, a.Lq, a.D, a.vq);
  copy_tile<T, ROWS, DMAX, NT>(dOs, g, a.sdo.l, q0, a.Lq, a.D, a.vdo);
  copy_tile<T, COLS, DMAX, NT>(Ks, k, a.sk.l, 0, a.Lk, a.D, a.vk);
  copy_tile<T, COLS, DMAX, NT>(Vs, v, a.sv.l, 0, a.Lk, a.D, a.vv);
  cp_commit();
  float rm[2], rl[2], rd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + 8 * r;
    const long long row = (long long)bh * a.Lq + i;
    const bool in = i < a.Lq;
    rm[r] = in ? a.stats[row * 2] : 0.f;
    rl[r] = in ? a.stats[row * 2 + 1] : 0.f;
    rd[r] = in ? a.delta[row] : 0.f;
  }

  float dq[NO][4];
  zero(dq);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * COLS;
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = (cur ^ 1) * COLS * kS;
      copy_tile<T, COLS, DMAX, NT>(Ks + nxt, k, a.sk.l, k0 + COLS, a.Lk, a.D,
                                   a.vk);
      copy_tile<T, COLS, DMAX, NT>(Vs + nxt, v, a.sv.l, k0 + COLS, a.Lk, a.D,
                                   a.vv);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + cur * COLS * kS;
    const T* Vt = Vs + cur * COLS * kS;
    float s[NK][4], ds[NK][4];  // S; dP then dS~
    zero(s);
    zero(ds);
    M::template rows<NK>(s, Qs + 16 * rw * kS, Kt, lane);
    M::template rows<NK>(ds, dOs + 16 * rw * kS, Vt, lane);
    const bool need = tile_masked(a, q0, ROWS, k0, COLS);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, i = r0 + 8 * r, c = k0 + 8 * j + 2 * t + (e & 1);
        bool allow = true;
        const float x = need ? finish_score(a, b, h, i, c, s[j][e], allow)
                             : s[j][e] * a.scale;
        // (s - m) first: for a fully masked row it is exactly 0
        const float p = fexp((x - rm[r]) - rl[r]);
        const float d = p * (ds[j][e] - rd[r]);
        if (a.ds != nullptr && cw == 0 && i < a.Lq && c < a.Lk)
          a.ds[((long long)bh * a.Lq + i) * a.Lk + c] = d;
        ds[j][e] = allow ? d : 0.f;
      }
    M::template regs<NK, NO, NO, true>(dq, ds, Kt + cw * DW, lane);  // dS~ K
    __syncthreads();  // the stage is read out before it is refilled
  }
  store_rows<T, M, NO>(static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h,
                    a.sdq.l, r0, a.Lq, cw * DW, a.D, t, dq, a.scale);
}

// ---- launch -------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// One kernel's tiles: ROWS owned rows (16 per row-warp), COLS rows per
// streamed tile, NSPLIT warps sharing a row group over D.
template <int ROWS_, int COLS_, int NSPLIT_> struct Tiles {
  static constexpr int ROWS = ROWS_, COLS = COLS_, NSPLIT = NSPLIT_;
};

template <typename T, int DMAX, typename F, typename Q, typename KV>
cudaError_t run_tiled(int op, const Args& a, cudaStream_t stream) {
  constexpr int kRow = (int)sizeof(T) * Mma<T, DMAX>::kS;  // bytes a row
  const unsigned bh = (unsigned)(a.B * a.H);
  switch (op) {
    case kFwd:
      return launch(flash_fwd<T, DMAX, F::ROWS, F::COLS, F::NSPLIT>,
                    dim3((a.Lq + F::ROWS - 1) / F::ROWS, bh),
                    threads_of<F::ROWS, F::NSPLIT>(),
                    (size_t)kRow * (F::ROWS + 4 * F::COLS), stream, a);
    case kDq:
      return launch(flash_bwd_dq<T, DMAX, Q::ROWS, Q::COLS, Q::NSPLIT>,
                    dim3((a.Lq + Q::ROWS - 1) / Q::ROWS, bh),
                    threads_of<Q::ROWS, Q::NSPLIT>(),
                    (size_t)kRow * (2 * Q::ROWS + 4 * Q::COLS), stream, a);
    case kDkdv:
      return launch(flash_bwd_dkdv<T, DMAX, KV::ROWS, KV::COLS, KV::NSPLIT>,
                    dim3((a.Lk + KV::ROWS - 1) / KV::ROWS, bh),
                    threads_of<KV::ROWS, KV::NSPLIT>(),
                    (size_t)kRow * (2 * KV::ROWS + 4 * KV::COLS) +
                        sizeof(float) * 6 * KV::COLS +
                        (KV::NSPLIT == 2 ? sizeof(float) * KV::ROWS / 16 *
                                               KV::COLS * 32
                                         : 0),
                    stream, a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run_typed(int op, const Args& a, cudaStream_t stream) {
  if (op == kDelta) {
    const long long rows = (long long)a.B * a.H * a.Lq;
    flash_bwd_delta<T><<<(unsigned)((rows + kDeltaWarps - 1) / kDeltaWarps),
                         kDeltaThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  // Tiles by head_dim, sized for fp32 (bf16 takes half the shared
  // memory).  Up to D 64: four warps owning 64 rows, 64-row tiles
  // streamed (32 in the dK/dV pass, whose two accumulators would spill
  // with two 64-wide score tiles), two CTAs an SM.  Up to D 128: the
  // forward and the dQ pass have eight warps owning 128 rows, streaming 64
  // and 32 rows a stage (170-203 KB); the dK/dV pass pairs two warps on
  // each of four 16-key row groups (152 KB).  At D 256 two warps share
  // each row group, one owning each half of D, so no warp holds more than
  // 128 accumulator columns.
  if (a.D <= 64)
    return run_tiled<T, 64, Tiles<64, 64, 1>, Tiles<64, 64, 1>,
                     Tiles<64, 32, 1>>(op, a, stream);
  if (a.D <= 128)
    return run_tiled<T, 128, Tiles<128, 64, 1>, Tiles<128, 32, 1>,
                     Tiles<64, 32, 2>>(op, a, stream);
  return run_tiled<T, 256, Tiles<64, 32, 2>, Tiles<32, 32, 2>,
                   Tiles<32, 32, 2>>(op, a, stream);
}

Str str_at(const long long* s, int i) {
  return Str{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// whether every row of the operand starts on 16 bytes
int aligned16(const void* p, const Str& s, int elem) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (s.b * elem) % 16 == 0 && (s.h * elem) % 16 == 0 &&
         (s.l * elem) % 16 == 0;
}

// strides: 28 int64 -- (batch, head, row) element strides of q, k, v, o,
// dout, dq, dk, dv in that order, then the bias's (batch, head, query,
// key) strides (0 on a broadcast axis).  Unused entries are ignored.
int run(int op, int dtype, Args& a, const long long* strides, int causal,
        void* stream) {
  if (a.B < 1 || a.H < 1 || a.B * a.H > 65535 || a.Lq < 1 || a.Lk < 1 ||
      a.D < 1 || a.D > kMaxD || a.D % 8 != 0 ||
      (a.qseg == nullptr) != (a.kseg == nullptr) || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  a.sq = str_at(strides, 0);
  a.sk = str_at(strides, 1);
  a.sv = str_at(strides, 2);
  a.so = str_at(strides, 3);
  a.sdo = str_at(strides, 4);
  a.sdq = str_at(strides, 5);
  a.sdk = str_at(strides, 6);
  a.sdv = str_at(strides, 7);
  a.bias_b = strides[24];
  a.bias_h = strides[25];
  a.bias_q = strides[26];
  a.bias_k = strides[27];
  a.causal = causal != 0;
  a.skip = a.causal && a.bias == nullptr && a.qseg == nullptr;
  a.masked = a.bias != nullptr || a.qseg != nullptr;
  const int elem = dtype == kBF16 ? 2 : 4;
  a.vq = aligned16(a.q, a.sq, elem);
  a.vk = aligned16(a.k, a.sk, elem);
  a.vv = aligned16(a.v, a.sv, elem);
  a.vdo = aligned16(a.dout, a.sdo, elem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)run_typed<float>(op, a, s);
    case kBF16: return (int)run_typed<bf16>(op, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Forward.  q [B,H,Lq,D], k/v [B,H,Lk,D] (f32 or bf16, unit stride over
// D); bias fp32 through its strides, or null; qseg [B,Lq] / kseg [B,Lk]
// int32, both or neither; out like q (through its strides); stats
// [B,H,Lq,2] fp32 contiguous.  Returns the launch's cudaError_t.
int ptt_flash_attention_forward(int dtype, const void* q, const void* k,
                                const void* v, const float* bias,
                                const int* qseg, const int* kseg, void* out,
                                float* stats, const long long* strides, int B,
                                int H, int Lq, int Lk, int D, int causal,
                                float scale, void* stream) {
  if (out == nullptr || stats == nullptr) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.qseg = qseg;
  a.kseg = kseg;
  a.out = out;
  a.stats = stats;
  a.B = B;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.D = D;
  a.scale = scale;
  return run(kFwd, dtype, a, strides, causal, stream);
}

// Backward preprocess: delta [B,H,Lq] fp32 = rowsum(dout * o).
int ptt_flash_attention_bwd_delta(int dtype, const void* o, const void* dout,
                                  float* delta, const long long* strides,
                                  int B, int H, int Lq, int D, void* stream) {
  if (o == nullptr || dout == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.o = o;
  a.dout = dout;
  a.delta = delta;
  a.B = B;
  a.H = H;
  a.Lq = Lq;
  a.Lk = 1;
  a.D = D;
  return run(kDelta, dtype, a, strides, 0, stream);
}

// Backward dK/dV pass (grid over key tiles).  Inputs as the forward plus
// dout, the forward's stats and delta; dk/dv like k/v through strides.
int ptt_flash_attention_bwd_dkdv(int dtype, const void* q, const void* k,
                                 const void* v, const float* bias,
                                 const int* qseg, const int* kseg,
                                 const void* dout, const float* stats,
                                 const float* delta, void* dk, void* dv,
                                 const long long* strides, int B, int H,
                                 int Lq, int Lk, int D, int causal,
                                 float scale, void* stream) {
  if (dk == nullptr || dv == nullptr || stats == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.qseg = qseg;
  a.kseg = kseg;
  a.dout = dout;
  a.stats = const_cast<float*>(stats);
  a.delta = const_cast<float*>(delta);
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.D = D;
  a.scale = scale;
  return run(kDkdv, dtype, a, strides, causal, stream);
}

// Backward dQ pass (grid over query tiles); also writes dS [B,H,Lq,Lk]
// fp32 (the bias gradient before any broadcast sum) when ds is not null.
int ptt_flash_attention_bwd_dq(int dtype, const void* q, const void* k,
                               const void* v, const float* bias,
                               const int* qseg, const int* kseg,
                               const void* dout, const float* stats,
                               const float* delta, void* dq, float* ds,
                               const long long* strides, int B, int H, int Lq,
                               int Lk, int D, int causal, float scale,
                               void* stream) {
  if (dq == nullptr || stats == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.qseg = qseg;
  a.kseg = kseg;
  a.dout = dout;
  a.stats = const_cast<float*>(stats);
  a.delta = const_cast<float*>(delta);
  a.dq = dq;
  a.ds = ds;
  a.B = B;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.D = D;
  a.scale = scale;
  return run(kDq, dtype, a, strides, causal, stream);
}

}  // extern "C"
