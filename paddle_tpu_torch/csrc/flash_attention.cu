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
// Kernels (256 threads a CTA, grid.y = b * H + h):
//   flash_fwd        grid over Q tiles, loops over K/V tiles, online softmax
//   flash_bwd_delta  one warp per query row
//   flash_bwd_dkdv   grid over K tiles, loops over Q tiles
//   flash_bwd_dq     grid over Q tiles, loops over K tiles
// Two passes instead of atomics keep the gradients deterministic.  Every
// [B,H,L,D] operand is addressed through its own (batch, head, row)
// strides with unit stride over D, so the transposed head views of the
// attention layer are read and written in place, and a broadcast bias is
// read through stride 0.
//
// Bound: at the training shape (B 2, H 16, L 2048, D 128, causal, fp32)
// the forward does ~2.2e10 flops against ~34 MB of q/k/v/o, far above the
// card's flop-per-byte ratio, so it is bound by operations; in fp32 without
// TF32 that is the CUDA cores' 67 TFLOP/s.  This first design keeps the
// O(L^2) scores on chip (the composition writes [B,H,L,L] to device memory)
// and feeds the FMAs from shared memory: tiles are staged in fp32 with rows
// padded by one float, so the 16 lanes of a row group that read 16
// different rows hit 16 banks, and each thread computes a (tile/16)^2 block
// of scores or a (tile/16) x (D/16) block of outputs from broadcast or
// consecutive shared loads.  Causal tiles wholly above the diagonal are
// skipped when causality is the only mask: every row then sees key 0, so
// a skipped key's exp(finfo.min - m) is exactly 0.
// Not yet done: tensor-core tiles (mma/wgmma: bf16 at full rate, TF32 for
// fp32), cp.async/TMA double buffering, a split over keys for short Lq.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of (ty, tx)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr float kMasked = -FLT_MAX;  // finfo(float32).min

enum DType { kF32 = 0, kBF16 = 1 };
enum Op { kFwd = 0, kDelta = 1, kDkdv = 2, kDq = 3 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
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
  float scale;
};

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The score of (i, j) after masking and bias; -inf (no weight at all)
// outside [0, Lq) x [0, Lk).  *allowed says whether the raw score stood.
__device__ __forceinline__ float finish_score(const Args& a, int b, int h,
                                              int i, int j, float dot,
                                              bool* allowed) {
  if (i >= a.Lq || j >= a.Lk) {
    *allowed = false;
    return -INFINITY;
  }
  bool allow = !(a.causal && j > i);
  if (a.qseg != nullptr)
    allow = allow && a.qseg[(long long)b * a.Lq + i] ==
                         a.kseg[(long long)b * a.Lk + j];
  float s = allow ? dot * a.scale : kMasked;
  if (a.bias != nullptr)
    s += a.bias[b * a.bias_b + h * a.bias_h + i * a.bias_q + j * a.bias_k];
  *allowed = allow;
  return s;
}

// Stage rows [r0, r0 + R) of one (b, h) slice into tile[R][DMAX + 1] as
// fp32, zero past L and past D.
template <typename T, int R, int DMAX>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          long long sl, int r0, int L,
                                          int D) {
  for (int e = threadIdx.x; e < R * DMAX; e += kThreads) {
    const int r = e / DMAX, d = e % DMAX;
    float x = 0.f;
    if (r0 + r < L && d < D) x = to_float(base[(long long)(r0 + r) * sl + d]);
    tile[r * (DMAX + 1) + d] = x;
  }
}

// s[i][j] = sum_{d < D} A[ty + 16 i][d] * Bm[tx + 16 j][d]
template <int RA, int RB, int DMAX>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int D, int ty, int tx,
                                         float (&s)[RA][RB]) {
  constexpr int kS = DMAX + 1;
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[RA], y[RB];
#pragma unroll
    for (int i = 0; i < RA; ++i) x[i] = A[(ty + 16 * i) * kS + d];
#pragma unroll
    for (int j = 0; j < RB; ++j) y[j] = Bm[(tx + 16 * j) * kS + d];
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// acc[i][n] += sum_{c < C} P(ty + 16 i, c) * M[c][tx + 16 n], where
// P(r, c) is P[r][c] (TRANS false) or P[c][r] (TRANS true); P has row
// stride PS, M has row stride DMAX + 1.
template <bool TRANS, int RA, int DMAX, int PS, int C>
__device__ __forceinline__ void tile_acc(const float* P, const float* M,
                                         int ty, int tx,
                                         float (&acc)[RA][DMAX / 16]) {
  constexpr int kS = DMAX + 1;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float p[RA];
#pragma unroll
    for (int i = 0; i < RA; ++i)
      p[i] = TRANS ? P[c * PS + ty + 16 * i] : P[(ty + 16 * i) * PS + c];
#pragma unroll
    for (int n = 0; n < DMAX / 16; ++n) {
      const float m = M[c * kS + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < RA; ++i) acc[i][n] = fmaf(p[i], m, acc[i][n]);
    }
  }
}

// Write rows r0 + ty + 16 i (< L) of acc * mul into one (b, h) slice.
template <typename T, int RA, int DMAX>
__device__ __forceinline__ void store_rows(T* base, long long sl, int r0,
                                           int L, int D, int ty, int tx,
                                           const float (&acc)[RA][DMAX / 16],
                                           float mul) {
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= L) continue;
#pragma unroll
    for (int n = 0; n < DMAX / 16; ++n) {
      const int d = tx + 16 * n;
      if (d < D) base[(long long)r * sl + d] = from_float<T>(acc[i][n] * mul);
    }
  }
}

// ---- forward ------------------------------------------------------------

template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Args a) {
  constexpr int RQ = BQ / 16, RK = BK / 16, ND = DMAX / 16;
  constexpr int DS = DMAX + 1, PS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KVs = Qs + BQ * DS;  // K, then V, of the current key tile
  float* Ps = KVs + BK * DS;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  load_tile<T, BQ, DMAX>(Qs, q, a.sq.l, q0, a.Lq, a.D);

  float m[RQ], l[RQ], acc[RQ][ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[i][n] = 0.f;
  }
  const int k_end = a.skip ? min(a.Lk, q0 + BQ) : a.Lk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q staged; the last tile's reads of KVs/Ps are done
    load_tile<T, BK, DMAX>(KVs, k, a.sk.l, k0, a.Lk, a.D);
    __syncthreads();
    float s[RQ][RK];
    tile_dot<RQ, RK, DMAX>(Qs, KVs, a.D, ty, tx, s);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        bool allowed;
        s[i][j] = finish_score(a, b, h, q0 + r, k0 + tx + 16 * j, s[i][j],
                               &allowed);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group16_max(mx);
      const float m_new = fmaxf(m[i], mx);
      // a row that has seen only -inf so far keeps p = 0 and alpha = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(s[i][j] - m_use);
        Ps[r * PS + tx + 16 * j] = p;
        sum += p;
      }
      sum = group16_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();  // every score of the tile is read out of KVs
    load_tile<T, BK, DMAX>(KVs, v, a.sv.l, k0, a.Lk, a.D);
    __syncthreads();
    tile_acc<false, RQ, DMAX, PS, BK>(Ps, KVs, ty, tx, acc);
  }

  T* o = static_cast<T*>(a.out) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.Lq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = tx + 16 * n;
      if (d < a.D)
        o[(long long)r * a.so.l + d] = from_float<T>(acc[i][n] * inv);
    }
    if (tx == 0) {
      float* st = a.stats + ((long long)bh * a.Lq + r) * 2;
      st[0] = m[i];
      st[1] = logf(l[i]);
    }
  }
}

// ---- backward -----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(const Args a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + warp;
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

// Stage the softmax statistics and delta of query rows [q0, q0 + BQ).
template <int BQ>
__device__ __forceinline__ void load_row_stats(const Args& a, int bh, int q0,
                                               float* rowm, float* rowl,
                                               float* rowd) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const long long row = (long long)bh * a.Lq + q0 + r;
    const bool in = q0 + r < a.Lq;
    rowm[r] = in ? a.stats[row * 2] : 0.f;
    rowl[r] = in ? a.stats[row * 2 + 1] : 0.f;
    rowd[r] = in ? a.delta[row] : 0.f;
  }
}

// For the (BQ x BK) tile at (q0, k0): P into p, dS into ds, the mask into
// allow.  Qs/dOs hold the Q and dO rows, Ks/Vs the K and V rows.
template <int RQ, int RK, int DMAX>
__device__ __forceinline__ void tile_grads(
    const Args& a, int b, int h, int q0, int k0, const float* Qs,
    const float* dOs, const float* Ks, const float* Vs, const float* rowm,
    const float* rowl, const float* rowd, int ty, int tx, float (&p)[RQ][RK],
    float (&ds)[RQ][RK], bool (&allow)[RQ][RK]) {
  tile_dot<RQ, RK, DMAX>(Qs, Ks, a.D, ty, tx, p);
  tile_dot<RQ, RK, DMAX>(dOs, Vs, a.D, ty, tx, ds);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const float s = finish_score(a, b, h, q0 + r, k0 + tx + 16 * j, p[i][j],
                                   &allow[i][j]);
      // (s - m) first: for a fully masked row it is exactly 0
      p[i][j] = expf((s - rowm[r]) - rowl[r]);
      ds[i][j] = p[i][j] * (ds[i][j] - rowd[r]);
    }
  }
}

template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(const Args a) {
  constexpr int RQ = BQ / 16, RK = BK / 16, ND = DMAX / 16;
  constexpr int DS = DMAX + 1, PS = BK + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * DS;
  float* Qs = Vs + BK * DS;
  float* dOs = Qs + BQ * DS;
  float* Ps = dOs + BQ * DS;  // P, then dS~, of the current tile
  float* rowm = Ps + BQ * PS;
  float* rowl = rowm + BQ;
  float* rowd = rowl + BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * BK;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* g = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  load_tile<T, BK, DMAX>(Ks, k, a.sk.l, k0, a.Lk, a.D);
  load_tile<T, BK, DMAX>(Vs, v, a.sv.l, k0, a.Lk, a.D);

  float dk[RK][ND], dv[RK][ND];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n) dk[i][n] = dv[i][n] = 0.f;
  // causal-only: query rows below k0 see none of these keys
  const int q_begin = a.skip ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < a.Lq; q0 += BQ) {
    __syncthreads();  // the last tile's reads of Qs/dOs/Ps are done
    load_tile<T, BQ, DMAX>(Qs, q, a.sq.l, q0, a.Lq, a.D);
    load_tile<T, BQ, DMAX>(dOs, g, a.sdo.l, q0, a.Lq, a.D);
    load_row_stats<BQ>(a, bh, q0, rowm, rowl, rowd);
    __syncthreads();
    float p[RQ][RK], ds[RQ][RK];
    bool allow[RQ][RK];
    tile_grads<RQ, RK, DMAX>(a, b, h, q0, k0, Qs, dOs, Ks, Vs, rowm, rowl,
                             rowd, ty, tx, p, ds, allow);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j)
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p[i][j];
    __syncthreads();
    tile_acc<true, RK, DMAX, PS, BQ>(Ps, dOs, ty, tx, dv);  // P^T dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j)
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = allow[i][j] ? ds[i][j] : 0.f;
    __syncthreads();
    tile_acc<true, RK, DMAX, PS, BQ>(Ps, Qs, ty, tx, dk);  // dS~^T Q
  }
  store_rows<T, RK, DMAX>(static_cast<T*>(a.dk) + b * a.sdk.b + h * a.sdk.h,
                          a.sdk.l, k0, a.Lk, a.D, ty, tx, dk, a.scale);
  store_rows<T, RK, DMAX>(static_cast<T*>(a.dv) + b * a.sdv.b + h * a.sdv.h,
                          a.sdv.l, k0, a.Lk, a.D, ty, tx, dv, 1.f);
}

template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const Args a) {
  constexpr int RQ = BQ / 16, RK = BK / 16, ND = DMAX / 16;
  constexpr int DS = DMAX + 1, PS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * DS;
  float* Ks = dOs + BQ * DS;
  float* Vs = Ks + BK * DS;
  float* Ps = Vs + BK * DS;  // dS~ of the current tile
  float* rowm = Ps + BQ * PS;
  float* rowl = rowm + BQ;
  float* rowd = rowl + BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* g = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  load_tile<T, BQ, DMAX>(Qs, q, a.sq.l, q0, a.Lq, a.D);
  load_tile<T, BQ, DMAX>(dOs, g, a.sdo.l, q0, a.Lq, a.D);
  load_row_stats<BQ>(a, bh, q0, rowm, rowl, rowd);

  float dq[RQ][ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n) dq[i][n] = 0.f;
  const int k_end = a.skip ? min(a.Lk, q0 + BQ) : a.Lk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q/dO/stats staged; the last tile's reads are done
    load_tile<T, BK, DMAX>(Ks, k, a.sk.l, k0, a.Lk, a.D);
    load_tile<T, BK, DMAX>(Vs, v, a.sv.l, k0, a.Lk, a.D);
    __syncthreads();
    float p[RQ][RK], ds[RQ][RK];
    bool allow[RQ][RK];
    tile_grads<RQ, RK, DMAX>(a, b, h, q0, k0, Qs, dOs, Ks, Vs, rowm, rowl,
                             rowd, ty, tx, p, ds, allow);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int c = k0 + tx + 16 * j;
        if (a.ds != nullptr && r < a.Lq && c < a.Lk)
          a.ds[((long long)bh * a.Lq + r) * a.Lk + c] = ds[i][j];
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = allow[i][j] ? ds[i][j] : 0.f;
      }
    }
    __syncthreads();
    tile_acc<false, RQ, DMAX, PS, BK>(Ps, Ks, ty, tx, dq);  // dS~ K
  }
  store_rows<T, RQ, DMAX>(static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h,
                          a.sdq.l, q0, a.Lq, a.D, ty, tx, dq, a.scale);
}

// ---- launch -------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX, int BQ, int BK>
cudaError_t run_tiled(int op, const Args& a, cudaStream_t stream) {
  constexpr int DS = DMAX + 1, PS = BK + 1;
  const unsigned bh = (unsigned)(a.B * a.H);
  const unsigned q_tiles = (unsigned)((a.Lq + BQ - 1) / BQ);
  const unsigned k_tiles = (unsigned)((a.Lk + BK - 1) / BK);
  const size_t bwd_smem =
      sizeof(float) * (2 * (BQ + BK) * DS + BQ * PS + 3 * BQ);
  switch (op) {
    case kFwd:
      return launch(flash_fwd<T, DMAX, BQ, BK>, dim3(q_tiles, bh),
                    sizeof(float) * ((BQ + BK) * DS + BQ * PS), stream, a);
    case kDkdv:
      return launch(flash_bwd_dkdv<T, DMAX, BQ, BK>, dim3(k_tiles, bh),
                    bwd_smem, stream, a);
    case kDq:
      return launch(flash_bwd_dq<T, DMAX, BQ, BK>, dim3(q_tiles, bh),
                    bwd_smem, stream, a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run_typed(int op, const Args& a, cudaStream_t stream) {
  if (op == kDelta) {
    const long long rows = (long long)a.B * a.H * a.Lq;
    flash_bwd_delta<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads,
                         0, stream>>>(a);
    return cudaGetLastError();
  }
  // tiles: 64 x 64 up to D 128 (registers: a 4 x D/16 accumulator block a
  // thread), 32 x 32 at D 256 (the same registers, the shared memory of
  // four [32, 257] fp32 tiles)
  if (a.D <= 64) return run_tiled<T, 64, 64, 64>(op, a, stream);
  if (a.D <= 128) return run_tiled<T, 128, 64, 64>(op, a, stream);
  return run_tiled<T, 256, 32, 32>(op, a, stream);
}

Str str_at(const long long* s, int i) {
  return Str{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// strides: 28 int64 -- (batch, head, row) element strides of q, k, v, o,
// dout, dq, dk, dv in that order, then the bias's (batch, head, query,
// key) strides (0 on a broadcast axis).  Unused entries are ignored.
int run(int op, int dtype, Args& a, const long long* strides, int causal,
        void* stream) {
  if (a.B < 1 || a.H < 1 || a.B * a.H > 65535 || a.Lq < 1 || a.Lk < 1 ||
      a.D < 1 || a.D > kMaxD || (a.qseg == nullptr) != (a.kseg == nullptr) ||
      strides == nullptr)
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)run_typed<float>(op, a, s);
    case kBF16: return (int)run_typed<__nv_bfloat16>(op, a, s);
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
