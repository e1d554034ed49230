// Decode attention for Hopper (sm_90a): a few query positions against a
// long KV cache, paged through a block table (K1) or dense (K2).
//
// Replaces the TPU kernels of the reference package:
//   K1  paddle_tpu/ops/pallas_decode.py::paged_decode_attention_kernel
//       (_paged_call, body _make_body)
//   K2  paddle_tpu/ops/pallas_decode.py::decode_attention_kernel
//       (_dense_call, same body)
//
// What it computes, per (batch row b, head h) and query l < Lq <= 8:
//   out[b,h,l] = sum_p softmax_p(q.k_p * sm_scale + bias[b,h,l,p]) v_p
// over key positions p <= q_pos[b,l]; keys past q_pos are masked to -inf.
// The softmax is online, with the running max floored at -1e30 (as in the
// reference) so a fully masked prefix contributes exactly 0, and a row
// with no visible key writes 0 (its normalizer 0 is mapped to 1).  int8
// caches are dequantized in registers with per-(position, head) fp32
// scales gathered through the same table row as the values.
//
// Bound: device-memory bandwidth.  One decode step reads each visible K/V
// row once, about B*ctx*H*D*2*bytes per layer (134 MB for fp32 at 8 rows x
// 1024 positions x 16 heads x 128, about 40 us at 3.35 TB/s), against
// 4*B*H*Lq*ctx*D flops -- far below the card's ratio of operations to
// bytes.  The design therefore streams K/V once and keeps everything else
// on chip: one CTA per (b, h) walks the row's keys in chunks of 32
// positions (the TPU's sequential grid axis becomes this loop), reads the
// block table itself for every key, stages the chunk in shared memory as
// fp32, scores it one key per lane, and keeps the softmax state and the
// fp32 accumulator [Lq, D] in registers.  The loop stops after the last
// key any query of the row can see (a fully masked chunk would add 0).
// Not yet done: split-K across CTAs when B*H < 132 SMs, and cp.async/TMA
// double buffering of the chunks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // keys staged per step: one per lane
constexpr int kMaxLq = 8;
constexpr int kMaxD = 256;
constexpr int kAccPerThread = kMaxLq * kMaxD / kThreads;
constexpr int kQueriesPerWarp = kMaxLq / kWarps;
constexpr int kUnitBatch = 4;  // 8-element loads in flight per thread
constexpr float kMFloor = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

// ---- 8-element loads that up-cast to fp32 (rows are 8-element aligned) --
template <typename T> struct Load8;

template <> struct Load8<float> {
  __device__ __forceinline__ static void run(const float* p, float* o) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

template <> struct Load8<__nv_bfloat16> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p,
                                             float* o) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <> struct Load8<__half> {
  __device__ __forceinline__ static void run(const __half* p, float* o) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <> struct Load8<int8_t> {
  __device__ __forceinline__ static void run(const int8_t* p, float* o) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);
  }
};

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int d) {
  return sizeof(float) * (2 * kChunk * (d + 1)      // K and V chunk
                          + kMaxLq * d              // queries
                          + kMaxLq * kChunk         // probabilities
                          + 2 * kMaxLq);            // alpha, normalizer
}

// Row index of key position p of (b, h) in the [rows, D] view of the
// cache (and the index of its scale): the paged pool is
// [num_blocks, H, bs, D], the dense cache [B, H, S, D].
template <bool PAGED>
__device__ __forceinline__ long long key_row(const int* table, int b, int h,
                                             int H, int p, int max_blocks,
                                             int block_size, int seq_len) {
  if (PAGED) {
    const long long phys = table[(long long)b * max_blocks + p / block_size];
    return (phys * H + h) * block_size + p % block_size;
  }
  return ((long long)b * H + h) * seq_len + p;
}

template <typename QT, typename KT, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ q_pos,
                        const float* __restrict__ bias, long long bias_sb,
                        long long bias_sh, long long bias_sl,
                        QT* __restrict__ out, int H, int Lq, int D,
                        int max_blocks, int block_size, int seq_len,
                        float sm_scale) {
  constexpr bool kQuant = sizeof(KT) == 1;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = D + 1;  // odd row stride: lane-per-key reads are conflict-free

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kChunk * ld;
  float* q_s = v_s + kChunk * ld;
  float* p_s = q_s + kMaxLq * D;
  float* alpha_s = p_s + kMaxLq * kChunk;
  float* l_s = alpha_s + kMaxLq;
  __shared__ int qpos_s[kMaxLq];
  __shared__ int n_keys_s;

  const long long bh = (long long)b * H + h;
  const QT* qp = q + bh * Lq * D;
  for (int i = tid; i < Lq * D; i += kThreads) q_s[i] = to_float(qp[i]);
  if (tid < Lq) qpos_s[tid] = q_pos[(long long)b * Lq + tid];
  __syncthreads();
  if (tid == 0) {
    int last = -1;
    for (int l = 0; l < Lq; ++l) last = max(last, qpos_s[l]);
    // keys past the last visible one are masked for every query: stop there
    n_keys_s = last < 0 ? 0 : min(last, seq_len - 1) + 1;
  }
  __syncthreads();
  const int n_keys = n_keys_s;

  const float* bias_bh =
      bias == nullptr ? nullptr : bias + b * bias_sb + h * bias_sh;

  float m_run[kQueriesPerWarp];
  float l_run[kQueriesPerWarp];
#pragma unroll
  for (int j = 0; j < kQueriesPerWarp; ++j) {
    m_run[j] = kMFloor;
    l_run[j] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  const int units_per_row = D >> 3;
  const int units = kChunk * units_per_row;

  for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
    // -- stage the chunk's K/V rows in shared memory as fp32 --------------
    for (int u0 = tid; u0 < units; u0 += kThreads * kUnitBatch) {
      float kr[kUnitBatch][8];
      float vr[kUnitBatch][8];
#pragma unroll
      for (int s = 0; s < kUnitBatch; ++s) {
        const int u = u0 + s * kThreads;
        const int t = u / units_per_row;
        const int p = c0 + t;
        if (u < units && p < n_keys) {
          const int d8 = (u - t * units_per_row) * 8;
          const long long row = key_row<PAGED>(table, b, h, H, p, max_blocks,
                                               block_size, seq_len);
          Load8<KT>::run(k + row * D + d8, kr[s]);
          Load8<KT>::run(v + row * D + d8, vr[s]);
          if (kQuant) {
            const float ks = __ldg(k_scale + row);
            const float vs = __ldg(v_scale + row);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              kr[s][e] *= ks;
              vr[s][e] *= vs;
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) kr[s][e] = vr[s][e] = 0.f;
        }
      }
#pragma unroll
      for (int s = 0; s < kUnitBatch; ++s) {
        const int u = u0 + s * kThreads;
        if (u < units) {
          const int t = u / units_per_row;
          const int d8 = (u - t * units_per_row) * 8;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            k_s[t * ld + d8 + e] = kr[s][e];
            v_s[t * ld + d8 + e] = vr[s][e];
          }
        }
      }
    }
    __syncthreads();

    // -- scores and online softmax: warp w owns queries w, w + 4 ----------
    const int p = c0 + lane;
#pragma unroll
    for (int j = 0; j < kQueriesPerWarp; ++j) {
      const int l = warp + j * kWarps;
      if (l < Lq) {  // warp-uniform
        float s = -INFINITY;
        if (p < n_keys) {
          const float* qr = q_s + l * D;
          const float* kr = k_s + lane * ld;
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          s = dot * sm_scale;
          if (bias_bh != nullptr) s += bias_bh[l * bias_sl + p];
          if (p > qpos_s[l]) s = -INFINITY;
        }
        const float m_new = fmaxf(m_run[j], warp_max(s));
        const float pr = expf(s - m_new);
        const float alpha = expf(m_run[j] - m_new);
        l_run[j] = alpha * l_run[j] + warp_sum(pr);
        m_run[j] = m_new;
        p_s[l * kChunk + lane] = pr;
        if (lane == 0) alpha_s[l] = alpha;
      }
    }
    __syncthreads();

    // -- acc[l, d] = acc * alpha[l] + sum_t p[l, t] v[t, d] ----------------
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < Lq * D) {
        const int l = e / D;
        const int d = e - l * D;
        const float* pr = p_s + l * kChunk;
        float a = acc[i] * alpha_s[l];
#pragma unroll 8
        for (int t = 0; t < kChunk; ++t) a = fmaf(pr[t], v_s[t * ld + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kQueriesPerWarp; ++j) {
    const int l = warp + j * kWarps;
    if (l < Lq && lane == 0) l_s[l] = l_run[j];
  }
  __syncthreads();
  QT* op = out + bh * Lq * D;
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < Lq * D) {
      const float norm = l_s[e / D];
      op[e] = from_float<QT>(acc[i] / (norm == 0.f ? 1.f : norm));
    }
  }
}

template <typename QT, typename KT, bool PAGED>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const float* k_scale, const float* v_scale,
                         const int* table, const int* q_pos, const float* bias,
                         long long bias_sb, long long bias_sh,
                         long long bias_sl, void* out, int B, int H, int Lq,
                         int D, int max_blocks, int block_size, int seq_len,
                         float sm_scale, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<QT, KT, PAGED>;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), k_scale, v_scale, table, q_pos, bias,
      bias_sb, bias_sh, bias_sl, static_cast<QT*>(out), H, Lq, D, max_blocks,
      block_size, seq_len, sm_scale);
  return cudaGetLastError();
}

template <bool PAGED>
int dispatch(int q_dtype, int kv_dtype, const void* q, const void* k,
             const void* v, const float* k_scale, const float* v_scale,
             const int* table, const int* q_pos, const float* bias,
             long long bias_sb, long long bias_sh, long long bias_sl,
             void* out, int B, int H, int Lq, int D, int max_blocks,
             int block_size, int seq_len, float sm_scale, void* stream) {
  if (B < 1 || H < 1 || B > 65535 || Lq < 1 || Lq > kMaxLq || D < 8 ||
      D > kMaxD || D % 8 != 0 || seq_len < 1)
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_LAUNCH(QT, KT)                                                  \
  return (int)launch_typed<QT, KT, PAGED>(                                  \
      q, k, v, k_scale, v_scale, table, q_pos, bias, bias_sb, bias_sh,     \
      bias_sl, out, B, H, Lq, D, max_blocks, block_size, seq_len, sm_scale, \
      s)
#define PTT_KV(QT)                                 \
  switch (kv_dtype) {                              \
    case kF32: PTT_LAUNCH(QT, float);              \
    case kBF16: PTT_LAUNCH(QT, __nv_bfloat16);     \
    case kF16: PTT_LAUNCH(QT, __half);             \
    case kI8: PTT_LAUNCH(QT, int8_t);              \
    default: return (int)cudaErrorInvalidValue;    \
  }
  switch (q_dtype) {
    case kF32: PTT_KV(float);
    case kBF16: PTT_KV(__nv_bfloat16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PTT_KV
#undef PTT_LAUNCH
}

}  // namespace

extern "C" {

// K1.  q [B,H,Lq,D]; k/v pool [num_blocks,H,block_size,D]; table
// [B,max_blocks] int32; q_pos [B,Lq] int32; k/v scales [num_blocks,H,
// block_size] fp32 (int8 pools only, else null); bias fp32 with element
// strides (batch, head, query) and unit stride over keys, or null; out like
// q.  Returns the launch's cudaError_t (0 on success).
int ptt_paged_decode_attention(int q_dtype, int kv_dtype, const void* q,
                               const void* k_pool, const void* v_pool,
                               const float* k_scale, const float* v_scale,
                               const int* table, const int* q_pos,
                               const float* bias, long long bias_sb,
                               long long bias_sh, long long bias_sl,
                               void* out, int B, int H, int Lq, int D,
                               int max_blocks, int block_size, float sm_scale,
                               void* stream) {
  if (table == nullptr || max_blocks < 1 || block_size < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(q_dtype, kv_dtype, q, k_pool, v_pool, k_scale,
                        v_scale, table, q_pos, bias, bias_sb, bias_sh,
                        bias_sl, out, B, H, Lq, D, max_blocks, block_size,
                        max_blocks * block_size, sm_scale, stream);
}

// K2.  As K1 over a dense cache k/v [B,H,S,D] with scales [B,H,S].
int ptt_dense_decode_attention(int q_dtype, int kv_dtype, const void* q,
                               const void* k, const void* v,
                               const float* k_scale, const float* v_scale,
                               const int* q_pos, const float* bias,
                               long long bias_sb, long long bias_sh,
                               long long bias_sl, void* out, int B, int H,
                               int Lq, int D, int S, float sm_scale,
                               void* stream) {
  return dispatch<false>(q_dtype, kv_dtype, q, k, v, k_scale, v_scale,
                         nullptr, q_pos, bias, bias_sb, bias_sh, bias_sl, out,
                         B, H, Lq, D, 1, 1, S, sm_scale, stream);
}

}  // extern "C"
