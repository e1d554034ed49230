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
// reference) so a fully masked span contributes exactly 0, and a row with
// no visible key writes 0 (its normalizer 0 is mapped to 1).  int8 caches
// are dequantized with per-(position, head) fp32 scales gathered through
// the same table entry as the values.
//
// Bound: device-memory bandwidth.  One decode step reads each visible K/V
// row once, about B*ctx*H*D*2*bytes per layer (134 MB for fp32 at 8 rows x
// 1024 positions x 16 heads x 128, about 40 us at 3.35 TB/s), against
// 4*B*H*Lq*ctx*D flops -- about 1 flop a byte, far below the card's ratio,
// so tensor cores buy nothing.  What the design buys is bytes in flight:
//
// - Split keys (flash-decoding).  The grid is (split, head, row).  Each
//   CTA takes one of `splits` equal spans of the row's visible keys
//   [0, n_keys), n_keys read from q_pos on the device, spans rounded up to
//   32 keys; a CTA whose span is empty writes the empty partial.  Each
//   split writes its unnormalized partial (m, l, acc[D]) in fp32; a second
//   kernel combines them per (b, h, l) in split order:
//   m = max m_i, l = sum e^(m_i - m) l_i, out = sum e^(m_i - m) acc_i / l.
//   No atomics, so two calls give the same bits.  The wrapper picks
//   `splits` from static shapes alone (rows, heads, capacity), so a
//   request's result never depends on its neighbours; with one split the
//   first kernel writes the output itself.
// - Asynchronous copies.  A CTA streams its span in chunks (64 int8 keys,
//   32 wider ones) through a ring of 2-8 shared-memory stages (as many as
//   fit in 64 KB) by 16-byte cp.async, keeping the next chunks in flight
//   while one is scored and accumulated.  Rows are staged in their own
//   width (bf16/f16/int8 are widened in registers as they are read),
//   padded by 16 bytes against bank conflicts.  int8 scales ride beside
//   their rows by 4-byte cp.async.  The CTA reads its q_pos and block-table
//   entries once, the table into shared memory.  A cache whose base is not
//   16-byte aligned, or whose rows are not a multiple of 16 bytes (int8
//   with D % 16 != 0), is staged by plain loads into the same layout.
// - Every warp scores.  Four lanes share a key (two in an int8 chunk; each
//   takes every fourth or second 8-element group of D, then shuffles sum
//   them), so the 128 threads score a chunk's keys at once even at Lq = 1;
//   the softmax update is per query (warp w owns queries w and w + 4), and
//   P.V gives each thread fixed (query, d) output elements.  int8 scales
//   are applied once a key: to the dot product for K and to the
//   probability for V.
//
// Measured alternatives (H100): each warp keeping its own softmax and
// accumulator over a quarter of each chunk, with one barrier a chunk, was
// 20-35% slower than this layout at the serving shape; launching the
// combine as a programmatic dependent saved about 1 us a call but made
// profiler kernel times overlap, and was dropped.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSpanKeys = 32;  // a split's span is a multiple of this
constexpr int kMaxLq = 8;
constexpr int kMaxD = 256;
constexpr int kAccPerThread = kMaxLq * kMaxD / kThreads;
constexpr int kQueriesPerWarp = kMaxLq / kWarps;
constexpr int kRowPad = 16;  // bytes after each staged row
constexpr int kStageTarget = 64 * 1024;
constexpr int kMaxStages = 8;
constexpr int kMaxTableSlots = 2048;
constexpr int kMinCtasPerSm = 3;  // caps registers at 170 a thread
constexpr float kMFloor = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

// ---- 8 staged elements (8-element aligned in shared memory) as fp32 ------
template <typename T> struct Widen8;

template <> struct Widen8<float> {
  __device__ __forceinline__ static void run(const float* p, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

template <> struct Widen8<__nv_bfloat16> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p,
                                             float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <> struct Widen8<__half> {
  __device__ __forceinline__ static void run(const __half* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// int8 -> fp32 without the conversion unit (16 a clock an SM, an eighth of
// the FMA rate, and the int8 kernels' limit): 2^23 + 128 + x is exact in
// fp32's mantissa, so one integer add (or byte permute) and one subtract
constexpr float kI8Magic = 8388736.f;  // 2^23 + 128

__device__ __forceinline__ float i8_to_float(int x) {
  return __int_as_float(0x4B000080 + x) - kI8Magic;
}

template <> struct Widen8<int8_t> {
  __device__ __forceinline__ static void run(const int8_t* p, float* o) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const unsigned w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};  // x + 128
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)  // bytes [x_j + 128, 0, 0, 0x4B]
        o[4 * i + j] =
            __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 + j)) -
            kI8Magic;
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return i8_to_float(x); }
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

// wait until at most n of this thread's groups are pending (n < kMaxStages)
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
#define PTT_WAIT(N) \
  case N: asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); break;
    PTT_WAIT(0) PTT_WAIT(1) PTT_WAIT(2) PTT_WAIT(3) PTT_WAIT(4)
    PTT_WAIT(5) PTT_WAIT(6)
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory");
#undef PTT_WAIT
  }
}

// ---- launch geometry, shared by the host and the kernel -------------------

struct Geom {
  int ld;           // staged row stride in bytes: D * elem + kRowPad
  int stage_bytes;  // K rows, V rows, K scales, V scales of one chunk
  int stages;
  int table_slots;  // block-table entries a CTA's span can touch (paged)
  size_t smem;
};

// keys staged per step: 64 int8 rows (so an int8 step moves enough bytes
// to pay for its barriers), 32 wider ones (so two stages still leave room
// for three CTAs an SM)
__host__ __device__ constexpr int chunk_keys(int elem) {
  return elem == 1 ? 64 : 32;
}

__host__ __device__ inline int max_span(int seq_len, int splits) {
  const int per = (seq_len + splits - 1) / splits;
  return (per + kSpanKeys - 1) / kSpanKeys * kSpanKeys;
}

Geom geometry(int elem, int D, int seq_len, int splits, bool paged,
              int max_blocks, int block_size) {
  Geom g;
  const int chunk = chunk_keys(elem);
  g.ld = D * elem + kRowPad;
  g.stage_bytes = 2 * chunk * g.ld + 2 * chunk * (int)sizeof(float);
  g.stages = kStageTarget / g.stage_bytes;
  g.stages = g.stages < 2 ? 2 : (g.stages > kMaxStages ? kMaxStages
                                                       : g.stages);
  g.table_slots = 0;
  if (paged) {
    const int slots = (max_span(seq_len, splits) - 1) / block_size + 2;
    g.table_slots = slots < max_blocks ? slots : max_blocks;
  }
  g.smem = (size_t)g.stages * g.stage_bytes
           + sizeof(float) * (kMaxLq * D + kMaxLq * chunk + kMaxLq)
           + sizeof(int) * g.table_slots;
  return g;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* q_pos;
  const float* bias;
  long long bias_sb, bias_sh, bias_sl;
  void* out;          // the output, when splits == 1
  float* part_m;      // [B, H, splits, Lq] running max of each split
  float* part_l;      // [B, H, splits, Lq] its normalizer
  float* part_acc;    // [B, H, splits, Lq, D] its unnormalized P.V
  int H, Lq, D, max_blocks, block_size, seq_len, splits;
  int ld, stage_bytes, stages;
  int vec;            // 16-byte cp.async staging (else plain loads)
  float sm_scale;
};

// Stage chunk [c0, c0 + chunk) of keys, those >= k1 zero-filled, into one
// stage of shared memory: K rows, V rows, then (int8) K and V scales.
template <typename KT, bool PAGED>
__device__ __forceinline__ void stage_chunk(const Params& a, char* st,
                                            const int* table_s, int blk0,
                                            long long bh, int h, int c0,
                                            int k1) {
  constexpr bool kQuant = sizeof(KT) == 1;
  constexpr int kElem = (int)sizeof(KT);
  constexpr int kChunk = chunk_keys(kElem);
  const KT* kg = static_cast<const KT*>(a.k);
  const KT* vg = static_cast<const KT*>(a.v);
  char* ks = st;
  char* vs = st + kChunk * a.ld;
  float* kscale_s = reinterpret_cast<float*>(st + 2 * kChunk * a.ld);
  float* vscale_s = kscale_s + kChunk;
  const int D = a.D;
  auto row_of = [&](int p) -> long long {
    if (PAGED) {
      const long long phys = table_s[p / a.block_size - blk0];
      return (phys * a.H + h) * a.block_size + p % a.block_size;
    }
    return bh * a.seq_len + p;
  };
  if (a.vec) {
    // a thread copies one 16-byte column of every rows_per_pass-th row
    const int upr = D * kElem / 16;  // 16-byte units per row, <= 64
    const int rows_per_pass = kThreads / upr;
    const int t0 = threadIdx.x / upr;
    const int c = (threadIdx.x - t0 * upr) * 16;
    for (int t = t0; t < kChunk && t0 < rows_per_pass; t += rows_per_pass) {
      const int p = c0 + t;
      const bool in = p < k1;
      const long long off = in ? row_of(p) * D * kElem + c : 0;
      cp_async16(ks + t * a.ld + c,
                 reinterpret_cast<const char*>(kg) + off, in ? 16 : 0);
      cp_async16(vs + t * a.ld + c,
                 reinterpret_cast<const char*>(vg) + off, in ? 16 : 0);
    }
    if (kQuant) {
      for (int t = threadIdx.x; t < kChunk; t += kThreads) {
        const int p = c0 + t;
        const bool in = p < k1;
        const long long row = in ? row_of(p) : 0;
        cp_async4(kscale_s + t, a.k_scale + row, in ? 4 : 0);
        cp_async4(vscale_s + t, a.v_scale + row, in ? 4 : 0);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kChunk * D; e += kThreads) {
      const int t = e / D;
      const int d = e - t * D;
      const int p = c0 + t;
      KT kx{}, vx{};
      if (p < k1) {
        const long long off = row_of(p) * D + d;
        kx = kg[off];
        vx = vg[off];
      }
      reinterpret_cast<KT*>(ks + t * a.ld)[d] = kx;
      reinterpret_cast<KT*>(vs + t * a.ld)[d] = vx;
    }
    if (kQuant) {
      for (int t = threadIdx.x; t < kChunk; t += kThreads) {
        const int p = c0 + t;
        const bool in = p < k1;
        const long long row = in ? row_of(p) : 0;
        kscale_s[t] = in ? a.k_scale[row] : 0.f;
        vscale_s[t] = in ? a.v_scale[row] : 0.f;
      }
    }
  }
}

template <typename QT, typename KT, bool PAGED>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
decode_split_kernel(const Params a) {
  constexpr bool kQuant = sizeof(KT) == 1;
  constexpr int kChunk = chunk_keys((int)sizeof(KT));
  constexpr int kLanesPerKey = kThreads / kChunk;
  constexpr int kKeysPerLane = kChunk / 32;  // in the softmax
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = a.H, Lq = a.Lq, D = a.D;
  const long long bh = (long long)b * H + h;

  extern __shared__ __align__(16) char smem[];
  char* stages_s = smem;
  float* q_s = reinterpret_cast<float*>(smem + a.stages * a.stage_bytes);
  float* s_s = q_s + kMaxLq * D;    // scores, then probabilities [Lq][32]
  float* alpha_s = s_s + kMaxLq * kChunk;
  int* table_s = reinterpret_cast<int*>(alpha_s + kMaxLq);
  __shared__ int qpos_s[kMaxLq];

  // this split's keys: keys past the last visible one are masked for every
  // query, so [0, n_keys) is cut into `splits` spans of whole chunks.  Each
  // thread reads the row's q_pos itself, so the table load below overlaps
  // the q load.
  const int* qpos_g = a.q_pos + (long long)b * Lq;
  int last = -1;
  for (int l = 0; l < Lq; ++l) last = max(last, __ldg(qpos_g + l));
  const int n_keys = last < 0 ? 0 : min(last, a.seq_len - 1) + 1;
  const int span = max_span(n_keys > 0 ? n_keys : 1, a.splits);
  const int k0 = split * span;
  const int k1 = min(n_keys, k0 + span);
  const int n_chunks = k1 > k0 ? (k1 - k0 + kChunk - 1) / kChunk : 0;

  const QT* qp = static_cast<const QT*>(a.q) + bh * Lq * D;
  for (int i = tid; i < Lq * D; i += kThreads) q_s[i] = to_float(qp[i]);
  if (tid < Lq) qpos_s[tid] = qpos_g[tid];
  int blk0 = 0;
  if (PAGED && n_chunks > 0) {
    blk0 = k0 / a.block_size;
    const int n_blk = (k1 - 1) / a.block_size - blk0 + 1;
    const int* trow = a.table + (long long)b * a.max_blocks + blk0;
    for (int i = tid; i < n_blk; i += kThreads) table_s[i] = trow[i];
  }
  __syncthreads();

  // prologue: the first stages - 1 chunks in flight
  for (int c = 0; c < a.stages - 1; ++c) {
    if (c < n_chunks)
      stage_chunk<KT, PAGED>(a, stages_s + c * a.stage_bytes, table_s, blk0,
                             bh, h, k0 + c * kChunk, k1);
    cp_commit();
  }

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

  const float* bias_bh =
      a.bias == nullptr ? nullptr : a.bias + b * a.bias_sb + h * a.bias_sh;
  const int key = tid / kLanesPerKey;   // the chunk key this lane scores
  const int part = tid % kLanesPerKey;  // its share of D's 8-element groups
  const int groups = D / 8;
  const int ld_el = a.ld / (int)sizeof(KT);

  for (int c = 0; c < n_chunks; ++c) {
    cp_wait(a.stages - 2);  // chunk c has landed (this thread's copies)
    __syncthreads();        // ... every thread's; chunk c - 1 is consumed
    {
      const int nxt = c + a.stages - 1;
      if (nxt < n_chunks)
        stage_chunk<KT, PAGED>(a, stages_s + (nxt % a.stages) * a.stage_bytes,
                               table_s, blk0, bh, h, k0 + nxt * kChunk, k1);
      cp_commit();
    }
    const char* st = stages_s + (c % a.stages) * a.stage_bytes;
    const KT* k_s = reinterpret_cast<const KT*>(st);
    const KT* v_s = reinterpret_cast<const KT*>(st + kChunk * a.ld);
    const float* kscale_s =
        reinterpret_cast<const float*>(st + 2 * kChunk * a.ld);
    const float* vscale_s = kscale_s + kChunk;
    const int c0 = k0 + c * kChunk;

    // -- scores: four lanes a key, every warp busy ---------------------------
    {
      float dot[kMaxLq];
#pragma unroll
      for (int l = 0; l < kMaxLq; ++l) dot[l] = 0.f;
      const KT* kr = k_s + key * ld_el;
      for (int g = part; g < groups; g += kLanesPerKey) {
        float kv[8];
        Widen8<KT>::run(kr + g * 8, kv);
#pragma unroll
        for (int l = 0; l < kMaxLq; ++l) {
          if (l < Lq) {
            const float4 qa = *reinterpret_cast<const float4*>(
                q_s + l * D + g * 8);
            const float4 qb = *reinterpret_cast<const float4*>(
                q_s + l * D + g * 8 + 4);
            float d0 = dot[l];
            d0 = fmaf(qa.x, kv[0], d0);
            d0 = fmaf(qa.y, kv[1], d0);
            d0 = fmaf(qa.z, kv[2], d0);
            d0 = fmaf(qa.w, kv[3], d0);
            d0 = fmaf(qb.x, kv[4], d0);
            d0 = fmaf(qb.y, kv[5], d0);
            d0 = fmaf(qb.z, kv[6], d0);
            d0 = fmaf(qb.w, kv[7], d0);
            dot[l] = d0;
          }
        }
      }
      const int p = c0 + key;
#pragma unroll
      for (int l = 0; l < kMaxLq; ++l) {
        if (l < Lq) {
          float d0 = dot[l];
#pragma unroll
          for (int o = 1; o < kLanesPerKey; o <<= 1)
            d0 += __shfl_xor_sync(0xffffffffu, d0, o);
          if (part == 0) {
            float s = -INFINITY;
            if (p < k1 && p <= qpos_s[l]) {
              if (kQuant) d0 *= kscale_s[key];  // int8: q.(x k_scale)
              s = d0 * a.sm_scale;
              if (bias_bh != nullptr) s += bias_bh[l * a.bias_sl + p];
            }
            s_s[l * kChunk + key] = s;
          }
        }
      }
    }
    __syncthreads();

    // -- online softmax: warp w owns queries w, w + 4 ------------------------
#pragma unroll
    for (int j = 0; j < kQueriesPerWarp; ++j) {
      const int l = warp + j * kWarps;
      if (l < Lq) {  // warp-uniform
        float s[kKeysPerLane];
        float mx = -INFINITY;
#pragma unroll
        for (int r = 0; r < kKeysPerLane; ++r) {
          s[r] = s_s[l * kChunk + lane + 32 * r];
          mx = fmaxf(mx, s[r]);
        }
        const float m_new = fmaxf(m_run[j], warp_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < kKeysPerLane; ++r) {
          const int t = lane + 32 * r;
          const float pr = expf(s[r] - m_new);
          sum += pr;
          // int8: the value scale rides on the probability, p (x v_scale)
          s_s[l * kChunk + t] = kQuant ? pr * vscale_s[t] : pr;
        }
        const float alpha = expf(m_run[j] - m_new);
        l_run[j] = alpha * l_run[j] + warp_sum(sum);
        m_run[j] = m_new;
        if (lane == 0) alpha_s[l] = alpha;
      }
    }
    __syncthreads();

    // -- acc[l, d] = acc * alpha[l] + sum_t p[l, t] v[t, d] ------------------
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < Lq * D) {
        const int l = e / D;
        const int d = e - l * D;
        const float4* pr = reinterpret_cast<const float4*>(s_s + l * kChunk);
        const KT* vc = v_s + d;
        float x = acc[i] * alpha_s[l];
#pragma unroll 2
        for (int t4 = 0; t4 < kChunk / 4; ++t4) {
          const float4 p4 = pr[t4];
          const KT* vt = vc + 4 * t4 * ld_el;
          x = fmaf(p4.x, to_float(vt[0]), x);
          x = fmaf(p4.y, to_float(vt[ld_el]), x);
          x = fmaf(p4.z, to_float(vt[2 * ld_el]), x);
          x = fmaf(p4.w, to_float(vt[3 * ld_el]), x);
        }
        acc[i] = x;
      }
    }
  }
  cp_wait(0);  // no copy may outlive the CTA (empty groups past the span)

  // -- epilogue: the output itself (one split) or this split's partial -----
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kQueriesPerWarp; ++j) {
    const int l = warp + j * kWarps;
    if (l < Lq && lane == 0) {
      alpha_s[l] = l_run[j];
      if (a.out == nullptr) {
        const long long r = (bh * a.splits + split) * Lq + l;
        a.part_m[r] = m_run[j];
        a.part_l[r] = l_run[j];
      }
    }
  }
  __syncthreads();
  if (a.out != nullptr) {
    QT* op = static_cast<QT*>(a.out) + bh * Lq * D;
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < Lq * D) {
        const float norm = alpha_s[e / D];
        op[e] = from_float<QT>(acc[i] / (norm == 0.f ? 1.f : norm));
      }
    }
  } else {
    float* pa = a.part_acc + (bh * a.splits + split) * Lq * D;
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < Lq * D) pa[e] = acc[i];
    }
  }
}

// out[b, h, l] from the splits' partials, summed in split order.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, QT* __restrict__ out,
                      int H, int Lq, int D, int splits) {
  const long long bh = (long long)blockIdx.y * H + blockIdx.x;
  const int tid = threadIdx.x;
  extern __shared__ float w_s[];  // [Lq][splits] weights, then [Lq] norms
  float* norm_s = w_s + Lq * splits;
  if (tid < Lq) {
    const float* pm = part_m + bh * splits * Lq + tid;
    const float* pl = part_l + bh * splits * Lq + tid;
    float m = kMFloor;
    for (int i = 0; i < splits; ++i) m = fmaxf(m, pm[i * Lq]);
    float l = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float w = expf(pm[i * Lq] - m);
      w_s[tid * splits + i] = w;
      l += w * pl[i * Lq];
    }
    norm_s[tid] = l == 0.f ? 1.f : l;
  }
  __syncthreads();
  const float* pa = part_acc + bh * splits * Lq * D;
  QT* op = out + bh * Lq * D;
  for (int e = tid; e < Lq * D; e += kThreads) {
    const int l = e / D;
    const float* w = w_s + l * splits;
    float o = 0.f;
    for (int i = 0; i < splits; ++i) o += w[i] * pa[(long long)i * Lq * D + e];
    op[e] = from_float<QT>(o / norm_s[l]);
  }
}

template <typename QT, typename KT, bool PAGED>
cudaError_t launch_typed(Params a, int B, cudaStream_t stream) {
  const Geom g = geometry((int)sizeof(KT), a.D, a.seq_len, a.splits, PAGED,
                          a.max_blocks, a.block_size);
  if (g.table_slots > kMaxTableSlots) return cudaErrorInvalidValue;
  a.ld = g.ld;
  a.stage_bytes = g.stage_bytes;
  a.stages = g.stages;
  const int row_bytes = a.D * (int)sizeof(KT);
  a.vec = row_bytes % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  auto kernel = decode_split_kernel<QT, KT, PAGED>;
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.splits, a.H, B), kThreads, g.smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_combine(const Params& a, void* out, int B,
                           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (a.Lq * a.splits + a.Lq);
  auto kernel = decode_combine_kernel<QT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.H, B), kThreads, smem, stream>>>(
      a.part_m, a.part_l, a.part_acc, static_cast<QT*>(out), a.H, a.Lq, a.D,
      a.splits);
  return cudaGetLastError();
}

template <bool PAGED>
int dispatch(int q_dtype, int kv_dtype, Params a, void* out, float* work,
             int B, void* stream) {
  if (B < 1 || a.H < 1 || B > 65535 || a.H > 65535 || a.Lq < 1 ||
      a.Lq > kMaxLq || a.D < 8 || a.D > kMaxD || a.D % 8 != 0 ||
      a.seq_len < 1 || a.splits < 1 || a.splits > 65535 || out == nullptr ||
      (a.splits > 1) != (work != nullptr))
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype == kI8) != (a.k_scale != nullptr && a.v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // workspace: m [B,H,splits,Lq], l [B,H,splits,Lq], acc [B,H,splits,Lq,D]
  const long long n = (long long)B * a.H * a.splits * a.Lq;
  a.out = a.splits == 1 ? out : nullptr;
  a.part_m = work;
  a.part_l = work == nullptr ? nullptr : work + n;
  a.part_acc = work == nullptr ? nullptr : work + 2 * n;
  cudaError_t err = cudaSuccess;
#define PTT_LAUNCH(QT, KT) err = launch_typed<QT, KT, PAGED>(a, B, s); break
#define PTT_KV(QT)                                         \
  switch (kv_dtype) {                                      \
    case kF32: PTT_LAUNCH(QT, float);                      \
    case kBF16: PTT_LAUNCH(QT, __nv_bfloat16);             \
    case kF16: PTT_LAUNCH(QT, __half);                     \
    case kI8: PTT_LAUNCH(QT, int8_t);                      \
    default: return (int)cudaErrorInvalidValue;            \
  }
  switch (q_dtype) {
    case kF32: PTT_KV(float); break;
    case kBF16: PTT_KV(__nv_bfloat16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PTT_KV
#undef PTT_LAUNCH
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  return (int)(q_dtype == kF32 ? launch_combine<float>(a, out, B, s)
                               : launch_combine<__nv_bfloat16>(a, out, B, s));
}

Params params(const void* q, const void* k, const void* v,
              const float* k_scale, const float* v_scale, const int* table,
              const int* q_pos, const float* bias, long long bias_sb,
              long long bias_sh, long long bias_sl, int H, int Lq, int D,
              int max_blocks, int block_size, int seq_len, int splits,
              float sm_scale) {
  Params a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.table = table;
  a.q_pos = q_pos;
  a.bias = bias;
  a.bias_sb = bias_sb;
  a.bias_sh = bias_sh;
  a.bias_sl = bias_sl;
  a.H = H;
  a.Lq = Lq;
  a.D = D;
  a.max_blocks = max_blocks;
  a.block_size = block_size;
  a.seq_len = seq_len;
  a.splits = splits;
  a.sm_scale = sm_scale;
  return a;
}

}  // namespace

extern "C" {

// K1.  q [B,H,Lq,D]; k/v pool [num_blocks,H,block_size,D]; table
// [B,max_blocks] int32; q_pos [B,Lq] int32; k/v scales [num_blocks,H,
// block_size] fp32 (int8 pools only, else null); bias fp32 with element
// strides (batch, head, query) and unit stride over keys, or null; out like
// q.  `splits` CTAs share each (b, h); with splits > 1, `work` is fp32
// scratch of B*H*splits*Lq*(D+2) elements (else null).  Launches the split
// kernel and, with splits > 1, the combine; returns the first launch's
// cudaError_t (0 on success).
int ptt_paged_decode_attention(int q_dtype, int kv_dtype, const void* q,
                               const void* k_pool, const void* v_pool,
                               const float* k_scale, const float* v_scale,
                               const int* table, const int* q_pos,
                               const float* bias, long long bias_sb,
                               long long bias_sh, long long bias_sl,
                               void* out, float* work, int B, int H, int Lq,
                               int D, int max_blocks, int block_size,
                               int splits, float sm_scale, void* stream) {
  if (table == nullptr || max_blocks < 1 || block_size < 1 ||
      (long long)max_blocks * block_size > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(
      q_dtype, kv_dtype,
      params(q, k_pool, v_pool, k_scale, v_scale, table, q_pos, bias,
             bias_sb, bias_sh, bias_sl, H, Lq, D, max_blocks, block_size,
             max_blocks * block_size, splits, sm_scale),
      out, work, B, stream);
}

// K2.  As K1 over a dense cache k/v [B,H,S,D] with scales [B,H,S].
int ptt_dense_decode_attention(int q_dtype, int kv_dtype, const void* q,
                               const void* k, const void* v,
                               const float* k_scale, const float* v_scale,
                               const int* q_pos, const float* bias,
                               long long bias_sb, long long bias_sh,
                               long long bias_sl, void* out, float* work,
                               int B, int H, int Lq, int D, int S, int splits,
                               float sm_scale, void* stream) {
  return dispatch<false>(
      q_dtype, kv_dtype,
      params(q, k, v, k_scale, v_scale, nullptr, q_pos, bias, bias_sb,
             bias_sh, bias_sl, H, Lq, D, 1, 1, S, splits, sm_scale),
      out, work, B, stream);
}

}  // extern "C"
