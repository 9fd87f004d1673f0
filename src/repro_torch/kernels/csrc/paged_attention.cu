// Paged decode attention for Hopper (sm_90a), bf16 in, f32 arithmetic.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py, paged_attention_pallas
// (kernel body _kernel). One decode query per request: the G grouped query
// heads of each (request, KV head) attend over lengths[b] tokens stored in the
// pool pages listed in block_tables[b], with an f32 online softmax, an optional
// tanh logit softcap, and positions >= length masked.
//
// What bounds it on this card: device-memory bytes. Each (request, KV head)
// reads length x hd bf16 of K and of V once and does 2*G multiply-adds per
// element read (G = 7 for qwen2.5-7b), far under the ~295 operations per byte
// the H100 needs before its arithmetic becomes the limit.
//
// What the design does about it:
//  * one thread block per (request, KV head) serves all G query heads, so each
//    K/V row is read from device memory once per group, not once per head;
//  * the block reads the layer's pool directly through the real block table
//    (64-bit offsets from the pool's strides). No compacted page gather is
//    built; table entries past the length are never dereferenced;
//  * tokens go through shared memory in 64-token tiles loaded with 16-byte
//    vector loads, rows past the length are zero-filled, and the per-tile
//    softmax state lives in shared memory, the loop over tiles taking the
//    place of the TPU's sequential grid axis.
// Known cost: a (B, Hkv) grid at the runtime's bucket of 8 and Hkv = 4 fills
// 32 of the 132 SMs, and tiles are not double-buffered. A split over the
// context and asynchronous copies are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;   // tokens per shared-memory tile (two per lane in the softmax)
constexpr int kMaxG = 8;    // query heads per KV head
constexpr float kNegInf = -1e30f;

static_assert(kTile == 64, "the softmax phase gives each lane two tokens");

template <int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,       // (B, Hkv, G, HD) contiguous
    const __nv_bfloat16* __restrict__ k_pool,  // one layer: (pages, page, Hkv, HD), strided
    const __nv_bfloat16* __restrict__ v_pool,
    const int32_t* __restrict__ tables,        // (B, P)
    const int32_t* __restrict__ lengths,       // (B,)
    __nv_bfloat16* __restrict__ out,           // (B, Hkv, G, HD)
    int G, int P, int page_size, long long page_stride, long long tok_stride,
    long long head_stride, float scale, float softcap) {
  static_assert(HD % 8 == 0 && kThreads % HD == 0, "unsupported head_dim");
  constexpr int KSTR = HD + 2;               // odd word stride: conflict-free row reads
  constexpr int GSTEP = kThreads / HD;       // threads sharing one output dim
  constexpr int NACC = kMaxG / GSTEP;        // query heads per thread in P@V
  constexpr int GS = kThreads / kTile;       // threads sharing one token in Q@K
  constexpr int CH = HD / 8;                 // 16-byte chunks per row

  __shared__ float q_s[kMaxG][HD];
  __shared__ __align__(16) __nv_bfloat16 k_s[kTile][KSTR];
  __shared__ __align__(16) __nv_bfloat16 v_s[kTile][HD];
  __shared__ float p_s[kMaxG][kTile];
  __shared__ float alpha_s[kMaxG], m_s[kMaxG], l_s[kMaxG];
  __shared__ long long row_off[kTile];

  const int b = blockIdx.x, h = blockIdx.y, Hkv = gridDim.y;
  const int tid = threadIdx.x;
  const int len = lengths[b];
  const long long qo = ((long long)b * Hkv + h) * G * HD;

  for (int i = tid; i < G * HD; i += kThreads) q_s[i / HD][i % HD] = __bfloat162float(q[qo + i]);
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int d = tid % HD, gp = tid / HD;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    // ---- row offsets of this tile's tokens (only positions < len) ----
    if (tid < kTile) {
      const int pos = t0 + tid;
      long long off = -1;
      if (pos < len && pos / page_size < P) {
        const long long page = tables[(long long)b * P + pos / page_size];
        off = page * page_stride + (long long)(pos % page_size) * tok_stride +
              (long long)h * head_stride;
      }
      row_off[tid] = off;
    }
    __syncthreads();
    // ---- K and V tiles into shared memory, zero past the length ----
    for (int i = tid; i < kTile * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      const long long off = row_off[r];
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (off >= 0) {
        kv = *reinterpret_cast<const uint4*>(k_pool + off + c * 8);
        vv = *reinterpret_cast<const uint4*>(v_pool + off + c * 8);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(&k_s[r][c * 8]);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<uint4*>(&v_s[r][c * 8]) = vv;
    }
    __syncthreads();
    // ---- scores: thread -> one token, every GS-th query head ----
    {
      const int t = tid % kTile, g0 = tid / kTile;
      float s[kMaxG / GS];
#pragma unroll
      for (int i = 0; i < kMaxG / GS; ++i) s[i] = 0.f;
      for (int dd = 0; dd < HD; dd += 2) {
        const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&k_s[t][dd]));
#pragma unroll
        for (int i = 0; i < kMaxG / GS; ++i) {
          const int g = g0 + i * GS;
          if (g < G) s[i] += q_s[g][dd] * kf.x + q_s[g][dd + 1] * kf.y;
        }
      }
      const bool valid = row_off[t] >= 0;
#pragma unroll
      for (int i = 0; i < kMaxG / GS; ++i) {
        const int g = g0 + i * GS;
        if (g < G) {
          float x = s[i] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          p_s[g][t] = valid ? x : kNegInf;
        }
      }
    }
    __syncthreads();
    // ---- online softmax: one warp per query head ----
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int g = warp; g < G; g += kThreads / 32) {
        const float a = p_s[g][lane], c = p_s[g][lane + 32];
        float mx = fmaxf(a, c);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        const float pa = a > kNegInf ? expf(a - m_new) : 0.f;
        const float pc = c > kNegInf ? expf(c - m_new) : 0.f;
        p_s[g][lane] = pa;
        p_s[g][lane + 32] = pc;
        float sum = pa + pc;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float al = expf(m_old - m_new);
          alpha_s[g] = al;
          l_s[g] = l_s[g] * al + sum;
          m_s[g] = m_new;
        }
      }
    }
    __syncthreads();
    // ---- acc = acc * alpha + P @ V: thread -> one dim, NACC query heads ----
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int g = gp + i * GSTEP;
      if (g < G) acc[i] *= alpha_s[g];
    }
    for (int t = 0; t < kTile; ++t) {
      const float v = __bfloat162float(v_s[t][d]);
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int g = gp + i * GSTEP;
        if (g < G) acc[i] += p_s[g][t] * v;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int g = gp + i * GSTEP;
    if (g < G) out[qo + (long long)g * HD + d] = __float2bfloat16(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                    const void* tables, const void* lengths, void* out, int B,
                                    int Hkv, int G, int hd, int P, int page_size,
                                    long long page_stride, long long tok_stride,
                                    long long head_stride, float scale, float softcap,
                                    void* stream) {
  if (B < 1 || Hkv < 1 || Hkv > 65535 || G < 1 || G > kMaxG || P < 1 || page_size < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k_pool);
  const auto* vb = static_cast<const __nv_bfloat16*>(v_pool);
  const auto* tb = static_cast<const int32_t*>(tables);
  const auto* lb = static_cast<const int32_t*>(lengths);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (hd == 128)
    paged_decode_kernel<128><<<grid, kThreads, 0, s>>>(qb, kb, vb, tb, lb, ob, G, P, page_size,
                                                       page_stride, tok_stride, head_stride,
                                                       scale, softcap);
  else if (hd == 64)
    paged_decode_kernel<64><<<grid, kThreads, 0, s>>>(qb, kb, vb, tb, lb, ob, G, P, page_size,
                                                      page_stride, tok_stride, head_stride,
                                                      scale, softcap);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
