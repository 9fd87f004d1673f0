// Causal flash prefill attention for Hopper (sm_90a): bf16 tensor-core
// products (mma.sync m16n8k16, f32 accumulate) and an f32 online softmax.
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py, flash_prefill_pallas
// (kernel body _kernel). Causal GQA attention, optionally sliding-window, of
// Sq queries at absolute positions q_offset.. over the first kv_lens[b] keys,
// with an optional tanh logit softcap. Key tiles above the causal diagonal or
// left of the window are skipped.
//
// What bounds it on this card: at a prompt of 512 tokens (qwen2.5-7b widths,
// Hq = 28, Hkv = 4, hd = 128) the bytes of q, K, V and the output (8.4 MB,
// 2.5 us at 3.35 TB/s) outweigh the causal products (1.9 GFLOP, 1.9 us at the
// bf16 tensor-core peak); from about 700 tokens on the products dominate and
// grow with the square of the prompt.
//
// What the design does about it:
//  * one thread block of four warps per (batch row, query head, 64-row query
//    tile); each warp owns 16 query rows. A loop over 64-key tiles takes the
//    place of the TPU's sequential grid axis and stops at min(kv_lens[b], the
//    tile's causal bound), so the masked upper triangle is never loaded;
//  * both products run on the tensor cores (mma.sync, operands from shared
//    memory through ldmatrix); the scores stay in registers, and the softmax
//    probabilities go straight from the score accumulators into the A
//    operand of P @ V (rounded to bf16) without touching shared memory;
//  * q_offset and the per-row kv_lens are runtime arguments, so one build
//    serves every prompt bucket and chunk position;
//  * the model layout (B, S, H, hd) is read through strides, the ragged edges
//    are masked here, and nothing is padded or transposed outside.
// Left for later: wgmma and TMA, double-buffered tiles, warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr float kNegInf = -1e30f;

template <int HD>
struct Smem {
  static constexpr int kStr = HD + 8;  // 16-byte row shift: conflict-free ldmatrix
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(__nv_bfloat16) * kBQ * kStr;
  static constexpr size_t v = k + sizeof(__nv_bfloat16) * kBK * kStr;
  static constexpr size_t bytes = v + sizeof(__nv_bfloat16) * kBK * kStr;
};

// rows x HD bf16 from global (row stride `rs` elements) into shared memory
// with row stride `str`; rows at or past `valid` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int str, const __nv_bfloat16* src,
                                          long long rs, int rows, int valid) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < valid) x = *reinterpret_cast<const uint4*>(src + r * rs + c * 8);
    *reinterpret_cast<uint4*>(dst + r * str + c * 8) = x;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c (16x8, f32) += a (16x16, bf16, row-major) * b (16x8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Fragment layout of mma m16n8k16 (lane = 4 * g + t): an accumulator c[i]
// of an 8-column tile holds row g + 8 * (i / 2), column 2 * t + i % 2.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    const int32_t* __restrict__ kv_lens, int Sq, int Skv, int Hkv,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int q_offset, int causal, int window, float scale,
    float softcap) {
  using L = Smem<HD>;
  constexpr int kStr = L::kStr;
  constexpr int KS = HD / 16;   // k-steps of Q @ K^T
  constexpr int NT = kBK / 8;   // 8-key score tiles
  constexpr int DT = HD / 8;    // 8-dim output tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::v);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = gridDim.y / Hkv, hk = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * kBQ;  // first query row of this block
  const int q_rows = min(kBQ, Sq - q0);
  const int kv_len = min(kv_lens[b], Skv);

  load_tile<HD>(q_s, kStr, q + b * q_sb + (long long)q0 * q_ss + h * q_sh, q_ss, kBQ, q_rows);

  // key range: up to the causal bound of the last real query row, and from
  // the window's left edge of the first one
  const int qpos_first = q_offset + q0, qpos_last = q_offset + q0 + q_rows - 1;
  int kv_end = kv_len, kv_begin = 0;
  if (causal) {
    kv_end = min(kv_end, qpos_last + 1);
    if (window > 0) kv_begin = max(0, qpos_first - window + 1) / kBK * kBK;
  }
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;
  // this thread's two query rows (g and g + 8 of the warp's 16)
  const int qpos0 = q_offset + q0 + warp * 16 + g;

  uint32_t qa[KS][4];
  float o[DT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous tile's readers are done (and q_s is landed)
    const int k_rows = min(kBK, kv_end - k0);
    load_tile<HD>(k_s, kStr, kb + (long long)k0 * k_ss, k_ss, kBK, k_rows);
    load_tile<HD>(v_s, kStr, vb + (long long)k0 * v_ss, v_ss, kBK, k_rows);
    __syncthreads();
    if (k0 == kv_begin) {  // Q fragments, once per block
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int m8 = lane / 8;
        ldmatrix_x4(qa[ks], q_s + (warp * 16 + (m8 & 1) * 8 + lane % 8) * kStr +
                                ks * 16 + (m8 >> 1) * 8);
      }
    }

    // ---- S = Q K^T on the tensor cores ----
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kf[4];
        const int m8 = lane / 8;
        ldmatrix_x4(kf, k_s + (j * 8 + (m8 >> 1) * 8 + lane % 8) * kStr + ks * 16 +
                            (m8 & 1) * 8);
        mma_bf16(s[j], qa[ks], kf[0], kf[1]);
        mma_bf16(s[j + 1], qa[ks], kf[2], kf[3]);
      }
    }

    // ---- mask, online softmax (a row spans the 4 lanes of a quad) ----
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = qpos0 + 8 * (i / 2);
        const int kpos = k0 + j * 8 + 2 * t + i % 2;
        bool ok = kpos < kv_len;
        if (causal) {
          ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && qpos - kpos < window;
        }
        float x = s[j][i] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[j][i] = ok ? x : kNegInf;
        mx[i / 2] = fmaxf(mx[i / 2], s[j][i]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = s[j][i] > kNegInf ? expf(s[j][i] - m[i / 2]) : 0.f;
        s[j][i] = p;
        sum[i / 2] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // ---- O += P V: score accumulators become the A operand directly ----
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t vf[4];
        const int m8 = lane / 8;
        ldmatrix_x4_trans(vf, v_s + (kk * 16 + (m8 & 1) * 8 + lane % 8) * kStr + j * 8 +
                                  (m8 >> 1) * 8);
        mma_bf16(o[j], pa, vf[0], vf[1]);
        mma_bf16(o[j + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (row >= q_rows) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* op = out + b * o_sb + (long long)(q0 + row) * o_ss + h * o_sh + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, const void* kv_lens, int B,
           int Sq, int Skv, int Hq, int Hkv, const long long* st, int q_offset, int causal,
           int window, float scale, float softcap, cudaStream_t s) {
  static bool attr_set = false;  // one opt-in per process for > 48 KB of shared memory
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Smem<HD>::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_prefill_kernel<HD><<<grid, kThreads, Smem<HD>::bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<const int32_t*>(kv_lens), Sq, Skv, Hkv, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], q_offset, causal, window, scale,
      softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v and out in that
// order; the head_dim stride is 1. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v, void* out,
                                  const void* kv_lens, int B, int Sq, int Skv, int Hq, int Hkv,
                                  int hd, const long long* strides, int q_offset, int causal,
                                  int window, float scale, float softcap, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128>(q, k, v, out, kv_lens, B, Sq, Skv, Hq, Hkv, strides, q_offset, causal,
                       window, scale, softcap, s);
  if (hd == 64)
    return launch<64>(q, k, v, out, kv_lens, B, Sq, Skv, Hq, Hkv, strides, q_offset, causal,
                      window, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
