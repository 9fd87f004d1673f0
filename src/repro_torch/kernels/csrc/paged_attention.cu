// Paged decode attention for Hopper (sm_90a), bf16 in, f32 arithmetic:
// split-KV over the context, each warp an independent split with its own
// cp.async ring, products on the tensor cores (mma.sync), a merge kernel.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py, paged_attention_pallas
// (kernel body _kernel). One decode query per request: the G grouped query
// heads of each (request, KV head) attend over lengths[b] tokens stored in the
// pool pages listed in block_tables[b], with an f32 online softmax, an optional
// tanh logit softcap, and positions >= length masked.
//
// What bounds it on this card: device-memory bytes. Each (request, KV head)
// reads length x hd bf16 of K and of V once and does 2*G multiply-adds per
// element read (G = 7 for qwen2.5-7b), about 14 operations per byte, far under
// the ~295 the H100 needs before its arithmetic becomes the limit. The card
// reaches its memory rate only with many blocks, each with loads in flight,
// and at the runtime's shapes (8 requests x 512 tokens, 8.4 MB) the whole call
// is a few microseconds, so every serial step (dependent loads, barriers, a
// second launch) shows.
//
// What the design does about it:
//  * a (B, Hkv, splits) grid of four-warp blocks: each block serves the G
//    query heads of one (request, KV head) over one chunk of the context, and
//    each warp one quarter of the chunk, as an independent split with its own
//    online softmax state. The chunk size comes from the wrapper's planner, a
//    function of the shapes only, so the launch is the same for every step of
//    a (bucket, pages) shape (bucket 8, 32 pages: 256 blocks on 132 SMs);
//  * the block reads its chunk's page ids into shared memory once (never past
//    the length), its only block barrier; then each warp reads the layer's
//    pool directly through them, with 64-bit offsets from the pool's strides;
//  * each warp streams 16-token K/V tiles through its own three-stage ring of
//    16-byte cp.async.cg copies and synchronises only with itself, so two
//    tiles stay in flight while one is computed. Rows past the length use the
//    copy's zero-fill form, so garbage never reaches the sums as 0 x Inf;
//  * both products run on the tensor cores with the G heads as the rows of
//    the mma (G <= 8 of its 16, the rest zero): S = Q K^T with K from shared
//    memory (ldmatrix), then O += P V with P straight from the S accumulator
//    and V through ldmatrix.trans, P as a bf16 pair hi + lo so that its
//    rounding stays out of O. The softmax runs in f32 registers in base 2
//    (exp2f, log2(e) folded into the scale);
//  * every warp writes its partial (m, l, o) in f32 to scratch, an empty one
//    (-1e30, 0, 0), and a merge kernel with one block per (request, query
//    head) rescales and sums them in parallel and writes bf16. (Merging in
//    the last block of each (request, KV head) instead, behind an arrival
//    counter, measured slower: that block's serial merge sat on the critical
//    path.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kWarps = 4;        // warps per block, each an independent split
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;        // tokens per ring stage of a warp (the mma's N and K)
constexpr int kStages = 3;
constexpr int kMaxG = 8;         // query heads per KV head: rows 0..7 of the mma
constexpr int kMaxChunk = 1024;  // tokens per block (the planner's cap)
constexpr int kMaxParts = 12288; // partials per row the merge holds in shared memory
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Smem {
  static constexpr int kStr = HD + 8;  // row stride: a 16-byte shift per row, conflict-free ldmatrix
  static constexpr int stage = 2 * kTile * kStr;  // bf16 elements: K tile, then V tile
  static constexpr size_t ring = sizeof(__nv_bfloat16) * kWarps * kStages * stage;
  static constexpr size_t pages = ring;  // int [kMaxChunk + 1]
  static constexpr size_t bytes = pages + (kMaxChunk + 1) * sizeof(int);
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8, f32) += a (16x16, bf16, row-major) * b (16x8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// (a, b) as a pair of bf16 and, in `lo`, the pair's rounding error in bf16:
// hi + lo carries a and b to about 2^-16 of their size
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Partial layouts: o_part (B, Hkv, G, parts, HD) and ml_part (B, Hkv, G,
// parts, 2) in f32, (m, l) in base 2, with parts = splits * kWarps and part
// split * kWarps + warp. Fragment layout of mma m16n8k16 (lane = 4 g + t):
// accumulator c[0..1] of an 8-column tile is row g, columns 2t, 2t + 1; the
// rows are query heads, row g + 8 (c[2..3]) is padding.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2) paged_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,       // (B, Hkv, G, HD) contiguous
    const __nv_bfloat16* __restrict__ k_pool,  // one layer: (pages, page, Hkv, HD), strided
    const __nv_bfloat16* __restrict__ v_pool,
    const int32_t* __restrict__ tables,        // (B, P)
    const int32_t* __restrict__ lengths,       // (B,)
    float* __restrict__ o_part, float* __restrict__ ml_part, int G, int P, int page_size,
    int chunk, long long page_stride, long long tok_stride, long long head_stride, float scale,
    float softcap) {
  using L = Smem<HD>;
  constexpr int kStr = L::kStr;
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int DT = HD / 8;   // 8-dim tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  int* page_s = reinterpret_cast<int*>(smem + L::pages);

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int Hkv = gridDim.y, parts = gridDim.z * kWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long bh = (long long)b * Hkv + h;
  const int len = min(lengths[b], P * page_size);
  const int c0 = split * chunk, c1 = min(c0 + chunk, len);

  // ---- q as the mma's A operand (rows = heads), straight from global ----
  uint32_t qa[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = qa[ks][1] = 0u;
    if (g < G) {
      const __nv_bfloat16* qr = q + (bh * G + g) * HD + ks * 16 + 2 * t;
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(qr);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
    }
  }
  // ---- the chunk's page ids, never past the length ----
  const int p0 = c0 / page_size;
  if (c0 < c1) {
    const int np = (c1 - 1) / page_size - p0 + 1;
    for (int i = threadIdx.x; i < np; i += kThreads) page_s[i] = tables[(long long)b * P + p0 + i];
  }
  __syncthreads();

  // ---- this warp's quarter of the chunk ----
  const int quarter = chunk / kWarps;
  const int w0 = c0 + warp * quarter, w1 = min(w0 + quarter, c1);
  const int ntiles = w1 > w0 ? (w1 - w0 + kTile - 1) / kTile : 0;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) +
                        warp * kStages * L::stage * (uint32_t)sizeof(__nv_bfloat16);

  // lane l issues the copies of row l % 16, chunks l / 16, l / 16 + 2, ...
  auto issue = [&](int tile, int st) {
    const int row = lane % kTile, pos = w0 + tile * kTile + row;
    const bool ok = pos < w1;
    long long off = 0;
    if (ok)
      off = (long long)page_s[pos / page_size - p0] * page_stride +
            (long long)(pos % page_size) * tok_stride + (long long)h * head_stride;
    const uint32_t kd = ring + (st * L::stage + row * kStr) * 2;
    const uint32_t vd = kd + kTile * kStr * 2;
#pragma unroll
    for (int c = lane / kTile; c < CH; c += 32 / kTile) {
      cp_async16(kd + c * 16, k_pool + off + c * 8, ok);
      cp_async16(vd + c * 16, v_pool + off + c * 8, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) issue(st, st);
    cp_async_commit();
  }

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m = kNegInf, l = 0.f;
  const bool capped = softcap > 0.f;
  const float c_scale = capped ? scale / softcap : scale * kLog2e;
  const float c_cap = softcap * kLog2e;
  const int m8 = lane / 8;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // tile `it` landed for every lane; stage (it - 1) % kStages is free
    {
      const int nt = it + kStages - 1;
      if (nt < ntiles) issue(nt, nt % kStages);
      cp_async_commit();
    }
    const uint32_t ks_addr = ring + (it % kStages) * L::stage * 2;
    const uint32_t vs_addr = ks_addr + kTile * kStr * 2;

    // ---- S = Q K^T: 16 heads (G used) x 16 tokens ----
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kf[4];
      ldmatrix_x4(kf, ks_addr + (((m8 >> 1) * 8 + lane % 8) * kStr + ks * 16 + (m8 & 1) * 8) * 2);
      mma_bf16(s[0], qa[ks][0], 0u, qa[ks][1], 0u, kf[0], kf[1]);
      mma_bf16(s[1], qa[ks][0], 0u, qa[ks][1], 0u, kf[2], kf[3]);
    }

    // ---- online softmax in base 2 over head g's four tokens of this lane ----
    const int t0 = w0 + it * kTile;
    float x[4], mx = kNegInf;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = s[e / 2][e % 2];
      const bool ok = t0 + (e / 2) * 8 + 2 * t + (e % 2) < w1;
      x[e] = ok ? (capped ? tanhf(v * c_scale) * c_cap : v * c_scale) : kNegInf;
      mx = fmaxf(mx, x[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx), alpha = exp2f(m - m_new);
    m = m_new;
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = x[e] > kNegInf ? exp2f(x[e] - m_new) : 0.f;
      sum += x[e];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;

    // ---- O = O * alpha + P V: P from the accumulator, V through ldmatrix.trans ----
    // P goes in as hi + lo bf16 parts (two products; the tensor cores idle in
    // this bytes-bound kernel), so its bf16 rounding does not reach O
    uint32_t ph0, pl0, ph2, pl2;
    split_bf16(x[0], x[1], ph0, pl0);
    split_bf16(x[2], x[3], ph2, pl2);
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha;
      o[j][1] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < DT; j += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vs_addr + (((m8 & 1) * 8 + lane % 8) * kStr + j * 8 + (m8 >> 1) * 8) * 2);
      mma_bf16(o[j], ph0, 0u, ph2, 0u, vf[0], vf[1]);
      mma_bf16(o[j], pl0, 0u, pl2, 0u, vf[0], vf[1]);
      mma_bf16(o[j + 1], ph0, 0u, ph2, 0u, vf[2], vf[3]);
      mma_bf16(o[j + 1], pl0, 0u, pl2, 0u, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();

  // ---- this warp's partial: head g, dims 8 j + 2 t (+1) ----
  if (g < G) {
    const long long idx = (bh * G + g) * parts + split * kWarps + warp;
    float* op = o_part + idx * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j) *reinterpret_cast<float2*>(op + j * 8) = make_float2(o[j][0], o[j][1]);
    if (t == 0) *reinterpret_cast<float2*>(ml_part + idx * 2) = make_float2(m, l);
  }
}

// One block per (request, query head), one thread per dim: rescale every
// partial to the largest max and sum. Empty partials weigh exp2(-1e30 - M) = 0.
template <int HD>
__global__ void __launch_bounds__(HD) paged_decode_merge_kernel(
    const float* __restrict__ o_part, const float* __restrict__ ml_part,
    __nv_bfloat16* __restrict__ out, int parts) {
  extern __shared__ float w_s[];  // [parts]
  __shared__ float red[HD / 32];
  const long long row = blockIdx.x;
  const int d = threadIdx.x, lane = d % 32, warp = d / 32;
  const float* ml = ml_part + row * parts * 2;

  float mx = kNegInf;
  for (int s = d; s < parts; s += HD) mx = fmaxf(mx, ml[2 * s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < HD / 32; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();

  float l = 0.f;
  for (int s = d; s < parts; s += HD) {
    const float w = exp2f(ml[2 * s] - mx);
    w_s[s] = w;
    l += w * ml[2 * s + 1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  if (lane == 0) red[warp] = l;
  __syncthreads();  // also publishes w_s
  l = 0.f;
#pragma unroll
  for (int w = 0; w < HD / 32; ++w) l += red[w];

  const float* op = o_part + row * parts * HD + d;
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < parts; ++s) acc += w_s[s] * op[(long long)s * HD];
  out[row * HD + d] = __float2bfloat16(acc / fmaxf(l, 1e-30f));
}

template <int HD>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* lengths, void* out, void* o_part, void* ml_part, int B, int Hkv, int G,
           int P, int page_size, int chunk, int splits, long long page_stride,
           long long tok_stride, long long head_stride, float scale, float softcap,
           cudaStream_t s) {
  static bool attr_set = false;  // one opt-in per process for > 48 KB of shared memory
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(paged_decode_split_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<HD>::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  auto* op = static_cast<float*>(o_part);
  auto* mp = static_cast<float*>(ml_part);
  paged_decode_split_kernel<HD><<<dim3(B, Hkv, splits), kThreads, Smem<HD>::bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), op, mp, G, P, page_size, chunk, page_stride,
      tok_stride, head_stride, scale, softcap);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int parts = splits * kWarps;
  paged_decode_merge_kernel<HD><<<B * Hkv * G, HD, parts * sizeof(float), s>>>(
      op, mp, static_cast<__nv_bfloat16*>(out), parts);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// context is cut into `splits` chunks of `chunk` token slots (a multiple of
// 64: a 16-token tile for each of the four warps); o_part
// (B*Hkv*G*splits*4*hd f32) and ml_part (B*Hkv*G*splits*4*2 f32) are the
// caller's scratch, and the merge kernel follows on the same stream.
extern "C" int paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                    const void* tables, const void* lengths, void* out,
                                    void* o_part, void* ml_part, int B, int Hkv, int G, int hd,
                                    int P, int page_size, int chunk, int splits,
                                    long long page_stride, long long tok_stride,
                                    long long head_stride, float scale, float softcap,
                                    void* stream) {
  if (B < 1 || Hkv < 1 || Hkv > 65535 || G < 1 || G > kMaxG || P < 1 || page_size < 1 ||
      chunk < 1 || chunk > kMaxChunk || chunk % (kWarps * kTile) != 0 || splits < 1 ||
      splits > 65535 || splits * kWarps > kMaxParts ||
      (long long)chunk * splits < (long long)P * page_size || o_part == nullptr ||
      ml_part == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128>(q, k_pool, v_pool, tables, lengths, out, o_part, ml_part, B, Hkv, G, P,
                       page_size, chunk, splits, page_stride, tok_stride, head_stride, scale,
                       softcap, s);
  if (hd == 64)
    return launch<64>(q, k_pool, v_pool, tables, lengths, out, o_part, ml_part, B, Hkv, G, P,
                      page_size, chunk, splits, page_stride, tok_stride, head_stride, scale,
                      softcap, s);
  return (int)cudaErrorInvalidValue;
}
