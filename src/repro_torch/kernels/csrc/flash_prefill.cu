// Causal flash prefill attention for Hopper (sm_90a): wgmma tensor-core
// products fed by TMA through an mbarrier ring, an f32 online softmax in
// registers.
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py, flash_prefill_pallas
// (kernel body _kernel). GQA attention of Sq queries at absolute positions
// q_offset.. over the first kv_lens[b] of Skv keys, causal (optionally
// sliding-window) or not (an encoder's self-attention, or cross attention
// with Sq != Skv), with an optional tanh logit softcap. Key tiles above the
// causal diagonal, left of the window or past kv_lens[b] are skipped; the
// tile that crosses kv_lens[b] (or ends past Skv, where TMA reads zeros) is
// masked.
//
// Head dims 64, 96, 112, 128 and 256. Tiles are cut into column panels of one
// swizzle span: 64 columns (128-byte rows, 128-byte swizzle) where hd is a
// multiple of 64, else 32 columns (64-byte rows, 64-byte swizzle), so hd 96
// is three panels and is not padded. hd 112 (zamba2's shared attention) runs
// the hd 128 tiles over the 112-wide tensors (the template's W): the tensor
// maps span 112 columns, so TMA fills the second panel's last 16 columns of
// Q, K and V with zeros (which add nothing to Q K^T and make O's last 16
// columns 0), and the epilogue writes only the first 112. The reference pads
// hd to 128 with zeros in the same way before its kernel; here nothing is
// copied, and the card does 8/7 of the products.
//
// What bounds it on this card: at a prompt of 512 tokens (qwen2.5-7b widths,
// Hq = 28, Hkv = 4, hd = 128) the bytes of q, K, V and the output (8.4 MB,
// 2.5 us at 3.35 TB/s) outweigh the causal products (1.9 GFLOP, 1.9 us at the
// bf16 tensor-core peak), and how well the grid fills the 132 SMs decides most
// of the time; from about 700 tokens on the products dominate (30.1 GFLOP at
// 2048 tokens, 30 us at 989 TFLOP/s) and only wgmma reaches that rate.
//
// What the design does about it:
//  * at hd 256 the O accumulator alone is 128 f32 registers a thread: the
//    block keeps the 64-key tile and one consumer warpgroup, is allowed up
//    to 255 registers (one block per SM; its 160 KB of Q and K/V ring leave
//    no room for a second anyway);
//  * one block per (query tile, KV head, batch row) packs the G query heads of
//    the KV head into its 64 rows (row = position * G + head: 9 positions x 7
//    heads for qwen2.5-7b), so each K/V tile is fetched once per group, not
//    once per head. A block is one consumer warpgroup and one producer warp,
//    small enough for two blocks per SM: B=1, S=512 gives 228 blocks, all
//    resident at once on the 132 SMs. (Two consumer warpgroups of 128 rows
//    with 128-key tiles spilled registers and measured no faster.);
//  * the producer warp keeps TMA copies in flight: the Q tile once, then K and
//    V tiles of 64 keys into a two-stage ring, each stage with its own K-full,
//    V-full and empty mbarrier. The tensor maps are encoded on the host per
//    call over the model layout's strides (driver entry point, no libcuda
//    link), with 128-B swizzle matching the wgmma descriptors;
//  * S = Q K^T is wgmma m64n64k16 with Q and K from shared memory (K-major);
//    O += P V is wgmma m64nHDk16 with P from registers (the S accumulator in
//    bf16 is already the A fragment) and V from shared memory (MN-major,
//    transpose bit). A tile's P V and the next tile's S are issued back to
//    back and waited for together, once per tile;
//  * the softmax runs in f32 registers in base 2, one FFMA and one exp2f per
//    score (log2(e) folded into the scale); the mask is evaluated only on
//    tiles that cross the causal diagonal, the window edge or kv_lens[b]. On
//    the tile that crosses kv_lens[b] the V rows past it are zeroed in shared
//    memory, so whatever lies there cannot turn into NaN through P V;
//  * query tiles run heaviest first (reverse causal order);
//  * q_offset and the per-row kv_lens are runtime arguments, and a ragged
//    Sq needs nothing: TMA fills positions past the tensor with zeros and the
//    epilogue writes only rows inside it;
//  * a row that sees no key at all (a padded query past kv_lens[b] plus the
//    window, or kv_lens[b] = 0) gets what the plain version gives it: its
//    scores are all masked, so its softmax is uniform over all Skv keys and
//    the row is the mean of V. A block with such rows computes that mean
//    once, all consumers together, after the epilogue (an out-of-line
//    function); other blocks pay one barrier for it.
#include <cuda.h>  // CUtensorMap and its enums: types only, libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;      // keys per tile
constexpr int kStages = 2;   // depth of the K/V ring
constexpr int kMaxGP = 16;   // query heads packed into one block
constexpr int kConsumers = 128;  // one consumer warpgroup
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Smem {
  static constexpr int kPW = HD % 64 == 0 ? 64 : 32;  // columns of a panel (the swizzle span)
  static constexpr int kRB = 2 * kPW;                  // bytes of a panel row: 128 or 64
  static constexpr int kPanels = HD / kPW;
  static_assert(HD % kPW == 0 && HD <= 256, "head_dim");
  static constexpr uint64_t kSwizzle = kRB == 128 ? 1 : 2;  // descriptor mode: 128 B, 64 B
  static constexpr uint32_t kAtom = 8 * kRB;  // 8 rows: the swizzle pattern's period
  static constexpr int kRows = 64;            // query rows of a block: one warpgroup
  static constexpr uint32_t q_panel = kRows * kRB;
  static constexpr uint32_t kv_panel = kBN * kRB;
  static constexpr uint32_t q = 0;                                     // [kPanels][kRows][64]
  static constexpr uint32_t k = q + kPanels * q_panel;                 // [kStages][kPanels][kBN][64]
  static constexpr uint32_t v = k + kStages * kPanels * kv_panel;      // [kStages][kPanels][kBN][64]
  static constexpr uint32_t bar = v + kStages * kPanels * kv_panel;    // q_full, k_full, v_full, empty
  static constexpr uint32_t bytes = bar + 8 * (1 + 3 * kStages);
  static constexpr uint32_t alloc = bytes + 1024;  // the swizzle needs a 1024-byte aligned base
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of `bar` with this parity. A wait that has not ended
// after ~2^26 polls (seconds; a tile takes microseconds) traps, so a fault
// in the pipeline ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`. The
// map's dims are (hd, then H, S, B in the order of their strides); `perm`
// holds the slot of H, S and B in 2 bits each.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int perm, int x, int h, int s, int b) {
  int c[4];
  c[0] = x;
  c[perm & 3] = h;
  c[(perm >> 2) & 3] = s;
  c[(perm >> 4) & 3] = b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3])
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, all in 16-byte units, and the swizzle mode (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                            uint64_t mode) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// Whether `pred` holds on any consumer thread (named barrier 1, consumers only).
__device__ __forceinline__ bool consumers_any(bool pred) {
  uint32_t any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\nbar.red.or.pred p, 1, %2, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(any)
      : "r"((uint32_t)pred), "n"(kConsumers)
      : "memory");
  return any != 0;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of wgmma accumulators across the
// asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// d (64 x 64, f32) = A (64 x 16, smem, K-major) * B (64 x 16, smem, K-major)^T
// (+ d when `accumulate`)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 96, f32) += A (64 x 16, bf16 in registers) * B (16 x 96, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16, bf16 in registers) * B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The mean of V over all Skv keys of one (batch row, KV head), into `mean`
// (HD floats): what the plain version gives a query that sees no key, since
// all its scores are masked alike and its softmax is uniform. `vb` points at
// key 0 of the row and head. Each consumer sums column pairs over the keys,
// four keys in flight. Out of line, so that this rare path costs the main
// loop no registers.
template <int W>
__device__ __noinline__ void mean_v(float* mean, const __nv_bfloat16* vb, long long v_ss,
                                    int Skv, int tid) {
  for (int c = 2 * tid; c < W; c += 2 * kConsumers) {
    float x0[4] = {0.f, 0.f, 0.f, 0.f}, x1[4] = {0.f, 0.f, 0.f, 0.f};
    int key = 0;
    for (; key + 4 <= Skv; key += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vb + (key + u) * v_ss + c));
        x0[u] += x.x;
        x1[u] += x.y;
      }
    }
    for (; key < Skv; ++key) {
      const float2 x =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vb + key * v_ss + c));
      x0[0] += x.x;
      x1[0] += x.y;
    }
    mean[c] = (x0[0] + x0[1] + x0[2] + x0[3]) / Skv;
    mean[c + 1] = (x1[0] + x1[1] + x1[2] + x1[3]) / Skv;
  }
}

// Block (blockIdx.x: query tile, heaviest first; blockIdx.y: KV head and head
// group; blockIdx.z: batch row). Warps 0..3 are the consumer warpgroup, warp
// 4 the producer. Rows of the block's Q tile are (position, packed head)
// pairs: position-major (row = pos * GP + g) when the q map's S dim is outer
// to its H dim, else head-major (row = g * qbox_s + pos). HD is the width of
// the tiles, W (<= HD) that of the tensors: columns W..HD-1 of the tiles are
// TMA's zero fill.
template <int HD, int W>
__global__ void __launch_bounds__(160, HD > 128 ? 1 : 2) flash_prefill_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ v, long long v_sb, long long v_ss, long long v_sh,
    const int32_t* __restrict__ kv_lens, int Sq, int Skv, int G, int GP, int npos, int qbox_s,
    int kv_box, int q_perm, int k_perm, int v_perm, long long o_sb, long long o_ss,
    long long o_sh, int q_offset, int causal, int window, float scale, float softcap) {
  using L = Smem<HD>;
  static_assert(W % 8 == 0 && W <= HD && W > HD - L::kPW, "tensor width");
  constexpr int kPanels = L::kPanels;
  constexpr int NS = kBN / 2;  // score registers per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)));
  const uint32_t q_full = base + L::bar;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages, empty = v_full + 8 * kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest query tiles first
  const int groups = G / GP;
  const int hk = blockIdx.y / groups;
  const int gbase = hk * G + (blockIdx.y % groups) * GP;  // first query head of the block
  const int b = blockIdx.z;
  const int p0 = qt * npos;
  const int nq = min(npos, Sq - p0);  // positions of this tile inside the tensor
  const int kv_len = min(kv_lens[b], Skv);

  // key range: up to the causal bound of the last position, from the window's
  // left edge of the first one
  const int qfirst = q_offset + p0, qlast = q_offset + p0 + nq - 1;
  int kv_end = kv_len, kv_begin = 0;
  if (causal) {
    kv_end = min(kv_end, qlast + 1);
    if (window > 0) kv_begin = max(0, qfirst - window + 1);
  }
  const int t_begin = kv_begin / kBN;
  const int ntiles = kv_end > kv_begin ? (kv_end + kBN - 1) / kBN - t_begin : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ================= producer: one lane issues every copy =================
    if (lane == 0) {
      mbar_expect_tx(q_full, kPanels * GP * qbox_s * L::kRB);
      for (int p = 0; p < kPanels; ++p)
        tma_load(base + L::q + p * L::q_panel, &q_map, q_full, q_perm, p * L::kPW, gbase, p0, b);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % kStages, round = i / kStages;
        if (round > 0) mbar_wait(empty + 8 * st, (round - 1) & 1);
        const int k0 = (t_begin + i) * kBN;
        mbar_expect_tx(k_full + 8 * st, kPanels * kv_box * L::kRB);
        for (int p = 0; p < kPanels; ++p)
          tma_load(base + L::k + (st * kPanels + p) * L::kv_panel, &k_map, k_full + 8 * st,
                   k_perm, p * L::kPW, hk, k0, b);
        mbar_expect_tx(v_full + 8 * st, kPanels * kv_box * L::kRB);
        for (int p = 0; p < kPanels; ++p)
          tma_load(base + L::v + (st * kPanels + p) * L::kv_panel, &v_map, v_full + 8 * st,
                   v_perm, p * L::kPW, hk, k0, b);
      }
    }
    return;
  }

  // ======================= consumers: 64 rows per warpgroup =======================
  const int t4 = lane % 4;
  const bool pos_major = ((q_perm >> 2) & 3) > (q_perm & 3);
  int qpos[2], prow[2], hrow[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + lane / 4 + 8 * r;
    prow[r] = pos_major ? row / GP : row % qbox_s;
    hrow[r] = pos_major ? row % GP : row / qbox_s;
    live[r] = row < GP * qbox_s && prow[r] < nq;
    qpos[r] = q_offset + p0 + prow[r];
  }

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const bool capped = softcap > 0.f;
  const float c_scale = capped ? scale / softcap : scale * kLog2e;
  const float c_cap = softcap * kLog2e;
  const uint32_t q_addr = base + L::q;

  // S = Q K^T of one tile into s (asynchronous: committed, not waited for)
  auto issue_s = [&](float(&acc)[NS], int i) {
    const int st = i % kStages;
    const uint32_t k_addr = base + L::k + st * kPanels * L::kv_panel;
    mbar_wait(k_full + 8 * st, (i / kStages) & 1);
    wgmma_fence();
    constexpr int kSteps = L::kPW / 16;  // k-steps of 16 columns in a panel
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint32_t off = (ks % kSteps) * 32;  // 16 columns into the swizzled panel
      const uint64_t dq =
          desc_sw(q_addr + (ks / kSteps) * L::q_panel + off, 16, L::kAtom, L::kSwizzle);
      const uint64_t dk =
          desc_sw(k_addr + (ks / kSteps) * L::kv_panel + off, 16, L::kAtom, L::kSwizzle);
      wgmma_ss_n64(acc, dq, dk, ks > 0);
    }
    wgmma_commit();
  };

  // Each iteration waits once: for its S and the previous tile's P V, which
  // were in flight together; then it issues its own P V and the next tile's
  // S back to back, so the tensor cores are fed across the softmax.
  float s[NS];
  uint32_t pa[kBN / 16][4];
  mbar_wait(q_full, 0);
  if (ntiles > 0) issue_s(s, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kStages;
    const int k0 = (t_begin + i) * kBN;
    const uint32_t v_addr = base + L::v + st * kPanels * L::kv_panel;
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(o);
    if (i > 0) mbar_arrive(empty + 8 * ((i - 1) % kStages));  // tile i - 1's K and V are read

    // ---- online softmax in base 2: a row spans the 4 lanes of a quad ----
    const bool edge = k0 + kBN > kv_len ||
                      (causal && (k0 + kBN - 1 > qfirst || (window > 0 && qlast - k0 >= window)));
    if (edge) {  // masked scores become -1e30 (ignored by the max, zeroed below)
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        const int key = k0 + (e / 4) * 8 + 2 * t4 + (e & 1);
        const int qp = qpos[(e >> 1) & 1];
        bool ok = key < kv_len;
        if (causal) ok = ok && key <= qp && (window <= 0 || qp - key < window);
        s[e] = ok ? s[e] : kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf}, alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < NS; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // the raw max, in the base-2 units of the scores (both maps increase)
      const float m_tile = capped ? tanhf(mx[r] * c_scale) * c_cap : mx[r] * c_scale;
      const float m_new = fmaxf(m[r], m_tile);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int r = (e >> 1) & 1;
      float p = capped ? exp2f(tanhf(s[e] * c_scale) * c_cap - m[r])
                       : exp2f(fmaf(s[e], c_scale, -m[r]));
      if (edge) p = s[e] > kNegInf ? p : 0.f;
      s[e] = p;
      sum[r] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
    // P in bf16: the S accumulator of 16 keys is the A fragment of P V
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // ---- O += P V, then the next tile's S ----
    mbar_wait(v_full + 8 * st, (i / kStages) & 1);
    if (k0 + kBN > kv_len) {
      // zero the V rows at and past kv_len (whatever lies there, 0 x it
      // must stay 0), then make the stores visible to wgmma
      const int first = kv_len - k0;
      constexpr int kChunks = L::kRB / 16;  // 16-byte chunks of a panel row
      for (int idx = threadIdx.x; idx < kPanels * (kBN - first) * kChunks; idx += kConsumers) {
        const int p = idx / ((kBN - first) * kChunks), rem = idx % ((kBN - first) * kChunks);
        *reinterpret_cast<uint4*>(smem + (v_addr - base) + p * L::kv_panel +
                                  (first + rem / kChunks) * L::kRB + (rem % kChunks) * 16) =
            make_uint4(0, 0, 0, 0);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      // 16 keys down; the panels side by side (leading offset) make up n = HD
      const uint64_t dv = desc_sw(v_addr + kk * 16 * L::kRB, L::kv_panel, L::kAtom, L::kSwizzle);
      wgmma_rs(o, pa[kk], dv);
    }
    wgmma_commit();
    if (i + 1 < ntiles) issue_s(s, i + 1);
  }
  wgmma_wait_all();
  fence_regs(o);

  // ---- epilogue: rows inside the tensor, straight to the model layout ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live[r]) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* op = out + b * o_sb + (long long)(p0 + prow[r]) * o_ss +
                        (long long)(gbase + hrow[r]) * o_sh + 2 * t4;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
  // rows that saw no key (l = 0, written as 0 above) get the mean of V,
  // computed once for the block into the Q tile's space (no longer read)
  const bool keyless = (live[0] && l[0] == 0.f) || (live[1] && l[1] == 0.f);
  if (consumers_any(keyless)) {
    float* mean = reinterpret_cast<float*>(smem + L::q);
    mean_v<W>(mean, v + b * v_sb + (long long)hk * v_sh, v_ss, Skv, threadIdx.x);
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r] || l[r] != 0.f) continue;
      __nv_bfloat16* op = out + b * o_sb + (long long)(p0 + prow[r]) * o_ss +
                          (long long)(gbase + hrow[r]) * o_sh + 2 * t4;
      for (int j = 0; j < W / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
            __floats2bfloat162_rn(mean[j * 8 + 2 * t4], mean[j * 8 + 2 * t4 + 1]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a bf16 tensor of shape (B, S, H, hd) with element strides
// (sb, ss, sh, 1): dims (hd, then H, S, B ordered by stride), box (box_x,
// box_h, box_s, 1), rows of box_x columns swizzled over their 2 * box_x bytes
// (128 or 64). *perm gets the slot of H, S and B.
int make_map(CUtensorMap* map, const void* ptr, int hd, int H, int S, int B, long long sh,
             long long ss, long long sb, int box_x, int box_h, int box_s, int* perm) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  struct Dim {
    cuuint64_t n, stride;
    cuuint32_t box;
    int which;
  } d[3] = {{(cuuint64_t)H, (cuuint64_t)sh, (cuuint32_t)box_h, 0},
            {(cuuint64_t)S, (cuuint64_t)ss, (cuuint32_t)box_s, 1},
            {(cuuint64_t)B, (cuuint64_t)sb, 1u, 2}};
  for (int i = 1; i < 3; ++i)  // by stride, stable
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  const cuuint64_t dims[4] = {(cuuint64_t)hd, d[0].n, d[1].n, d[2].n};
  const cuuint64_t strides[3] = {d[0].stride * 2, d[1].stride * 2, d[2].stride * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_x, d[0].box, d[1].box, d[2].box};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int slot[3];
  for (int i = 0; i < 3; ++i) slot[d[i].which] = i + 1;
  *perm = slot[0] | (slot[1] << 2) | (slot[2] << 4);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        box_x == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD, int W>
int launch(const void* q, const void* k, const void* v, void* out, const void* kv_lens, int B,
           int Sq, int Skv, int Hq, int Hkv, int GP, const long long* st, int q_offset,
           int causal, int window, float scale, float softcap, cudaStream_t s) {
  using L = Smem<HD>;
  static bool attr_set = false;  // one opt-in per process for > 48 KB of shared memory
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<HD, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::alloc);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int G = Hq / Hkv;
  const int npos = L::kRows / GP;
  const int qbox_s = Sq < npos ? Sq : npos;
  const int kv_box = Skv < kBN ? Skv : kBN;
  CUtensorMap qm, km, vm;
  int qp, kp, vp, err;
  if ((err = make_map(&qm, q, W, Hq, Sq, B, st[2], st[1], st[0], L::kPW, GP, qbox_s, &qp)) ||
      (err = make_map(&km, k, W, Hkv, Skv, B, st[5], st[4], st[3], L::kPW, 1, kv_box, &kp)) ||
      (err = make_map(&vm, v, W, Hkv, Skv, B, st[8], st[7], st[6], L::kPW, 1, kv_box, &vp)))
    return err;
  const dim3 grid((Sq + npos - 1) / npos, Hkv * (G / GP), B);
  flash_prefill_kernel<HD, W><<<grid, 160, L::alloc, s>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(v), st[6],
      st[7], st[8], static_cast<const int32_t*>(kv_lens), Sq,
      Skv, G, GP, npos, qbox_s, kv_box, qp, kp, vp, st[9], st[10], st[11], q_offset, causal,
      window, scale, softcap);
  return (int)cudaGetLastError();
}

template <int HD, int W = HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, const void* kv_lens,
              int B, int Sq, int Skv, int Hq, int Hkv, const long long* st, int q_offset,
              int causal, int window, float scale, float softcap, cudaStream_t s) {
  const int G = Hq / Hkv;
  int GP = G < kMaxGP ? G : kMaxGP;  // the largest divisor of G up to kMaxGP
  while (G % GP) --GP;
  return launch<HD, W>(q, k, v, out, kv_lens, B, Sq, Skv, Hq, Hkv, GP, st, q_offset, causal,
                       window, scale, softcap, s);
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v and out in that
// order; the head_dim stride is 1, and every other stride and base address is
// a multiple of 16 bytes (TMA). Launches on `stream` and returns a CUDA error
// code (0 = launched).
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v, void* out,
                                  const void* kv_lens, int B, int Sq, int Skv, int Hq, int Hkv,
                                  int hd, const long long* strides, int q_offset, int causal,
                                  int window, float scale, float softcap, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_hd<128>(q, k, v, out, kv_lens, B, Sq, Skv, Hq, Hkv, strides, q_offset, causal,
                          window, scale, softcap, s);
  if (hd == 64)
    return launch_hd<64>(q, k, v, out, kv_lens, B, Sq, Skv, Hq, Hkv, strides, q_offset, causal,
                         window, scale, softcap, s);
  if (hd == 96)
    return launch_hd<96>(q, k, v, out, kv_lens, B, Sq, Skv, Hq, Hkv, strides, q_offset, causal,
                         window, scale, softcap, s);
  if (hd == 112)  // the hd 128 tiles over 112-wide tensors
    return launch_hd<128, 112>(q, k, v, out, kv_lens, B, Sq, Skv, Hq, Hkv, strides, q_offset,
                               causal, window, scale, softcap, s);
  if (hd == 256)
    return launch_hd<256>(q, k, v, out, kv_lens, B, Sq, Skv, Hq, Hkv, strides, q_offset, causal,
                          window, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
