// Flash-attention forward on Hopper's tensor cores (sm_90a): the bf16 route.
// Causal attention with an optional sliding window and an optional tanh
// softcap, online softmax.
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/flash_attention/kernel.py::flash_attention_bnh (_flash_kernel)
// for bf16 q, k, v (fp32 goes to flash_attention_fwd.cu). Same function:
// fp32 scores scaled by 1/sqrt(H), softcap * tanh(s / softcap), masked
// entries set to -1e30, running max / denominator / accumulator in fp32,
// denominator clamped at 1e-30, output rounded once to bf16.
//
// Bound. phi3-mini's shape (B=4, S=1024, N=32, H=96, causal): 25.8 GFLOP
// over the causal pairs against 100.7 MB of q, k, v and o, so the bytes
// bound it (0.0300 ms at 3.35 TB/s against 0.0261 ms at 989 TFLOP/s).
// recurrentgemma's local attention (B=1, S=4096, N=10, H=256, window
// 2048): 64.4 GFLOP against 83.9 MB, so the operations bound it (0.0652
// ms against 0.0250 ms). Both products run on wgmma, bf16 in and fp32
// accumulated. P enters P.V as two bf16 terms, hi = bf16(P) and lo =
// bf16(P - hi), each a wgmma into the same fp32 accumulator: one bf16
// rounding of P would put the output several bf16 roundings away from the
// fp32 function, while hi + lo carries P to about 2^-17 of itself. So the
// kernel does 1.5 times the tensor-core work of the function (QK^T once,
// P.V twice).
//
// Design.
// - A block owns 128 query rows of one (batch, head): two warpgroups of
//   128 threads, each the M = 64 of its wgmmas. Its Q tile is loaded once
//   by TMA into shared memory.
// - K and V stream through a ring of two stages of 64-key tiles, each
//   filled by TMA (one thread starts each copy, completion on an
//   mbarrier per tile and tensor), so the next tile's copy overlaps this
//   tile's products. A stage is refilled once both warpgroups are done
//   with it.
// - Tiles are stored as slabs of rows of 128 bytes (64 columns; 32 or 64
//   bytes when H is 16 or 32) in the swizzle that TMA writes and wgmma
//   reads. H = 96 takes two 64-column slabs; TMA fills the columns past
//   96 with zeros, and no product reads them.
// - S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory.
//   The softcap, the masks and the online softmax work on the fp32
//   accumulator in registers: a thread holds two rows, and a row's max
//   meets across the four threads of a quad in two shuffles. Only tiles
//   that cross the diagonal, the window's edge or the end of the keys
//   are masked element by element; tiles wholly above the diagonal or
//   wholly outside the window are skipped, as they add exactly zero.
// - O += P V: wgmma m64nHk16 with P from registers (the accumulator of a
//   16-bit wgmma is, element for element, the register layout of the next
//   product's A operand) and V the MN-major B operand (transpose bit).
// - The denominator is summed from the fp32 P. The epilogue divides by
//   max(l, 1e-30), rounds once to bf16 and stores through o's strides.
// - q, k and v are addressed by 4-D tensor maps over their (B, S, N, H)
//   strides, so no fold or transpose copy is made; the rows past S or T
//   are read as zeros. The wrapper hands over a 16-byte-aligned base and
//   strides that are multiples of 16 bytes, as TMA requires, or a copy.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockM = 128;             // query rows a block
constexpr int kBlockN = 64;              // keys a tile
constexpr int kStages = 2;               // K/V ring depth
constexpr int kThreads = 256;            // two warpgroups
constexpr int kTmaError = 1000;          // + CUresult: a refused tensor map
// an mbarrier wait longer than this many cycles (about 9 s) is a fault of
// the kernel, not a slow copy: trap, so that it fails instead of hanging
constexpr long long kWaitCycles = 1ll << 34;

struct Args {
  void* o;
  int N, S, T;
  long long o_sb, o_ss, o_sn;            // strides of o in elements
  float scale;                           // 1/sqrt(H)
  int causal;
  int window;                            // <= 0: no window
  float softcap;                         // <= 0: no softcap
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// One box of a 4-D tensor map (columns, rows, head, batch) into shared
// memory; the copy's bytes complete the transaction count of `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (all in 16-byte units) and the swizzle of rows of
// kSwB bytes (1: 128 B, 2: 64 B, 3: 32 B).
template <int kSwB>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t layout = kSwB == 128 ? 1 : (kSwB == 64 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
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

// Pin registers that an in-flight wgmma reads or writes: no access the
// compiler makes to them may move across this point.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// S (64 x 64, fp32) = A (64 x 16, K-major in shared memory) . B^T
// (B 64 x 16, K-major in shared memory); scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N, fp32) += A (64 x 16 bf16, in registers) . B (16 x N,
// MN-major in shared memory), for each head dim N.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat162 x) {
  uint32_t r;
  memcpy(&r, &x, sizeof(r));
  return r;
}

// p0, p1 (fp32) as the bf16 pairs hi = bf16(p) and lo = bf16(p - hi)
__device__ __forceinline__ void split_hi_lo(float p0, float p1, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16x2(h);
  lo = pack_bf16x2(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// Shared memory, from a 1024-byte-aligned base: the Q tile (kNs slabs of
// kBlockM rows), then kStages K tiles and kStages V tiles (kNs slabs of
// kBlockN rows each), then the mbarriers (Q, K per stage, V per stage).
template <int H, int kSwB>
struct Layout {
  static constexpr int kCols = kSwB / 2;                   // bf16 a slab row
  static constexpr int kNs = (H + kCols - 1) / kCols;       // slabs a row
  static constexpr uint32_t kQSlab = kBlockM * kSwB;
  static constexpr uint32_t kKvSlab = kBlockN * kSwB;
  static constexpr uint32_t kQBytes = kNs * kQSlab;
  static constexpr uint32_t kKvBytes = kNs * kKvSlab;      // one tile
  static constexpr uint32_t kBars = kQBytes + 2 * kStages * kKvBytes;
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// Fill ring stage `stage` with key tile `tile` of K and of V, each slab a
// TMA box, each tensor completing its own mbarrier.
template <int H, int kSwB>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t sk,
                                        uint32_t sv, uint32_t bar_k,
                                        uint32_t bar_v, int stage, int tile,
                                        int n, int b) {
  using L = Layout<H, kSwB>;
  const uint32_t off = stage * L::kKvBytes;
  mbar_expect_tx(bar_k + 8 * stage, L::kKvBytes);
#pragma unroll
  for (int s = 0; s < L::kNs; ++s)
    tma_load_4d(sk + off + s * L::kKvSlab, tk, bar_k + 8 * stage,
                s * L::kCols, tile * kBlockN, n, b);
  mbar_expect_tx(bar_v + 8 * stage, L::kKvBytes);
#pragma unroll
  for (int s = 0; s < L::kNs; ++s)
    tma_load_4d(sv + off + s * L::kKvSlab, tv, bar_v + 8 * stage,
                s * L::kCols, tile * kBlockN, n, b);
}

template <int H, int kSwB>
__global__ void __launch_bounds__(kThreads, H <= 96 ? 2 : 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Layout<H, kSwB>;
  constexpr int kCols = L::kCols;
  constexpr int kSlabSteps = kCols / 16;     // k16 steps of Q K^T a slab
  constexpr uint32_t kSbo = 8 * kSwB;        // from 8 rows to the next 8
  static_assert(H % 16 == 0 && kCols % 16 == 0, "H: a multiple of 16");
  static_assert(L::kSmem <= 232448, "shared memory of one block");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + L::kQBytes;
  const uint32_t sv = sk + kStages * L::kKvBytes;
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_k = bar_q + 8;          // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int b = blockIdx.y / a.N, n = blockIdx.y % a.N;
  // the longest rows first: under the causal mask the last tiles see the
  // most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;

  const int q_hi = min(q0 + kBlockM, a.S);   // one past the block's last row
  const int k_hi = a.causal ? min(a.T, q_hi) : a.T;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_first = k_lo / kBlockN;
  const int n_tiles = max(0, (k_hi + kBlockN - 1) / kBlockN - t_first);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int s = 0; s < L::kNs; ++s)
      tma_load_4d(sq + s * L::kQSlab, &tq, bar_q, s * kCols, q0, n, b);
    for (int i = 0; i < kStages && i < n_tiles; ++i)
      load_kv<H, kSwB>(&tk, &tv, sk, sv, bar_k, bar_v, i, t_first + i, n, b);
  }

  // this thread's rows: row0 and row0 + 8 of the block's 128
  const int wg_lo = q0 + wg * 64, wg_hi = wg_lo + 63;
  const int row0 = wg_lo + warp * 16 + lane / 4;
  const int col0 = (lane % 4) * 2;           // and col0 + 1, of each 8
  const uint32_t qa = sq + wg * 64 * kSwB;   // this warpgroup's Q rows
  const float scale_log2 = a.scale * kLog2e;

  float o[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int k0 = (t_first + it) * kBlockN;
    const uint32_t kb = sk + stage * L::kKvBytes, vb = sv + stage * L::kKvBytes;

    // S = Q K^T: accumulator element 4j + e is row row0 + 8 (e / 2),
    // key k0 + 8 j + col0 + e % 2
    float s[kBlockN / 2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.f;
    mbar_wait(bar_k + 8 * stage, parity);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const uint32_t slab = kk / kSlabSteps, off = (kk % kSlabSteps) * 32;
      const uint64_t da = make_desc<kSwB>(qa + slab * L::kQSlab + off, 16,
                                          kSbo);
      const uint64_t db = make_desc<kSwB>(kb + slab * L::kKvSlab + off, 16,
                                          kSbo);
      wgmma_ss_n64(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scores in the log2 domain; masks only on the tiles that need them
    const bool edge = k0 + kBlockN > a.T
        || (a.causal && k0 + kBlockN - 1 > wg_lo)
        || (a.window > 0 && k0 <= wg_hi - a.window);
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      float x = s[i];
      if (a.softcap > 0.f)
        x = a.softcap * tanhf(x * a.scale / a.softcap) * kLog2e;
      else
        x *= scale_log2;
      if (edge) {
        const int qpos = row0 + 8 * ((i % 4) / 2);
        const int kpos = k0 + 8 * (i / 4) + col0 + i % 2;
        const bool ok = kpos < a.T && (!a.causal || kpos <= qpos)
                        && (a.window <= 0 || kpos > qpos - a.window);
        if (!ok) x = kNegInf;
      }
      s[i] = x;
    }

    // online softmax: a row's max over the quad, the rescale of l and O
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i)
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
    // P as the A operand of k16 step kk: register r holds elements
    // 8 kk + 2 r and + 1 of the accumulator, of row half r % 2
    uint32_t ph[kBlockN / 16][4], pl[kBlockN / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float p0 = exp2f(s[i] - m[r % 2]);
        const float p1 = exp2f(s[i + 1] - m[r % 2]);
        rs[r % 2] += p0 + p1;
        split_hi_lo(p0, p1, ph[kk][r], pl[kk][r]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) o[i] *= alpha[(i % 4) / 2];

    // O += P_hi V + P_lo V; V's k16 step kk is 16 rows on
    mbar_wait(bar_v + 8 * stage, parity);
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint64_t db = make_desc<kSwB>(vb + kk * 16 * kSwB, L::kKvSlab,
                                          kSbo);
      wgmma_rs(o, ph[kk], db);
      wgmma_rs(o, pl[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);

    // both warpgroups are done with this stage: refill it
    __syncthreads();
    if (tid == 0 && it + kStages < n_tiles)
      load_kv<H, kSwB>(&tk, &tv, sk, sv, bar_k, bar_v, stage,
                       t_first + it + kStages, n, b);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    if (qpos >= a.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb
                        + qpos * a.o_ss + n * a.o_sn;
#pragma unroll
    for (int j = 0; j < H / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + col0) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / denom,
                                o[4 * j + 2 * r + 1] / denom);
  }
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the CUDA runtime so
// that the library links no libcuda of its own
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over a (B, rows, N, H) bf16 tensor with the given element
// strides, in boxes of `box_rows` rows by one slab of columns. Returns 0
// or kTmaError + the CUresult.
int encode(CUtensorMap* map, const void* ptr, int B, int rows, int N, int H,
           long long s_b, long long s_row, long long s_n, int box_cols,
           int box_rows, int swb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kTmaError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)H, (cuuint64_t)rows,
                              (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_n * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      swb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (swb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaError + (int)r;
}

struct Strides {
  long long q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn;
};

template <int H, int kSwB>
int launch(const void* q, const void* k, const void* v, int B, const Args& a,
           const Strides& st, cudaStream_t stream) {
  using L = Layout<H, kSwB>;
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, B, a.S, a.N, H, st.q_sb, st.q_ss, st.q_sn,
                  L::kCols, kBlockM, kSwB);
  if (rc == 0)
    rc = encode(&tk, k, B, a.T, a.N, H, st.k_sb, st.k_ss, st.k_sn, L::kCols,
                kBlockN, kSwB);
  if (rc == 0)
    rc = encode(&tv, v, B, a.T, a.N, H, st.v_sb, st.v_ss, st.v_sn, L::kCols,
                kBlockN, kSwB);
  if (rc != 0) return rc;
  auto kernel = flash_fwd_sm90_kernel<H, kSwB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + kBlockM - 1) / kBlockM, B * a.N);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,S,N,H), k and v (B,T,N,H), o (B,S,N,H), all bf16, addressed through
// the given strides (in elements; H is contiguous). The base addresses of
// q, k and v are 16-byte aligned and their strides multiples of 8.
extern "C" int flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o,
    int B, int N, int S, int T, int H,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    long long o_sb, long long o_ss, long long o_sn,
    float scale, int causal, int window, float softcap, void* stream) {
  const Args a{o, N, S, T, o_sb, o_ss, o_sn, scale, causal, window, softcap};
  const Strides st{q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 16: return launch<16, 32>(q, k, v, B, a, st, s);
    case 32: return launch<32, 64>(q, k, v, B, a, st, s);
    case 64: return launch<64, 128>(q, k, v, B, a, st, s);
    case 96: return launch<96, 128>(q, k, v, B, a, st, s);
    case 128: return launch<128, 128>(q, k, v, B, a, st, s);
    case 256: return launch<256, 128>(q, k, v, B, a, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_fwd_sm90_error_string(int err) {
  if (err >= kTmaError)
    return "cuTensorMapEncodeTiled refused a tensor map of q, k or v "
           "(the code less 1000 is the CUresult)";
  return cudaGetErrorString((cudaError_t)err);
}
