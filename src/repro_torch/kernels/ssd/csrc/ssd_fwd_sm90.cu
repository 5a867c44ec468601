// Mamba2 SSD chunked scan, forward, on Hopper's tensor cores (sm_90a): the
// bf16 route.
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/ssd/kernel.py::ssd_bh (_ssd_kernel)
// for bf16 x, B and C with p a multiple of 8 up to 128 (fp32, and other
// bf16 head dims, go to ssd_fwd.cu). Same function: for each
// (batch, head), with cs the inclusive cumulative sum of the log decay
// over a run of rows,
//   y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) x_j + exp(cs_i) C_i . state
//   state <- exp(cs_end) state + sum_j exp(cs_end - cs_j) x_j B_j^T,
// all sums in fp32, y rounded once to bf16. The function does not depend
// on the chunk length, so the kernel cuts the sequence into its own
// pieces of 128 rows whatever chunk the caller names. exp(cs_i - cs_j) is
// taken element by element and only where j <= i: at mamba2's decays cs
// falls by hundreds over a piece, and exp(cs_i) exp(-cs_j) would
// overflow. B and C are read per group through their (b, s, g, n)
// strides, head h reading group h / (heads / groups), with no per-head
// copy. Rows past S come in as TMA's zero fill with zero log decay, and
// change neither y nor the state.
//
// Bound. mamba2-1.3b's layer (b=2, s=2048, 64 heads x 64, one group of
// 128) moves 70 MB of x, y, la, B and C: 0.0210 ms at 3.35 TB/s. Over the
// causal pairs of 128-row pieces the function takes 15.1 GFLOP, 0.0153 ms
// at 989 TFLOP/s (21.5 GFLOP at chunks of 256; fewer rows a piece take
// fewer still), so the bytes bound it. Every product runs on wgmma, bf16
// in and fp32 accumulated.
//
// Precision. x, B and C are bf16, so C B^T and the products that read x
// are exact in bf16. Three operands are fp32 intermediates: M = (C B^T) o
// exp(cs_i - cs_j), the carried state, and dec_j x_j with dec_j =
// exp(cs_end - cs_j). Each enters its product as two bf16 terms, hi =
// bf16(v) and lo = bf16(v - hi), two wgmmas into one fp32 accumulator,
// which carries v to about 2^-17 of itself: rounding any one of the three
// once to bf16 puts outputs many bf16 roundings from the fp32 function,
// while with all three split the output stays within one bf16 rounding of
// it (tests/test_torch_kernels.py emulates both). So the kernel does 30.1
// GFLOP of tensor work at mamba2's shape, 2.0 times the function's 15.1 at
// its own pieces: the split doubles three products, and the 64 x 64 tiles
// on the diagonal are computed whole.
//
// Design.
// - One block per (batch, head), 256 threads in two warpgroups; the loop
//   over the pieces runs inside the block, as the TPU kernel's
//   sequential grid axis did, and the (p, n) state never leaves the SM.
//   Warpgroup w owns rows 64w .. 64w + 63 of a piece: the M = 64 of its
//   wgmmas. mamba2's shape gives 128 blocks for 132 SMs; splitting p over
//   two blocks would fill more of them but compute C B^T twice, and is
//   not done.
// - C, B (128 x n) and x (128 x p, p padded to 64 or 128 by TMA's zero
//   fill) of a piece come through 4-D tensor maps over their strides into
//   a ring of two stages where it fits (one where p > 64 and n = 128),
//   one mbarrier a stage. Tiles are slabs of 128-byte rows (64 columns;
//   32 and 64 bytes for n = 16 and 32) in the swizzle that TMA writes and
//   wgmma reads, as in flash_attention_fwd_sm90.cu; both take their
//   mbarrier, TMA and wgmma helpers from ../../sm90.cuh. la is read with
//   plain loads, the next piece's while this one computes, and its
//   cumulative sum is a warp scan.
// - Y = exp(cs_i) (C state_hi^T + C state_lo^T) + sum over the 64-row
//   tiles t on or below the diagonal of M_hi x_t + M_lo x_t: C state^T by
//   wgmma m64n{64,128}k16 with the state's bf16 hi and lo K-major in
//   shared memory; S = C B_t^T by m64n64k16, both K-major; M on the fp32
//   accumulator in registers (a thread holds two rows), split into the A
//   operand of the next product, whose B operand is x, MN-major
//   (transpose bit). Y is rounded once to bf16 and stored through y's
//   strides.
// - State update. The state stays fp32 in registers, rows p by columns
//   n; with n = 128 each warpgroup owns 64 of the columns, otherwise the
//   first warpgroup owns all. It is scaled by exp(cs_end), then gets
//   (dec x)_hi^T B + (dec x)_lo^T B, with dec x written by all threads
//   into shared memory in x's swizzled layout (a row's 16-byte pieces stay
//   in their row, so the per-row scale needs no address arithmetic) and
//   read as the MN-major A operand, and B as the MN-major B operand. The
//   new state is written back as bf16 hi and lo, K-major, for the next
//   piece's C state^T.
// - Every mbarrier wait traps after about 9 s, so a fault fails instead
//   of hanging. The wrapper hands over a 16-byte-aligned base and strides
//   that are multiples of 16 bytes, as TMA requires, or a copy.
#include "../../sm90.cuh"

namespace {

constexpr int kPiece = 128;              // rows a piece
constexpr int kTile = 64;                // rows of a warpgroup, columns of S
constexpr int kThreads = 256;            // two warpgroups
constexpr int kSmemMax = 232448;         // shared memory of one block

struct Args {
  void* y;
  const float* la;
  int S, H, heads_per_group, p;
  long long la_sb, la_ss, la_sh;         // strides in elements
  long long y_sb, y_ss, y_sh;
};

// Shared-memory writes of the threads, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// Where TMA's swizzle for rows of kSwB bytes puts the byte whose plain
// row-major offset in a slab is `off` (the slab's base aligned to the
// swizzle's period): its 16-byte unit is XORed with the place of its
// 128-byte line within the period, 8, 4 or 2 lines for rows of 128, 64 or
// 32 bytes.
template <int kSwB>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (kSwB / 16 - 1)) << 4);
}

// Shared memory, from a 1024-byte-aligned base: kStages stages of a
// piece's C, B (kNs slabs of 128 rows each) and x (kXs slabs of 128 rows
// of 64 columns); dec x as hi and lo (x's layout); the state as hi and lo
// (kNs slabs of kP rows); the cumulative log decay of the piece; the
// warp sums of its scan; an mbarrier a stage.
template <int N, int kP>
struct Layout {
  static constexpr int kSwB = N == 16 ? 32 : (N == 32 ? 64 : 128);
  static constexpr int kCols = kSwB / 2;            // bf16 a slab row
  static constexpr int kNs = N / kCols;             // slabs of B, C, state
  static constexpr int kXs = kP / 64;               // slabs of x
  static constexpr uint32_t kBcSlab = kPiece * kSwB;
  static constexpr uint32_t kBcBytes = kNs * kBcSlab;
  static constexpr uint32_t kXSlab = kPiece * 128;
  static constexpr uint32_t kXBytes = kXs * kXSlab;
  static constexpr uint32_t kStSlab = kP * kSwB;
  static constexpr uint32_t kStBytes = kNs * kStSlab;
  static constexpr uint32_t kStage = 2 * kBcBytes + kXBytes;
  static constexpr uint32_t kFixed = 2 * kXBytes + 2 * kStBytes;
  static constexpr uint32_t kTail = 4 * (kPiece + 4) + 8 * 2 + 1024;
  static constexpr int kStages =
      2 * kStage + kFixed + kTail <= kSmemMax ? 2 : 1;
  static constexpr uint32_t kDx = kStages * kStage;   // dec x hi, then lo
  static constexpr uint32_t kSt = kDx + 2 * kXBytes;  // state hi, then lo
  static constexpr uint32_t kCs = kSt + 2 * kStBytes;
  static constexpr uint32_t kWsum = kCs + 4 * kPiece;
  static constexpr uint32_t kBars = kWsum + 16;
  static constexpr int kSmem = kBars + 8 * kStages + 1024;
};

// Fill stage `stage` with piece `piece` of C, B and x, each slab a TMA
// box, all completing the stage's mbarrier.
template <int N, int kP>
__device__ __forceinline__ void load_piece(const CUtensorMap* tx,
                                           const CUtensorMap* tb,
                                           const CUtensorMap* tc,
                                           uint32_t base, int stage,
                                           int piece, int h, int g, int b) {
  using L = Layout<N, kP>;
  const uint32_t sc = base + stage * L::kStage, sb = sc + L::kBcBytes,
                 sx = sb + L::kBcBytes, bar = base + L::kBars + 8 * stage;
  const int row = piece * kPiece;
  mbar_expect_tx(bar, L::kStage);
#pragma unroll
  for (int s = 0; s < L::kNs; ++s) {
    tma_load_4d(sc + s * L::kBcSlab, tc, bar, s * L::kCols, row, g, b);
    tma_load_4d(sb + s * L::kBcSlab, tb, bar, s * L::kCols, row, g, b);
  }
#pragma unroll
  for (int s = 0; s < L::kXs; ++s)
    tma_load_4d(sx + s * L::kXSlab, tx, bar, s * 64, row, h, b);
}

template <int N, int kP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tc, const Args a) {
  using L = Layout<N, kP>;
  constexpr int kSwB = L::kSwB;
  constexpr int kSlabSteps = L::kCols / 16;  // k16 steps over n a slab
  constexpr uint32_t kSbo = 8 * kSwB;        // from 8 rows to the next 8
  // state columns a warpgroup updates: n = 128 splits over both
  constexpr bool kSplitN = N == 128;
  constexpr int kNW = kSplitN ? 64 : N;
  static_assert(L::kSmem <= kSmemMax, "shared memory of one block");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_dx = base + L::kDx, s_st = base + L::kSt;
  float* cs = reinterpret_cast<float*>(smem_raw + (L::kCs + base
                                                   - smem_u32(smem_raw)));
  float* wsum = cs + kPiece;
  const uint32_t bars = base + L::kBars;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int g = h / a.heads_per_group;
  const int n_pieces = (a.S + kPiece - 1) / kPiece;

  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the state before the first piece: zero
  for (uint32_t o = 16 * tid; o < 2 * L::kStBytes; o += 16 * kThreads)
    sts128(s_st + o, make_uint4(0, 0, 0, 0));
  fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < L::kStages && i < n_pieces; ++i)
      load_piece<N, kP>(&tx, &tb, &tc, base, i, i, h, g, b);

  // this thread's rows of the piece, row0 and row0 + 8, and its columns
  // col0 and col0 + 1 of each 8 in an accumulator
  const int row0 = wg * kTile + warp * 16 + lane / 4;
  const int col0 = (lane % 4) * 2;
  float st[kP / 64][kNW / 2];
#pragma unroll
  for (int m = 0; m < kP / 64; ++m)
#pragma unroll
    for (int i = 0; i < kNW / 2; ++i) st[m][i] = 0.f;

  const float* lap = a.la + b * a.la_sb + h * a.la_sh;
  float la_next = tid < kPiece && tid < a.S ? lap[tid * a.la_ss] : 0.f;
  for (int it = 0; it < n_pieces; ++it) {
    const int stage = it % L::kStages;
    const uint32_t parity = (it / L::kStages) & 1;
    const int r0 = it * kPiece;
    const uint32_t sc = base + stage * L::kStage, sb = sc + L::kBcBytes,
                   sx = sb + L::kBcBytes;

    // cs: the inclusive sum of this piece's log decays, a scan per warp
    // of the first warpgroup; the next piece's loads go out now
    float v = la_next;
    if (tid < kPiece) {
      const int r = r0 + kPiece + tid;
      la_next = r < a.S ? lap[static_cast<long long>(r) * a.la_ss] : 0.f;
    }
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const float u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    if (tid < kPiece && lane == 31) wsum[tid / 32] = v;
    __syncthreads();
    // every thread is done with the stage of the last piece: refill it
    if (tid == 0 && it > 0 && it - 1 + L::kStages < n_pieces)
      load_piece<N, kP>(&tx, &tb, &tc, base, (it - 1) % L::kStages,
                        it - 1 + L::kStages, h, g, b);
    if (tid < kPiece) {
      for (int w = 0; w < tid / 32; ++w) v += wsum[w];
      cs[tid] = v;
    }
    mbar_wait(bars + 8 * stage, parity);
    __syncthreads();
    const float cs_end = cs[kPiece - 1];

    // dec x = exp(cs_end - cs_j) x_j as bf16 hi and lo, in x's layout
    for (uint32_t o = 16 * tid; o < L::kXBytes; o += 16 * kThreads) {
      const float dec = expf(cs_end - cs[(o % L::kXSlab) / 128]);
      const uint4 xv = lds128(sx + o);
      const uint32_t w[4] = {xv.x, xv.y, xv.z, xv.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        split_hi_lo(__uint_as_float(w[k] << 16) * dec,
                    __uint_as_float(w[k] & 0xffff0000u) * dec, hi[k], lo[k]);
      sts128(s_dx + o, make_uint4(hi[0], hi[1], hi[2], hi[3]));
      sts128(s_dx + L::kXBytes + o, make_uint4(lo[0], lo[1], lo[2], lo[3]));
    }
    fence_proxy_async();

    // Y = C state_hi^T + C state_lo^T, over n in k16 steps
    const uint32_t ca = sc + wg * kTile * kSwB;  // this warpgroup's rows
    float y[kP / 2];
#pragma unroll
    for (int i = 0; i < kP / 2; ++i) y[i] = 0.f;
    fence_regs(y);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk / kSlabSteps) * L::kBcSlab
                           + (kk % kSlabSteps) * 32;
      const uint32_t soff = (kk / kSlabSteps) * L::kStSlab
                            + (kk % kSlabSteps) * 32;
      const uint64_t da = make_desc<kSwB>(ca + off, 16, kSbo);
      wgmma_ss<0, 0>(y, da, make_desc<kSwB>(s_st + soff, 16, kSbo), 1);
      wgmma_ss<0, 0>(y, da,
                     make_desc<kSwB>(s_st + L::kStBytes + soff, 16, kSbo), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(y);
    const float cs_r[2] = {cs[row0], cs[row0 + 8]};
    const float e_r[2] = {expf(cs_r[0]), expf(cs_r[1])};
#pragma unroll
    for (int i = 0; i < kP / 2; ++i) y[i] *= e_r[(i % 4) / 2];

    // Y += M_hi x_t + M_lo x_t over the tiles t on or below the diagonal
    for (int t = 0; t <= wg; ++t) {
      // S = C B_t^T: element 4j + e is row row0 + 8 (e / 2), column
      // 64 t + 8 j + col0 + e % 2
      float s[kTile / 2];
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t off = (kk / kSlabSteps) * L::kBcSlab
                             + (kk % kSlabSteps) * 32;
        wgmma_ss<0, 0>(s, make_desc<kSwB>(ca + off, 16, kSbo),
                       make_desc<kSwB>(sb + t * kTile * kSwB + off, 16, kSbo),
                       kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      // M = S o exp(cs_i - cs_j) where j <= i, else 0, as the A operand of
      // k16 step kk: register r holds elements 8 kk + 2 r and + 1, of row
      // half r % 2
      uint32_t mh[kTile / 16][4], ml[kTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const int row = row0 + 8 * (r % 2);
          const int j = t * kTile + 8 * (i / 4) + col0;
          const float m0 = j <= row ? s[i] * expf(cs_r[r % 2] - cs[j]) : 0.f;
          const float m1 =
              j + 1 <= row ? s[i + 1] * expf(cs_r[r % 2] - cs[j + 1]) : 0.f;
          split_hi_lo(m0, m1, mh[kk][r], ml[kk][r]);
        }
      fence_regs(y);
      fence_regs(mh);
      fence_regs(ml);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint64_t db = make_desc<128>(
            sx + (t * kTile + kk * 16) * 128, L::kXSlab, 1024);
        wgmma_rs(y, mh[kk], db);
        wgmma_rs(y, ml[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(y);
      fence_regs(mh);
      fence_regs(ml);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + row0 + 8 * r;
      if (row >= a.S) continue;
      __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(a.y) + b * a.y_sb
                          + row * a.y_ss + h * a.y_sh;
#pragma unroll
      for (int j = 0; j < kP / 8; ++j)
        if (8 * j + col0 < a.p)
          *reinterpret_cast<__nv_bfloat162*>(yp + 8 * j + col0) =
              __floats2bfloat162_rn(y[4 * j + 2 * r], y[4 * j + 2 * r + 1]);
    }

    // every thread has written its dec x and read the state's bf16 copy
    __syncthreads();
    if (kSplitN || wg == 0) {
      // state = exp(cs_end) state + (dec x)_hi^T B + (dec x)_lo^T B, rows
      // p in tiles of 64 (A MN-major from dec x), this warpgroup's
      // columns n (B MN-major), k16 steps over the piece's rows
      const float ed = expf(cs_end);
#pragma unroll
      for (int m = 0; m < kP / 64; ++m)
#pragma unroll
        for (int i = 0; i < kNW / 2; ++i) st[m][i] *= ed;
      const uint32_t bn = sb + (kSplitN ? wg * L::kBcSlab : 0);
      fence_regs(st);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < kP / 64; ++m)
#pragma unroll
        for (int kk = 0; kk < kPiece / 16; ++kk) {
          const uint32_t xo = m * L::kXSlab + kk * 16 * 128;
          const uint64_t db = make_desc<kSwB>(bn + kk * 16 * kSwB,
                                              L::kBcSlab, kSbo);
          wgmma_ss<1, 1>(st[m], make_desc<128>(s_dx + xo, L::kXSlab, 1024),
                         db, 1);
          wgmma_ss<1, 1>(st[m],
                         make_desc<128>(s_dx + L::kXBytes + xo, L::kXSlab,
                                        1024),
                         db, 1);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      // the new state as bf16 hi and lo, K-major (rows p, columns n) in
      // the swizzle of C's tiles, for the next piece's C state^T
#pragma unroll
      for (int m = 0; m < kP / 64; ++m)
#pragma unroll
        for (int i = 0; i < kNW / 2; i += 2) {
          const int prow = m * 64 + warp * 16 + lane / 4 + 8 * ((i % 4) / 2);
          const int ncol = (kSplitN ? wg * 64 : 0) + 8 * (i / 4) + col0;
          const uint32_t off =
              (ncol / L::kCols) * L::kStSlab
              + swizzle<kSwB>(prow * kSwB + (ncol % L::kCols) * 2);
          uint32_t hi, lo;
          split_hi_lo(st[m][i], st[m][i + 1], hi, lo);
          sts32(s_st + off, hi);
          sts32(s_st + L::kStBytes + off, lo);
        }
      fence_proxy_async();
    }
  }
}

struct Strides {
  long long x_sb, x_ss, x_sh, B_sb, B_ss, B_sg, C_sb, C_ss, C_sg;
};

template <int N, int kP>
int launch(const void* x, const void* B, const void* C, int b, int g,
           const Args& a, const Strides& st, cudaStream_t stream) {
  using L = Layout<N, kP>;
  CUtensorMap tx, tb, tc;
  int rc = encode(&tx, x, b, a.S, a.H, a.p, st.x_sb, st.x_ss, st.x_sh, 64,
                  kPiece, 128);
  if (rc == 0)
    rc = encode(&tb, B, b, a.S, g, N, st.B_sb, st.B_ss, st.B_sg, L::kCols,
                kPiece, L::kSwB);
  if (rc == 0)
    rc = encode(&tc, C, b, a.S, g, N, st.C_sb, st.C_ss, st.C_sg, L::kCols,
                kPiece, L::kSwB);
  if (rc != 0) return rc;
  auto kernel = ssd_fwd_sm90_kernel<N, kP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<b * a.H, kThreads, L::kSmem, stream>>>(tx, tb, tc, a);
  return (int)cudaGetLastError();
}

template <int kP>
int dispatch_state(int n, const void* x, const void* B, const void* C,
                   int b, int g, const Args& a, const Strides& st,
                   cudaStream_t s) {
  switch (n) {
    case 16: return launch<16, kP>(x, B, C, b, g, a, st, s);
    case 32: return launch<32, kP>(x, B, C, b, g, a, st, s);
    case 64: return launch<64, kP>(x, B, C, b, g, a, st, s);
    case 128: return launch<128, kP>(x, B, C, b, g, a, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (b,s,h,p), B and C (b,s,g,n), y (b,s,h,p), all bf16; la (b,s,h)
// fp32. Strides in elements; the last dim of x, B, C and y is
// contiguous. p is a multiple of 8 up to 128, n one of 16, 32, 64, 128,
// and g divides h. The base addresses of x, B and C are 16-byte aligned
// and their strides multiples of 8.
extern "C" int ssd_fwd_sm90(
    const void* x, const float* la, const void* B, const void* C, void* y,
    int b, int s, int h, int p, int g, int n,
    long long x_sb, long long x_ss, long long x_sh,
    long long la_sb, long long la_ss, long long la_sh,
    long long B_sb, long long B_ss, long long B_sg,
    long long C_sb, long long C_ss, long long C_sg,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  if (b < 1 || s < 1 || g < 1 || h % g != 0 || p < 8 || p > 128 || p % 8)
    return (int)cudaErrorInvalidValue;
  const Args a{y, la, s, h, h / g, p, la_sb, la_ss, la_sh, y_sb, y_ss, y_sh};
  const Strides st{x_sb, x_ss, x_sh, B_sb, B_ss, B_sg, C_sb, C_ss, C_sg};
  const cudaStream_t stream_ = (cudaStream_t)stream;
  return p <= 64 ? dispatch_state<64>(n, x, B, C, b, g, a, st, stream_)
                 : dispatch_state<128>(n, x, B, C, b, g, a, st, stream_);
}

extern "C" const char* ssd_fwd_sm90_error_string(int err) {
  if (err >= kTmaError)
    return "cuTensorMapEncodeTiled refused a tensor map of x, B or C "
           "(the code less 1000 is the CUresult)";
  return cudaGetErrorString((cudaError_t)err);
}
