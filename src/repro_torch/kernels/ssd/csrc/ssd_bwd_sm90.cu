// Mamba2 SSD chunked scan, backward, on Hopper's tensor cores (sm_90a): the
// bf16 route.
//
// Replaces no kernel of the JAX package: its gradient of the scan is
// jax.vjp of models/ssm.py::ssd_reference (its Pallas kernel
// kernels/ssd/kernel.py::ssd_bh has no backward), which the port's plain
// backward (ops.py, an autograd recompute of ref.py::ssd_reference in fp32)
// still takes for fp32, for other bf16 head dims and on the CPU. This
// kernel takes exactly the calls whose forward ran ssd_fwd_sm90.cu.
//
// Function. For each (batch, head), with y_i = sum_{j<=i} (C_i . B_j)
// exp(A_i - A_j) x_j (A the cumulative log decay), and gy given: dx, dB and
// dC per head, summed over the heads of a group for dB and dC, and
// dlog_a. Cut into pieces of 128 rows, with cs the inclusive cumulative
// sum of the log decay inside a piece, dS the gradient of the state after
// the piece and S the state before it:
//   dx_j = sum_{i>=j} M_ij gy_i + dec_j B_j dS^T,    M_ij = (C_i.B_j) E_ij
//   dB_j = sum_{i>=j} P_ij C_i + dec_j x_j dS,       P_ij = (gy_i.x_j) E_ij
//   dC_i = sum_{j<=i} P_ij B_j + e_i gy_i S
//   dS  <- exp(cs_end) dS + sum_i e_i gy_i C_i^T     (the state before it)
// with E_ij = exp(cs_i - cs_j) (j <= i), e_i = exp(cs_i), dec_j =
// exp(cs_end - cs_j). The gradient of cs_k is the row sum of T = M o
// (gy x^T) off the diagonal at row k less its column sum at k, plus C_k .
// (e_k gy_k S) less B_k . (dec_k x_k dS), plus <dS, S_next> at the last
// row (S_next the state after the piece); dlog_a is its reverse cumulative
// sum inside the piece. Rows past S come in as TMA's zero fill with zero
// log decay and add nothing.
//
// Bound. mamba2-1.3b's layer (b=2, s=2048, 64 heads x 64, one group of
// 128): x, gy and dx in bf16, the fp32 log decay and its gradient, B, C,
// dB and dC move 107 MB, 0.0319 ms at 3.35 TB/s; twice the forward's 15.1
// GFLOP at 128-row pieces, 30.2 GFLOP, take 0.0305 ms at 989 TFLOP/s. So
// the bytes bound it, just. The kernel moves more: the states of the
// forward sweep (67 MB written and read) and per-head fp32 partials of dB
// and dC (268 MB written and read by the reduce), and it does about 81
// GFLOP of tensor work (the hi + lo splits double seven products, the
// four score products are computed in both orientations, and the 64 x 64
// tiles on the diagonal are computed whole).
//
// Precision. x, gy, B and C are bf16, so the score products C B^T and
// gy x^T are exact in bf16. Seven operands are fp32 intermediates: M (for
// dx), P in both orientations (for dB and dC), the state S (for dC) and
// its gradient dS (for dx and dB), e o gy (for dS) and dec o x (for the
// forward sweep's states). Each enters its product as bf16 hi + lo, two
// wgmmas into one fp32 accumulator, as in ssd_fwd_sm90.cu; dropping any
// one split puts gradients many bf16 roundings from the fp32 function
// (tests/test_torch_kernels.py emulates every split and each one
// dropped). The states and dS are carried in fp32. dx, dB and dC are
// rounded to bf16 once; dB and dC are summed over a group's heads in
// fp32 in a fixed order first; dlog_a stays fp32.
//
// Design.
// - One block per (batch, head, 64 columns of p): 256 threads in two
//   warpgroups, warpgroup w owning rows 64w .. 64w + 63 of a piece (the M
//   = 64 of its wgmmas). Every gradient is linear in the columns of p
//   (the score gy x^T is a sum over them), so p = 128 runs as two blocks
//   whose dlog_a partials meet in fp32 atomics (two terms added to zero:
//   the same sum in either order) and whose dB and dC partials meet in
//   the reduce. mamba2's shape gives 128 blocks for 132 SMs.
// - A forward sweep over the pieces recomputes each piece's entry state
//   as ssd_fwd_sm90.cu does (scale by exp(cs_end), add (dec x)^T B on
//   wgmma) and writes it, fp32, to a scratch of (blocks, pieces, 64, n)
//   that the wrapper allocates; the forward kernel saves nothing. The
//   reverse sweep then reads them back (the same block, so no other sync)
//   and carries dS in registers, as the forward carries the state: with
//   n = 128 each warpgroup owns 64 of its columns, otherwise the first
//   owns all. Each piece runs four phases:
//   1. dx: B dS^T (dS hi and lo K-major in shared memory), scaled by dec;
//      then per 64-row tile t >= w of i, S^T = B_w C_t^T and G^T = x_w
//      gy_t^T (m64n64, K-major), M^T = S^T o E^T as the register A
//      operand (hi, lo) against gy MN-major; T's column sums.
//   2. dB: x dS (dS MN-major), scaled by dec, its dot with B; then P^T =
//      G^T o E^T against C MN-major. Written as a per-head fp32 partial.
//   3. dC: gy S (S hi and lo MN-major), scaled by e, its dot with C; then
//      per tile t <= w, S = C_w B_t^T, G = gy_w x_t^T, T's row sums, P = G
//      o E against B MN-major. A per-head fp32 partial.
//   4. dcs to dlog_a (a reverse warp scan); dS <- exp(cs_end) dS + (e
//      gy)^T C with e gy hi and lo written in gy's swizzled layout (read
//      MN-major) and C MN-major; dS back to shared memory as hi and lo.
//   <dS, S_next> is read from the scratch in dS's register layout.
// - ssd_bwd_reduce_kernel sums the partials of a group's heads (and
//   column halves) in order and rounds dB and dC once to bf16.
// - x, gy (64 columns of p; TMA's zero fill past p), B and C of a piece
//   come through 4-D tensor maps over their strides into one stage (at n
//   = 128 the four tiles, dS, S and e gy hi and lo fill 194 KB), in the
//   swizzles and with the helpers of ../../sm90.cuh. The log decay is read
//   with plain loads and summed by a warp scan.
// - Every mbarrier wait traps after about 9 s, so a fault fails instead
//   of hanging. The wrapper hands over 16-byte-aligned bases and strides
//   that are multiples of 16 bytes, as TMA requires, or copies.
#include "../../sm90.cuh"

namespace {

constexpr int kPiece = 128;              // rows a piece
constexpr int kTile = 64;                // rows of a warpgroup
constexpr int kP = 64;                   // columns of p a block
constexpr int kThreads = 256;            // two warpgroups
constexpr int kSmemMax = 232448;         // shared memory of one block
constexpr uint32_t kXSlab = kPiece * 128;  // a piece of x or gy, 64 columns

struct Args {
  const float* la;
  void* dx;
  float* dla;
  float* states;                         // (blocks, pieces, 64, n) fp32
  float* pdB;                            // (b, S, heads * halves, n) fp32
  float* pdC;
  int S, H, heads_per_group, p, halves;
  long long la_sb, la_ss, la_sh;         // strides in elements
  long long dx_sb, dx_ss, dx_sh;
  long long dl_sb, dl_ss, dl_sh;
};

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

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void sts64(uint32_t addr, uint32_t a, uint32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n"
               :: "r"(addr), "r"(a), "r"(b) : "memory");
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// Where TMA's swizzle for rows of kSwB bytes puts the byte at plain
// row-major offset `off` of a slab (as in ssd_fwd_sm90.cu)
template <int kSwB>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (kSwB / 16 - 1)) << 4);
}

// The two bf16 of a packed pair as floats
__device__ __forceinline__ float2 bf16x2_float2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// Shared memory, from a 1024-byte-aligned base: the piece's x, gy, C and
// B (kNs slabs of 128 rows each for C and B); dS and the state S, each hi
// then lo (kNs slabs of 64 rows); e gy (or, in the forward sweep, dec x)
// hi then lo in x's layout; the cumulative log decay, dcs, warp sums, the
// end term's warp sums, one mbarrier.
template <int N>
struct Layout {
  static constexpr int kSwB = N == 16 ? 32 : (N == 32 ? 64 : 128);
  static constexpr int kCols = kSwB / 2;            // bf16 a slab row
  static constexpr int kNs = N / kCols;             // slabs of B, C, dS
  static constexpr uint32_t kBcSlab = kPiece * kSwB;
  static constexpr uint32_t kBcBytes = kNs * kBcSlab;
  static constexpr uint32_t kStSlab = kP * kSwB;
  static constexpr uint32_t kStBytes = kNs * kStSlab;
  static constexpr uint32_t kX = 0;
  static constexpr uint32_t kG = kX + kXSlab;
  static constexpr uint32_t kC = kG + kXSlab;
  static constexpr uint32_t kB = kC + kBcBytes;
  static constexpr uint32_t kDs = kB + kBcBytes;
  static constexpr uint32_t kSp = kDs + 2 * kStBytes;
  static constexpr uint32_t kEg = kSp + 2 * kStBytes;
  static constexpr uint32_t kCs = kEg + 2 * kXSlab;
  static constexpr uint32_t kDcs = kCs + 4 * kPiece;
  static constexpr uint32_t kWsum = kDcs + 4 * kPiece;
  static constexpr uint32_t kRed = kWsum + 4 * 8;
  static constexpr uint32_t kBar = kRed + 4 * 8;
  static constexpr int kSmem = kBar + 8 + 1024;
};

// The inclusive sum of piece `r0`'s log decays into cs (rows past S: 0),
// a scan per warp of the first warpgroup; ends on a __syncthreads after
// which cs is complete.
__device__ __forceinline__ void piece_cs(const float* lap, long long la_ss,
                                         int S, int r0, float* cs,
                                         float* wsum, int tid, int lane) {
  float v = 0.f;
  if (tid < kPiece && r0 + tid < S)
    v = lap[static_cast<long long>(r0 + tid) * la_ss];
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const float u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (tid < kPiece && lane == 31) wsum[tid / 32] = v;
  __syncthreads();
  if (tid < kPiece) {
    for (int w = 0; w < tid / 32; ++w) v += wsum[w];
    cs[tid] = v;
  }
  __syncthreads();
}

// 64 rows of `rows` (a 128-byte-row slab) times 64 rows of `cols`, over
// K = 64 (k16 steps of 32 bytes): both K-major, as x gy^T or gy x^T
__device__ __forceinline__ void score64(float (&d)[32], uint32_t rows,
                                        uint32_t cols) {
#pragma unroll
  for (int kk = 0; kk < kP / 16; ++kk)
    wgmma_ss<0, 0>(d, make_desc<128>(rows + kk * 32, 16, 1024),
                   make_desc<128>(cols + kk * 32, 16, 1024), kk > 0);
}

// The same over K = n, in the slabs of B and C: C B^T or B C^T
template <int N>
__device__ __forceinline__ void score_n(float (&d)[32], uint32_t rows,
                                        uint32_t cols) {
  using L = Layout<N>;
  constexpr int kSlabSteps = L::kCols / 16;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t off = (kk / kSlabSteps) * L::kBcSlab
                         + (kk % kSlabSteps) * 32;
    wgmma_ss<0, 0>(d, make_desc<L::kSwB>(rows + off, 16, 8 * L::kSwB),
                   make_desc<L::kSwB>(cols + off, 16, 8 * L::kSwB), kk > 0);
  }
}

// acc (64 rows x N) = A (64 rows of a 128-byte-row slab, K-major, K = 64)
// times a (64 x N) fp32 matrix held as hi and lo in shared memory at
// `hl` (rows K, columns N: MN-major), as x dS or gy S
template <int N>
__device__ __forceinline__ void times_state(float (&d)[N / 2], uint32_t a,
                                            uint32_t hl) {
  using L = Layout<N>;
#pragma unroll
  for (int kk = 0; kk < kP / 16; ++kk) {
    const uint64_t da = make_desc<128>(a + kk * 32, 16, 1024);
    const uint32_t o = kk * 16 * L::kSwB;
    wgmma_ss<0, 1>(d, da, make_desc<L::kSwB>(hl + o, L::kStSlab,
                                             8 * L::kSwB), 1);
    wgmma_ss<0, 1>(d, da, make_desc<L::kSwB>(hl + L::kStBytes + o,
                                             L::kStSlab, 8 * L::kSwB), 1);
  }
}

// The row dot of a 64 x N accumulator with rows of B or C in shared
// memory: this thread's share of rows `rl` (two), its columns only
template <int N>
__device__ __forceinline__ void row_dot(const float (&d)[N / 2],
                                        uint32_t tile, const int (&rl)[2],
                                        int col0, float (&out)[2]) {
  using L = Layout<N>;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int c = 8 * jj + col0;
      const float2 v = bf16x2_float2(lds32(
          tile + (c / L::kCols) * L::kBcSlab
          + swizzle<L::kSwB>(rl[r] * L::kSwB + (c % L::kCols) * 2)));
      out[r] += v.x * d[4 * jj + 2 * r] + v.y * d[4 * jj + 2 * r + 1];
    }
}

// Write rows of an accumulator (64 x N, fp32) to a per-head partial
template <int N>
__device__ __forceinline__ void store_partial(const float (&d)[N / 2],
                                              float* base, long long row_st,
                                              int r0, const int (&rl)[2],
                                              int col0, int S) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + rl[r];
    if (row >= S) continue;
    float* q = base + row * row_st;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
      *reinterpret_cast<float2*>(q + 8 * jj + col0) =
          make_float2(d[4 * jj + 2 * r], d[4 * jj + 2 * r + 1]);
  }
}

// A piece's rows of v (x or gy, 128 x 64 bf16, swizzled) scaled by w(row)
// as bf16 hi and lo in the same layout at dst and dst + kXSlab
template <typename W>
__device__ __forceinline__ void scaled_hi_lo(uint32_t src, uint32_t dst,
                                             int tid, W w) {
  for (uint32_t o = 16 * tid; o < kXSlab; o += 16 * kThreads) {
    const float s = w(o / 128);
    const uint4 xv = lds128(src + o);
    const uint32_t x4[4] = {xv.x, xv.y, xv.z, xv.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = bf16x2_float2(x4[k]);
      split_hi_lo(f.x * s, f.y * s, hi[k], lo[k]);
    }
    sts128(dst + o, make_uint4(hi[0], hi[1], hi[2], hi[3]));
    sts128(dst + kXSlab + o, make_uint4(lo[0], lo[1], lo[2], lo[3]));
  }
}

// st (this warpgroup's rows p, columns n of a state) += (w v)^T U over the
// piece's 128 rows: A from the hi and lo at `hl` (x's layout, MN-major),
// U's columns from `u` (MN-major)
template <int N, int kNW>
__device__ __forceinline__ void state_update(float (&st)[kNW / 2],
                                             uint32_t hl, uint32_t u) {
  using L = Layout<N>;
  fence_regs(st);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kPiece / 16; ++kk) {
    const uint64_t db = make_desc<L::kSwB>(u + kk * 16 * L::kSwB, L::kBcSlab,
                                           8 * L::kSwB);
    const uint32_t o = kk * 16 * 128;
    wgmma_ss<1, 1>(st, make_desc<128>(hl + o, kXSlab, 1024), db, 1);
    wgmma_ss<1, 1>(st, make_desc<128>(hl + kXSlab + o, kXSlab, 1024), db, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(st);
}

template <int N>
__device__ __forceinline__ void load_tiles(const CUtensorMap* tx,
                                           const CUtensorMap* tg,
                                           const CUtensorMap* tb,
                                           const CUtensorMap* tc,
                                           uint32_t base, int row, int col,
                                           int h, int g, int b,
                                           bool backward) {
  using L = Layout<N>;
  const uint32_t bar = base + L::kBar;
  mbar_expect_tx(bar, backward ? 2 * (kXSlab + L::kBcBytes)
                               : kXSlab + L::kBcBytes);
  tma_load_4d(base + L::kX, tx, bar, col, row, h, b);
#pragma unroll
  for (int s = 0; s < L::kNs; ++s)
    tma_load_4d(base + L::kB + s * L::kBcSlab, tb, bar, s * L::kCols, row, g,
                b);
  if (backward) {
    tma_load_4d(base + L::kG, tg, bar, col, row, h, b);
#pragma unroll
    for (int s = 0; s < L::kNs; ++s)
      tma_load_4d(base + L::kC + s * L::kBcSlab, tc, bar, s * L::kCols, row,
                  g, b);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tg,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tc, const Args a) {
  using L = Layout<N>;
  constexpr int kSwB = L::kSwB;
  constexpr uint32_t kSbo = 8 * kSwB;
  // dS columns a warpgroup owns: n = 128 splits over both
  constexpr bool kSplitN = N == 128;
  constexpr int kNW = kSplitN ? 64 : N;
  static_assert(L::kSmem <= kSmemMax, "shared memory of one block");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sx = base + L::kX, sg = base + L::kG, sc = base + L::kC,
                 sb = base + L::kB, s_ds = base + L::kDs,
                 s_sp = base + L::kSp, s_eg = base + L::kEg,
                 bar = base + L::kBar;
  float* cs = reinterpret_cast<float*>(gbase + L::kCs);
  float* dcs = reinterpret_cast<float*>(gbase + L::kDcs);
  float* wsum = reinterpret_cast<float*>(gbase + L::kWsum);
  float* red = reinterpret_cast<float*>(gbase + L::kRed);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int blk = blockIdx.x;
  const int half = blk % a.halves, bh = blk / a.halves;
  const int b = bh / a.H, h = bh % a.H;
  const int g = h / a.heads_per_group;
  const int col = kP * half;
  const int n_pieces = (a.S + kPiece - 1) / kPiece;
  const bool owner = kSplitN || wg == 0;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // dS after the last piece: zero
  for (uint32_t o = 16 * tid; o < 2 * L::kStBytes; o += 16 * kThreads)
    sts128(s_ds + o, make_uint4(0, 0, 0, 0));
  fence_proxy_async();
  __syncthreads();

  // this thread's rows of a piece and its columns of an accumulator, as
  // in ssd_fwd_sm90.cu; its state rows and columns
  const int row0 = warp * 16 + lane / 4;
  const int col0 = (lane % 4) * 2;
  const int rl[2] = {wg * kTile + row0, wg * kTile + row0 + 8};
  const int nbase = kSplitN ? wg * 64 : 0;
  const float* lap = a.la + b * a.la_sb + h * a.la_sh;
  float* states = a.states + static_cast<long long>(blk) * n_pieces * kP * N;
  uint32_t phase = 0;

  float st[kNW / 2];
#pragma unroll
  for (int i = 0; i < kNW / 2; ++i) st[i] = 0.f;

  // forward sweep: each piece's entry state to the scratch (the state
  // after the last piece is not needed)
  for (int it = 0; it < n_pieces; ++it) {
    if (owner) {
      float* sp = states + static_cast<long long>(it) * kP * N;
#pragma unroll
      for (int i = 0; i < kNW / 2; i += 2)
        *reinterpret_cast<float2*>(
            sp + (row0 + 8 * ((i % 4) / 2)) * N + nbase + 8 * (i / 4)
            + col0) = make_float2(st[i], st[i + 1]);
    }
    if (it + 1 == n_pieces) break;
    const int r0 = it * kPiece;
    if (tid == 0)
      load_tiles<N>(&tx, &tg, &tb, &tc, base, r0, col, h, g, b, false);
    piece_cs(lap, a.la_ss, a.S, r0, cs, wsum, tid, lane);
    mbar_wait(bar, phase & 1);
    ++phase;
    const float cs_end = cs[kPiece - 1];
    scaled_hi_lo(sx, s_eg, tid, [&](int r) { return expf(cs_end - cs[r]); });
    fence_proxy_async();
    __syncthreads();
    if (owner) {
      const float ed = expf(cs_end);
#pragma unroll
      for (int i = 0; i < kNW / 2; ++i) st[i] *= ed;
      state_update<N, kNW>(st, s_eg, sb + (kSplitN ? wg * L::kBcSlab : 0));
    }
    __syncthreads();
  }

  // reverse sweep
#pragma unroll
  for (int i = 0; i < kNW / 2; ++i) st[i] = 0.f;
  const long long hh = static_cast<long long>(h) * a.halves + half;
  const long long part_row = static_cast<long long>(a.H) * a.halves * N;
  float* pdB = a.pdB + (static_cast<long long>(b) * a.S * a.H * a.halves
                        + hh) * N;
  float* pdC = a.pdC + (static_cast<long long>(b) * a.S * a.H * a.halves
                        + hh) * N;
  for (int it = n_pieces - 1; it >= 0; --it) {
    const int r0 = it * kPiece;
    if (tid == 0)
      load_tiles<N>(&tx, &tg, &tb, &tc, base, r0, col, h, g, b, true);
    piece_cs(lap, a.la_ss, a.S, r0, cs, wsum + 4, tid, lane);

    // S, the state before the piece, as hi and lo (rows p, columns n,
    // K-major in C's swizzle)
    const float* sp = states + static_cast<long long>(it) * kP * N;
    for (int i = 4 * tid; i < kP * N; i += 4 * kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(sp + i);
      const int prow = i / N, ncol = i % N;
      const uint32_t off = (ncol / L::kCols) * L::kStSlab
                           + swizzle<kSwB>(prow * kSwB
                                           + (ncol % L::kCols) * 2);
      uint32_t h0, l0, h1, l1;
      split_hi_lo(v.x, v.y, h0, l0);
      split_hi_lo(v.z, v.w, h1, l1);
      sts64(s_sp + off, h0, h1);
      sts64(s_sp + L::kStBytes + off, l0, l1);
    }
    fence_proxy_async();
    // <dS, S_next>, S_next the state after the piece (dS is 0 after the
    // last): this warp's share
    {
      float e = 0.f;
      if (owner && it + 1 < n_pieces) {
        const float* sn = states + static_cast<long long>(it + 1) * kP * N;
#pragma unroll
        for (int i = 0; i < kNW / 2; i += 2) {
          const float2 v = *reinterpret_cast<const float2*>(
              sn + (row0 + 8 * ((i % 4) / 2)) * N + nbase + 8 * (i / 4)
              + col0);
          e += st[i] * v.x + st[i + 1] * v.y;
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d /= 2) e += __shfl_xor_sync(0xffffffffu, e, d);
      if (lane == 0) red[tid / 32] = e;
    }
    mbar_wait(bar, phase & 1);
    ++phase;
    __syncthreads();

    const float cs_end = cs[kPiece - 1];
    const float cs_r[2] = {cs[rl[0]], cs[rl[1]]};
    const float dec_r[2] = {expf(cs_end - cs_r[0]), expf(cs_end - cs_r[1])};
    const float e_r[2] = {expf(cs_r[0]), expf(cs_r[1])};
    float dcs_r[2] = {0.f, 0.f};

    // 1. dx (rows j of this warpgroup) = dec o (B dS^T) + sum_t M^T gy_t
    {
      constexpr int kSlabSteps = L::kCols / 16;
      float acc[kP / 2];
#pragma unroll
      for (int i = 0; i < kP / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t off = (kk / kSlabSteps) * L::kBcSlab
                             + (kk % kSlabSteps) * 32;
        const uint32_t soff = (kk / kSlabSteps) * L::kStSlab
                              + (kk % kSlabSteps) * 32;
        const uint64_t da = make_desc<kSwB>(sb + wg * kTile * kSwB + off, 16,
                                            kSbo);
        wgmma_ss<0, 0>(acc, da, make_desc<kSwB>(s_ds + soff, 16, kSbo), 1);
        wgmma_ss<0, 0>(acc, da,
                       make_desc<kSwB>(s_ds + L::kStBytes + soff, 16, kSbo),
                       1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < kP / 2; ++i) acc[i] *= dec_r[(i % 4) / 2];

      for (int t = wg; t < 2; ++t) {
        float s[32], gt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = gt[i] = 0.f;
        fence_regs(s);
        fence_regs(gt);
        wgmma_fence();
        score_n<N>(s, sb + wg * kTile * kSwB, sc + t * kTile * kSwB);
        score64(gt, sx + wg * kTile * 128, sg + t * kTile * 128);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(gt);
        // M^T = S^T o exp(cs_i - cs_j) where i >= j: register r of k16
        // step kk holds elements 8 kk + 2 r and + 1, row rl[r % 2]
        uint32_t mh[kTile / 16][4], ml[kTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = 8 * kk + 2 * r, hr = r % 2, j = rl[hr];
            const int i = t * kTile + 8 * (e / 4) + col0;
            const float m0 = i >= j ? s[e] * expf(cs[i] - cs_r[hr]) : 0.f;
            const float m1 =
                i + 1 >= j ? s[e + 1] * expf(cs[i + 1] - cs_r[hr]) : 0.f;
            if (i > j) dcs_r[hr] -= m0 * gt[e];
            if (i + 1 > j) dcs_r[hr] -= m1 * gt[e + 1];
            split_hi_lo(m0, m1, mh[kk][r], ml[kk][r]);
          }
        fence_regs(acc);
        fence_regs(mh);
        fence_regs(ml);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint64_t db = make_desc<128>(sg + (t * kTile + kk * 16) * 128,
                                             kXSlab, 1024);
          wgmma_rs(acc, mh[kk], db);
          wgmma_rs(acc, ml[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(mh);
        fence_regs(ml);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + rl[r];
        if (row >= a.S) continue;
        __nv_bfloat16* q = static_cast<__nv_bfloat16*>(a.dx) + b * a.dx_sb
                           + row * a.dx_ss + h * a.dx_sh + col;
#pragma unroll
        for (int jj = 0; jj < kP / 8; ++jj)
          if (col + 8 * jj + col0 < a.p)
            *reinterpret_cast<__nv_bfloat162*>(q + 8 * jj + col0) =
                __floats2bfloat162_rn(acc[4 * jj + 2 * r],
                                      acc[4 * jj + 2 * r + 1]);
      }
    }

    // 2. dB (rows j) = dec o (x dS) + sum_t P^T C_t, a per-head partial
    {
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      wgmma_fence();
      times_state<N>(acc, sx + wg * kTile * 128, s_ds);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] *= dec_r[(i % 4) / 2];
      float off[2] = {0.f, 0.f};
      row_dot<N>(acc, sb, rl, col0, off);
      dcs_r[0] -= off[0];
      dcs_r[1] -= off[1];

      for (int t = wg; t < 2; ++t) {
        float gt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) gt[i] = 0.f;
        fence_regs(gt);
        wgmma_fence();
        score64(gt, sx + wg * kTile * 128, sg + t * kTile * 128);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(gt);
        uint32_t ph[kTile / 16][4], pl[kTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = 8 * kk + 2 * r, hr = r % 2, j = rl[hr];
            const int i = t * kTile + 8 * (e / 4) + col0;
            const float p0 = i >= j ? gt[e] * expf(cs[i] - cs_r[hr]) : 0.f;
            const float p1 =
                i + 1 >= j ? gt[e + 1] * expf(cs[i + 1] - cs_r[hr]) : 0.f;
            split_hi_lo(p0, p1, ph[kk][r], pl[kk][r]);
          }
        fence_regs(acc);
        fence_regs(ph);
        fence_regs(pl);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint64_t db = make_desc<kSwB>(
              sc + (t * kTile + kk * 16) * kSwB, L::kBcSlab, kSbo);
          wgmma_rs(acc, ph[kk], db);
          wgmma_rs(acc, pl[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(ph);
        fence_regs(pl);
      }
      store_partial<N>(acc, pdB, part_row, r0, rl, col0, a.S);
    }

    // 3. dC (rows i) = e o (gy S) + sum_t P B_t, a per-head partial
    {
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      wgmma_fence();
      times_state<N>(acc, sg + wg * kTile * 128, s_sp);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] *= e_r[(i % 4) / 2];
      float off[2] = {0.f, 0.f};
      row_dot<N>(acc, sc, rl, col0, off);
      dcs_r[0] += off[0];
      dcs_r[1] += off[1];

      for (int t = 0; t <= wg; ++t) {
        float s[32], gg[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = gg[i] = 0.f;
        fence_regs(s);
        fence_regs(gg);
        wgmma_fence();
        score_n<N>(s, sc + wg * kTile * kSwB, sb + t * kTile * kSwB);
        score64(gg, sg + wg * kTile * 128, sx + t * kTile * 128);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(gg);
        uint32_t ph[kTile / 16][4], pl[kTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = 8 * kk + 2 * r, hr = r % 2, i = rl[hr];
            const int j = t * kTile + 8 * (e / 4) + col0;
            const float p0 = j <= i ? gg[e] * expf(cs_r[hr] - cs[j]) : 0.f;
            const float p1 =
                j + 1 <= i ? gg[e + 1] * expf(cs_r[hr] - cs[j + 1]) : 0.f;
            if (j < i) dcs_r[hr] += p0 * s[e];
            if (j + 1 < i) dcs_r[hr] += p1 * s[e + 1];
            split_hi_lo(p0, p1, ph[kk][r], pl[kk][r]);
          }
        fence_regs(acc);
        fence_regs(ph);
        fence_regs(pl);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint64_t db = make_desc<kSwB>(
              sb + (t * kTile + kk * 16) * kSwB, L::kBcSlab, kSbo);
          wgmma_rs(acc, ph[kk], db);
          wgmma_rs(acc, pl[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(ph);
        fence_regs(pl);
      }
      store_partial<N>(acc, pdC, part_row, r0, rl, col0, a.S);
    }

    // 4. dcs of each row (a quad holds a row), the end term at the last
    // row; e gy as hi and lo for the dS update
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = dcs_r[r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (lane % 4 == 0) {
        if (rl[r] == kPiece - 1)
          for (int w = 0; w < 8; ++w) v += red[w];
        dcs[rl[r]] = v;
      }
    }
    scaled_hi_lo(sg, s_eg, tid, [&](int r) { return expf(cs[r]); });
    fence_proxy_async();
    __syncthreads();
    // dlog_a_t = sum of dcs over the piece's rows from t on: a scan of
    // the reversed rows
    {
      float v = tid < kPiece ? dcs[kPiece - 1 - tid] : 0.f;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
      }
      if (tid < kPiece && lane == 31) wsum[tid / 32] = v;
      __syncthreads();
      const int row = r0 + kPiece - 1 - tid;
      if (tid < kPiece && row < a.S) {
        for (int w = 0; w < tid / 32; ++w) v += wsum[w];
        atomicAdd(a.dla + b * a.dl_sb + row * a.dl_ss + h * a.dl_sh, v);
      }
    }
    // dS <- exp(cs_end) dS + (e gy)^T C, then to shared memory as hi and
    // lo for the next piece's products
    if (owner) {
      const float ed = expf(cs_end);
#pragma unroll
      for (int i = 0; i < kNW / 2; ++i) st[i] *= ed;
      state_update<N, kNW>(st, s_eg, sc + (kSplitN ? wg * L::kBcSlab : 0));
#pragma unroll
      for (int i = 0; i < kNW / 2; i += 2) {
        const int prow = warp * 16 + lane / 4 + 8 * ((i % 4) / 2);
        const int ncol = nbase + 8 * (i / 4) + col0;
        const uint32_t off = (ncol / L::kCols) * L::kStSlab
                             + swizzle<kSwB>(prow * kSwB
                                             + (ncol % L::kCols) * 2);
        uint32_t hi, lo;
        split_hi_lo(st[i], st[i + 1], hi, lo);
        sts32(s_ds + off, hi);
        sts32(s_ds + L::kStBytes + off, lo);
      }
      fence_proxy_async();
    }
    __syncthreads();
  }
}

// dB and dC (rows x groups x n, bf16) = the per-head fp32 partials (rows x
// groups * per x n) of each group's `per` heads (and column halves) summed
// in order, rounded once; a thread takes 4 columns of both
__global__ void ssd_bwd_reduce_kernel(const float* pdB, const float* pdC,
                                      __nv_bfloat16* dB, __nv_bfloat16* dC,
                                      long long rows, int G, int per, int N) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  const int q = N / 4;
  if (idx >= rows * G * q) return;
  const long long rg = idx / q;
  const int c = 4 * static_cast<int>(idx % q);
  const long long src = rg * per * N + c;   // (row, g, head 0 of g, c)
  float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
  for (int k = 0; k < per; ++k) {
    const float4 vb = *reinterpret_cast<const float4*>(pdB + src + k * N);
    const float4 vc = *reinterpret_cast<const float4*>(pdC + src + k * N);
    sb.x += vb.x; sb.y += vb.y; sb.z += vb.z; sb.w += vb.w;
    sc.x += vc.x; sc.y += vc.y; sc.z += vc.z; sc.w += vc.w;
  }
  __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(dB + rg * N + c);
  __nv_bfloat162* oc = reinterpret_cast<__nv_bfloat162*>(dC + rg * N + c);
  ob[0] = __floats2bfloat162_rn(sb.x, sb.y);
  ob[1] = __floats2bfloat162_rn(sb.z, sb.w);
  oc[0] = __floats2bfloat162_rn(sc.x, sc.y);
  oc[1] = __floats2bfloat162_rn(sc.z, sc.w);
}

struct Maps {
  const void *x, *gy, *B, *C;
  long long x_sb, x_ss, x_sh, g_sb, g_ss, g_sh, B_sb, B_ss, B_sg, C_sb,
      C_ss, C_sg;
};

template <int N>
int launch(const Maps& m, int b, int g, const Args& a, void* dB, void* dC,
           cudaStream_t stream) {
  using L = Layout<N>;
  CUtensorMap tx, tg, tb, tc;
  int rc = encode(&tx, m.x, b, a.S, a.H, a.p, m.x_sb, m.x_ss, m.x_sh, kP,
                  kPiece, 128);
  if (rc == 0)
    rc = encode(&tg, m.gy, b, a.S, a.H, a.p, m.g_sb, m.g_ss, m.g_sh, kP,
                kPiece, 128);
  if (rc == 0)
    rc = encode(&tb, m.B, b, a.S, g, N, m.B_sb, m.B_ss, m.B_sg, L::kCols,
                kPiece, L::kSwB);
  if (rc == 0)
    rc = encode(&tc, m.C, b, a.S, g, N, m.C_sb, m.C_ss, m.C_sg, L::kCols,
                kPiece, L::kSwB);
  if (rc != 0) return rc;
  auto kernel = ssd_bwd_sm90_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<b * a.H * a.halves, kThreads, L::kSmem, stream>>>(tx, tg, tb, tc,
                                                             a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = static_cast<long long>(b) * a.S;
  const long long threads = rows * g * (N / 4);
  ssd_bwd_reduce_kernel<<<(threads + 255) / 256, 256, 0, stream>>>(
      a.pdB, a.pdC, static_cast<__nv_bfloat16*>(dB),
      static_cast<__nv_bfloat16*>(dC), rows, g,
      a.heads_per_group * a.halves, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x and gy (b,s,h,p), B and C (b,s,g,n), all bf16; la (b,s,h) fp32.
// Outputs: dx (b,s,h,p) bf16 through its strides; dla (b,s,h) fp32
// through its strides, zero on entry (the kernel adds to it); dB and dC
// (b,s,g,n) bf16, contiguous. Scratch, fp32 and contiguous: states of
// (b * h * halves, pieces, 64, n) and the partials pdB and pdC of (b, s,
// h * halves, n), halves = ceil(p / 64), pieces = ceil(s / 128). Strides
// in elements; the last dim of every tensor is contiguous. p is a
// multiple of 8 up to 128, n one of 16, 32, 64, 128, and g divides h. The
// base addresses of x, gy, B and C are 16-byte aligned and their strides
// multiples of 8.
extern "C" int ssd_bwd_sm90(
    const void* x, const float* la, const void* B, const void* C,
    const void* gy, void* dx, float* dla, void* dB, void* dC, float* states,
    float* pdB, float* pdC, int b, int s, int h, int p, int g, int n,
    long long x_sb, long long x_ss, long long x_sh,
    long long la_sb, long long la_ss, long long la_sh,
    long long B_sb, long long B_ss, long long B_sg,
    long long C_sb, long long C_ss, long long C_sg,
    long long g_sb, long long g_ss, long long g_sh,
    long long dx_sb, long long dx_ss, long long dx_sh,
    long long dl_sb, long long dl_ss, long long dl_sh, void* stream) {
  if (b < 1 || s < 1 || g < 1 || h % g != 0 || p < 8 || p > 128 || p % 8)
    return (int)cudaErrorInvalidValue;
  const Args a{la, dx, dla, states, pdB, pdC, s, h, h / g, p, (p + kP - 1) / kP,
               la_sb, la_ss, la_sh, dx_sb, dx_ss, dx_sh, dl_sb, dl_ss, dl_sh};
  const Maps m{x, gy, B, C, x_sb, x_ss, x_sh, g_sb, g_ss, g_sh,
               B_sb, B_ss, B_sg, C_sb, C_ss, C_sg};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 16: return launch<16>(m, b, g, a, dB, dC, st);
    case 32: return launch<32>(m, b, g, a, dB, dC, st);
    case 64: return launch<64>(m, b, g, a, dB, dC, st);
    case 128: return launch<128>(m, b, g, a, dB, dC, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_bwd_sm90_error_string(int err) {
  if (err >= kTmaError)
    return "cuTensorMapEncodeTiled refused a tensor map of x, gy, B or C "
           "(the code less 1000 is the CUresult)";
  return cudaGetErrorString((cudaError_t)err);
}
