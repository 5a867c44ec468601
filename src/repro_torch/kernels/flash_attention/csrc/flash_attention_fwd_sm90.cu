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
// - The mbarrier, TMA and wgmma helpers are in ../../sm90.cuh, shared with
//   ssd_fwd_sm90.cu.
#include "../../sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockM = 128;             // query rows a block
constexpr int kBlockN = 64;              // keys a tile
constexpr int kStages = 2;               // K/V ring depth
constexpr int kThreads = 256;            // two warpgroups

struct Args {
  void* o;
  int N, S, T;
  long long o_sb, o_ss, o_sn;            // strides of o in elements
  float scale;                           // 1/sqrt(H)
  int causal;
  int window;                            // <= 0: no window
  float softcap;                         // <= 0: no softcap
};

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
      wgmma_ss<0, 0>(s, da, db, kk > 0);
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
