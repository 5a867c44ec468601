// RG-LRU linear recurrence for Hopper (sm_90a): forward, reverse and the
// fused backward, each one pass over device memory.
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/rglru/kernel.py::rglru_scan_b (_rglru_kernel).
// Per (batch, channel), fp32 throughout, la, u and the outputs addressed
// through their strides:
// - forward:  out_t = exp(la_t) out_{t-1} + u_t, out_{-1} = 0;
// - reverse:  out_t = exp(la_{t+1}) out_{t+1} + u_t, with the coefficient
//   0 at t = S-1 (the backward's recurrence, u the output gradient);
// - backward: g, the reverse scan of the output gradient gh, gives
//   db = g and dlog_a_t = g_t exp(la_t) h_{t-1} (h the forward's output,
//   h_{-1} = 0), written in the same pass as the scan.
//
// Bound. recurrentgemma-2b's layer is (1, 4096, 2560): 41.9 MB an array.
// Forward and reverse read la and u and write out, three arrays: 126 MB,
// 0.0376 ms at 3.35 TB/s. The backward reads la, gh and h and writes db
// and dlog_a, five arrays: 210 MB, 0.0626 ms. A step is one exp and one
// fused multiply-add (two more multiplies for dlog_a), far below the
// card's rate, so bytes bound every mode: the design reads each input
// once and keeps enough loads in flight to reach HBM's rate.
//
// Design.
// - A block owns kCW = 32 channels of one batch row (threadIdx.x: a warp
//   reads one 128-byte run a time step) and kNC = 8 chunk threads
//   (threadIdx.y), 256 threads. It walks the sequence in segments of
//   kNC x L steps, L steps a chunk thread (16 in the scans, 12 in the
//   backward). A thread first issues every load of its chunk into
//   registers, all independent (2L of them; 3L + 1 in the backward), then
//   scans the chunk from a zero state, keeping its end value and the
//   product of its coefficients. The exps are taken once, into the
//   registers that held la.
// - The (decay, end) pairs of the segment's chunks fold in parallel: kNC
//   lanes a channel, a shuffle scan in three steps gives each chunk the
//   state before it as an affine function of the segment's incoming
//   state, and the segment's own pair.
// - A thread block cluster of CL = 1 to 8 blocks splits the sequence:
//   round q gives rank r segment q CL + r. Each block publishes its
//   segment pair in shared memory; after one cluster barrier every block
//   reads all CL pairs through distributed shared memory
//   (map_shared_rank), folds those of the lower ranks into its incoming
//   state and all of them into the next round's, which every block thus
//   holds without a message. No device scratch, no flags, no wait on a
//   block that might not be resident. The pairs are double-buffered by
//   round, so one barrier a round suffices; a last split barrier keeps a
//   block's shared memory alive until the others have read it.
// - Then each thread rescans its registers from its chunk's true
//   incoming state with the same fmaf(c, v, u) as the zero-state scan and
//   writes the outputs: la and u are read once, and the state of a step
//   is never formed from a running product times the incoming state.
// - The wrapper picks CL (ops.plan): the largest whose blocks are all
//   resident at once, three a SM (256 threads at up to 85 registers). At
//   (1, 4096, 2560) that is 4: 80 strips give 320 blocks for 396 places
//   on 132 SMs, and each block walks 8 forward rounds (11 backward).
//   These 256-thread blocks, each walking several rounds, measured
//   faster than 512- and 1,024-thread blocks taking one segment each,
//   and several blocks a SM faster than one: the phases of one block's
//   round (loads, scan, barriers, stores) overlap another's.
// - Reverse and backward walk step k at time t = S-1-k, their
//   coefficients la_{t+1} loaded shifted by one step (-inf at t = S-1, so
//   exp gives 0). The backward's exp(la_t) is the next step's
//   coefficient, and for a chunk's last step one extra la load; h_{t-1}
//   is loaded shifted by one too, one element from the neighbour's
//   range.
// - Steps past S and channels past W load identities (la = 0, u = 0) and
//   store nothing. Offsets along the sequence are 32-bit where they fit
//   (S x |stride| < 2^31), which keeps the addresses' registers few.
// - The next round's loads are not issued before this round's fold: the
//   SM's other blocks keep loads in flight while one block folds, and a
//   second set of chunk registers does not fit three blocks a SM
//   without spilling.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCW = 32;      // channels a block (threadIdx.x)
constexpr int kNC = 8;       // chunk threads a block (threadIdx.y)
constexpr int kLScan = 16;   // steps a chunk thread, forward and reverse
constexpr int kLBwd = 12;    // steps a chunk thread, backward
constexpr int kLWide = 8;    // at most, with 64-bit offsets
constexpr int kMinBlocks = 3;    // blocks a SM: up to 85 registers
constexpr int kMaxCluster = 8;   // blocks a cluster, the portable most

enum Mode { kForward = 0, kReverse = 1, kBackward = 2 };

struct ScanArgs {
  const float* la;   // log coefficients
  const float* u;    // input; the output gradient gh in the backward
  const float* h;    // the forward's output (backward only)
  float* out;        // the scan; db in the backward
  float* dla;        // dlog_a (backward only)
  int S, W, cluster;
  long long la_sb, la_ss, la_sw;
  long long u_sb, u_ss, u_sw;
  long long h_sb, h_ss, h_sw;
  long long o_sb, o_ss, o_sw;
  long long d_sb, d_ss, d_sw;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// (A, B) after (Al, Bl): the affine map x -> A (Al x + Bl) + B.
__device__ __forceinline__ void compose(float Al, float Bl, float& A,
                                        float& B) {
  B = fmaf(A, Bl, B);
  A *= Al;
}

template <int MODE, int L, typename Index>
__global__ void __launch_bounds__(kCW * kNC, kMinBlocks)
rglru_scan_kernel(const ScanArgs a) {
  constexpr int kSeg = kNC * L;
  constexpr bool kRev = MODE != kForward;
  static_assert(kNC >= kMaxCluster && kNC <= 32 && (kNC & (kNC - 1)) == 0,
                "the folds scan kNC lanes, at least a cluster's ranks");
  // a chunk's decay and end value, then its prefix's; a row of kCW + 1
  // keeps the folds' column reads off one bank
  __shared__ float pa[kNC][kCW + 1];
  __shared__ float pb[kNC][kCW + 1];
  __shared__ float2 agg[2][kCW];   // the segment's pair, by round parity
  __shared__ float hin[kCW];       // the segment's incoming state

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = a.cluster;
  const int rank = (int)cluster.block_rank();
  const int cx = threadIdx.x, ci = threadIdx.y;
  // in the folds a thread takes chunk fk of channel fc: kNC lanes of a
  // warp a channel
  const int fc = (ci * kCW + cx) / kNC, fk = (ci * kCW + cx) % kNC;
  const int w = (blockIdx.x / CL) * kCW + cx;
  const bool ok = w < a.W;
  const int S = a.S;
  const long long bi = blockIdx.y;
  const float* la = a.la + bi * a.la_sb + (long long)w * a.la_sw;
  const float* u = a.u + bi * a.u_sb + (long long)w * a.u_sw;
  const float* hp = a.h + bi * a.h_sb + (long long)w * a.h_sw;
  float* out = a.out + bi * a.o_sb + (long long)w * a.o_sw;
  float* dla = a.dla + bi * a.d_sb + (long long)w * a.d_sw;
  const Index la_ss = a.la_ss, u_ss = a.u_ss, h_ss = a.h_ss;
  const Index o_ss = a.o_ss, d_ss = a.d_ss;
  const int rounds = (S + CL * kSeg - 1) / (CL * kSeg);

  float h_round = 0.f;   // the state entering the round, channel fc's
  for (int q = 0; q < rounds; ++q) {
    const int k0 = (q * CL + rank) * kSeg + ci * L;
    // the chunk's steps in range, and its first step's time; a step
    // further on is j steps on in time, or back in reverse
    const int n = ok ? min(L, S - k0) : 0;
    const Index t0 = kRev ? S - 1 - k0 : k0;
    const Index dt = kRev ? -1 : 1;
    const float* up = u + t0 * u_ss;
    const float* lp = la + (t0 + (kRev ? 1 : 0)) * la_ss;   // c's la
    const float* hq = hp + (t0 - 1) * h_ss;                  // h_{t-1}
    // Every load of the chunk first: c holds la until its exp. In
    // reverse the first step's coefficient is 0 (la = -inf) at t = S-1,
    // and in the backward h_{-1} = 0.
    float c[L], x[L], hprev[MODE == kBackward ? L : 1];
    float la_last = 0.f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const bool in = n == L || j < n;
      x[j] = in ? up[j * dt * u_ss] : 0.f;
      c[j] = !in ? 0.f
             : kRev && j == 0 && k0 == 0 ? -INFINITY : lp[j * dt * la_ss];
      if (MODE == kBackward)
        hprev[j] = ok && k0 + j + 1 < S ? hq[j * dt * h_ss] : 0.f;
    }
    if (MODE == kBackward && n == L) la_last = lp[L * dt * la_ss];

    // Zero-state scan of the chunk.
    float prod = 1.f, v = 0.f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      c[j] = expf(c[j]);
      v = fmaf(c[j], v, x[j]);
      prod *= c[j];
    }
    pa[ci][cx] = prod;
    pb[ci][cx] = v;
    __syncthreads();

    // Fold the segment's chunks: an inclusive shuffle scan of the affine
    // maps over kNC lanes, then each chunk's exclusive prefix and the
    // segment's pair.
    {
      float A = pa[fk][fc], B = pb[fk][fc];
#pragma unroll
      for (int d = 1; d < kNC; d <<= 1) {
        const float Al = __shfl_up_sync(~0u, A, d, kNC);
        const float Bl = __shfl_up_sync(~0u, B, d, kNC);
        if (fk >= d) compose(Al, Bl, A, B);
      }
      const float XA = __shfl_up_sync(~0u, A, 1, kNC);
      const float XB = __shfl_up_sync(~0u, B, 1, kNC);
      pa[fk][fc] = fk ? XA : 1.f;
      pb[fk][fc] = fk ? XB : 0.f;
      if (fk == kNC - 1) agg[q & 1][fc] = make_float2(A, B);
    }
    cluster_arrive();
    cluster_wait();

    // The cluster's segments: lane r reads rank r's pair; the lower
    // ranks' fold gives this segment's incoming state, all of them the
    // next round's.
    {
      float A = 1.f, B = 0.f;
      if (fk < CL) {
        const float2 p = *cluster.map_shared_rank(&agg[q & 1][fc], fk);
        A = p.x;
        B = p.y;
      }
#pragma unroll
      for (int d = 1; d < kMaxCluster; d <<= 1) {
        const float Al = __shfl_up_sync(~0u, A, d, kNC);
        const float Bl = __shfl_up_sync(~0u, B, d, kNC);
        if (fk >= d) compose(Al, Bl, A, B);
      }
      const float XA = __shfl_sync(~0u, A, rank ? rank - 1 : 0, kNC);
      const float XB = __shfl_sync(~0u, B, rank ? rank - 1 : 0, kNC);
      const float TA = __shfl_sync(~0u, A, CL - 1, kNC);
      const float TB = __shfl_sync(~0u, B, CL - 1, kNC);
      if (fk == 0) hin[fc] = rank ? fmaf(XA, h_round, XB) : h_round;
      h_round = fmaf(TA, h_round, TB);
    }
    // the last round's pairs are read: let the cluster's blocks go on
    if (q == rounds - 1) cluster_arrive();
    __syncthreads();

    // Rescan from the chunk's true incoming state and write.
    v = fmaf(pa[ci][cx], hin[cx], pb[ci][cx]);
    float* op = out + t0 * o_ss;
    float* dp = dla + t0 * d_ss;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      v = fmaf(c[j], v, x[j]);
      if (n == L || j < n) {
        op[j * dt * o_ss] = v;
        if (MODE == kBackward) {
          const float ea = j + 1 < L ? c[j + 1] : expf(la_last);
          dp[j * dt * d_ss] = v * ea * hprev[j];
        }
      }
    }
  }
  cluster_wait();
}

// The grid: the cluster's ranks side by side in x for each strip of
// channels, so the cluster size always divides it; batch rows in y.
template <int MODE, int L, typename Index>
int launch_as(const ScanArgs& a, int B, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.W + kCW - 1) / kCW) * a.cluster, B);
  cfg.blockDim = dim3(kCW, kNC);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, rglru_scan_kernel<MODE, L, Index>, a);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// 32-bit offsets along the sequence where every array's S x |stride|
// fits them; otherwise 64-bit ones, with fewer steps a chunk thread so
// that the addresses fit the registers too.
template <int MODE, int L>
int launch(const ScanArgs& a, int B, void* stream) {
  if (a.cluster != 1 && a.cluster != 2 && a.cluster != 4 && a.cluster != 8)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || a.S <= 0 || a.W <= 0) return 0;   // nothing to scan
  const long long strides[5] = {a.la_ss, a.u_ss, a.h_ss, a.o_ss, a.d_ss};
  long long ss = 0;
  for (long long s : strides) ss = s > ss ? s : (-s > ss ? -s : ss);
  if ((a.S + 1LL) * ss < (1LL << 31))
    return launch_as<MODE, L, int>(a, B, stream);
  return launch_as<MODE, (L < kLWide ? L : kLWide), long long>(a, B, stream);
}

}  // namespace

// la, u, out: (B, S, W) fp32, addressed through the given strides (in
// elements). reverse = 0: out_t = exp(la_t) out_{t-1} + u_t; reverse = 1:
// out_t = exp(la_{t+1}) out_{t+1} + u_t, with exp(la_S) taken as 0.
// cluster: blocks a cluster, 1, 2, 4 or 8, each a range of the sequence.
extern "C" int rglru_scan(
    const float* la, const float* u, float* out, int B, int S, int W,
    int reverse, int cluster, long long la_sb, long long la_ss,
    long long la_sw, long long u_sb, long long u_ss, long long u_sw,
    long long o_sb, long long o_ss, long long o_sw, void* stream) {
  const ScanArgs a{la, u, nullptr, out, nullptr, S, W, cluster,
                   la_sb, la_ss, la_sw, u_sb, u_ss, u_sw, 0, 0, 0,
                   o_sb, o_ss, o_sw, 0, 0, 0};
  return reverse ? launch<kReverse, kLScan>(a, B, stream)
                 : launch<kForward, kLScan>(a, B, stream);
}

// The backward of the forward scan h = rglru_scan(la, b) given the output
// gradient gh: g_t = exp(la_{t+1}) g_{t+1} + gh_t, db = g and
// dla_t = g_t exp(la_t) h_{t-1} with h_{-1} = 0. All (B, S, W) fp32
// through their strides.
extern "C" int rglru_scan_bwd(
    const float* la, const float* gh, const float* h, float* db, float* dla,
    int B, int S, int W, int cluster, long long la_sb, long long la_ss,
    long long la_sw, long long g_sb, long long g_ss, long long g_sw,
    long long h_sb, long long h_ss, long long h_sw, long long b_sb,
    long long b_ss, long long b_sw, long long d_sb, long long d_ss,
    long long d_sw, void* stream) {
  const ScanArgs a{la, gh, h, db, dla, S, W, cluster,
                   la_sb, la_ss, la_sw, g_sb, g_ss, g_sw, h_sb, h_ss, h_sw,
                   b_sb, b_ss, b_sw, d_sb, d_ss, d_sw};
  return launch<kBackward, kLBwd>(a, B, stream);
}

extern "C" const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
