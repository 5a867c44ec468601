// RG-LRU linear recurrence for Hopper (sm_90a), forward and reverse.
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/rglru/kernel.py::rglru_scan_b (_rglru_kernel).
// Forward, per (batch, channel):  h_t = exp(la_t) h_{t-1} + u_t, h_{-1} = 0.
// Reverse, the same recurrence walked from the end, which is the
// backward of the forward: g_t = exp(la_{t+1}) g_{t+1} + u_t with the
// coefficient 0 at t = S-1 (u is then the output gradient). fp32
// throughout; la and u are read through their strides.
//
// Bound: at the main path's shape (1, 4096, 2560) one launch must read la
// and u and write h, three 41.9 MB arrays: 0.038 ms at 3.35 TB/s. It does
// about 4 operations an element, far below the card's rate, so bytes
// bound it.
//
// Design. The TPU kernel walks chunks of 128 steps on a sequential grid
// axis, carrying the state in VMEM, and builds a (Q, Q, W) decay tensor
// for the chunk's parallel form. On the card one thread per (batch,
// channel) walking all of S would give only 2,560 threads at the main
// shape, too few to fill 132 SMs, and the parallel form spends Q times
// the operations. So a block owns 16 channels of one batch row and cuts
// S into 64 chunks, one thread per (channel, chunk): 1,024 threads, and
// 160 blocks at the main shape. Each thread first scans its chunk from a
// zero state, keeping the chunk's last value and the product of its
// coefficients in shared memory; one thread per channel then folds the
// 64 chunks in order into each chunk's incoming state; each thread scans
// its chunk again from that state and writes it out. la and u are read
// twice (the second read is the price of needing no scratch in device
// memory and a single launch); a warp reads 16 contiguous channels of
// two chunks, 64-byte runs.
#include <cuda_runtime.h>

namespace {

constexpr int kCW = 16;   // channels per block (threadIdx.x)
constexpr int kNC = 64;   // chunks of the sequence (threadIdx.y)

struct ScanArgs {
  const float* la;
  const float* u;
  float* out;
  int B, S, W, reverse;
  long long la_sb, la_ss, la_sw;
  long long u_sb, u_ss, u_sw;
  long long o_sb, o_ss, o_sw;
};

// Scan step k visits time t = k (forward) or S-1-k (reverse); its
// coefficient is exp(la_t), or in reverse exp(la_{t+1}) and 0 at the end.
__device__ __forceinline__ float coef(const float* la, long long ss, int t,
                                      int S, int reverse) {
  if (!reverse) return expf(la[t * ss]);
  return t + 1 < S ? expf(la[(t + 1) * ss]) : 0.f;
}

__global__ void __launch_bounds__(kCW * kNC)
rglru_scan_kernel(const ScanArgs a) {
  __shared__ float decay[kNC][kCW];   // product of a chunk's coefficients
  __shared__ float carry[kNC][kCW];   // a chunk's end value, then its
                                      // incoming state
  const int cx = threadIdx.x, ci = threadIdx.y;
  const int w = blockIdx.x * kCW + cx;
  const int bi = blockIdx.y;
  const bool ok = w < a.W;
  const int S = a.S, rev = a.reverse;
  const int len = (S + kNC - 1) / kNC;
  const int k0 = min(ci * len, S), k1 = min(k0 + len, S);
  const float* la = a.la + bi * a.la_sb + (long long)w * a.la_sw;
  const float* u = a.u + bi * a.u_sb + (long long)w * a.u_sw;
  const long long la_ss = a.la_ss, u_ss = a.u_ss, o_ss = a.o_ss;

  float prod = 1.f, v = 0.f;
  if (ok) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const int t = rev ? S - 1 - k : k;
      const float c = coef(la, la_ss, t, S, rev);
      v = fmaf(c, v, u[t * u_ss]);
      prod *= c;
    }
  }
  decay[ci][cx] = prod;
  carry[ci][cx] = v;
  __syncthreads();
  if (ci == 0) {
    float in = 0.f;
    for (int j = 0; j < kNC; ++j) {
      const float end = carry[j][cx];
      carry[j][cx] = in;
      in = fmaf(decay[j][cx], in, end);
    }
  }
  __syncthreads();
  if (!ok) return;
  v = carry[ci][cx];
  float* out = a.out + bi * a.o_sb + (long long)w * a.o_sw;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const int t = rev ? S - 1 - k : k;
    v = fmaf(coef(la, la_ss, t, S, rev), v, u[t * u_ss]);
    out[t * o_ss] = v;
  }
}

}  // namespace

// la, u, out: (B, S, W) fp32, addressed through the given strides (in
// elements). reverse = 0: out_t = exp(la_t) out_{t-1} + u_t; reverse = 1:
// out_t = exp(la_{t+1}) out_{t+1} + u_t, with exp(la_S) taken as 0.
extern "C" int rglru_scan(
    const float* la, const float* u, float* out, int B, int S, int W,
    int reverse, long long la_sb, long long la_ss, long long la_sw,
    long long u_sb, long long u_ss, long long u_sw,
    long long o_sb, long long o_ss, long long o_sw, void* stream) {
  const ScanArgs a{la, u, out, B, S, W, reverse,
                   la_sb, la_ss, la_sw, u_sb, u_ss, u_sw,
                   o_sb, o_ss, o_sw};
  const dim3 grid((W + kCW - 1) / kCW, B);
  const dim3 block(kCW, kNC);
  rglru_scan_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
