// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a), on the CUDA
// cores: the fp32 route, and bf16 of a head dim that the tensor-core
// kernel (ssd_fwd_sm90.cu, which takes bf16 with p a multiple of 8 up to
// 128) does not take.
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/ssd/kernel.py::ssd_bh (_ssd_kernel).
// Same function: for each (batch, head), the sequence is cut into chunks
// of Q rows; with la_cs the inclusive cumulative sum of the log decay
// over the chunk, row i of a chunk gets
//   y_i = sum_{j<=i} (C_i . B_j) exp(la_cs_i - la_cs_j) x_j       (intra)
//       + exp(la_cs_i) C_i . state                                  (carried)
// and the (P, N) fp32 state is carried across chunks as
//   state <- exp(la_cs_end) state + sum_j exp(la_cs_end - la_cs_j) x_j B_j^T.
// All sums in fp32; y is written in x's dtype. exp(la_cs_i - la_cs_j) is
// evaluated only where i >= j, as the TPU kernel's `where` does: above
// the diagonal it would overflow and poison the sum with inf * 0. Any S
// is taken: the ragged last chunk is read as rows of zero input and zero
// log decay, which change neither the outputs nor the state.
//
// B and C are read per group, through their (b, s, g, n) strides, and
// head h uses group h / (heads / groups): the 64 heads of mamba2 share one
// group, so no per-head copy of B and C is ever made.
//
// Bound: at the main path's shape (b=2, s=2048, h=64, p=64, n=128,
// chunk 256, bf16) the chunked form does about 21.5 GFLOP over the
// causal pairs j <= i only (1,024 chunk-heads x 21.0 MFLOP) against
// about 70 MB of x, y, la and one group of B and C. The function does
// not depend on the chunk, and at 128 rows it takes 15.1 GFLOP, 0.0153 ms
// at 989 TFLOP/s on the tensor cores, under the bytes' 0.0210 ms at 3.35
// TB/s: the bytes bound it. This kernel keeps every product on the
// fp32 CUDA cores (67 TFLOP/s, 0.32 ms for 21.5 GFLOP), which holds
// fp32 inputs at the JAX package's 1e-5; bf16 at that shape runs on
// ssd_fwd_sm90.cu.
//
// Design. The TPU kernel walks the chunks on a sequential grid axis with
// the state in VMEM. On the card blocks run in parallel, so the chunk
// loop lives inside one block, and the grid is (P / 32, b * h): column
// p of y and row p of the state depend only on column p of x, so each
// block owns 32 head-dim columns and their (32, N) state slice in shared
// memory (at the main shape 2 x 128 = 256 blocks). Thread i owns row i
// of the chunk (Q <= 256): it keeps C_i (N floats) and its 32 outputs in
// registers. B and x are staged in shared memory 32 rows at a time as
// fp32; every thread reads the same row at the same time, so each float4
// read is a broadcast. For each staged row j <= i a thread takes the dot
// C_i . B_j, scales it by exp(la_cs_i - la_cs_j) and adds it times x_j to
// its outputs; the same staged rows feed the state update, where each
// thread owns a 4 x 4 tile of the state slice. The chunk's cumulative
// sum is taken by one thread in order, as torch.cumsum does. C B^T is
// recomputed by each of a head's P / 32 blocks: the price of having
// enough blocks to fill the card while a thread's registers hold C_i.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // one thread per row of a chunk
constexpr int kPT = 32;         // head-dim columns per block
constexpr int kJT = 32;         // rows of B, C and x staged at a time

struct SsdArgs {
  const void* x;
  const float* la;
  const void* B;
  const void* C;
  void* y;
  int b, s, h, p, g, chunk;
  long long x_sb, x_ss, x_sh;   // strides in elements; the last dim of
  long long la_sb, la_ss, la_sh;  // x, B, C and y is contiguous
  long long B_sb, B_ss, B_sg;
  long long C_sb, C_ss, C_sg;
  long long y_sb, y_ss, y_sh;
};

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd_kernel(const SsdArgs a) {
  static_assert(N % 4 == 0, "N must be a multiple of 4");
  // the state update hands each thread one 4 x 4 tile of the slice
  constexpr int kTilesN = N / 4;
  static_assert((kPT / 4) * kTilesN <= kThreads, "N too large");
  // rows padded by 4 floats: a warp reading 32 different rows as float4s
  // (the C staging) hits distinct banks in each quarter warp
  constexpr int kRow = N + 4;
  __shared__ __align__(16) float bs[kJT][kRow];   // staged rows of B or C
  __shared__ __align__(16) float xs[kJT][kPT];    // staged rows of x
  __shared__ __align__(16) float st[kPT][N];      // carried state slice
  __shared__ float cs[kThreads];                  // la, then its cumsum

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / a.h, hi = bh % a.h;
  const int gi = hi / (a.h / a.g);
  const int p0 = blockIdx.x * kPT;

  const T* xp = static_cast<const T*>(a.x) + bi * a.x_sb + hi * a.x_sh + p0;
  const float* lap = a.la + bi * a.la_sb + hi * a.la_sh;
  const T* Bp = static_cast<const T*>(a.B) + bi * a.B_sb + gi * a.B_sg;
  const T* Cp = static_cast<const T*>(a.C) + bi * a.C_sb + gi * a.C_sg;
  T* yp = static_cast<T*>(a.y) + bi * a.y_sb + hi * a.y_sh + p0;

  for (int e = tid; e < kPT * N; e += kThreads) (&st[0][0])[e] = 0.f;
  const bool owns = tid < (kPT / 4) * kTilesN;
  const int sp = (tid / kTilesN) * 4, sn = (tid % kTilesN) * 4;

  const int Q = a.chunk;
  const int n_chunks = (a.s + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int qv = min(Q, a.s - t0);              // valid rows
    const int n_tiles = (qv + kJT - 1) / kJT;
    __syncthreads();                              // last chunk is done
    if (tid < Q) cs[tid] = tid < qv ? lap[(t0 + tid) * a.la_ss] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += cs[i];
        cs[i] = run;
      }
    }

    // C_i into registers, 32 rows at a time through shared memory
    const bool row = tid < qv;
    float cr[N];
    for (int rt = 0; rt < n_tiles; ++rt) {
      __syncthreads();
      for (int e = tid; e < kJT * N; e += kThreads) {
        const int r = e / N, n = e % N, j = rt * kJT + r;
        bs[r][n] = j < qv ? to_float(Cp[(t0 + j) * a.C_ss + n]) : 0.f;
      }
      __syncthreads();
      if (tid / kJT == rt) {
        const float4* src = reinterpret_cast<const float4*>(bs[tid % kJT]);
#pragma unroll
        for (int k = 0; k < N / 4; ++k) {
          const float4 v = src[k];
          cr[4 * k] = v.x;
          cr[4 * k + 1] = v.y;
          cr[4 * k + 2] = v.z;
          cr[4 * k + 3] = v.w;
        }
      }
    }
    const float cs_i = row ? cs[tid] : 0.f;
    const float cs_end = cs[Q - 1];

    // carried state: exp(la_cs_i) C_i . state[p, :]
    float acc[kPT];
#pragma unroll
    for (int pp = 0; pp < kPT; ++pp) {
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
      if (row) {
        const float4* srow = reinterpret_cast<const float4*>(st[pp]);
#pragma unroll
        for (int k = 0; k < N / 4; ++k) {
          const float4 v = srow[k];
          d0 = fmaf(cr[4 * k], v.x, d0);
          d1 = fmaf(cr[4 * k + 1], v.y, d1);
          d2 = fmaf(cr[4 * k + 2], v.z, d2);
          d3 = fmaf(cr[4 * k + 3], v.w, d3);
        }
      }
      acc[pp] = ((d0 + d1) + (d2 + d3)) * expf(cs_i);
    }

    float sacc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) sacc[r][q] = 0.f;

    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kJT;
      __syncthreads();                            // done with bs, xs, st
      for (int e = tid; e < kJT * N; e += kThreads) {
        const int r = e / N, n = e % N, j = j0 + r;
        bs[r][n] = j < qv ? to_float(Bp[(t0 + j) * a.B_ss + n]) : 0.f;
      }
      for (int e = tid; e < kJT * kPT; e += kThreads) {
        const int r = e / kPT, pp = e % kPT, j = j0 + r;
        xs[r][pp] = (j < qv && p0 + pp < a.p)
                        ? to_float(xp[(t0 + j) * a.x_ss + pp]) : 0.f;
      }
      __syncthreads();

      // intra-chunk rows j <= i only
      if (row && j0 <= tid) {
        const int jn = min(kJT, tid - j0 + 1);
        for (int jj = 0; jj < jn; ++jj) {
          const float4* brow = reinterpret_cast<const float4*>(bs[jj]);
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
          for (int k = 0; k < N / 4; ++k) {
            const float4 v = brow[k];
            d0 = fmaf(cr[4 * k], v.x, d0);
            d1 = fmaf(cr[4 * k + 1], v.y, d1);
            d2 = fmaf(cr[4 * k + 2], v.z, d2);
            d3 = fmaf(cr[4 * k + 3], v.w, d3);
          }
          const float w =
              ((d0 + d1) + (d2 + d3)) * expf(cs_i - cs[j0 + jj]);
          const float4* xrow = reinterpret_cast<const float4*>(xs[jj]);
#pragma unroll
          for (int k = 0; k < kPT / 4; ++k) {
            const float4 v = xrow[k];
            acc[4 * k] = fmaf(w, v.x, acc[4 * k]);
            acc[4 * k + 1] = fmaf(w, v.y, acc[4 * k + 1]);
            acc[4 * k + 2] = fmaf(w, v.z, acc[4 * k + 2]);
            acc[4 * k + 3] = fmaf(w, v.w, acc[4 * k + 3]);
          }
        }
      }

      // this tile's share of the chunk's end state
      if (owns) {
        const int jn = min(kJT, qv - j0);
        for (int jj = 0; jj < jn; ++jj) {
          const float dec = expf(cs_end - cs[j0 + jj]);
          const float4 xv = *reinterpret_cast<const float4*>(&xs[jj][sp]);
          const float4 bv = *reinterpret_cast<const float4*>(&bs[jj][sn]);
          const float xw[4] = {xv.x * dec, xv.y * dec, xv.z * dec,
                               xv.w * dec};
          const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              sacc[r][q] = fmaf(xw[r], bb[q], sacc[r][q]);
        }
      }
    }

    if (row) {
      T* out = yp + (t0 + tid) * a.y_ss;
#pragma unroll
      for (int pp = 0; pp < kPT; ++pp)
        if (p0 + pp < a.p) out[pp] = from_float<T>(acc[pp]);
    }
    // every read of st for this chunk came before the tile loop's first
    // barrier, and each thread rewrites only its own tile
    if (owns) {
      const float chunk_decay = expf(cs_end);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          st[sp + r][sn + q] = st[sp + r][sn + q] * chunk_decay + sacc[r][q];
    }
  }
}

template <typename T, int N>
cudaError_t launch(const SsdArgs& a, cudaStream_t stream) {
  const dim3 grid((a.p + kPT - 1) / kPT, a.b * a.h);
  ssd_fwd_kernel<T, N><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_state(int n, const SsdArgs& a, cudaStream_t s) {
  switch (n) {
    case 16: return launch<T, 16>(a, s);
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 128: return launch<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (b,s,h,p), B and C (b,s,g,n), y (b,s,h,p), all of one dtype (fp32, or
// bf16 when is_bf16); la (b,s,h) fp32. Strides in elements.
extern "C" int ssd_fwd(
    const void* x, const float* la, const void* B, const void* C, void* y,
    int is_bf16, int b, int s, int h, int p, int g, int n, int chunk,
    long long x_sb, long long x_ss, long long x_sh,
    long long la_sb, long long la_ss, long long la_sh,
    long long B_sb, long long B_ss, long long B_sg,
    long long C_sb, long long C_ss, long long C_sg,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  if (chunk < 1 || chunk > kThreads || g < 1 || h % g != 0)
    return (int)cudaErrorInvalidValue;
  const SsdArgs a{x, la, B, C, y, b, s, h, p, g, chunk,
                  x_sb, x_ss, x_sh, la_sb, la_ss, la_sh,
                  B_sb, B_ss, B_sg, C_sb, C_ss, C_sg,
                  y_sb, y_ss, y_sh};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(is_bf16 ? dispatch_state<__nv_bfloat16>(n, a, st)
                       : dispatch_state<float>(n, a, st));
}

extern "C" const char* ssd_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
