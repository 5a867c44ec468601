// Flash-attention forward for Hopper (sm_90a): causal attention with an
// optional sliding window and an optional tanh softcap, online softmax.
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/flash_attention/kernel.py::flash_attention_bnh (_flash_kernel).
// Same function: fp32 scores scaled by 1/sqrt(H), softcap * tanh(s /
// softcap), masked entries set to -1e30, running max / denominator /
// accumulator in fp32, denominator clamped at 1e-30, output in q's dtype.
//
// Bound: at the main path's shape (B=4, S=1024, N=32, H=96, bf16, causal)
// the work is about 25.8 GFLOP against about 101 MB of q, k, v and o, so
// on the tensor cores the bytes would bound it (30 us at 3.35 TB/s vs 26 us
// at 989 TFLOP/s). This first version keeps every product on the fp32
// CUDA cores (67 TFLOP/s), so the operations bound it here; moving the two
// products onto wgmma is the next step for this kernel.
//
// Design. One block of 256 threads per (batch*head, 64-query tile); four
// neighbouring threads share one query row. Each holds a quarter of the
// row's q and output accumulator in registers, in runs of four elements
// (thread j of the four owns elements 16g + 4j + c), so it reads a key or
// value row of the shared-memory tile as float4s: one load feeds four
// FMAs, the four threads read 64 contiguous bytes that the warp's eight
// rows share as a broadcast, and the four partial dot products meet in two
// warp shuffles. Key and value tiles of 32 rows are staged in shared memory
// as fp32, one tile at a time; with 32-row tiles a thread's scores, q and
// accumulator fit in 128 registers for H <= 128, so two blocks share an
// SM. q, k, v and o are read through their (B, S, N, H) strides, so no
// fold or transpose copy is needed. Any S and T are taken: the ragged edge
// is masked. Key tiles wholly above the diagonal or wholly outside the
// window are skipped: they would add exactly zero to the row, because a
// masked score's weight is exp(-1e30 - max) = 0 once the row has seen an
// unmasked key, and the weights of keys seen before that are multiplied by
// exp(-1e30 - max) = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kLanes = 4;                    // threads per query row
constexpr int kVec = 4;                      // floats per shared-memory read
constexpr int kThreads = kBlockQ * kLanes;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, N, S, T;
  long long q_sb, q_ss, q_sn;                // strides in elements; H is
  long long k_sb, k_ss, k_sn;                // contiguous (stride 1)
  long long v_sb, v_ss, v_sn;
  long long o_sb, o_ss, o_sn;
  float scale;
  int causal;
  int window;                                // <= 0: no window
  float softcap;                             // <= 0: no softcap
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

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, H <= 128 ? 2 : 1)
flash_fwd_kernel(const FlashArgs a) {
  static_assert(H % (kLanes * kVec) == 0, "H must be a multiple of 16");
  constexpr int G = H / (kLanes * kVec);     // float4 runs per thread
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [kBlockK][H]
  float* vs = smem + kBlockK * H;            // [kBlockK][H]

  const int bn = blockIdx.y;
  const int b = bn / a.N, n = bn % a.N;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int qpos = q0 + row;
  const bool q_valid = qpos < a.S;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + n * a.q_sn;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + n * a.k_sn;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + n * a.v_sn;

  // this thread's elements of the row: 16 g + 4 lane + c
  float qr[G][kVec], acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const int d = g * kLanes * kVec + lane * kVec + c;
      qr[g][c] = q_valid ? to_float(qp[qpos * a.q_ss + d]) : 0.f;
      acc[g][c] = 0.f;
    }
  float m = kNegInf, l = 0.f;

  const int q_hi = min(q0 + kBlockQ, a.S);   // one past the tile's last row
  const int k_hi = a.causal ? min(a.T, q_hi) : a.T;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_end = (k_hi + kBlockK - 1) / kBlockK;

  for (int t = k_lo / kBlockK; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();                         // the last tile is consumed
    for (int idx = threadIdx.x; idx < kBlockK * H; idx += kThreads) {
      const int kk = idx / H, d = idx % H;
      const int kpos = k0 + kk;
      const bool ok = kpos < a.T;
      ks[idx] = ok ? to_float(kp[kpos * a.k_ss + d]) : 0.f;
      vs[idx] = ok ? to_float(vp[kpos * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float4* krow = reinterpret_cast<const float4*>(ks + kk * H);
      float part[kVec] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 kv = krow[g * kLanes + lane];
        part[0] = fmaf(qr[g][0], kv.x, part[0]);
        part[1] = fmaf(qr[g][1], kv.y, part[1]);
        part[2] = fmaf(qr[g][2], kv.z, part[2]);
        part[3] = fmaf(qr[g][3], kv.w, part[3]);
      }
      float dot = (part[0] + part[1]) + (part[2] + part[3]);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      float sc = dot * a.scale;
      if (a.softcap > 0.f) sc = a.softcap * tanhf(sc / a.softcap);
      const int kpos = k0 + kk;
      const bool ok = kpos < a.T && (!a.causal || kpos <= qpos) &&
                      (a.window <= 0 || kpos > qpos - a.window);
      s[kk] = ok ? sc : kNegInf;
      tile_max = fmaxf(tile_max, s[kk]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[g][c] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float p = expf(s[kk] - m_new);
      psum += p;
      const float4* vrow = reinterpret_cast<const float4*>(vs + kk * H);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv = vrow[g * kLanes + lane];
        acc[g][0] = fmaf(p, vv.x, acc[g][0]);
        acc[g][1] = fmaf(p, vv.y, acc[g][1]);
        acc[g][2] = fmaf(p, vv.z, acc[g][2]);
        acc[g][3] = fmaf(p, vv.w, acc[g][3]);
      }
    }
    l = alpha * l + psum;
    m = m_new;
  }

  if (q_valid) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = static_cast<T*>(a.o) + b * a.o_sb + qpos * a.o_ss + n * a.o_sn;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        op[g * kLanes * kVec + lane * kVec + c] =
            from_float<T>(acc[g][c] / denom);
  }
}

template <typename T, int H>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  const int smem = 2 * kBlockK * H * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.B * a.N);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int H, const FlashArgs& a, cudaStream_t s) {
  switch (H) {
    case 16: return launch<T, 16>(a, s);
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 96: return launch<T, 96>(a, s);
    case 128: return launch<T, 128>(a, s);
    case 256: return launch<T, 256>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,N,H), k and v (B,T,N,H), o (B,S,N,H), all of one dtype (fp32, or
// bf16 when is_bf16), addressed through the given strides (in elements).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16,
    int B, int N, int S, int T, int H,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    long long o_sb, long long o_ss, long long o_sn,
    float scale, int causal, int window, float softcap, void* stream) {
  const FlashArgs a{q, k, v, o, B, N, S, T,
                    q_sb, q_ss, q_sn, k_sb, k_ss, k_sn,
                    v_sb, v_ss, v_sn, o_sb, o_ss, o_sn,
                    scale, causal, window, softcap};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? dispatch_head_dim<__nv_bfloat16>(H, a, s)
                       : dispatch_head_dim<float>(H, a, s));
}

extern "C" const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
