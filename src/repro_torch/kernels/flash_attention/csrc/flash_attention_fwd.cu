// Flash-attention forward on the CUDA cores (sm_90a): the fp32 route.
// Causal attention with an optional sliding window and an optional tanh
// softcap, online softmax.
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/flash_attention/kernel.py::flash_attention_bnh (_flash_kernel)
// for fp32 q, k, v; bf16 goes to flash_attention_fwd_sm90.cu, on the
// tensor cores. Same function: fp32 scores scaled by 1/sqrt(H), softcap *
// tanh(s / softcap), masked entries set to -1e30, running max /
// denominator / accumulator in fp32, denominator clamped at 1e-30.
//
// Why fp32 stays here: the fp32 route is held to its plain version at
// 2e-5, and the tensor cores take fp32 only as TF32, whose 10-bit
// mantissa could not meet that bar. So every product runs on the fp32
// CUDA cores (67 TFLOP/s), which bound it by operations. The SMOKE
// configurations and the tests run attention in fp32; the full-size
// models run it in bf16.
//
// Design. One block of 256 threads per (batch*head, 64-query tile); four
// neighbouring threads share one query row. Each holds a quarter of the
// row's q and output accumulator in registers, in runs of V elements
// (thread j of the four owns elements 4Vg + Vj + c), so it reads a key or
// value row of the shared-memory tile as V-float vectors: one load feeds
// V FMAs, the four threads read 4V contiguous floats that the warp's
// eight rows share as a broadcast, and the four partial dot products meet
// in two warp shuffles. V is 4 (float4) where H is a multiple of 16, and
// 2 (float2) for H = 8, the head dim of the SMOKE configurations with
// d_model 64 over 8 heads: there each thread holds two elements. Key and value tiles of 32 rows are staged in shared memory
// as fp32, one tile at a time; with 32-row tiles a thread's scores, q and
// accumulator fit in 128 registers for H <= 128, so two blocks share an
// SM. q, k, v and o are read through their (B, S, N, H) strides, so no
// fold or transpose copy is needed. Any S and T are taken: the ragged edge
// is masked. Key tiles wholly above the diagonal or wholly outside the
// window are skipped: they would add exactly zero to the row, because a
// masked score's weight is exp(-1e30 - max) = 0 once the row has seen an
// unmasked key, and the weights of keys seen before that are multiplied by
// exp(-1e30 - max) = 0.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kLanes = 4;                    // threads per query row
constexpr int kThreads = kBlockQ * kLanes;

// floats per shared-memory read: a float4 where H allows, else a float2
template <int H>
constexpr int kVecWidth = H % (kLanes * 4) == 0 ? 4 : 2;

template <int V> struct VecType;
template <> struct VecType<4> { using type = float4; };
template <> struct VecType<2> { using type = float2; };

// V consecutive floats of shared memory, in one vector load
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[V]) {
  const typename VecType<V>::type t =
      *reinterpret_cast<const typename VecType<V>::type*>(p);
  const float* f = reinterpret_cast<const float*>(&t);
#pragma unroll
  for (int c = 0; c < V; ++c) out[c] = f[c];
}

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

template <int H>
__global__ void __launch_bounds__(kThreads, H <= 128 ? 2 : 1)
flash_fwd_kernel(const FlashArgs a) {
  constexpr int kVec = kVecWidth<H>;
  static_assert(H % (kLanes * kVec) == 0, "H must be a multiple of 8");
  constexpr int G = H / (kLanes * kVec);     // vector runs per thread
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [kBlockK][H]
  float* vs = smem + kBlockK * H;            // [kBlockK][H]

  const int bn = blockIdx.y;
  const int b = bn / a.N, n = bn % a.N;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int qpos = q0 + row;
  const bool q_valid = qpos < a.S;

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + n * a.q_sn;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + n * a.k_sn;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + n * a.v_sn;

  // this thread's elements of the row: 4 kVec g + kVec lane + c
  float qr[G][kVec], acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const int d = g * kLanes * kVec + lane * kVec + c;
      qr[g][c] = q_valid ? qp[qpos * a.q_ss + d] : 0.f;
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
      ks[idx] = ok ? kp[kpos * a.k_ss + d] : 0.f;
      vs[idx] = ok ? vp[kpos * a.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float* krow = ks + kk * H;
      float part[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) part[c] = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float kv[kVec];
        load_vec<kVec>(krow + (g * kLanes + lane) * kVec, kv);
#pragma unroll
        for (int c = 0; c < kVec; ++c) part[c] = fmaf(qr[g][c], kv[c], part[c]);
      }
      float dot;
      if constexpr (kVec == 4)
        dot = (part[0] + part[1]) + (part[2] + part[3]);
      else
        dot = part[0] + part[1];
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
      const float* vrow = vs + kk * H;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float vv[kVec];
        load_vec<kVec>(vrow + (g * kLanes + lane) * kVec, vv);
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[g][c] = fmaf(p, vv[c], acc[g][c]);
      }
    }
    l = alpha * l + psum;
    m = m_new;
  }

  if (q_valid) {
    const float denom = fmaxf(l, 1e-30f);
    float* op = static_cast<float*>(a.o) + b * a.o_sb + qpos * a.o_ss
                + n * a.o_sn;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        op[g * kLanes * kVec + lane * kVec + c] = acc[g][c] / denom;
  }
}

template <int H>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  const int smem = 2 * kBlockK * H * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.B * a.N);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B,S,N,H), k and v (B,T,N,H), o (B,S,N,H), all fp32, addressed
// through the given strides (in elements).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
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
  switch (H) {
    case 8: return (int)launch<8>(a, s);
    case 16: return (int)launch<16>(a, s);
    case 32: return (int)launch<32>(a, s);
    case 64: return (int)launch<64>(a, s);
    case 96: return (int)launch<96>(a, s);
    case 128: return (int)launch<128>(a, s);
    case 256: return (int)launch<256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
