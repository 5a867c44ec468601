// Symmetric int8 block codec for client updates, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   kernels/grad_quant/kernel.py::quantize_blocks   (_quant_kernel)
//   kernels/grad_quant/kernel.py::dequantize_blocks (_dequant_kernel)
// Each 2048-wide row of the flattened tensor gets one fp32 scale:
//   amax = max(max|x|, 1e-12), scale = amax / 127,
//   q = clip(round_half_even(x / scale), -127, 127),
// and dequantization is q * scale.
//
// The result must equal the reference bit for bit, because the bytes the
// comms subsystem bills are these bytes. So both divisions are IEEE
// round-to-nearest (__fdiv_rn) and rounding is rintf (half to even, as
// jnp.round); the library must be built without --use_fast_math.
//
// Bound: device memory. Quantize reads 4 bytes and writes 1 byte per
// element plus 4 bytes per row; dequantize the reverse. There is no
// reuse, so the design is one block per row, each value loaded once into
// a register, a block-wide max in shared memory, and one store per value.
// The ragged tail (n not a multiple of 2048) is read as zeros inside the
// kernel, so the wrapper never copies the input to pad it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 2048;                 // must equal ops.BLOCK
constexpr int kThreads = 256;
constexpr int kPerThread = kBlock / kThreads;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, long long n) {
  __shared__ float red[kThreads / 32];
  const long long base = (long long)blockIdx.x * kBlock;
  float vals[kPerThread];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + threadIdx.x + j * kThreads;
    vals[j] = i < n ? x[i] : 0.f;
    amax = fmaxf(amax, fabsf(vals[j]));
  }
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kThreads / 32 ? red[threadIdx.x] : 0.f;
    v = warp_max(v);
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  amax = fmaxf(red[0], 1e-12f);
  const float scale = __fdiv_rn(amax, 127.0f);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const float r = rintf(__fdiv_rn(vals[j], scale));
    q[base + threadIdx.x + j * kThreads] =
        (int8_t)fminf(fmaxf(r, -127.f), 127.f);
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ out,
                  long long n) {
  const long long base = (long long)blockIdx.x * kBlock;
  const float scale = scales[blockIdx.x];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + threadIdx.x + j * kThreads;
    if (i < n) out[i] = (float)q[i] * scale;
  }
}

}  // namespace

// x: n fp32 values; q: nb*2048 int8; scales: nb fp32; nb = max(ceil(n/2048), 1).
extern "C" int grad_quant_quantize(const float* x, int8_t* q, float* scales,
                                   long long n, long long nb, void* stream) {
  quantize_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      x, q, scales, n);
  return (int)cudaGetLastError();
}

// q: nb*2048 int8; scales: nb fp32; out: the first n fp32 values.
extern "C" int grad_quant_dequantize(const int8_t* q, const float* scales,
                                     float* out, long long n, long long nb,
                                     void* stream) {
  dequantize_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      q, scales, out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* grad_quant_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
