// 2-bit gradient compression with error feedback, hand-written for Hopper
// (sm_90a).  Plain C interface, loaded through ctypes by
// mxnet_tpu_torch/kernels/__init__.py.
//
// Replaces the Pallas kernels of mxnet_tpu/contrib/compression.py:
//   quantize_2bit_kernel   <- _quantize_kernel   (compression.py:50)
//   dequantize_2bit_kernel <- _dequantize_kernel (compression.py:68)
//
// Layout (the TPU one, kept bit for bit so packets interoperate): the
// gradient is a zero-padded (rows, 128) f32 array, rows a multiple of
// 128.  Packed word (r, l) of the (rows/16, 128) int32 code array holds
// the codes of elements (16r + j, l), j = 0..15, at bits 2j..2j+1
// (01 = +t, 10 = -t, 00 = 0).  On the TPU that folded 16 sublanes of a
// (128, 128) tile into one (8, 128) code block; here it means one thread
// per word walks a column of 16 elements 128 floats apart.
//
// Bound: bytes.  Quantize reads grad and residual and writes the residual
// and the codes: 12.25 B per padded element.  Dequantize reads 0.25 B and
// writes 4 B per padded element.  Neither does more than a few operations per byte, so
// the design only has to keep every access coalesced: neighbouring
// threads take neighbouring lanes l, so each of the 16 loads and stores
// of a warp covers 128 contiguous bytes.  No shared memory, no atomics.
//
// Arithmetic is bit-exact with the JAX kernel: g = grad + residual;
// new residual = (g - (pos ? t : 0)) + (neg ? t : 0) in f32, in that
// order, t being the f32 of the threshold.  No multiplication is
// involved, so no FMA contraction can change a result.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kGroup = 16;
constexpr int kThreads = 256;

__global__ void quantize_2bit_kernel(const float* __restrict__ grad,
                                     const float* __restrict__ residual,
                                     int32_t* __restrict__ codes,
                                     float* __restrict__ new_residual,
                                     long long n_words, float t) {
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (w >= n_words) return;
  const long long row = w / kLanes;
  const long long lane = w - row * kLanes;
  const long long base = row * kGroup * kLanes + lane;
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const long long i = base + static_cast<long long>(j) * kLanes;
    const float g = grad[i] + residual[i];
    const bool pos = g >= t;
    const bool neg = g <= -t;
    new_residual[i] = (g - (pos ? t : 0.0f)) + (neg ? t : 0.0f);
    const uint32_t code = (pos ? 1u : 0u) | (neg ? 2u : 0u);
    word |= code << (2 * j);
  }
  codes[w] = static_cast<int32_t>(word);
}

__global__ void dequantize_2bit_kernel(const int32_t* __restrict__ codes,
                                       float* __restrict__ out,
                                       long long n_words, float t) {
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (w >= n_words) return;
  const long long row = w / kLanes;
  const long long lane = w - row * kLanes;
  const long long base = row * kGroup * kLanes + lane;
  // logical shifts on the unsigned word: bit 31 is data, not a sign
  const uint32_t word = static_cast<uint32_t>(codes[w]);
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const uint32_t code = (word >> (2 * j)) & 3u;
    out[base + static_cast<long long>(j) * kLanes] =
        code == 1u ? t : (code == 2u ? -t : 0.0f);
  }
}

unsigned int blocks_for(long long n_words) {
  return static_cast<unsigned int>((n_words + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the
// cudaGetLastError() code of the launch (0 = cudaSuccess).
int mxtt_quantize_2bit(const float* grad, const float* residual,
                       int32_t* codes, float* new_residual,
                       long long n_words, float threshold,
                       cudaStream_t stream) {
  if (n_words <= 0) return 0;
  quantize_2bit_kernel<<<blocks_for(n_words), kThreads, 0, stream>>>(
      grad, residual, codes, new_residual, n_words, threshold);
  return static_cast<int>(cudaGetLastError());
}

int mxtt_dequantize_2bit(const int32_t* codes, float* out,
                         long long n_words, float threshold,
                         cudaStream_t stream) {
  if (n_words <= 0) return 0;
  dequantize_2bit_kernel<<<blocks_for(n_words), kThreads, 0, stream>>>(
      codes, out, n_words, threshold);
  return static_cast<int>(cudaGetLastError());
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
