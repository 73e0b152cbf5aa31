// 2-bit gradient compression with error feedback, hand-written for Hopper
// (sm_90a).  Plain C interface, loaded through ctypes by
// mxnet_tpu_torch/kernels/__init__.py.
//
// Replaces the Pallas kernels of mxnet_tpu/contrib/compression.py:
//   quantize_2bit_batch_kernel   <- _quantize_kernel   (compression.py:50)
//   dequantize_2bit_batch_kernel <- _dequantize_kernel (compression.py:68)
//
// One launch covers every entry (one per key and worker) of a KVStore
// push.  A small entry table in device memory says where each entry lies
// (struct Entry below; built by kernels.compression_table), followed by
// the entry of every tile.  Each entry keeps the TPU's per-key code
// layout bit for bit, so codes interoperate with the JAX package key by
// key: its gradient counts as zero-padded to (rows, 128), rows a multiple
// of 128, and packed word (r, l) of its (rows/16, 128) int32 codes holds
// the codes of elements (16r + j, l), j = 0..15, at bits 2j..2j+1
// (01 = +t, 10 = -t, 00 = 0).  Padding never leaves device memory: an
// element at or past the entry's size reads as 0, which always gives
// code 00 and residual 0, so the residual and the dequantized values
// hold only the real elements.
//
// Bound: bytes.  Quantize reads the gradient and the residual and writes
// the residual, 12 B per real element, and writes 0.25 B of codes per
// padded element; dequantize reads the codes (0.25 B per padded element)
// and writes 4 B per real element.  Neither does more than a few
// operations per byte.  The design meets the bound by moving nothing
// else and keeping every access wide and coalesced:
// - one launch per push, not one per key (a resnet50_v1 step has 193
//   keys, most of them too small to fill the card in a launch of their
//   own), with one block per (128, 128) tile of some entry: ~1,700
//   blocks of 256 threads a resnet50_v1 step, enough to fill 132 SMs;
// - the gradient is read straight from the parameter's gradient buffer
//   and the padding is computed, not copied (no per-key pad pass);
// - each thread owns 4 adjacent lanes of one code row: 16 float4 loads
//   of gradient and residual, 16 float4 residual stores and one int4
//   code store, each warp instruction covering 512 contiguous bytes.
//   An entry whose gradient or residual is not 16-byte aligned
//   (Entry::vector 0), and the 4-lane group that the entry's size cuts,
//   take a scalar path for those elements.
// No shared memory, no atomics, no state between blocks; the residual
// may be updated in place (residual_in == residual_out), since the one
// thread that reads an element is the one that writes it.
//
// Arithmetic is bit-exact with the JAX kernel: g = grad + residual;
// new residual = (g - (pos ? t : 0)) + (neg ? t : 0) in f32, in that
// order, t being the f32 of the threshold.  No multiplication is
// involved, so no FMA contraction can change a result.  Shifts are on
// unsigned words: bit 31 is data, not a sign.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kGroup = 16;                   // codes per word
constexpr int kCodeRows = 8;                 // code rows per tile
constexpr int kVec = 4;                      // lanes per thread
constexpr int kThreads = kCodeRows * kLanes / kVec;   // 256

// One row of the entry table, 8 x int64 (kernels.COMPRESSION_FIELDS).
struct Entry {
  long long grad;         // address of the flat f32 gradient
  long long size;         // real elements
  long long residual_in;  // offset of the residual read, in floats
  long long residual_out; // offset of the residual written, in floats
  long long codes;        // offset of the codes, in words
  long long values;       // offset of the dequantized values, in floats
  long long first_tile;   // the entry's first tile in the launch
  long long vector;       // 1: gradient and residual 16-byte aligned
};

struct Place {
  Entry e;
  long long row;    // the thread's code row within its entry
  long long base;   // element index of (16 row, lane0) in the entry
  int lane0;        // first of the thread's 4 lanes
};

__device__ __forceinline__ Place place(const Entry* entries,
                                       const int* tile_entry) {
  Place p;
  p.e = entries[tile_entry[blockIdx.x]];
  p.lane0 = (threadIdx.x % (kLanes / kVec)) * kVec;
  p.row = (static_cast<long long>(blockIdx.x) - p.e.first_tile) * kCodeRows +
          threadIdx.x / (kLanes / kVec);
  p.base = p.row * kGroup * kLanes + p.lane0;
  return p;
}

__device__ __forceinline__ uint32_t quantize_one(float grad, float res,
                                                 float t, float* new_res) {
  const float g = grad + res;
  const bool pos = g >= t;
  const bool neg = g <= -t;
  *new_res = (g - (pos ? t : 0.0f)) + (neg ? t : 0.0f);
  return (pos ? 1u : 0u) | (neg ? 2u : 0u);
}

// 4 adjacent elements at i, 16-byte accesses; their codes go to bit
// pair j of w[0..3]
__device__ __forceinline__ void quantize4(const float* grad, const float* rin,
                                          float* rout, long long i, int j,
                                          float t, uint32_t* w) {
  const float4 g = *reinterpret_cast<const float4*>(grad + i);
  const float4 r = *reinterpret_cast<const float4*>(rin + i);
  float4 nr;
  w[0] |= quantize_one(g.x, r.x, t, &nr.x) << (2 * j);
  w[1] |= quantize_one(g.y, r.y, t, &nr.y) << (2 * j);
  w[2] |= quantize_one(g.z, r.z, t, &nr.z) << (2 * j);
  w[3] |= quantize_one(g.w, r.w, t, &nr.w) << (2 * j);
  *reinterpret_cast<float4*>(rout + i) = nr;
}

__device__ __forceinline__ float dequantize_one(uint32_t word, int j,
                                                float t) {
  const uint32_t code = (word >> (2 * j)) & 3u;
  return code == 1u ? t : (code == 2u ? -t : 0.0f);
}

__device__ __forceinline__ float4 dequantize4(const uint32_t* w, int j,
                                              float t) {
  return make_float4(dequantize_one(w[0], j, t), dequantize_one(w[1], j, t),
                     dequantize_one(w[2], j, t), dequantize_one(w[3], j, t));
}

__global__ void __launch_bounds__(kThreads)
quantize_2bit_batch_kernel(const Entry* __restrict__ entries,
                           const int* __restrict__ tile_entry,
                           const float* residual_in, float* residual_out,
                           int32_t* __restrict__ codes, float t) {
  const Place p = place(entries, tile_entry);
  const float* grad = reinterpret_cast<const float*>(p.e.grad);
  const float* rin = residual_in + p.e.residual_in;
  float* rout = residual_out + p.e.residual_out;
  const long long size = p.e.size;
  uint32_t w[kVec] = {0u, 0u, 0u, 0u};
  if (p.e.vector && p.base + (kGroup - 1) * kLanes + kVec <= size) {
    // the whole column of 16 x 4 elements is real and aligned
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      quantize4(grad, rin, rout, p.base + j * kLanes, j, t, w);
    }
  } else {
    // the column the entry's size cuts, an unaligned entry, or padding
    for (int j = 0; j < kGroup; ++j) {
      const long long i = p.base + j * kLanes;
      if (i >= size) break;  // every later element is padding
      if (p.e.vector && i + kVec <= size) {
        quantize4(grad, rin, rout, i, j, t, w);
      } else {
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
          if (i + q < size) {
            float nr;
            w[q] |= quantize_one(grad[i + q], rin[i + q], t, &nr) << (2 * j);
            rout[i + q] = nr;
          }
        }
      }
    }
  }
  // every word is written, the ones wholly in padding as 0
  *reinterpret_cast<int4*>(codes + p.e.codes + p.row * kLanes + p.lane0) =
      make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                static_cast<int>(w[2]), static_cast<int>(w[3]));
}

__global__ void __launch_bounds__(kThreads)
dequantize_2bit_batch_kernel(const Entry* __restrict__ entries,
                             const int* __restrict__ tile_entry,
                             const int32_t* __restrict__ codes,
                             float* __restrict__ out, float t,
                             int vector_codes) {
  const Place p = place(entries, tile_entry);
  const long long size = p.e.size;
  if (p.base >= size) return;  // the column is padding: nothing to write
  const int32_t* c = codes + p.e.codes + p.row * kLanes + p.lane0;
  uint32_t w[kVec];
  if (vector_codes) {
    const int4 v = *reinterpret_cast<const int4*>(c);
    w[0] = static_cast<uint32_t>(v.x);
    w[1] = static_cast<uint32_t>(v.y);
    w[2] = static_cast<uint32_t>(v.z);
    w[3] = static_cast<uint32_t>(v.w);
  } else {
#pragma unroll
    for (int q = 0; q < kVec; ++q) w[q] = static_cast<uint32_t>(c[q]);
  }
  // values offsets are multiples of 4 floats and the buffer is fresh, so
  // every whole 4-lane group is a 16-byte aligned store
  float* o = out + p.e.values;
  if (p.base + (kGroup - 1) * kLanes + kVec <= size) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const long long i = p.base + j * kLanes;
      *reinterpret_cast<float4*>(o + i) = dequantize4(w, j, t);
    }
  } else {
    for (int j = 0; j < kGroup; ++j) {
      const long long i = p.base + j * kLanes;
      if (i >= size) break;
      if (i + kVec <= size) {
        *reinterpret_cast<float4*>(o + i) = dequantize4(w, j, t);
      } else {
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
          if (i + q < size) o[i + q] = dequantize_one(w[q], j, t);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// `table` is the device copy of the entry table: n_entries Entry rows,
// then n_tiles int32 tile -> entry indices.  Each launcher enqueues one
// kernel on `stream` and returns the cudaGetLastError() code of the
// launch (0 = cudaSuccess).
int mxtt_quantize_2bit_batch(const void* table, long long n_entries,
                             long long n_tiles, const float* residual_in,
                             float* residual_out, int32_t* codes,
                             float threshold, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  const Entry* entries = static_cast<const Entry*>(table);
  quantize_2bit_batch_kernel<<<static_cast<unsigned int>(n_tiles), kThreads,
                               0, stream>>>(
      entries, reinterpret_cast<const int*>(entries + n_entries),
      residual_in, residual_out, codes, threshold);
  return static_cast<int>(cudaGetLastError());
}

int mxtt_dequantize_2bit_batch(const void* table, long long n_entries,
                               long long n_tiles, const int32_t* codes,
                               float* out, float threshold, int vector_codes,
                               cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  const Entry* entries = static_cast<const Entry*>(table);
  dequantize_2bit_batch_kernel<<<static_cast<unsigned int>(n_tiles),
                                 kThreads, 0, stream>>>(
      entries, reinterpret_cast<const int*>(entries + n_entries), codes, out,
      threshold, vector_codes);
  return static_cast<int>(cudaGetLastError());
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
