// Greedy non-maximum suppression over boxes already sorted, as a bitmask
// NMS hand-written for Hopper (sm_90a).  Plain C interface, loaded
// through ctypes by mxnet_tpu_torch/kernels/__init__.py and reached
// through the mxnet_tpu_torch::nms custom op of mxnet_tpu_torch/ops/ssd.py.
//
// Replaces no Pallas kernel: the JAX package runs this loop as a
// lax.fori_loop inside its jit program, three times over:
//   MultiBoxDetection  mxnet_tpu/ops/ssd_jax.py:216-228   (iou >= t)
//   box_nms            mxnet_tpu/ops/contrib_ops.py:91-95 (iou >  t)
//   Proposal           mxnet_tpu/ops/ssd_jax.py:301-311   (iou >  t, +1)
// A torch.compile'd graph cannot hold such a loop (unrolled, Proposal's is
// 6000 steps), so the port gives the loop a kernel of its own.
//
// What it computes, for each image b: keep starts as alive[b]; for
// i = 0..n-1 in order, if keep[i], every j > i with the same class as i
// (when class-aware) and IoU(i, j) >= t (inclusive) or > t is cleared.
// IoU is the corner IoU with the union floored at 1e-12, or with plus_one
// the +1 pixel-box convention ((x2-x1+1)(y2-y1+1), no floor).
//
// Design, two phases a pass:
//  1. nms_mask_kernel, all SMs: a block per (image, 64-box row block,
//     64-box column block at or after it) stages the column block's boxes
//     in shared memory; each thread computes row i's 64-bit word, bit j
//     set where j > i, the class matches (class-aware) and the IoU passes
//     the threshold.  That is every decision the greedy pass could make,
//     independent of which boxes survive.
//  2. nms_walk_kernel, a block an image: the removed bits (one per box,
//     ~alive at the start) live in shared memory.  For each chunk of 64
//     candidates every thread resolves the chunk's keep bits from its
//     removed word and the chunk's diagonal mask words (a loop over the
//     kept boxes only, read from shared memory), then the threads OR the
//     kept rows' words into the removed bits of the later chunks, while
//     64 of them stage the next chunk's diagonal words: one barrier a
//     chunk, not one a kept box.
// The mask takes B rows x ceil(n/64) words a row.  The wrapper caps it: a
// call whose mask is larger runs in passes over row ranges [r0, r1) (the
// mask of those rows against every later column, then the walk over
// those rows, the removed bits carried between passes in device memory).
// Passes change no result.  One call makes 2 launches a pass: 2 when the
// mask fits under the cap (98 MB at n = 27,976, batch 1).
//
// Bound: operations and latency, not bytes.  Phase 1 is n^2 / 2 IoUs at
// most (391 M at n = 27,976), all SMs in parallel; phase 2 is ceil(n/64)
// dependent steps (438 at n = 27,976), each one shared-memory resolve and
// one round of global loads; the bytes are the boxes once (16 B a box),
// the masks and the mask words the walk reads.
//
// Rounding: the IoU is computed with __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn, so nvcc cannot contract a*b+c into an FMA, and each value
// rounds as the plain PyTorch version (one op at a time) rounds it, with
// box i as the first argument: a tie at the threshold decides as it does
// there.  A zero intersection over a positive union is 0 without the
// division (the same comparison either way).  (A quotient by __fdividef
// that decided the pairs far from the threshold, leaving the rounded
// division to the rest, was tried and made the mask kernel slower.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBox = 64;           // boxes a row / column block, bits a word
constexpr int kWalkThreads = 512;
constexpr int kLoads = 8;          // mask words a walk thread loads at once

__device__ __forceinline__ float area_of(float4 a, int plus_one) {
  return plus_one ? __fmul_rn(__fadd_rn(__fsub_rn(a.z, a.x), 1.0f),
                              __fadd_rn(__fsub_rn(a.w, a.y), 1.0f))
                  : __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

// IoU(a, b), box i first as the plain version takes it; area_b is b's
// area_of, computed once a column box
__device__ __forceinline__ float iou_of(float4 a, float area_a, float4 b,
                                        float area_b, int plus_one) {
  const float tlx = fmaxf(a.x, b.x), tly = fmaxf(a.y, b.y);
  const float brx = fminf(a.z, b.z), bry = fminf(a.w, b.w);
  float w = __fsub_rn(brx, tlx), h = __fsub_rn(bry, tly);
  if (plus_one) {
    w = __fadd_rn(w, 1.0f);
    h = __fadd_rn(h, 1.0f);
  }
  const float inter = __fmul_rn(fmaxf(w, 0.0f), fmaxf(h, 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float den = plus_one ? uni : fmaxf(uni, 1e-12f);
  if (inter == 0.0f && den > 0.0f) return 0.0f;
  return __fdiv_rn(inter, den);
}

// grid (column block, row block of this pass, image); 64 threads, one row
// each.  mask rows are this pass's rows, ceil(n/64) words a row; words of
// column blocks before the row block are neither written nor read.
__global__ void __launch_bounds__(kBox)
nms_mask_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ ids, uint64_t* __restrict__ mask,
                int n, int nb, int r0, int rows, float thresh,
                int class_aware, int inclusive, int plus_one) {
  const int cb = blockIdx.x;
  const int rb = r0 / kBox + blockIdx.y;
  if (cb < rb) return;
  __shared__ float4 cbox[kBox];
  __shared__ float carea[kBox];
  __shared__ float cid[kBox];
  const long long base = static_cast<long long>(blockIdx.z) * n;
  const int t = threadIdx.x;
  const int col0 = cb * kBox;
  const int ncols = min(kBox, n - col0);
  if (t < ncols) {
    cbox[t] = boxes[base + col0 + t];
    carea[t] = area_of(cbox[t], plus_one);
    cid[t] = ids[base + col0 + t];
  }
  __syncthreads();
  const int i = rb * kBox + t;
  if (i >= n || i - r0 >= rows) return;
  const float4 a = boxes[base + i];
  const float area_a = area_of(a, plus_one);
  const float cls = ids[base + i];
  uint64_t bits = 0;
  for (int j = (cb == rb) ? t + 1 : 0; j < ncols; ++j) {
    if (class_aware && cid[j] != cls) continue;
    const float iou = iou_of(a, area_a, cbox[j], carea[j], plus_one);
    if (inclusive ? iou >= thresh : iou > thresh) bits |= 1ull << j;
  }
  mask[(static_cast<long long>(blockIdx.z) * rows + (i - r0)) * nb + cb] =
      bits;
}

// one block an image; nb words of dynamic shared memory.  first: the
// removed bits start as ~alive; else they come from removed_g.  last:
// write keep = ~removed; else store the removed bits to removed_g.
__global__ void __launch_bounds__(kWalkThreads)
nms_walk_kernel(const uint64_t* __restrict__ mask,
                uint64_t* __restrict__ removed_g,
                const uint8_t* __restrict__ alive,
                uint8_t* __restrict__ keep, int n, int nb, int r0, int rows,
                int first, int last) {
  extern __shared__ uint64_t removed[];
  __shared__ uint64_t diag[2][kBox];
  const int b = blockIdx.x;
  const long long base = static_cast<long long>(b) * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (first) {
    uint32_t* half = reinterpret_cast<uint32_t*>(removed);
    for (int w32 = tid >> 5; w32 < 2 * nb; w32 += kWalkThreads >> 5) {
      const int i = w32 * 32 + lane;
      const bool dead = i >= n || !alive[base + i];
      const uint32_t bits = __ballot_sync(0xffffffffu, dead);
      if (lane == 0) half[w32] = bits;   // little-endian halves of a word
    }
  } else {
    for (int w = tid; w < nb; w += kWalkThreads)
      removed[w] = removed_g[static_cast<long long>(b) * nb + w];
  }
  const uint64_t* rowmask = mask + static_cast<long long>(b) * rows * nb;
  const int c0 = r0 / kBox;
  const int c1 = (r0 + rows + kBox - 1) / kBox;   // one past the last chunk
  if (tid < kBox) {
    const int r = tid;
    diag[c0 & 1][tid] = (r < rows) ? rowmask[static_cast<long long>(r) * nb
                                             + c0] : 0;
  }
  __syncthreads();
  uint64_t prev = 0;
  for (int c = c0; c < c1; ++c) {
    // every thread resolves chunk c alike: only the kept boxes loop
    uint64_t rem = removed[c];
    uint64_t kept = 0;
    uint64_t todo = ~rem;
    while (todo) {
      const int t = __ffsll(static_cast<long long>(todo)) - 1;
      kept |= 1ull << t;
      rem |= diag[c & 1][t];
      todo = (t == kBox - 1) ? 0 : (~rem & (~0ull << (t + 1)));
    }
    if (tid == 0 && c > c0) removed[c - 1] = prev;  // no thread reads it now
    prev = rem;
    // stage the next chunk's diagonal words
    if (c + 1 < c1 && tid < kBox) {
      const int r = (c + 1) * kBox + tid - r0;
      diag[(c + 1) & 1][tid] =
          (r < rows) ? rowmask[static_cast<long long>(r) * nb + c + 1] : 0;
    }
    // the kept rows' words into the later chunks' removed bits
    if (kept) {
      const uint64_t* rows_c = rowmask + static_cast<long long>(c * kBox - r0)
                                             * nb;
      for (int w = c + 1 + tid; w < nb; w += kWalkThreads) {
        uint64_t acc = 0, bits = kept;
        while (bits) {                   // 8 independent loads a round
          uint64_t v[kLoads];
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            v[u] = 0;
            if (bits) {
              const int t = __ffsll(static_cast<long long>(bits)) - 1;
              bits &= bits - 1;
              v[u] = rows_c[static_cast<long long>(t) * nb + w];
            }
          }
#pragma unroll
          for (int u = 0; u < kLoads; ++u) acc |= v[u];
        }
        removed[w] |= acc;
      }
    }
    __syncthreads();
  }
  if (tid == 0 && c1 > c0) removed[c1 - 1] = prev;
  __syncthreads();
  if (last) {
    for (int i = tid; i < n; i += kWalkThreads)
      keep[base + i] = !((removed[i / kBox] >> (i % kBox)) & 1);
  } else {
    for (int w = tid; w < nb; w += kWalkThreads)
      removed_g[static_cast<long long>(b) * nb + w] = removed[w];
  }
}

}  // namespace

extern "C" {

// boxes (batch, n, 4) f32 corners, 16-byte aligned; ids (batch, n) f32;
// alive and keep (batch, n) bytes (0/1); mask (batch, rows_per_pass,
// ceil(n/64)) and removed (batch, ceil(n/64)) 64-bit words of workspace.
// rows_per_pass is a multiple of 64; the call makes two launches for each
// pass over rows_per_pass rows.  Returns the cudaGetLastError() code of
// the first launch that failed (0 = cudaSuccess).
int mxtt_nms(const void* boxes, const void* ids, const void* alive,
             void* keep, void* mask, void* removed, int batch, int n,
             int rows_per_pass, float thresh, int class_aware, int inclusive,
             int plus_one, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int nb = (n + kBox - 1) / kBox;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int r0 = 0; r0 < n; r0 += rows_per_pass) {
    const int rows = n - r0 < rows_per_pass ? n - r0 : rows_per_pass;
    dim3 grid(nb, (rows + kBox - 1) / kBox, batch);
    nms_mask_kernel<<<grid, kBox, 0, s>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(ids),
        static_cast<uint64_t*>(mask), n, nb, r0, rows, thresh, class_aware,
        inclusive, plus_one);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    nms_walk_kernel<<<batch, kWalkThreads, nb * sizeof(uint64_t), s>>>(
        static_cast<const uint64_t*>(mask), static_cast<uint64_t*>(removed),
        static_cast<const uint8_t*>(alive), static_cast<uint8_t*>(keep), n,
        nb, r0, rows, r0 == 0, r0 + rows >= n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
