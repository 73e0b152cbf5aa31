// Greedy non-maximum suppression over boxes already sorted, hand-written
// for Hopper (sm_90a).  Plain C interface, loaded through ctypes by
// mxnet_tpu_torch/kernels/__init__.py and reached through the
// mxnet_tpu_torch::nms custom op of mxnet_tpu_torch/ops/ssd.py.
//
// Replaces no Pallas kernel: the JAX package runs this loop as a
// lax.fori_loop inside its jit program, three times over:
//   MultiBoxDetection  mxnet_tpu/ops/ssd_jax.py:216-228   (iou >= t)
//   box_nms            mxnet_tpu/ops/contrib_ops.py:91-95 (iou >  t)
//   Proposal           mxnet_tpu/ops/ssd_jax.py:301-311   (iou >  t, +1)
// A torch.compile'd graph cannot hold such a loop (unrolled, Proposal's is
// 6000 steps), so the port gives the loop a kernel of its own.
//
// What it computes, for each image b (one block each): keep starts as
// alive[b]; for i = 0..n-1 in order, if keep[i], every j > i with
// keep[j], the same class as i (when class-aware) and IoU(i, j) >= t
// (inclusive) or > t is cleared.  IoU is the corner IoU with the union
// floored at 1e-12, or with plus_one the +1 pixel-box convention
// ((x2-x1+1)(y2-y1+1), no floor).
//
// Design: the keep mask lives in shared memory (n bytes); the block walks
// i serially and suppresses the j > i in parallel, one j per thread.  A
// barrier follows each i that was kept; an i already cleared skips both
// the sweep and the barrier (keep[i] was last written before a barrier,
// so every thread reads the same value).  Boxes are read as float4 from
// device memory (L1/L2 serve the repeats).
//
// Bound: operations and latency, not bytes.  The sweep is O(n^2 / 2)
// IoUs in the worst case, with n serial steps whose barriers dominate
// small n; the bytes are the boxes once (16 B a box) and the masks.
//
// Rounding: the IoU is computed with __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn, so nvcc cannot contract a*b+c into an FMA, and each value
// rounds as the plain PyTorch version (one op at a time) rounds it: a
// tie at the threshold decides as it does there.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float iou_of(float4 a, float area_a, float4 b,
                                        int plus_one) {
  const float tlx = fmaxf(a.x, b.x), tly = fmaxf(a.y, b.y);
  const float brx = fminf(a.z, b.z), bry = fminf(a.w, b.w);
  float w = __fsub_rn(brx, tlx), h = __fsub_rn(bry, tly);
  float area_b;
  if (plus_one) {
    w = __fadd_rn(w, 1.0f);
    h = __fadd_rn(h, 1.0f);
    area_b = __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                       __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
  } else {
    area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  }
  const float inter = __fmul_rn(fmaxf(w, 0.0f), fmaxf(h, 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, plus_one ? uni : fmaxf(uni, 1e-12f));
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ ids,
           const uint8_t* __restrict__ alive, uint8_t* __restrict__ keep_out,
           int n, float thresh, int class_aware, int inclusive,
           int plus_one) {
  extern __shared__ uint8_t keep[];
  const long long base = static_cast<long long>(blockIdx.x) * n;
  const float4* bx = boxes + base;
  const float* id = ids + base;
  for (int j = threadIdx.x; j < n; j += blockDim.x) keep[j] = alive[base + j];
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    if (!keep[i]) continue;            // the same value in every thread
    const float4 a = bx[i];
    const float area_a =
        plus_one ? __fmul_rn(__fadd_rn(__fsub_rn(a.z, a.x), 1.0f),
                             __fadd_rn(__fsub_rn(a.w, a.y), 1.0f))
                 : __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
    const float cls = id[i];
    for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x) {
      if (!keep[j] || (class_aware && id[j] != cls)) continue;
      const float iou = iou_of(a, area_a, bx[j], plus_one);
      if (inclusive ? iou >= thresh : iou > thresh) keep[j] = 0;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    keep_out[base + j] = keep[j];
}

}  // namespace

extern "C" {

// boxes (batch, n, 4) f32 corners, 16-byte aligned; ids (batch, n) f32;
// alive and keep (batch, n) bytes (0/1).  One block per image, n bytes of
// dynamic shared memory.  Returns the cudaGetLastError() code of the
// launch (0 = cudaSuccess).
int mxtt_nms(const void* boxes, const void* ids, const void* alive,
             void* keep, int batch, int n, float thresh, int class_aware,
             int inclusive, int plus_one, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const size_t smem = static_cast<size_t>(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(ids),
      static_cast<const uint8_t*>(alive), static_cast<uint8_t*>(keep), n,
      thresh, class_aware, inclusive, plus_one);
  return static_cast<int>(cudaGetLastError());
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
