// int8 x int8 -> int32 convolution (NCHW data, OIHW weights, stride, pad,
// dilation, groups) as an implicit GEMM on Hopper's tensor cores
// (sm_90a, mma.sync.aligned.m16n8k32 s8.s8.s32).  Plain C interface,
// loaded through ctypes by mxnet_tpu_torch/kernels/__init__.py and
// reached through the mxnet_tpu_torch::int8_conv custom op of
// mxnet_tpu_torch/ops/quantization.py.
//
// Replaces no Pallas kernel: the JAX package leaves
//   _quantized_conv  mxnet_tpu/contrib/quantization.py:352-378
//   (lax.conv_general_dilated(..., preferred_element_type=jnp.int32))
//   _quantized_fc    mxnet_tpu/contrib/quantization.py:332-349
// to XLA's int8 convolution and dot.  PyTorch on CUDA has no int8
// convolution with int32 accumulation, and an f32 one is not exact once
// 127^2 K passes 2^24 (K 2304 gives 3.7e7), so the port writes its own.
// The fully connected case runs here as a 1x1 convolution of a 1x1 map.
//
// GEMM view, per group: rows m = (image, out y, out x), M = N Ho Wo;
// columns f = the group's filters, Fg; depth k = (channel, ky, kx),
// Kg = Cg KH KW.  The weights arrive as (F, Kp) int8 rows, Kp = Kg
// rounded up to 32 with zeros (the wrapper pads them: conv1_1's Kg is 27),
// so a k-tile of 32 is one mma's depth.  The data are gathered per
// k-tile straight from the NCHW int8 input (im2col on the fly, padding
// and the k >= Kg tail read as 0), through a 32-entry table of
// (channel offset, ky*dy, kx*dx) the block builds for each k-tile.
//
// Tiles: a block of 4 warps computes 64 rows x 64 filters; each warp
// 32 x 32, as 2 x 4 m16n8k32 products per k-tile, 32 int32 accumulators
// a thread.  Shared rows are 48 bytes (32 + 16 padding), so the fragment
// loads (8 rows x 4 words a warp) hit 32 distinct banks.  A fully
// connected layer (a 1x1 map, 1x1 kernel, Cg a multiple of 16) loads its
// data rows as 16-byte vectors like the weights.
//
// Bound: at the SSD's layer shapes, bytes: conv1_2 at (32, 64, 300, 300)
// is 106 GMAC (0.11 ms at 1,979 TOP/s) against 0.18 GB of int8 read and
// 0.74 GB of int32 written (0.27 ms at 3.35 TB/s).  This first version
// is simple: no cp.async pipeline and no wgmma; the byte gathers of the
// data tile are its cost.
//
// Exact: int32 sums of int8 products, |sum| <= 127^2 K < 2^31 for any
// K below 133,000; the same bits as the plain version (an f64
// convolution rounded to int32) whatever the order of the sum.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;       // rows (output pixels) a block
constexpr int kBN = 64;       // filters a block
constexpr int kBK = 32;       // depth of one mma
constexpr int kRow = 48;      // bytes a shared row: 32 + 16 padding
constexpr int kThreads = 128;

struct Conv {
  int N, C, H, W;       // data
  int F, KH, KW;        // filters (all groups) and kernel
  int Ho, Wo;
  int sh, sw, ph, pw, dh, dw;
  int groups, Cg, Fg, Kg, Kp;
  int vector_rows;      // 1: data rows are contiguous int8 vectors (FC)
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ out, Conv p) {
  __shared__ __align__(16) uint8_t As[kBM * kRow];
  __shared__ __align__(16) uint8_t Bs[kBN * kRow];
  __shared__ int k_off[kBK];   // channel offset + ky*dy*W + kx*dx
  __shared__ int k_dy[kBK];    // ky*dy, or a large negative past Kg
  __shared__ int k_dx[kBK];    // kx*dx

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int grp = blockIdx.z;
  const long long M = static_cast<long long>(p.N) * p.Ho * p.Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int f0 = blockIdx.y * kBN;
  const int HW = p.H * p.W;

  // this thread's load row (a data row and a weight row) and k half
  const int lrow = tid & 63, khalf = tid >> 6;
  const long long m = m0 + lrow;
  const bool m_ok = m < M;
  int ih0 = 0, iw0 = 0;
  const int8_t* xrow = x;
  if (m_ok) {
    const long long hw = static_cast<long long>(p.Ho) * p.Wo;
    const long long img = m / hw;
    const int rem = static_cast<int>(m - img * hw);
    const int oy = rem / p.Wo, ox = rem - (rem / p.Wo) * p.Wo;
    ih0 = oy * p.sh - p.ph;
    iw0 = ox * p.sw - p.pw;
    xrow = x + (img * p.C + static_cast<long long>(grp) * p.Cg) * HW;
  }
  const int f_load = f0 + lrow;
  const int8_t* wrow = w + (static_cast<long long>(grp) * p.Fg + f_load) *
                               static_cast<long long>(p.Kp);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int KK = p.KH * p.KW;
  for (int k0 = 0; k0 < p.Kp; k0 += kBK) {
    if (!p.vector_rows && tid < kBK) {
      const int k = k0 + tid;
      if (k < p.Kg) {
        const int c = k / KK, r = k - (k / KK) * KK;
        const int ky = r / p.KW, kx = r - (r / p.KW) * p.KW;
        k_dy[tid] = ky * p.dh;
        k_dx[tid] = kx * p.dw;
        k_off[tid] = c * HW + ky * p.dh * p.W + kx * p.dw;
      } else {
        k_dy[tid] = -(1 << 30);
        k_dx[tid] = 0;
        k_off[tid] = 0;
      }
    }
    __syncthreads();
    // data tile: row lrow, k = k0 + khalf*16 .. +15
    uint4 av = make_uint4(0, 0, 0, 0);
    const int kb = k0 + khalf * 16;
    if (p.vector_rows) {
      if (m_ok && kb < p.Kg)
        av = *reinterpret_cast<const uint4*>(xrow + kb);
    } else if (m_ok) {
      uint32_t wd[4] = {0, 0, 0, 0};
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int kk = khalf * 16 + q;
        const int iy = ih0 + k_dy[kk], ix = iw0 + k_dx[kk];
        uint32_t v = 0;
        if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
          v = static_cast<uint8_t>(xrow[k_off[kk] + ih0 * p.W + iw0]);
        wd[q >> 2] |= v << (8 * (q & 3));
      }
      av = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    *reinterpret_cast<uint4*>(As + lrow * kRow + khalf * 16) = av;
    uint4 bv = make_uint4(0, 0, 0, 0);
    if (f_load < p.Fg) bv = *reinterpret_cast<const uint4*>(wrow + kb);
    *reinterpret_cast<uint4*>(Bs + lrow * kRow + khalf * 16) = bv;
    __syncthreads();

    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* r0 = As + (wm * 32 + i * 16 + g8) * kRow + 4 * t4;
      a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[i][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * kRow);
      a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * kRow + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* c0 = Bs + (wn * 32 + j * 8 + g8) * kRow + 4 * t4;
      b[j][0] = *reinterpret_cast<const uint32_t*>(c0);
      b[j][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    __syncthreads();
  }

  // accumulator r of tile (i, j): row g8 (+8 for r >= 2), filter 2 t4
  // (+1 for odd r)
  const long long hw = static_cast<long long>(p.Ho) * p.Wo;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long mo = m0 + wm * 32 + i * 16 + g8 + 8 * half;
      if (mo >= M) continue;
      const long long img = mo / hw;
      const long long pix = mo - img * hw;
      int32_t* orow = out + (img * p.F + static_cast<long long>(grp) * p.Fg)
                                * hw + pix;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + wn * 32 + j * 8 + 2 * t4;
        if (f < p.Fg) orow[f * hw] = acc[i][j][2 * half];
        if (f + 1 < p.Fg) orow[(f + 1) * hw] = acc[i][j][2 * half + 1];
      }
    }
  }
}

}  // namespace

extern "C" {

// x (N, C, H, W) int8, contiguous; w (F, Kp) int8 rows, 16-byte aligned,
// each group's Kg weights zero-padded to Kp (a multiple of 32); out
// (N, F, Ho, Wo) int32.  One block per (64 rows, 64 filters, group).
// Returns the cudaGetLastError() code of the launch (0 = cudaSuccess).
int mxtt_int8_conv(const void* x, const void* w, void* out, int N, int C,
                   int H, int W, int F, int KH, int KW, int sh, int sw,
                   int ph, int pw, int dh, int dw, int groups,
                   int vector_rows, void* stream) {
  Conv p;
  p.N = N; p.C = C; p.H = H; p.W = W; p.F = F; p.KH = KH; p.KW = KW;
  p.sh = sh; p.sw = sw; p.ph = ph; p.pw = pw; p.dh = dh; p.dw = dw;
  p.Ho = (H + 2 * ph - (dh * (KH - 1) + 1)) / sh + 1;
  p.Wo = (W + 2 * pw - (dw * (KW - 1) + 1)) / sw + 1;
  p.groups = groups;
  p.Cg = C / groups;
  p.Fg = F / groups;
  p.Kg = p.Cg * KH * KW;
  p.Kp = (p.Kg + kBK - 1) / kBK * kBK;
  p.vector_rows = vector_rows;
  const long long M = static_cast<long long>(N) * p.Ho * p.Wo;
  if (M <= 0 || F <= 0) return 0;
  dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
            static_cast<unsigned>((p.Fg + kBN - 1) / kBN),
            static_cast<unsigned>(groups));
  int8_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
