// Flash attention forward with f32 arithmetic on Hopper's CUDA cores
// (sm_90a).  Plain C interface, loaded through ctypes by
// mxnet_tpu_torch/kernels/__init__.py, which sends here f32 inputs at any
// head dim and bf16 inputs with D > 256 (bf16 up to D 256 runs the
// tensor-core kernel, flash_attention_bf16.cu).
//
// Replaces the Pallas kernel of mxnet_tpu/ops/attention_pallas.py:
//   flash_fwd_kernel and flash_fwd_wide_kernel <- _kernel
//   (attention_pallas.py:30), launched there by _flash_fwd_raw (:84)
//   through pl.pallas_call (:107).
//
// What it computes (the TPU kernel's arithmetic, not its blocking): q, k
// and v are taken to f32 as they are staged (attention_pallas.py:54-56);
// for each query row, over the keys in order, an f32 running max m, a
// denominator l and an accumulator acc; q is scaled in f32 before the
// QK^T product; under `causal` a score with q_pos < k_pos (absolute
// positions from 0) is set to -1e30, not -inf, and K/V tiles wholly above
// the diagonal are skipped; keys past Tk score -inf and add exactly 0; at
// the end o = acc / max(l, 1e-30), rounded to the input type, and
// lse = m + log(max(l, 1e-30)), all in f32.  q, k and v are read in their
// (B, T, H, D) layout through the strides the wrapper passes (the head dim
// has stride 1), with no copies; o is written contiguous (B, Tq, H, D) and
// lse contiguous (B, Tq, H).
//
// Bound: 4*D flops per live (query, key) pair against q, k, v and o read
// or written once, so for Tq = Tk = T the intensity is T / 4 flops per
// byte in f32.  The card's ratio is 67e12 / 3.35e12 = 20 (data sheet):
// bound by operations from T = 512 on, by the FMA pipe of the CUDA cores
// (128 FMAs and one exponential per score at D 64; the exponential runs
// on the special-function units, so the FMAs stay the limit).  No tensor
// cores and no TF32: the f32 path is held at 5e-5 against a plain version
// in full f32.
//
// Design.  One block of 128 threads (4 warps) owns a (batch*head, query
// tile) and walks the K/V tiles in a loop, keeping m, l and acc in
// registers; query tiles run last tile first, so under `causal` the
// longest blocks start first.
//   - Register tiling.  The threads form row groups of 8 lanes (up to DP
//     64) or 16 lanes (DP 128 and 256), whole within a warp.  A thread
//     computes a micro-tile of S (rows ty + RG i, keys tx + LANES j) and
//     the same rows of O at its own head dims (4 tx + 4 LANES g + e): 8 x 8
//     and 8 x 8 at DP 64, 8 x 2 and 8 x 8 at DP 128, 4 x 2 and 4 x 16 at
//     DP 256.  Both products read their operands as 16-byte float4 from
//     shared memory: at DP 64 each thread loads 16 float4 (64 floats) per
//     256 FMAs, 4 FMAs a float (the first version: 32 FMAs per 12 scalar
//     loads, 2.7).  Shared rows are padded by 4 floats, so the rows a warp
//     reads at once fall on distinct banks and 8 consecutive K or V rows
//     fill the 32 banks once.
//   - Online softmax in registers.  A row's max reduces over its lanes
//     with shuffles; each lane keeps its share of l, reduced once at the
//     end.  P goes through shared memory (BQ x BK, padded): P.V needs
//     every key of a row in each of its lanes; the lanes of a row group
//     write and read it, all in one warp.
//   - Staging by 16-byte cp.async.cg, one buffer each for K and V: V of
//     tile j is in flight while Q.K^T of tile j runs, K of tile j + 1
//     while P.V of tile j runs (two barriers a tile).  At 128 query rows,
//     double buffers would leave one block an SM; this keeps two.  Q is
//     staged once; each thread scales the Q values it copied itself once
//     they land.  Rows past T and head dims past D use the zero-fill form
//     (src-size 0), so pads are exact zeros.  Where a row start is not
//     16-byte aligned (a data pointer or a stride times 4 bytes not a
//     multiple of 16, or D not a multiple of 4; the wrapper decides once a
//     launch, kernels.f32_vector_loads), the same kernel loads element by
//     element into the same layout.
//   - Tiles per head dim (DP = D rounded up to 16, 32, 64, 128 or 256):
//     128 query rows x 64 keys up to DP 64, 64 x 32 at DP 128, 32 x 32 at
//     DP 256.  Shared memory per block 55,296 (DP 16), 71,680 (32),
//     104,448 (64), 76,800 (128), 104,448 (256) bytes: two blocks an SM or
//     more at every DP.
//   - D > 256 (flash_fwd_wide_kernel, f32 and bf16; 64 x 32 tiles, 16
//     lanes): a second grid dimension takes slices of o's head dims, 256
//     wide.  Each block computes the scores over the full D, staging Q
//     and K in 64-wide head-dim chunks through double-buffered shared
//     buffers (chunk c+1 in flight while chunk c is computed), and
//     accumulates only its slice of V and o; slice 0 writes lse.  Each
//     slice recomputes Q.K^T, so the work is (2 slices + 2) D flops a pair
//     against the 4 D counted in the bound (6 D at D 512): a correctness
//     path for head dims past the narrow templates.  bf16 inputs are
//     converted to f32 as they are staged (16-byte loads through
//     registers, or element by element).

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kPad = 4;            // floats of padding per shared row
constexpr float kMasked = -1e30f;  // attention_pallas.py:64
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, t, h;  // in elements; the head dim has stride 1
};

// The narrow kernel's tiles, one template per DP (the head dim rounded
// up): up to DP 64, 128 query rows x 64 keys with row groups of 8 lanes
// (8 x 8 micro-tiles of S, and of O at DP 64); at DP 128, 64 x 32 with
// 16 lanes (S 8 x 2, O 8 x 8); at DP 256, 32 x 32 with 16 lanes (S 4 x 2,
// O 4 x 16).  Shared: Q [kBQ][kRow], K [kBK][kRow], V [kBK][kRow],
// P [kBQ][kBK + kPad], all f32.
template <int DP>
struct Tile {
  static constexpr int kLanes = DP <= 64 ? 8 : 16;
  static constexpr int kBQ = DP <= 64 ? 128 : DP <= 128 ? 64 : 32;
  static constexpr int kBK = DP <= 64 ? 64 : 32;
  static constexpr int kRow = DP + kPad;
  static constexpr int kSmemBytes =
      ((kBQ + 2 * kBK) * kRow + kBQ * (kBK + kPad)) *
      static_cast<int>(sizeof(float));
};

// The wide kernel's tiles (D > 256), 16 lanes a row group (S 8 x 2, O
// 8 x 16).  Shared, 94,720 bytes: Q chunks [2][kBQ][kQKRow], K chunks
// [2][kBK][kQKRow], V slice [kBK][kVRow], P [kBQ][kBK + kPad].
struct Wide {
  static constexpr int kBQ = 64, kBK = 32;
  static constexpr int kDC = 64;   // head dims per Q/K chunk
  static constexpr int kDV = 256;  // head dims per slice of V and o
  static constexpr int kQKRow = kDC + kPad, kVRow = kDV + kPad;
  static constexpr int kSmemBytes =
      (2 * (kBQ + kBK) * kQKRow + kBK * kVRow + kBQ * (kBK + kPad)) *
      static_cast<int>(sizeof(float));
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false nothing is read and the 16
// bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// 16-byte cp.async staging: f32 with a vector-aligned layout
template <typename T, bool kVec>
constexpr bool kAsync = kVec && std::is_same<T, float>::value;

// Rows [r0, r0 + ROWS) and head dims [c0, c0 + W) of one head (row stride
// st) into a shared f32 tile [ROWS][RS], times mul; rows past T and head
// dims past D are zeros.  The cp.async form copies and leaves mul to
// scale_own; the others convert and scale as they store.
template <typename T, int ROWS, int W, int RS, bool kVec>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int r0, int T_,
                                          int c0, int D, float mul, int tid) {
  if constexpr (kAsync<T, kVec>) {
    // one 16-byte chunk per thread and pass: the thread's column is fixed
    // and its row steps by kStep
    constexpr int kChunks = W / 4;
    constexpr int kStep = kThreads / kChunks;
    static_assert(kThreads % kChunks == 0, "a thread keeps its column");
    const int c = (tid % kChunks) * 4;
#pragma unroll 1
    for (int r = tid / kChunks; r < ROWS; r += kStep) {
      const bool ok = r0 + r < T_ && c0 + c < D;
      const T* g = ok ? src + static_cast<long long>(r0 + r) * st + c0 + c
                      : src;
      cp_async16(smem_u32(dst + r * RS + c), g, ok);
    }
  } else if constexpr (kVec) {  // bf16: 8 values per 16 bytes
    constexpr int kChunks = W / 8;
    constexpr int kStep = kThreads / kChunks;
    static_assert(kThreads % kChunks == 0, "a thread keeps its column");
    const int c = (tid % kChunks) * 8;
#pragma unroll 1
    for (int r = tid / kChunks; r < ROWS; r += kStep) {
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.0f;
      if (r0 + r < T_ && c0 + c < D) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + static_cast<long long>(r0 + r) * st + c0 + c);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
        // a bf16 value is the top half of its f32 (exact); the lower
        // address holds the lower half of each word
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[2 * e] = __uint_as_float(w[e] << 16) * mul;
          x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u) * mul;
        }
      }
      float4* d = reinterpret_cast<float4*>(dst + r * RS + c);
      d[0] = make_float4(x[0], x[1], x[2], x[3]);
      d[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
  } else {
    for (int i = tid; i < ROWS * W; i += kThreads) {
      const int r = i / W, c = i % W;
      float x = 0.0f;
      if (r0 + r < T_ && c0 + c < D)
        x = to_f32(src[static_cast<long long>(r0 + r) * st + c0 + c]) * mul;
      dst[r * RS + c] = x;
    }
  }
}

// After cp.async.wait_group: each thread scales the 16-byte chunks it
// copied itself (load_tile's cp.async mapping), visible to it already.
template <int ROWS, int W, int RS>
__device__ __forceinline__ void scale_own(float* dst, float mul, int tid) {
  constexpr int kChunks = W / 4;
  constexpr int kStep = kThreads / kChunks;
  const int c = (tid % kChunks) * 4;
#pragma unroll 1
  for (int r = tid / kChunks; r < ROWS; r += kStep) {
    float4* p = reinterpret_cast<float4*>(dst + r * RS + c);
    float4 x = *p;
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *p = x;
  }
}

// The threads of a block form row groups of LANES lanes (kThreads / LANES
// groups, whole within a warp).  A thread's query rows are ty + RG i
// (RG = kThreads / LANES), its keys tx + LANES j, its head dims dim_of(c).

// s[i][j] += the product of Q row ty + RG i and K row tx + LANES j over
// head dims [0, W), operands read as float4
template <int LANES, int TM, int TN, int W, int QRS, int KRS>
__device__ __forceinline__ void qk_tile(float (&s)[TM][TN], const float* Qs,
                                        const float* Ks, int ty, int tx) {
  constexpr int RG = kThreads / LANES;
#pragma unroll 4
  for (int d = 0; d < W; d += 4) {
    float4 a[TM], b[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = *reinterpret_cast<const float4*>(Ks + (tx + LANES * j) * KRS + d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(Qs + (ty + RG * i) * QRS + d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// Where this tile reaches past Tk or the diagonal (edge): keys past Tk
// score -inf and causally masked ones -1e30.  Then the online-softmax
// update of each row: m_new = max(m, row max) over the row's LANES lanes,
// P = exp(s - m_new) into Ps at (row, key), this lane's share of l and
// the accumulator rescaled by exp(m - m_new).
template <int LANES, int TM, int TN, int TD, int PRS>
__device__ __forceinline__ void softmax_tile(float (&s)[TM][TN],
                                             float (&m)[TM], float (&l)[TM],
                                             float (&acc)[TM][TD], float* Ps,
                                             int ty, int tx, bool edge, int q0,
                                             int k0, int Tk, int causal) {
  constexpr int RG = kThreads / LANES;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q_pos = q0 + ty + RG * i;
    float m_new = m[i];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (edge) {
        const int k_pos = k0 + tx + LANES * j;
        if (k_pos >= Tk)
          s[i][j] = -INFINITY;
        else if (causal && q_pos < k_pos)
          s[i][j] = kMasked;
      }
      m_new = fmaxf(m_new, s[i][j]);
    }
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1)
      m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, off));
    const float alpha = exp2_approx((m[i] - m_new) * kLog2e);
    float row_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float p = exp2_approx((s[i][j] - m_new) * kLog2e);
      row_sum += p;
      Ps[(ty + RG * i) * PRS + tx + LANES * j] = p;
    }
    l[i] = l[i] * alpha + row_sum;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
  }
}

// head dim of a thread's accumulator column c: 4 tx + 4 LANES (c / 4) +
// c % 4 (float4 groups) from 4 columns on, TD tx + c below
template <int LANES, int TD>
__device__ __forceinline__ int dim_of(int tx, int c) {
  if constexpr (TD >= 4)
    return 4 * LANES * (c / 4) + 4 * tx + c % 4;
  else
    return TD * tx + c;
}

template <int LANES, int TD>
__device__ __forceinline__ void load_v_row(float (&v)[TD], const float* row,
                                           int tx) {
  if constexpr (TD >= 4) {
#pragma unroll
    for (int g = 0; g < TD / 4; ++g) {
      const float4 x =
          *reinterpret_cast<const float4*>(row + 4 * LANES * g + 4 * tx);
      v[4 * g] = x.x;
      v[4 * g + 1] = x.y;
      v[4 * g + 2] = x.z;
      v[4 * g + 3] = x.w;
    }
  } else if constexpr (TD == 2) {
    const float2 x = *reinterpret_cast<const float2*>(row + 2 * tx);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = row[tx];
  }
}

// acc[i][c] += sum over the tile's BK keys of P[row ty + RG i][key] *
// V[key][dim_of(c)], P read as float4 along the keys
template <int LANES, int TM, int TD, int BK, int PRS, int VRS>
__device__ __forceinline__ void pv_tile(float (&acc)[TM][TD], const float* Ps,
                                        const float* Vs, int ty, int tx) {
  constexpr int RG = kThreads / LANES;
#pragma unroll 4
  for (int k = 0; k < BK; k += 4) {
    float4 p[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      p[i] = *reinterpret_cast<const float4*>(Ps + (ty + RG * i) * PRS + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v[TD];
      load_v_row<LANES, TD>(v, Vs + (k + e) * VRS, tx);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float pi = lane_of(p[i], e);
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[i][c] = fmaf(pi, v[c], acc[i][c]);
      }
    }
  }
}

// o = acc / max(l, 1e-30) at head dims dv0 + dim_of(c) < D, rounded to T;
// lse = m + log(max(l, 1e-30)) where write_lse
template <typename T, int LANES, int TM, int TD>
__device__ __forceinline__ void store_rows(T* o, float* lse,
                                           const float (&acc)[TM][TD],
                                           const float (&m)[TM],
                                           const float (&l)[TM], int b, int h,
                                           int H, int Tq, int D, int q0,
                                           int dv0, bool write_lse, int ty,
                                           int tx) {
  constexpr int RG = kThreads / LANES;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int r = q0 + ty + RG * i;
    if (r >= Tq) continue;
    const float l_safe = fmaxf(li, 1e-30f);
    const long long orow = (static_cast<long long>(b) * Tq + r) * H + h;
    T* op = o + orow * D + dv0;
    if constexpr (std::is_same<T, float>::value && TD >= 4) {
      if ((D & 3) == 0) {  // then op + dim_of(4g) is 16-byte aligned
#pragma unroll
        for (int g = 0; g < TD / 4; ++g) {
          const int d = dim_of<LANES, TD>(tx, 4 * g);
          if (dv0 + d < D)
            *reinterpret_cast<float4*>(op + d) = make_float4(
                acc[i][4 * g] / l_safe, acc[i][4 * g + 1] / l_safe,
                acc[i][4 * g + 2] / l_safe, acc[i][4 * g + 3] / l_safe);
        }
        if (write_lse && tx == 0) lse[orow] = m[i] + logf(l_safe);
        continue;
      }
    }
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int d = dim_of<LANES, TD>(tx, c);
      if (dv0 + d < D) op[d] = from_f32<T>(acc[i][c] / l_safe);
    }
    if (write_lse && tx == 0) lse[orow] = m[i] + logf(l_safe);
  }
}

template <typename T, int DP, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 Strides sq, Strides sk, Strides sv, float scale, int causal,
                 int n_qblk) {
  using Cfg = Tile<DP>;
  constexpr int kLanes = Cfg::kLanes, kBQ = Cfg::kBQ, kBK = Cfg::kBK;
  constexpr int kRow = Cfg::kRow, kPRow = kBK + kPad;
  constexpr int TM = kBQ * kLanes / kThreads;  // query rows per thread
  constexpr int TN = kBK / kLanes;             // keys per thread
  constexpr int TD = DP / kLanes;              // head dims per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [kBQ][kRow], q * scale
  float* Ks = Qs + kBQ * kRow;    // [kBK][kRow]
  float* Vs = Ks + kBK * kRow;    // [kBK][kRow]
  float* Ps = Vs + kBK * kRow;    // [kBQ][kPRow]

  const int tid = threadIdx.x;
  const int ty = tid / kLanes, tx = tid % kLanes;
  const int qblk = n_qblk - 1 - static_cast<int>(blockIdx.x % n_qblk);
  const long long bh = blockIdx.x / n_qblk;
  const int b = static_cast<int>(bh / H);
  const int h = static_cast<int>(bh % H);
  const int q0 = qblk * kBQ;

  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;

  const int q_last = min(q0 + kBQ, Tq) - 1;
  const int n_kblk = (Tk + kBK - 1) / kBK;
  const int n_live = causal ? min(n_kblk, q_last / kBK + 1) : n_kblk;

  load_tile<T, kBQ, DP, kRow, kVec>(Qs, qp, sq.t, q0, Tq, 0, D, scale, tid);
  load_tile<T, kBK, DP, kRow, kVec>(Ks, kp, sk.t, 0, Tk, 0, D, 1.0f, tid);
  cp_async_commit();

  float acc[TM][TD];
  float m[TM], l[TM];  // running max; this lane's share of the sum
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.0f;
  }

  // One buffer each for K and V: V of tile j is in flight during Q.K^T of
  // tile j, K of tile j + 1 during P.V of tile j.
  for (int j = 0; j < n_live; ++j) {
    const int k0 = j * kBK;
    cp_async_wait<0>();  // K of this tile (and, at j = 0, Q)
    if constexpr (kAsync<T, kVec>) {
      if (j == 0) scale_own<kBQ, DP, kRow>(Qs, scale, tid);
    }
    __syncthreads();  // K visible; every warp is done with the previous V
    load_tile<T, kBK, DP, kRow, kVec>(Vs, vp, sv.t, k0, Tk, 0, D, 1.0f, tid);
    cp_async_commit();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) s[i][jj] = 0.0f;
    qk_tile<kLanes, TM, TN, DP, kRow, kRow>(s, Qs, Ks, ty, tx);
    const bool edge = k0 + kBK > Tk || (causal && k0 + kBK - 1 > q0);
    // a row's probabilities are written and read by the lanes of its row
    // group, all in one warp
    softmax_tile<kLanes, TM, TN, TD, kPRow>(s, m, l, acc, Ps, ty, tx, edge,
                                            q0, k0, Tk, causal);

    cp_async_wait<0>();  // V of this tile
    __syncthreads();     // V visible; every warp is done with K
    if (j + 1 < n_live)
      load_tile<T, kBK, DP, kRow, kVec>(Ks, kp, sk.t, k0 + kBK, Tk, 0, D,
                                        1.0f, tid);
    cp_async_commit();
    pv_tile<kLanes, TM, TD, kBK, kPRow, kRow>(acc, Ps, Vs, ty, tx);
  }
  store_rows<T, kLanes, TM, TD>(o, lse, acc, m, l, b, h, H, Tq, D, q0, 0,
                                true, ty, tx);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int H, int Tq, int Tk, int D,
                      Strides sq, Strides sk, Strides sv, float scale,
                      int causal, int n_qblk) {
  constexpr int kBQ = Wide::kBQ, kBK = Wide::kBK, kDC = Wide::kDC;
  constexpr int kDV = Wide::kDV, kQKRow = Wide::kQKRow, kVRow = Wide::kVRow;
  constexpr int kPRow = kBK + kPad, kLanes = 16;
  constexpr int TM = kBQ * kLanes / kThreads, TN = kBK / kLanes;
  constexpr int TD = kDV / kLanes;
  extern __shared__ __align__(16) float smem[];
  float* Qc = smem;                       // [2][kBQ][kQKRow], q * scale
  float* Kc = Qc + 2 * kBQ * kQKRow;      // [2][kBK][kQKRow]
  float* Vs = Kc + 2 * kBK * kQKRow;      // [kBK][kVRow], this slice
  float* Ps = Vs + kBK * kVRow;           // [kBQ][kPRow]

  const int tid = threadIdx.x;
  const int ty = tid / kLanes, tx = tid % kLanes;
  const int qblk = n_qblk - 1 - static_cast<int>(blockIdx.x % n_qblk);
  const long long bh = blockIdx.x / n_qblk;
  const int b = static_cast<int>(bh / H);
  const int h = static_cast<int>(bh % H);
  const int q0 = qblk * kBQ;
  const int dv0 = static_cast<int>(blockIdx.y) * kDV;

  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;

  const int q_last = min(q0 + kBQ, Tq) - 1;
  const int n_kblk = (Tk + kBK - 1) / kBK;
  const int n_live = causal ? min(n_kblk, q_last / kBK + 1) : n_kblk;
  const int n_chunks = (D + kDC - 1) / kDC;

  float acc[TM][TD];
  float m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.0f;
  }

  for (int j = 0; j < n_live; ++j) {
    const int k0 = j * kBK;
    // the previous tile's readers are done (the barrier ending the loop)
    load_tile<T, kBK, kDV, kVRow, kVec>(Vs, vp, sv.t, k0, Tk, dv0, D, 1.0f,
                                        tid);
    load_tile<T, kBQ, kDC, kQKRow, kVec>(Qc, qp, sq.t, q0, Tq, 0, D, scale,
                                         tid);
    load_tile<T, kBK, kDC, kQKRow, kVec>(Kc, kp, sk.t, k0, Tk, 0, D, 1.0f,
                                         tid);
    cp_async_commit();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) s[i][jj] = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c & 1;
      if (c + 1 < n_chunks) {
        const int c1 = (c + 1) * kDC;
        load_tile<T, kBQ, kDC, kQKRow, kVec>(Qc + (buf ^ 1) * kBQ * kQKRow,
                                             qp, sq.t, q0, Tq, c1, D, scale,
                                             tid);
        load_tile<T, kBK, kDC, kQKRow, kVec>(Kc + (buf ^ 1) * kBK * kQKRow,
                                             kp, sk.t, k0, Tk, c1, D, 1.0f,
                                             tid);
      }
      cp_async_commit();
      cp_async_wait<1>();  // chunk c (and, from c = 0 on, the V slice)
      if constexpr (kAsync<T, kVec>)
        scale_own<kBQ, kDC, kQKRow>(Qc + buf * kBQ * kQKRow, scale, tid);
      __syncthreads();
      qk_tile<kLanes, TM, TN, kDC, kQKRow, kQKRow>(
          s, Qc + buf * kBQ * kQKRow, Kc + buf * kBK * kQKRow, ty, tx);
      __syncthreads();  // buffer buf is free for chunk c + 2
    }

    const bool edge = k0 + kBK > Tk || (causal && k0 + kBK - 1 > q0);
    softmax_tile<kLanes, TM, TN, TD, kPRow>(s, m, l, acc, Ps, ty, tx, edge,
                                            q0, k0, Tk, causal);
    __syncwarp();  // a row's P is written and read within one warp
    pv_tile<kLanes, TM, TD, kBK, kPRow, kVRow>(acc, Ps, Vs, ty, tx);
    __syncthreads();  // V slice and P are free for the next tile
  }
  cp_async_wait<0>();
  store_rows<T, kLanes, TM, TD>(o, lse, acc, m, l, b, h, H, Tq, D, q0, dv0,
                                blockIdx.y == 0, ty, tx);
}

template <typename T, int DP, bool kVec>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int Tk, int D, Strides sq, Strides sk,
           Strides sv, float scale, int causal, cudaStream_t stream) {
  const int n_qblk = (Tq + Tile<DP>::kBQ - 1) / Tile<DP>::kBQ;
  const long long blocks = static_cast<long long>(n_qblk) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Tile<DP>::kSmemBytes;
  // per device, so set before every launch (a host-side call)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<T, DP, kVec>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), lse, H, Tq, Tk, D, sq,
          sk, sv, scale, causal, n_qblk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int Tq, int Tk, int D, Strides sq,
                Strides sk, Strides sv, float scale, int causal,
                cudaStream_t stream) {
  const int n_qblk = (Tq + Wide::kBQ - 1) / Wide::kBQ;
  const long long blocks = static_cast<long long>(n_qblk) * B * H;
  const int slices = (D + Wide::kDV - 1) / Wide::kDV;
  if (blocks > 0x7fffffffLL || slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Wide::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<T, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_wide_kernel<T, kVec>
      <<<dim3(static_cast<unsigned int>(blocks),
              static_cast<unsigned int>(slices)),
         kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), lse, H, Tq, Tk, D, sq,
          sk, sv, scale, causal, n_qblk);
  return static_cast<int>(cudaGetLastError());
}

// f32 inputs: one narrow template per DP up to D 256, the wide kernel
// above
template <bool kVec>
int dispatch_f32(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int Tq, int Tk, int D, Strides sq,
                 Strides sk, Strides sv, float scale, int causal,
                 cudaStream_t stream) {
  if (D <= 16)
    return launch<float, 16, kVec>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk,
                                   sv, scale, causal, stream);
  if (D <= 32)
    return launch<float, 32, kVec>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk,
                                   sv, scale, causal, stream);
  if (D <= 64)
    return launch<float, 64, kVec>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk,
                                   sv, scale, causal, stream);
  if (D <= 128)
    return launch<float, 128, kVec>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk,
                                    sv, scale, causal, stream);
  if (D <= 256)
    return launch<float, 256, kVec>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk,
                                    sv, scale, causal, stream);
  return launch_wide<float, kVec>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk,
                                  sv, scale, causal, stream);
}

}  // namespace

extern "C" {

// Enqueues one forward on `stream` and returns the cudaGetLastError() code
// of the launch (0 = cudaSuccess).  q, k, v: (B, T, H, D), f32 (bf16 = 0)
// or bf16 (bf16 != 0), element strides (batch, seq, head) given, head dim
// contiguous; o: contiguous (B, Tq, H, D) in the input type; lse:
// contiguous f32 (B, Tq, H).  Any D >= 1: f32 runs a narrow template up to
// D 256 and the wide kernel above; bf16 runs the wide kernel.
// vec_loads != 0 promises 16-byte aligned row starts (every data pointer
// and stride in bytes a multiple of 16, D a multiple of 4 in f32 or 8 in
// bf16) and selects the 16-byte loader.
int mxtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int H, int Tq,
                             int Tk, int D, long long q_sb, long long q_st,
                             long long q_sh, long long k_sb, long long k_st,
                             long long k_sh, long long v_sb, long long v_st,
                             long long v_sh, float scale, int causal,
                             int bf16, int vec_loads, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh},
      sv{v_sb, v_st, v_sh};
  if (bf16)
    return vec_loads
               ? launch_wide<__nv_bfloat16, true>(q, k, v, o, lse, B, H, Tq,
                                                  Tk, D, sq, sk, sv, scale,
                                                  causal, stream)
               : launch_wide<__nv_bfloat16, false>(q, k, v, o, lse, B, H, Tq,
                                                   Tk, D, sq, sk, sv, scale,
                                                   causal, stream);
  if (vec_loads)
    return dispatch_f32<true>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv,
                              scale, causal, stream);
  return dispatch_f32<false>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv,
                             scale, causal, stream);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
