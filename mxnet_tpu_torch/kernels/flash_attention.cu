// Flash attention forward, hand-written for Hopper (sm_90a).  Plain C
// interface, loaded through ctypes by mxnet_tpu_torch/kernels/__init__.py.
//
// Replaces the Pallas kernel of mxnet_tpu/ops/attention_pallas.py:
//   flash_fwd_kernel <- _kernel (attention_pallas.py:30), launched there by
//   _flash_fwd_raw (:84) through pl.pallas_call (:107).
//
// What it computes (the TPU kernel's arithmetic, not its blocking):
// for each query row, over the keys in order, an f32 running max m, a
// denominator l and an accumulator acc; q is scaled in f32 before the
// QK^T product; under `causal` a score with q_pos < k_pos (absolute
// positions from 0) is set to -1e30, not -inf, and K/V tiles wholly above
// the diagonal are skipped; at the end o = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)), all in f32.  This is the f32 kernel;
// bf16 inputs go to the tensor-core kernel, flash_attention_bf16.cu.
//
// Design (first, simple version): on the TPU the K/V tiles were the
// sequential innermost grid axis and m, l, acc lived in VMEM scratch
// between grid steps.  CUDA blocks run in no order and share nothing, so
// one block owns one (batch*head, 64-row query tile) and walks the K/V
// tiles of 64 keys in a loop, keeping m, l and acc in registers.
//   - 128 threads: 16 row groups of 4 query rows x 8 lanes.  A thread
//     holds the 4x8 scores of its rows at columns lane + 8j, and the
//     accumulator of its 4 rows at head dims lane + 8j; a row's max and
//     sum are reduced over its 8 lanes with warp shuffles, and the
//     probabilities pass through shared memory only within one warp.
//   - Shared memory (dynamic, f32): Q tile [64][DP+1] (scaled), K tile
//     [64][DP+1], V tile [64][DP], P [64][65]; the +1 pads keep the
//     lanes of a warp on distinct banks.  DP is the head dim rounded up
//     to 16, 32, 64, 128 or 256, zero-padded, so any D from 1 to 256
//     runs; bytes per block: 29,440 (DP 16), 41,728 (32), 66,304 (64),
//     115,456 (128), 213,760 (256).
//   - Products are f32 FMA on the CUDA cores; no tensor cores, TMA or
//     warp specialisation yet.  The kernel's tiles (64 x 64) are its
//     own; the blk_q/blk_k of the public function only validate shapes.
//   - Layout: q, k and v are read in their (B, T, H, D) layout through
//     the strides the wrapper passes (the head dim must have stride 1),
//     so the wrapper makes none of the (B, H, T, D) copies the JAX
//     wrapper makes with swapaxes.  o is written contiguous (B, Tq, H, D)
//     and lse contiguous (B, Tq, H).
//   - Ragged edges: query rows past Tq load zeros and are not stored;
//     keys past Tk score -inf, so they add exactly 0.
//   - Query tiles are scheduled last tile first, so under `causal` the
//     longest blocks start first.
//
// Bound: 4*D flops per live (query, key) pair against q, k, v and o read
// or written once, so for Tq = Tk = T the intensity is T / 4 flops per
// byte.  The card's ratio is 67e12 / 3.35e12 = 20 in f32 (data sheet):
// bound by operations from T = 512 on.  This version does not reach it:
// its inner loops issue one shared-memory load per 2-3 FMAs on the CUDA
// cores (register tiling and vector shared loads are queued).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per K/V tile
constexpr int kThreads = 128;   // 16 row groups x 8 lanes
constexpr int kLanes = 8;       // lanes per row group
constexpr int kRows = 4;        // query rows per thread
constexpr int kCols = kBK / kLanes;  // score columns per thread
constexpr float kMasked = -1e30f;    // attention_pallas.py:64
static_assert(kRows * (kThreads / kLanes) == kBQ, "row groups cover the tile");

struct Strides {
  long long b, t, h;  // in elements; the head dim has stride 1
};

__host__ __device__ constexpr int smem_floats(int dp) {
  return kBQ * (dp + 1) + kBK * (dp + 1) + kBK * dp + kBQ * (kBK + 1);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 Strides sq, Strides sk, Strides sv, float scale, int causal,
                 int n_qblk) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kBQ][DP + 1], q * scale
  float* Ks = Qs + kBQ * (DP + 1);    // [kBK][DP + 1]
  float* Vs = Ks + kBK * (DP + 1);    // [kBK][DP]
  float* Ps = Vs + kBK * DP;          // [kBQ][kBK + 1]
  constexpr int kAcc = DP / kLanes;   // head dims per thread

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int row0 = (tid / kLanes) * kRows;  // first of this thread's rows
  const int qblk = n_qblk - 1 - static_cast<int>(blockIdx.x % n_qblk);
  const long long bh = blockIdx.x / n_qblk;
  const int b = static_cast<int>(bh / H);
  const int h = static_cast<int>(bh % H);
  const int q0 = qblk * kBQ;

  const float* qp = q + b * sq.b + h * sq.h;
  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    float x = 0.0f;
    if (q0 + r < Tq && d < D)
      x = qp[static_cast<long long>(q0 + r) * sq.t + d] * scale;
    Qs[r * (DP + 1) + d] = x;
  }

  float acc[kRows][kAcc];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, Tq) - 1;
  const int n_kblk = (Tk + kBK - 1) / kBK;
  for (int kb = 0; kb < n_kblk; ++kb) {
    const int k0 = kb * kBK;
    if (causal && k0 > q_last) break;  // wholly above the diagonal
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + r < Tk && d < D) {
        kx = kp[static_cast<long long>(k0 + r) * sk.t + d];
        vx = vp[static_cast<long long>(k0 + r) * sv.t + d];
      }
      Ks[r * (DP + 1) + d] = kx;
      Vs[r * DP + d] = vx;
    }
    __syncthreads();

    // scores of rows row0..row0+3 at key columns lane + 8j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(row0 + i) * (DP + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = Ks[(lane + kLanes * j) * (DP + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + row0 + i;
      float m_blk = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = k0 + lane + kLanes * j;
        if (k_pos >= Tk)
          s[i][j] = -INFINITY;
        else if (causal && q_pos < k_pos)
          s[i][j] = kMasked;
        m_blk = fmaxf(m_blk, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, off));
      const float m_new = fmaxf(m[i], m_blk);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        Ps[(row0 + i) * (kBK + 1) + lane + kLanes * j] = p;
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kAcc; ++c) acc[i][c] *= alpha;
    }
    // a row's probabilities are written and read by the 8 lanes of its
    // row group, all in one warp
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(row0 + i) * (kBK + 1) + c];
#pragma unroll
      for (int jj = 0; jj < kAcc; ++jj) {
        const float vv = Vs[c * DP + lane + kLanes * jj];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + row0 + i;
    if (r >= Tq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const long long orow = (static_cast<long long>(b) * Tq + r) * H + h;
    float* op = o + orow * D;
#pragma unroll
    for (int jj = 0; jj < kAcc; ++jj) {
      const int d = lane + kLanes * jj;
      if (d < D) op[d] = acc[i][jj] / l_safe;
    }
    if (lane == 0) lse[orow] = m[i] + logf(l_safe);
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int Tk, int D, Strides sq, Strides sk,
           Strides sv, float scale, int causal, cudaStream_t stream) {
  const int n_qblk = (Tq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(n_qblk) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_floats(DP) * static_cast<int>(sizeof(float));
  // per device, so set before every launch (a host-side call)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<DP><<<static_cast<unsigned int>(blocks), kThreads, smem,
                         stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Tq, Tk, D,
      sq, sk, sv, scale, causal, n_qblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Enqueues one f32 forward on `stream` and returns the cudaGetLastError()
// code of the launch (0 = cudaSuccess).  q, k, v: f32 (B, T, H, D),
// element strides (batch, seq, head) given, head dim contiguous; o:
// contiguous f32 (B, Tq, H, D); lse: contiguous f32 (B, Tq, H).
// 1 <= D <= 256.
int mxtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int H, int Tq,
                             int Tk, int D, long long q_sb, long long q_st,
                             long long q_sh, long long k_sb, long long k_st,
                             long long k_sh, long long v_sb, long long v_st,
                             long long v_sh, float scale, int causal,
                             cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh},
      sv{v_sb, v_st, v_sh};
  if (D <= 16)
    return launch<16>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv, scale,
                      causal, stream);
  if (D <= 32)
    return launch<32>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv, scale,
                      causal, stream);
  if (D <= 64)
    return launch<64>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv, scale,
                      causal, stream);
  if (D <= 128)
    return launch<128>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv, scale,
                       causal, stream);
  return launch<256>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv, scale,
                     causal, stream);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
