// Flash attention forward for bf16 inputs on Hopper's tensor cores
// (sm_90a).  Plain C interface, loaded through ctypes by
// mxnet_tpu_torch/kernels/__init__.py, which sends bf16 here and f32 to
// flash_attention.cu.
//
// Replaces the Pallas kernel of mxnet_tpu/ops/attention_pallas.py for
// bf16 inputs: flash_fwd_bf16_kernel <- _kernel (attention_pallas.py:30),
// launched there by _flash_fwd_raw (:84) through pl.pallas_call (:107).
//
// What it computes (the TPU kernel's arithmetic, as in
// flash_attention.cu): for each query row, over the keys in order, an f32
// running max m, denominator l and accumulator acc; under `causal` a
// score with q_pos < k_pos (absolute positions from 0) is -1e30, not
// -inf, and K/V tiles wholly above the diagonal are skipped; keys past Tk
// add exactly 0; at the end o = acc / max(l, 1e-30) rounded to bf16 and
// lse = m + log(max(l, 1e-30)) in f32.  Where it rounds differently from
// the TPU kernel: q.k^T is a bf16 product accumulated in f32 and scaled
// after the product (the TPU kernel scales q in f32 first), and the
// probabilities P that feed P.V are rounded to bf16 (l is summed from the
// f32 P).  Each P rounding moves o by at most 2^-8 of its share of
// (P/l).|V|, which is where the bf16 bound of the tests and of
// chip_smoke.py comes from.
//
// Design (simple and right first; FlashAttention-2's shape on mma.sync):
//   - One block of 4 warps owns a (batch*head, query tile); each warp
//     owns 32 query rows (16 at head dim 256), as two 16-row blocks that
//     share every K and V fragment read from shared memory, and walks the
//     K/V tiles in a loop.  Query tiles run last tile first, so under
//     `causal` the longest blocks start first.
//   - Staging: Q once, K and V double-buffered, into shared memory as
//     bf16 by 16-byte cp.async.cg copies; tile j+1 is in flight while
//     tile j is computed (one commit group per tile, wait_group 1).  Rows
//     past T and head dims past D use the zero-fill form (src-size 0), so
//     pads are exact zeros.  Each shared row is padded by 8 bf16 values:
//     rows stay 16-byte aligned and the 8 row addresses of an ldmatrix
//     phase fall on distinct banks.
//   - Where a row start is not 16-byte aligned (data_ptr or a stride
//     times 2 bytes not a multiple of 16, or D not a multiple of 8; the
//     wrapper decides once per launch), the same kernel loads with
//     predicated 2-byte element loads into the same shared layout.
//   - S = Q.K^T with mma.sync.m16n8k16 bf16 -> f32 on ldmatrix.x4
//     fragments; the head dim is zero-padded to DP = 16, 32, 64, 128 or
//     256, one template each (tile sizes at struct Tile).
//   - Online softmax in registers on the accumulator fragments: a row's
//     max reduces over the 4 lanes that hold it (shfl_xor 1, 2); each
//     lane keeps its partial l, reduced once at the end.  The scores stay
//     unscaled, so P = 2^(S c - m c), c = |scale| log2(e), is one FMA and
//     one ex2.
//   - O += P.V: the S accumulators repack as bf16 A fragments of the next
//     mma.sync with no trip through shared memory; V fragments come
//     through ldmatrix.x4.trans; the f32 accumulator (32 x DP per warp,
//     16 x DP at DP 256) lives in registers.
//
// Bound: 4*D flops per live (query, key) pair against q, k, v and o read
// or written once.  In bf16 the card's ratio is 989e12 / 3.35e12 = 295
// flops per byte (data sheet), so the forward is bound by operations at
// the sp path's long context (1, 16384, 8, 64): 0.556 ms, and by bytes at
// the LM shape (32, 512, 8, 64): 0.0202 ms.  Per score at D 64 the
// forward does 128 multiply-adds on the tensor cores, one exponential on
// the special-function units and ~5 f32 operations, and the warp reads
// 8 bytes of K and V from shared memory for it (16 if it owned one row
// block: the second row block halves that).  At the data sheet's rates
// the tensor cores, the exponentials and the shared-memory reads each
// cap an SM near 16 scores a clock; with 8 warps an SM (about 250
// registers a thread at DP 64) they barely overlap.  What is left for
// the wgmma redesign: wgmma's rate over mma.sync's, TMA loads issued by a
// producer warp, and the softmax of one tile overlapped with the products
// of the next (the Hopper shape; queued in ROADMAP.md).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;            // bf16 values of padding per shared row
constexpr float kMasked = -1e30f;  // attention_pallas.py:64
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, t, h;  // in elements; the head dim has stride 1
};

template <int DP>
struct Tile {
  // 16-row blocks per warp: two up to DP 128, so that each K or V
  // fragment read from shared memory feeds the products of 32 query rows;
  // one at DP 256, where the accumulators of two would not fit the
  // registers.  Keys per K/V tile: 64, or 32 from DP 128 on, where the
  // accumulators take 128 registers.  Q's fragments stay in registers up
  // to DP 64 and are re-read from shared memory above.
  static constexpr int kMT = DP <= 128 ? 2 : 1;
  static constexpr int kBQ = kWarps * 16 * kMT;     // query rows per block
  static constexpr int kBK = DP >= 128 ? 32 : 64;
  static constexpr int kRow = DP + kPad;           // shared row, bf16 values
  static constexpr bool kQInRegs = DP <= 64;
  // Q [kBQ][kRow], K [2][kBK][kRow], V [2][kBK][kRow]
  static constexpr int kSmemBytes =
      (kBQ + 4 * kBK) * kRow * static_cast<int>(sizeof(__nv_bfloat16));
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one register of two bf16, `lo` in the low half (the lower
// column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + ROWS) of one head (row stride st) into a shared tile
// [ROWS][DP + kPad]; rows past T and head dims past D are zeros.
template <int DP, int ROWS, bool kVec>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long st, int r0, int T, int D,
                                          int tid) {
  constexpr int kRow = DP + kPad;
  if constexpr (kVec) {
    // one 16-byte chunk per thread and pass: the thread's column is fixed
    // and its row steps by kStep; a rolled loop keeps the addresses of
    // later passes out of registers
    constexpr int kChunks = DP / 8;            // 16-byte chunks per row
    constexpr int kStep = kThreads / kChunks;  // rows per pass
    static_assert(kThreads % kChunks == 0, "a thread keeps its column");
    const int c = (tid % kChunks) * 8;
#pragma unroll 1
    for (int r = tid / kChunks; r < ROWS; r += kStep) {
      const bool ok = r0 + r < T && c < D;
      const __nv_bfloat16* g =
          ok ? src + static_cast<long long>(r0 + r) * st + c : src;
      cp_async16(smem_u32(dst + r * kRow + c), g, ok);
    }
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
    for (int i = tid; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      unsigned short x = 0;  // the bits of +0.0
      if (r0 + r < T && c < D) x = s[static_cast<long long>(r0 + r) * st + c];
      d[r * kRow + c] = x;
    }
  }
}

template <int DP, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int H, int Tq, int Tk, int D, Strides sq, Strides sk,
                      Strides sv, float scale, int causal, int n_qblk) {
  using Cfg = Tile<DP>;
  constexpr int kMT = Cfg::kMT, kBQ = Cfg::kBQ, kBK = Cfg::kBK;
  constexpr int kRow = Cfg::kRow;
  constexpr int kKSteps = DP / 16;  // k16 steps of Q.K^T
  constexpr int kNTiles = kBK / 8;  // n8 key tiles of S
  constexpr int kDTiles = DP / 8;   // n8 head-dim tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * kRow;      // [2][kBK][kRow]
  __nv_bfloat16* Vs = Ks + 2 * kBK * kRow;  // [2][kBK][kRow]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int qblk = n_qblk - 1 - static_cast<int>(blockIdx.x % n_qblk);
  const long long bh = blockIdx.x / n_qblk;
  const int b = static_cast<int>(bh / H);
  const int h = static_cast<int>(bh % H);
  const int q0 = qblk * kBQ;
  const int qw = q0 + warp * 16 * kMT;  // first query row of this warp

  const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;

  const int q_last = min(q0 + kBQ, Tq) - 1;
  const int n_kblk = (Tk + kBK - 1) / kBK;
  const int n_live = causal ? min(n_kblk, q_last / kBK + 1) : n_kblk;

  // Scores stay unscaled: p = 2^(s c - m c) with c = |scale| log2(e) is
  // one FMA, and m |scale| is the row max in natural units for lse.  A
  // negative scale flips the sign of Q's fragments instead (exact).
  const float c = fabsf(scale) * kLog2e;
  const uint32_t q_sign = scale < 0.0f ? 0x80008000u : 0u;

  load_tile<DP, kBQ, kVec>(Qs, qp, sq.t, q0, Tq, D, tid);
  load_tile<DP, kBK, kVec>(Ks, kp, sk.t, 0, Tk, D, tid);
  load_tile<DP, kBK, kVec>(Vs, vp, sv.t, 0, Tk, D, tid);
  cp_async_commit();

  // per-lane ldmatrix row and column (bf16 values) within a 16x16 block:
  // Q as the A operand, K as the B operand of S, V (transposed) as the B
  // operand of O
  const int a_row = warp * 16 * kMT + (lane & 15), a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) * 8;

  uint32_t qf[kMT][Cfg::kQInRegs ? kKSteps : 1][4];
  float acc[kMT][kDTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int d = 0; d < kDTiles; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][d][e] = 0.0f;
  // per row block, rows g and g + 8: the running max (unscaled) and this
  // lane's share of the sum l
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = kMasked;
      l[mt][i] = 0.0f;
    }

  for (int j = 0; j < n_live; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_live) {
      const int nxt = (stage ^ 1) * kBK * kRow;
      load_tile<DP, kBK, kVec>(Ks + nxt, kp, sk.t, (j + 1) * kBK, Tk, D, tid);
      load_tile<DP, kBK, kVec>(Vs + nxt, vp, sv.t, (j + 1) * kBK, Tk, D, tid);
    }
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (Cfg::kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int kk = 0; kk < kKSteps; ++kk) {
            ldmatrix_x4(qf[mt][kk], smem_u32(Qs + (a_row + 16 * mt) * kRow +
                                             kk * 16 + a_col));
#pragma unroll
            for (int e = 0; e < 4; ++e) qf[mt][kk][e] ^= q_sign;
          }
      }
    }
    const __nv_bfloat16* Kt = Ks + stage * kBK * kRow;
    const __nv_bfloat16* Vt = Vs + stage * kBK * kRow;

    // S = Q.K^T: each K fragment feeds the kMT row blocks
    float s[kMT][kNTiles][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if constexpr (Cfg::kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt][kk][e];
        } else {
          ldmatrix_x4(a[mt], smem_u32(Qs + (a_row + 16 * mt) * kRow +
                                      kk * 16 + a_col));
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] ^= q_sign;
        }
      }
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk,
                    smem_u32(Kt + (np * 16 + k_row) * kRow + kk * 16 + k_col));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // Where this tile reaches past Tk or the diagonal: keys past Tk score
    // -inf and causally masked ones -1e30 before the max, and both get
    // p = 0 exactly after the exponential (also when scale is 0).
    // Element e of key tile n of row block mt is row
    // qw + 16 mt + g + 8 (e >> 1), key k0 + 8 n + 2 t + (e & 1).
    const int k0 = j * kBK;
    const bool edge = k0 + kBK > Tk || (causal && k0 + kBK - 1 > qw);
    if (edge) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int n = 0; n < kNTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = qw + 16 * mt + g + 8 * (e >> 1);
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            if (col >= Tk)
              s[mt][n][e] = -INFINITY;
            else if (causal && row < col)
              s[mt][n][e] = kMasked;
          }
    }

    // online softmax: m_new = max(m, row max); P = 2^(S c - m_new c) in
    // f32; l and acc rescaled by 2^((m - m_new) c)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float m_new[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        m_new[0] = fmaxf(m_new[0], fmaxf(s[mt][n][0], s[mt][n][1]));
        m_new[1] = fmaxf(m_new[1], fmaxf(s[mt][n][2], s[mt][n][3]));
      }
      float alpha[2], mc[2], row_sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
        m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
        alpha[i] = exp2_approx((m[mt][i] - m_new[i]) * c);
        mc[i] = m_new[i] * c;
        m[mt][i] = m_new[i];
      }
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(fmaf(s[mt][n][e], c, -mc[e >> 1]));
          if (edge) {
            const int row = qw + 16 * mt + g + 8 * (e >> 1);
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            if (col >= Tk || (causal && row < col)) p = 0.0f;
          }
          s[mt][n][e] = p;
          row_sum[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[mt][i] = l[mt][i] * alpha[i] + row_sum[i];
#pragma unroll
      for (int d = 0; d < kDTiles; ++d) {
        acc[mt][d][0] *= alpha[0];
        acc[mt][d][1] *= alpha[0];
        acc[mt][d][2] *= alpha[1];
        acc[mt][d][3] *= alpha[1];
      }
    }

    // O += P.V, P rounded to bf16 straight from the S fragments; each V
    // fragment feeds the kMT row blocks
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, smem_u32(Vt + (kk * 16 + v_row) * kRow + dp * 16 + v_col));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * dp], pa[mt], bv[0], bv[1]);
          mma_bf16(acc[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }
  cp_async_wait<0>();

  const float abs_scale = fabsf(scale);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int r = qw + 16 * mt + g + 8 * i;
      if (r >= Tq) continue;
      const float l_safe = fmaxf(li, 1e-30f);
      const long long orow = (static_cast<long long>(b) * Tq + r) * H + h;
      __nv_bfloat16* op = o + orow * D;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d) {
        const int col = 8 * d + 2 * t;
        const float x0 = acc[mt][d][2 * i] / l_safe;
        const float x1 = acc[mt][d][2 * i + 1] / l_safe;
        if ((D & 1) == 0) {  // then op + col is 4-byte aligned
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(op + col) =
                __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < D) op[col] = __float2bfloat16_rn(x0);
          if (col + 1 < D) op[col + 1] = __float2bfloat16_rn(x1);
        }
      }
      if (t == 0) lse[orow] = m[mt][i] * abs_scale + logf(l_safe);
    }
}

template <int DP, bool kVec>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int Tk, int D, Strides sq, Strides sk,
           Strides sv, float scale, int causal, cudaStream_t stream) {
  const int n_qblk = (Tq + Tile<DP>::kBQ - 1) / Tile<DP>::kBQ;
  const long long blocks = static_cast<long long>(n_qblk) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Tile<DP>::kSmemBytes;
  // per device, so set before every launch (a host-side call)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DP, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bf16_kernel<DP, kVec>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), lse, H, Tq, Tk, D, sq, sk, sv, scale,
          causal, n_qblk);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int H, int Tq, int Tk, int D, Strides sq, Strides sk,
             Strides sv, float scale, int causal, cudaStream_t stream) {
  if (D <= 16)
    return launch<16, kVec>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv,
                            scale, causal, stream);
  if (D <= 32)
    return launch<32, kVec>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv,
                            scale, causal, stream);
  if (D <= 64)
    return launch<64, kVec>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv,
                            scale, causal, stream);
  if (D <= 128)
    return launch<128, kVec>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv,
                             scale, causal, stream);
  return launch<256, kVec>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv,
                           scale, causal, stream);
}

}  // namespace

extern "C" {

// Enqueues one bf16 forward on `stream` and returns the cudaGetLastError()
// code of the launch (0 = cudaSuccess).  q, k, v: bf16 (B, T, H, D),
// element strides (batch, seq, head) given, head dim contiguous; o:
// contiguous bf16 (B, Tq, H, D); lse: contiguous f32 (B, Tq, H).
// 1 <= D <= 256.  vec_loads != 0 promises 16-byte aligned row starts
// (every data pointer and stride times 2 bytes a multiple of 16, D a
// multiple of 8) and selects the cp.async loader.
int mxtt_flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, float* lse, int B, int H, int Tq,
                                  int Tk, int D, long long q_sb,
                                  long long q_st, long long q_sh,
                                  long long k_sb, long long k_st,
                                  long long k_sh, long long v_sb,
                                  long long v_st, long long v_sh, float scale,
                                  int causal, int vec_loads,
                                  cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh},
      sv{v_sb, v_st, v_sh};
  if (vec_loads)
    return dispatch<true>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv, scale,
                          causal, stream);
  return dispatch<false>(q, k, v, o, lse, B, H, Tq, Tk, D, sq, sk, sv, scale,
                         causal, stream);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
