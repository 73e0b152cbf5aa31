// int8 x int8 -> int32 convolution (NCHW data, OIHW weights, stride, pad,
// dilation, groups) as an implicit GEMM on Hopper's tensor cores
// (sm_90a: cp.async into a ring of swizzled tiles, wgmma m64nNk32
// s32.s8.s8 from shared memory, an epilogue staged through shared
// memory).  Plain C interface, loaded through ctypes by
// mxnet_tpu_torch/kernels/__init__.py and reached through the
// mxnet_tpu_torch::int8_conv custom op of mxnet_tpu_torch/ops/quantization.py.
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
// columns f = the group's filters, Fg; depth k = (ky, kx, c), channels
// innermost, each group's Cg channels padded with zeros to Cg16, a
// multiple of 16.  So one 16-byte piece of a data row is one (ky, kx,
// 16 channels) run of one input pixel, and of a weight row 16 contiguous
// bytes.
//
// Layout pass: int8_nhwc_kernel rewrites the data as NHWC int8 with the
// padded channels (N, H, W, groups Cg16) into the caller's workspace, in
// the same call: 256 pixels x 64 channels a block through shared memory,
// read as words of 4 pixels (bytes when HW is not a multiple of 4 or x
// is not 4-byte aligned), transposed 4 x 4 bytes with byte permutes,
// written as 16-byte pieces.  It reads the data once and writes N H W
// groups Cg16 bytes (at conv1_2, (32, 64, 300, 300): 184 MB each way,
// 0.11 ms at 3.35 TB/s).  A 1x1 map whose Cg is a multiple of 16 (a fully
// connected layer) is that layout already and skips it.  The wrapper
// permutes the weights to (F, KH, KW, Cg16) rows (a view for a 1x1
// kernel).
//
// Main loop: a block computes BM = 64 WG rows x BN filters (BN 32, 64 or
// 128 set by Fg: the SSD's 64, 128, 256, 84 and 16 filters are masked,
// not padded in memory), WG warpgroups of 128 threads, each the 64-row
// wgmma of its rows.  A stage is a 128-byte depth slice of the A (BM
// rows) and B (BN rows) tiles, each row 128 bytes in the 128-byte swizzle
// (16-byte piece c of row r at c ^ (r mod 8)), which wgmma reads K-major
// as int8 requires; four m64nBNk32 products a stage.  Every A and B piece
// is one 16-byte cp.async from a pointer kept a row and an offset kept a
// thread (no division a stage); padding, the ragged edges and the k tail
// are zero-filled with src-size 0.  The stages form a ring of 4 in
// dynamic shared memory: 2 stages in flight while one wgmma group runs,
// one barrier a stage (cp.async.wait_group, fence.proxy.async,
// __syncthreads).  The block is persistent: it walks tiles blockIdx.x, +
// gridDim.x, ... and its ring runs across tiles, so a tile's epilogue
// overlaps the next tile's copies.
//
// Epilogue, after the stage loop (ptxas serializes every wgmma, waiting
// for each product, when a divergent path inside the loop touches the
// accumulators, and says so with -v): the int32 accumulators go through the
// ring slot consumed last, 32 or 64 filters a pass, transposed to
// filter-major, and each filter's rows leave as 16-byte runs along its
// contiguous Ho Wo plane (Ho Wo a multiple of 4), so a warp writes whole
// 128-byte lines; a 1x1 map writes 16-byte runs of filters; anything else
// one int32 a thread, a warp 128 contiguous bytes of the plane.
//
// Grid: as many blocks as fit on the card (2 an SM at 64 filters, 1 at
// 128); WG = 2 (128 rows, 256 threads) unless that leaves SMs without two
// tiles each, then WG = 1 with at most 64 filters (fc7, 256 x 4096 ->
// 4096: 4 x 64 tiles of 64 x 64, 32 stages each).
//
// Bound at the SSD's shapes: bytes.  conv1_2 at (32, 64, 300, 300) -> 64
// is 106 GMAC (0.11 ms at 1,979 TOP/s) against 0.18 GB of int8 read and
// 0.74 GB of int32 written (0.2751 ms at 3.35 TB/s); the layout pass adds
// 0.37 GB.  Only stage3's 256 -> 256 layers are bound by operations
// (0.107 ms).  What holds the kernel back on the card is the copies into
// shared memory: an implicit GEMM reads each input pixel once a tap from
// L2 (9 times for 3x3), and the copies alone, with no product and no
// store, run near L2's rate.  A direct convolution that copies each tile's
// halo once and builds the A rows in shared memory was tried and measured
// slower (its shared-memory copies cost what the L2 reads did).  ptxas's
// registers and spills a kernel: chip_smoke.py's build line
// (ptxas_summary).
//
// Exact: int32 sums of int8 products, |sum| <= 127^2 K < 2^31 for any
// K below 133,000; the same bits as the plain version (an f64
// convolution rounded to int32) whatever the order of the sum.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 128;          // depth bytes a stage: one swizzled row
constexpr int kPieces = kBK / 16; // 16-byte pieces a stage row
constexpr int kSMs = 132;         // H100 SXM
constexpr int kMaxDevices = 64;   // devices whose grid size is kept
constexpr int kRingStages = 4;    // cp.async ring: 2 stages loaded ahead,
constexpr int kLead = 2;          // one wgmma group in flight
constexpr int kLP = 256;          // the layout pass's pixels a block
constexpr int kLC = 64;           // ... and output channels

struct Conv {
  int N, C, H, W;       // data
  int F, KH, KW;        // filters (all groups) and kernel
  int Ho, Wo;
  int sh, sw, ph, pw, dh, dw;
  int groups, Cg, Fg;
  int Cg16;             // Cg rounded up to 16
  int Cp;               // bytes of a pixel in the NHWC data: groups Cg16
  int cpk;              // 16-byte pieces of one (ky, kx) tap: Cg16 / 16
  int Kq;               // 16-byte pieces of a weight row: KH KW cpk
  int KT;               // stages: ceil(Kq / kPieces)
  int HoWo;
  long long M;          // N Ho Wo
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte swizzled rows: start
// address >> 4, leading offset 1 (unused for swizzled K-major), stride
// 1024 bytes between 8-row groups, layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// NCHW int8 -> NHWC int8 with each group's channels padded to Cg16.
// grid (pixel tiles x images, channel tiles), 256 threads; a block moves
// 256 pixels x 64 output channels through shared memory: words of 4
// pixels in when words is set (HW a multiple of 4 and x 4-byte aligned;
// else bytes), then each thread transposes 4 pixels x 16 channels with
// byte permutes and stores them as 16-byte pieces, 4 threads covering a
// pixel's 64 contiguous bytes.
__global__ void __launch_bounds__(256)
int8_nhwc_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ y,
                 int C, int HW, int Cg, int Cg16, int Cp, int tiles,
                 bool words) {
  __shared__ uint32_t t[kLC][kLP / 4 + 1];        // [channel][pixel / 4]
  const int n = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - n * tiles) * kLP;
  const int oc0 = blockIdx.y * kLC;
  const int tid = threadIdx.x;
  const int8_t* xn = x + static_cast<long long>(n) * C * HW;
  if (words) {
#pragma unroll 4
    for (int i = 0; i < kLC * kLP / 4 / 256; ++i) {
      const int idx = tid + 256 * i;
      const int cl = idx / (kLP / 4), wq = idx - cl * (kLP / 4);
      const int oc = oc0 + cl, p = p0 + 4 * wq;
      uint32_t v = 0;
      if (oc < Cp && p < HW) {
        const int g = oc / Cg16, c = oc - g * Cg16;
        if (c < Cg)
          v = *reinterpret_cast<const uint32_t*>(
              xn + static_cast<long long>(g * Cg + c) * HW + p);
      }
      t[cl][wq] = v;
    }
  } else {
    uint8_t* tb = reinterpret_cast<uint8_t*>(&t[0][0]);
    for (int i = 0; i < kLC * kLP / 256; ++i) {
      const int idx = tid + 256 * i;
      const int cl = idx / kLP, pl = idx - cl * kLP;
      const int oc = oc0 + cl, p = p0 + pl;
      uint8_t v = 0;
      if (oc < Cp && p < HW) {
        const int g = oc / Cg16, c = oc - g * Cg16;
        if (c < Cg)
          v = static_cast<uint8_t>(xn[static_cast<long long>(g * Cg + c) * HW
                                      + p]);
      }
      tb[cl * (kLP + 4) + pl] = v;
    }
  }
  __syncthreads();
  const int piece = tid & 3, q4 = tid >> 2;       // 16 channels, 4 pixels
  const int oc = oc0 + 16 * piece;
  if (oc >= Cp) return;                           // Cp is a multiple of 16
  uint32_t px[4][4];                              // [pixel][4 channels]
#pragma unroll
  for (int c4 = 0; c4 < 4; ++c4) {
    const uint32_t* r = &t[16 * piece + 4 * c4][q4];
    const uint32_t w0 = r[0], w1 = r[kLP / 4 + 1], w2 = r[2 * (kLP / 4 + 1)],
                   w3 = r[3 * (kLP / 4 + 1)];
    const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
    const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
    const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
    const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
    px[0][c4] = __byte_perm(lo01, lo23, 0x5410);
    px[1][c4] = __byte_perm(lo01, lo23, 0x7632);
    px[2][c4] = __byte_perm(hi01, hi23, 0x5410);
    px[3][c4] = __byte_perm(hi01, hi23, 0x7632);
  }
  int8_t* yn = y + static_cast<long long>(n) * HW * Cp + oc;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int p = p0 + 4 * q4 + e;
    if (p < HW)
      *reinterpret_cast<uint4*>(yn + static_cast<long long>(p) * Cp) =
          make_uint4(px[e][0], px[e][1], px[e][2], px[e][3]);
  }
}

template <int WG, int BN>
struct Tiles {
  static constexpr int kThreads = 128 * WG;
  static constexpr int BM = 64 * WG;
  static constexpr int kAStage = BM * kBK;
  static constexpr int kStage = (BM + BN) * kBK;
  static constexpr int kLD = BM + 4;             // staged epilogue row
  // filters an epilogue pass stages in the ring slot just consumed
  static constexpr int kFP = BN * kLD * 4 <= kStage ? BN
                             : (BN / 2) * kLD * 4 <= kStage ? BN / 2
                             : BN / 4;
  static constexpr int kArows = 4;               // A pieces a thread
  static constexpr int kBrows = BN * kPieces / kThreads;
  static constexpr int S = kRingStages;
  static constexpr int kSmem = S * kStage + 1024;
  static_assert(kFP * kLD * 4 <= kStage, "epilogue pass too large");
  static_assert(kBrows >= 1, "BN too small for the block");
};

// One block walks tiles blockIdx.x, + gridDim.x, ...; its cp.async ring
// of S stages runs across tile boundaries, kLead stages ahead, so the next
// tile's loads are in flight while a tile's epilogue stores; one wgmma
// group stays in flight (kLead = S - 2).  The stage loop holds nothing
// but the copies and the products, and the epilogue follows it: ptxas
// serializes wgmma whose accumulators a divergent path touches.
template <int WG, int BN>
__global__ void __launch_bounds__(128 * WG)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ out, Conv p) {
  using T = Tiles<WG, BN>;
  constexpr int kThreads = T::kThreads, BM = T::BM;
  constexpr int kRowStep = kThreads / kPieces;   // rows between a thread's
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t sbase = raw + pad;              // 1024-byte aligned ring
  uint8_t* ring = smem_raw + pad;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int j = tid & (kPieces - 1);             // this thread's piece
  const int r_first = tid / kPieces;
  const int nR = static_cast<int>((p.M + BM - 1) / BM);
  const int nF = (p.Fg + BN - 1) / BN;
  const int total = nR * nF * p.groups;
  if (static_cast<int>(blockIdx.x) >= total) return;
  const int n_mine = (total - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int G = n_mine * p.KT;                   // stages of this block
  const int M = static_cast<int>(p.M);
  constexpr int S = T::S;

  // the tile being loaded: each of this thread's A rows as a pointer to
  // its first tap's pixel (which may lie in the padding: it is only read
  // where the tap lands inside the image) and that pixel's y and x; its B
  // rows; and its piece's depth position (ky, kx, 16-channel run cc)
  const int8_t* arow[T::kArows];
  int iy0[T::kArows], ix0[T::kArows];
  const int8_t* brow[T::kBrows];
  int ld_i = -1, ld_kt = 0, ld_slot = 0;
  int ky = 0, kx = 0, cc = j;                    // piece q = j of stage 0
  auto set_load_tile = [&](int i) {
    const int t = blockIdx.x + i * gridDim.x;
    const int rt = t % nR, rest = t / nR;
    const int ft = rest % nF, grp = rest / nF;
    const int m0 = rt * BM, f0 = ft * BN;
#pragma unroll
    for (int a = 0; a < T::kArows; ++a) {
      const int m = m0 + r_first + kRowStep * a;
      const int mm = m < M ? m : 0;
      const int img = mm / p.HoWo, pix = mm - img * p.HoWo;
      const int oy = pix / p.Wo, ox = pix - oy * p.Wo;
      const int iy = oy * p.sh - p.ph;
      ix0[a] = ox * p.sw - p.pw;
      arow[a] = x + static_cast<long long>(img) * p.H * p.W * p.Cp
                + grp * p.Cg16
                + (static_cast<long long>(iy) * p.W + ix0[a]) * p.Cp;
      iy0[a] = m < M ? iy : -(1 << 29);   // a row past M reads no tap
    }
#pragma unroll
    for (int b = 0; b < T::kBrows; ++b) {
      const int f = f0 + r_first + kRowStep * b;
      // filters past Fg read nothing: their pieces count as past the depth
      brow[b] = f < p.Fg ? w + (static_cast<long long>(grp) * p.Fg + f)
                               * (16LL * p.Kq)
                         : nullptr;
    }
    ky = 0, kx = 0, cc = j;
    while (cc >= p.cpk && ky < p.KH) {           // piece j's tap
      cc -= p.cpk;
      if (++kx == p.KW) kx = 0, ++ky;
    }
  };
  auto load = [&]() {                            // the next stage in order
    if (ld_kt == 0) set_load_tile(++ld_i);
    const int q = ld_kt * kPieces + j;
    if (++ld_kt == p.KT) ld_kt = 0;
    const bool qok = q < p.Kq;
    const int dy = ky * p.dh, dx = kx * p.dw;
    const int off = (dy * p.W + dx) * p.Cp + cc * 16;
    const uint32_t sA = sbase + ld_slot * T::kStage;
    const uint32_t sB = sA + T::kAStage;
    if (++ld_slot == S) ld_slot = 0;
#pragma unroll
    for (int a = 0; a < T::kArows; ++a) {
      const int r = r_first + kRowStep * a;
      const bool v = qok && static_cast<unsigned>(iy0[a] + dy) <
                     static_cast<unsigned>(p.H) &&
                     static_cast<unsigned>(ix0[a] + dx) <
                     static_cast<unsigned>(p.W);
      cp_async16(sA + r * kBK + ((j ^ (r & 7)) << 4), v ? arow[a] + off : x,
                 v ? 16 : 0);
    }
#pragma unroll
    for (int b = 0; b < T::kBrows; ++b) {
      const int r = r_first + kRowStep * b;
      const bool v = qok && brow[b] != nullptr;
      cp_async16(sB + r * kBK + ((j ^ (r & 7)) << 4), v ? brow[b] + 16 * q
                                                        : w, v ? 16 : 0);
    }
    // the piece 8 further on: cc += 8 runs of 16 channels, carried into kx
    // and ky
    cc += kPieces;
    while (cc >= p.cpk && ky < p.KH) {
      cc -= p.cpk;
      if (++kx == p.KW) kx = 0, ++ky;
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  for (int s = 0; s < kLead; ++s) {
    if (s < G) load();
    cp_async_commit();
  }
  int g = 0, slot = 0;                           // the stage being computed
  for (int ci = 0; ci < n_mine; ++ci) {
    for (int kt = 0; kt < p.KT; ++kt, ++g) {
      cp_async_wait<kLead - 1>();                // stage g has landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();                           // ... for every thread
      if (g + kLead < G) load();                 // into a slot no wgmma
      cp_async_commit();                         // still reads
      const uint32_t sA = sbase + slot * T::kStage;
      const uint64_t da = make_desc(sA + wg * 64 * kBK);
      const uint64_t db = make_desc(sA + T::kAStage);
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);   // +32 bytes of depth
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_operands(acc);
      if (++slot == S) slot = 0;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
    // the epilogue, staged in the slot consumed last (refilled only after
    // the next barrier)
    uint8_t* consumed = ring + (slot == 0 ? S - 1 : slot - 1) * T::kStage;
    const int t = blockIdx.x + ci * gridDim.x;
    const int rt = t % nR, rest = t / nR;
    const int ft = rest % nF, grp = rest / nF;
    const int m0 = rt * BM, f0 = ft * BN;
    int32_t* stage = reinterpret_cast<int32_t*>(consumed);
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int row = wg * 64 + warp * 16 + (lane >> 2);
    const int col = 2 * (lane & 3);
#pragma unroll
    for (int pass = 0; pass < BN / T::kFP; ++pass) {
      // accumulator i of a thread: row 16 warp + lane/4 (+8 when bit 1
      // of i is set), filter 8 (i/4) + 2 (lane%4) (+1 for odd i); this
      // pass stages filters [pass kFP, (pass + 1) kFP) as [filter][row]
      __syncthreads();             // every wgmma read / earlier pass done
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        if ((8 * (i >> 2)) / T::kFP != pass) continue;
        stage[(8 * (i >> 2) - pass * T::kFP + col + (i & 1)) * T::kLD + row
              + 8 * ((i >> 1) & 1)] = acc[i];
        acc[i] = 0;
      }
      __syncthreads();
      const int fp0 = f0 + pass * T::kFP;
      const int fbase = grp * p.Fg + fp0;
      if (p.HoWo % 4 == 0) {      // 16-byte runs along each filter's plane
        // kThreads is a multiple of BM / 4: a thread keeps its 4 rows
        const int g4 = tid % (BM / 4);
        const int m = m0 + 4 * g4;
        if (m < M) {
          const int img = m / p.HoWo, pix = m - img * p.HoWo;
          int32_t* o = out + static_cast<long long>(img * p.F + fbase)
                             * p.HoWo + pix;
          for (int f = tid / (BM / 4); f < T::kFP; f += kThreads / (BM / 4)) {
            if (fp0 + f >= p.Fg) break;
            *reinterpret_cast<int4*>(o + static_cast<long long>(f) * p.HoWo)
                = *reinterpret_cast<const int4*>(stage + f * T::kLD + 4 * g4);
          }
        }
      } else if (p.HoWo == 1 && p.Fg % 4 == 0) {  // 16-byte runs of filters
        for (int e = tid; e < BM * (T::kFP / 4); e += kThreads) {
          const int r = e / (T::kFP / 4), f = 4 * (e - r * (T::kFP / 4));
          const int m = m0 + r;
          if (fp0 + f >= p.Fg || m >= M) continue;
          const int4 v = make_int4(stage[f * T::kLD + r],
                                   stage[(f + 1) * T::kLD + r],
                                   stage[(f + 2) * T::kLD + r],
                                   stage[(f + 3) * T::kLD + r]);
          *reinterpret_cast<int4*>(out + static_cast<long long>(m) * p.F
                                   + fbase + f) = v;
        }
      } else {                    // one int32 a thread, along the plane
        // kThreads is a multiple of BM: a thread keeps its row
        const int r = tid % BM;
        const int m = m0 + r;
        if (m < M) {
          const int img = m / p.HoWo, pix = m - img * p.HoWo;
          int32_t* o = out + static_cast<long long>(img * p.F + fbase)
                             * p.HoWo + pix;
          for (int f = tid / BM; f < T::kFP; f += kThreads / BM) {
            if (fp0 + f >= p.Fg) break;
            o[static_cast<long long>(f) * p.HoWo] = stage[f * T::kLD + r];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The blocks of a persistent grid: as many as fit on the card at once (SMs
// x resident blocks an SM), or minus the CUDA error code.  The
// shared-memory attribute and the occupancy query cost host time, so they
// run on a kernel's first call on each device and the count is kept.
template <int WG, int BN>
long long resident_blocks() {
  using T = Tiles<WG, BN>;
  static std::atomic<long long> kept[kMaxDevices];   // 0: not yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const bool keep = device < kMaxDevices;
  if (keep) {
    const long long k = kept[device].load(std::memory_order_acquire);
    if (k > 0) return k;
  }
  err = cudaFuncSetAttribute(int8_conv_kernel<WG, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  int sms = kSMs, per_sm = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, int8_conv_kernel<WG, BN>, T::kThreads, T::kSmem)
      != cudaSuccess || per_sm < 1)
    per_sm = 1;
  const long long slots = static_cast<long long>(sms) * per_sm;
  if (keep) kept[device].store(slots, std::memory_order_release);
  return slots;
}

template <int WG, int BN>
int launch(const int8_t* x, const int8_t* w, int32_t* out, const Conv& p,
           cudaStream_t stream) {
  using T = Tiles<WG, BN>;
  const long long slots = resident_blocks<WG, BN>();
  if (slots < 0) return static_cast<int>(-slots);
  const long long tiles = (p.M + T::BM - 1) / T::BM
                          * ((p.Fg + BN - 1) / BN) * p.groups;
  const unsigned blocks = static_cast<unsigned>(tiles < slots ? tiles : slots);
  int8_conv_kernel<WG, BN><<<blocks, T::kThreads, T::kSmem, stream>>>(
      x, w, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (N, C, H, W) int8, contiguous (16-byte aligned when ws is null); w
// (F, KH, KW, Cg16) int8 rows (each group's channels zero-padded to Cg16,
// a multiple of 16), 16-byte aligned; out (N, F, Ho, Wo) int32; ws N H W
// groups Cg16 bytes of workspace for the NHWC data, or null when x is a
// 1x1 map whose Cg is a multiple of 16 (already that layout).  Launches the
// layout pass (unless ws is null) and the convolution.  Returns the
// cudaGetLastError() code of the first launch that failed (0 =
// cudaSuccess).
int mxtt_int8_conv(const void* x, const void* w, void* out, void* ws, int N,
                   int C, int H, int W, int F, int KH, int KW, int sh,
                   int sw, int ph, int pw, int dh, int dw, int groups,
                   void* stream) {
  Conv p;
  p.N = N; p.C = C; p.H = H; p.W = W; p.F = F; p.KH = KH; p.KW = KW;
  p.sh = sh; p.sw = sw; p.ph = ph; p.pw = pw; p.dh = dh; p.dw = dw;
  p.Ho = (H + 2 * ph - (dh * (KH - 1) + 1)) / sh + 1;
  p.Wo = (W + 2 * pw - (dw * (KW - 1) + 1)) / sw + 1;
  p.groups = groups;
  p.Cg = C / groups;
  p.Fg = F / groups;
  p.Cg16 = (p.Cg + 15) / 16 * 16;
  p.Cp = groups * p.Cg16;
  p.cpk = p.Cg16 / 16;
  p.Kq = KH * KW * p.cpk;
  p.KT = (p.Kq + kPieces - 1) / kPieces;
  p.HoWo = p.Ho * p.Wo;
  p.M = static_cast<long long>(N) * p.HoWo;
  if (p.M <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xd = static_cast<const int8_t*>(x);
  if (ws != nullptr) {
    const int HW = H * W;
    const int tiles = (HW + kLP - 1) / kLP;
    dim3 grid(static_cast<unsigned>(tiles) * N,
              static_cast<unsigned>((p.Cp + kLC - 1) / kLC));
    const bool words = (HW & 3) == 0
                       && (reinterpret_cast<uintptr_t>(x) & 3) == 0;
    int8_nhwc_kernel<<<grid, 256, 0, s>>>(xd, static_cast<int8_t*>(ws), C,
                                          HW, p.Cg, p.Cg16, p.Cp, tiles,
                                          words);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    xd = static_cast<const int8_t*>(ws);
  }
  const int8_t* wd = static_cast<const int8_t*>(w);
  int32_t* o = static_cast<int32_t*>(out);
  // 128-row tiles of 256 threads, unless they leave SMs without two
  // tiles each: then 64-row tiles of at most 64 filters (fc7: 4 x 64)
  const int bn = p.Fg <= 32 ? 32 : p.Fg <= 64 ? 64 : 128;
  const long long tiles2 = (p.M + 127) / 128 * ((p.Fg + bn - 1) / bn)
                           * groups;
  if (tiles2 >= 2 * kSMs) {
    if (bn == 32) return launch<2, 32>(xd, wd, o, p, s);
    if (bn == 64) return launch<2, 64>(xd, wd, o, p, s);
    return launch<2, 128>(xd, wd, o, p, s);
  }
  if (bn == 32) return launch<1, 32>(xd, wd, o, p, s);
  return launch<1, 64>(xd, wd, o, p, s);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
