// Quantized-weight matmul: out[M, N] = x[M, K] @ (codes[K, N] * scales).
//
// Replaces the TPU kernels `qmm` and `qmm_int4` in src/repro/kernels/qmm.py
// (bodies `_qmm_kernel` and `_qmm_int4_kernel`), reached through
// `ops.quantized_matmul` and `ops.quantized_matmul_int4`.  Every agent-stage
// matmul of the quantized co-inference forward runs here: int8 codes for
// layers at 5..8 bits, packed int4 (two codes per byte along K, low nibble
// first, two's complement) for layers at <= 4 bits.  Each f32 scale covers
// G consecutive contraction rows of one output column.
//
// Two routes, chosen by the wrapper from the shape alone (qmm.route):
// * tensor cores (qmm_wgmma_f32, qmm_int4_wgmma_f32) when G is a multiple
//   of 16 and N of 16 (TMA needs 16-byte rows): every main-path shape;
// * SIMT (qmm_f32, qmm_int4_f32) for the rest, e.g. per-element groups
//   (G = 1), N = 127, K = 200: a tiled f32 GEMM, one ascending-k fmaf
//   chain per output, codes dequantized as they are staged.
//
// What bounds the tensor-core route on an H100: it issues three bf16
// products per code, 3 * 2MNK operations at 989 TFLOP/s, against the codes
// (K*N bytes, K*N/2 for int4), scales, x and out at 3.35 TB/s.  At M = 256
// the serving shapes are operation-bound (3 * 45.8 GFLOP per forward:
// 0.139 ms; bytes 0.070 ms int8, 0.056 ms int4); at M = 1 every shape is
// bound by its code bytes (down projection int8: 4.37 MB, 1.3 us).
//
// Design.  The f32 activation cannot go to the tensor cores as it is
// (no f32 wgmma; TF32 keeps ~11 bits of x; fp8 and int8 products lose
// more or accumulate in reduced precision), but every code is an integer
// with |c| <= 127, exact in bf16, and x splits exactly into three bf16
// pieces, hi = bf16(x), mid = bf16(x - hi), lo = x - hi - mid.  Each
// piece * code is exact in f32, so within a group
//     sum_k x c = sum hi c + sum mid c + sum lo c,
// three bf16 wgmmas accumulating one f32 partial; at each group boundary
// the partial is promoted, total = fmaf(partial, scale[g, n], total), one
// scale per (group, column).  One block is one warpgroup (128 threads) and
// one 64 x 128 output tile (m64n128k16):
// * x is the wgmma A operand, from registers: each thread reads its
//   fragment of the f32 x tile (float2, conflict-free under the 128-byte
//   swizzle) and splits it there (two paired cvt.rn.bf16x2 per pair), so
//   the pieces never touch memory;
// * the code tile is B, from shared memory, MN-major as the codes lie
//   ([k][n], wgmma trans-b): 8 codes per 8-byte load become 8 exact bf16
//   by placing each byte under an f32 exponent (one byte_perm and one
//   subtraction per code), into one of two B buffers, so a stage's codes
//   convert while the previous stage's wgmmas run;
// * a ring of 3 stages (x [64, 64] f32 as two 128-byte-swizzled boxes,
//   codes [64, 128], the scale rows [4, 128] of the groups that can end in
//   the stage; 111 KB in all, two blocks to an SM), each filled by TMA on
//   its mbarrier, 2 stages ahead, the four copies of a refill issued by
//   the four warps; out of bounds zero-filled (ragged M, N and K edges:
//   no padding by the caller);
// * split K fills the card: the grid is (N/128, M/64, splits), splits from
//   (K, N, G, SM count) only (qmm.splits: 4 for the main path's 896-deep
//   shapes and the down projection, 1 for gate/up), each split whole
//   groups; every split writes its f32 total to a workspace and the last
//   block of the tile to arrive (an arrival counter it resets) sums them
//   in ascending split order, in the same launch; never an atomic add of
//   values.
// This layout (x as A in registers, codes as B) was chosen over the
// transposed one (codes as A, x pieces as B in shared memory) by analysis,
// not by timing both: the split then costs no shared-memory traffic, the
// codes are converted once per stage for all 64 rows, and M = 64, the
// sequential engine's shape, is one row tile either way.
// What holds it back (tools/qmm_tune.py --clock on an H100: ~2,780
// cycles per 64-deep stage for 64 x 128 x 64 x 3 bf16 MACs that the
// tensor cores finish in ~770): one warpgroup issues the wgmmas (817; the
// issue stalls until they drain), converts the next codes (~860), splits
// the next x (~640) and promotes (144 a stage), in series; the split and
// conversion, repeated by every block of a row tile, are the next work (a
// converter warpgroup beside the MMA one, or the split into shared memory
// for an SS wgmma).
//
// Error.  For |x| from 2^-103 (~1e-31, so that lo is not subnormal) to
// bf16's largest (3.39e38), hi + mid + lo == x exactly: RN to 8
// significant bits leaves a remainder of at most 16, then 8, significant
// bits.  Products of pieces and codes (8 x 7 bits) are exact in f32; the
// error is that of f32 accumulation (inside the tensor cores, then the
// promotion's fmaf), ~K/16 roundings of 2^-24 relative, the same order as
// the f32 SIMT route and the plain version (tests/test_torch_qmm_split.py
// emulates this order against ref.qmm_ref within 1e-5 relative at
// K = 4864; on the card the kernel is within 7.6e-6 of the plain version
// at the main path's shapes).
//
// Row independence, by construction: tile shapes, the instruction, the K
// order, group promotion and the split count depend on (K, N, G) and the
// SM count, never on M; the tensor cores and the promotion compute each
// output from its own row of x alone.  So a row's bits are the same alone
// (M = 1), in the sequential engine (M = 64) and in the batched one
// (M = 256).  The SIMT route keeps the same property (one ascending-k
// fmaf chain per output).
//
// Build (nvcc -Xptxas -v, sm_90a, CUDA 12.8, as chip_smoke.py phase 2
// prints it): qmm_wgmma_kernel<int8 / int4> 255 registers, an 8-byte stack
// frame with 4 bytes spilled, 16 bytes of static and 113,688 of dynamic
// shared memory; simt::qmm_kernel 80 registers, 16,512 bytes of shared
// memory, 12 / 4 bytes spilled.

#include <atomic>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// ---------------------------------------------------------------------------
// The SIMT route: a tiled f32 GEMM for the shapes the tensor-core route
// does not take (G off a multiple of 16, N off 16-byte rows).
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;  // even, so an int4 tile never splits a byte
constexpr int kThreads = 256;
constexpr int kXPer = kBM * kBK / kThreads;  // x elements a thread stages
constexpr int kWPer = kBK * kBN / kThreads;  // codes a thread stages

// Code at contraction row `k`, column `n`, sign-extended to int.
template <bool kInt4>
__device__ __forceinline__ int load_code(const int8_t* __restrict__ w,
                                         int k, int n, int ncols) {
  if constexpr (kInt4) {
    const int byte = w[static_cast<long long>(k >> 1) * ncols + n];
    const int nib = (k & 1) ? (byte >> 4) & 0x0F : byte & 0x0F;
    return nib >= 8 ? nib - 16 : nib;
  } else {
    return w[static_cast<long long>(k) * ncols + n];
  }
}

// The global loads of one K step, held in registers so that the next
// step's loads are in flight while the current step computes.
template <bool kInt4>
struct Stage {
  float x[kXPer];
  int code[kWPer];
  float scale[kWPer];

  // x[m0 + xr + 8p, k0 + xc] and codes/scales[k0 + wr + 4p, n0 + wc]
  __device__ __forceinline__ void load(
      const float* __restrict__ xp, const int8_t* __restrict__ w,
      const float* __restrict__ scales, int m, int k, int n, int group,
      int m0, int n0, int k0, int tid) {
    const int xr = tid / kBK, xc = tid % kBK;
    const int gk = k0 + xc;
#pragma unroll
    for (int p = 0; p < kXPer; ++p) {
      const int gm = m0 + xr + p * (kThreads / kBK);
      x[p] = (gm < m && gk < k) ? xp[static_cast<long long>(gm) * k + gk]
                                : 0.0f;
    }
    const int wr = tid / kBN, wc = tid % kBN;
    const int gn = n0 + wc;
#pragma unroll
    for (int p = 0; p < kWPer; ++p) {
      const int gkw = k0 + wr + p * (kThreads / kBN);
      const bool ok = gkw < k && gn < n;
      code[p] = ok ? load_code<kInt4>(w, gkw, gn, n) : 0;
      scale[p] = ok ? scales[static_cast<long long>(gkw / group) * n + gn]
                    : 0.0f;
    }
  }

  // Transposed x tile and the dequantized code tile into shared memory.
  __device__ __forceinline__ void store(float (*xs)[kBM + 1],
                                        float (*ws)[kBN], int tid) const {
    const int xr = tid / kBK, xc = tid % kBK;
#pragma unroll
    for (int p = 0; p < kXPer; ++p) xs[xc][xr + p * (kThreads / kBK)] = x[p];
    const int wr = tid / kBN, wc = tid % kBN;
#pragma unroll
    for (int p = 0; p < kWPer; ++p)
      ws[wr + p * (kThreads / kBN)][wc] =
          static_cast<float>(code[p]) * scale[p];
  }
};

template <bool kInt4>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scales, float* __restrict__ out,
           int m, int k, int n, int group) {
  // +1 column of padding: the x tile is stored transposed, and without it
  // the 32 threads of a warp (32 consecutive k of one row) would all hit
  // the same shared-memory bank
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns columns tx + 16 * j
  const int ty = tid / 16;  // owns rows ty + 16 * i
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  Stage<kInt4> stage;
  stage.load(x, w, scales, m, k, n, group, m0, n0, 0, tid);
  for (int k0 = 0; k0 < k; k0 += kBK) {
    stage.store(xs, ws, tid);
    __syncthreads();
    if (k0 + kBK < k)  // next step's loads overlap this step's FMAs
      stage.load(x, w, scales, m, k, n, group, m0, n0, k0 + kBK, tid);

    const int kmax = min(kBK, k - k0);
    if (kmax == kBK) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    } else {
      // the ragged K tail: the same ascending chain, only shorter, so no
      // zero products are ever added
      for (int kk = 0; kk < kmax; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n) out[static_cast<long long>(gm) * n + gn] = acc[i][j];
    }
  }
}

template <bool kInt4>
int launch(const void* x, const void* w, const void* scales, void* out,
           int m, int k, int n, int group, void* stream) {
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  qmm_kernel<kInt4><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<float*>(out),
      m, k, n, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// The tensor-core route: bf16 wgmma on exact codes and a three-piece split
// of x, promoted per group in f32.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 64;            // rows of x per block: the wgmma M
constexpr int kBN = 128;           // output columns per block: the wgmma N
constexpr int kBK = 64;            // contraction rows per pipeline stage
constexpr int kChunk = 16;         // the bf16 wgmma's K
constexpr int kStages = 3;         // ring depth: TMA runs 2 stages ahead
constexpr int kScaleRows = 4;      // groups that can end in one stage (G >= 16)
constexpr int kThreads = 128;      // one warpgroup

// One stage of the ring: x as two TMA boxes of [64 rows, 32 f32] (128-byte
// swizzle), the code tile [64 k, 128 n] int8 ([32, 128] packed int4) as it
// lies in memory, and the scale rows [4, 128] of the groups that can end in
// the stage.  Then two bf16 copies of the codes (the wgmma B operand, one
// converting while the other feeds the tensor cores), and the stages'
// mbarriers: 111 KB, two blocks to an SM.
constexpr int kXBytes = kBM * kBK * 4;
constexpr int kCodeBytes = kBK * kBN;
constexpr int kScaleBytes = kScaleRows * kBN * 4;
constexpr int kStageBytes = kXBytes + kCodeBytes + kScaleBytes;
constexpr int kBBytes = kBN * kBK * 2;
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kBBytes +
                           8 * kStages;
static_assert(kStageBytes % 1024 == 0, "swizzled tiles need 1 KB alignment");

// Built with -DQMM_STAGE_CLOCK (tools/qmm_tune.py --clock, never in the
// port's build), thread 0 of block (0, 0, 0) writes clock64() at 8 points
// of each of its first 16 stages to `counters` (int64 [16][8]; unused
// when splits == 1): where a stage's cycles go.
#ifdef QMM_STAGE_CLOCK
#define STAGE_CLOCK(point)                                                  \
  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && \
      s < 16)                                                               \
    reinterpret_cast<long long*>(counters)[s * 8 + (point)] = clock64()
#else
#define STAGE_CLOCK(point)
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase `parity` has completed.  A copy that
// never lands (a bad tensor map) traps after ~1e8 polls, seconds, rather
// than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int tries = 0;; ++tries) {
    if (tries == (1 << 27)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accumulator accesses across a wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[3][4][4]) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[p][c][i])::"memory");
}

// Shared-memory descriptor of the B tile: bf16 codes [64 k][128 n], N
// contiguous (MN-major, the wgmma's trans-b), as two [64 k][64 n] halves
// 8 KB apart (LBO = 512 x 16 B), each in rows of 128 B under the 128-byte
// swizzle with 8-row atoms 1024 B apart (SBO = 64 x 16 B); base 1024-byte
// aligned.  The next 16 k rows are 2048 B on: 128 in the address field.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(512) << 16) |
         (static_cast<uint64_t>(64) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d[64 x 128] f32 (+)= a[64 x 16] bf16 (registers) . b[16 x 128] bf16
// (shared, MN-major); `accumulate` 0 starts d afresh (d = a . b)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// two bf16 (the top halves of a and b) as one register, a in the low half
__device__ __forceinline__ uint32_t pack2(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// byte offset of x[r, kk] (kk < 64) in a stage: box kk / 32, row r at
// 128 B, 16-byte chunk (kk % 32) / 4 swizzled by r % 8
__device__ __forceinline__ int x_off(int r, int kk) {
  const int kq = kk & 31;
  return (kk >> 5) * (kBM * 128) + r * 128 +
         ((((kq >> 2) ^ (r & 7))) << 4) + ((kq & 3) << 2);
}

// bf16(a), bf16(b) rounded to nearest even, a in the low half
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float low_f32(uint32_t h) {
  return __uint_as_float(h << 16);
}
__device__ __forceinline__ float high_f32(uint32_t h) {
  return __uint_as_float(h & 0xFFFF0000u);
}

// One A fragment register of each piece, from x[r, kk] and x[r, kk + 1]:
// hi = bf16(x), mid = bf16(x - hi), lo = x - hi - mid, and x = hi + mid +
// lo exactly for |x| from 2^-103 to bf16's largest, 3.39e38 (lo has at
// most 8 significant bits, so taking its top half is exact).  An x that
// hi holds exactly (inf among them) leaves mid = lo = 0, so hi . c gives
// the reference's inf; a nan stays nan.
__device__ __forceinline__ void split_pair(const uint8_t* st, int r, int kk,
                                           uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  const float2 v = *reinterpret_cast<const float2*>(st + x_off(r, kk));
  hi = bf16x2(v.x, v.y);
  const float h0 = low_f32(hi), h1 = high_f32(hi);
  const float r0 = v.x == h0 ? 0.0f : v.x - h0;
  const float r1 = v.y == h1 ? 0.0f : v.y - h1;
  mid = bf16x2(r0, r1);
  lo = pack2(__float_as_uint(r0 - low_f32(mid)),
             __float_as_uint(r1 - high_f32(mid)));
}

// Eight codes, each held as an unsigned byte u = code + bias, to eight
// bf16 (16 bytes): 2^23 + u is exact in f32 (the byte placed under the
// exponent 0x4B), minus 2^23 + bias gives the code exactly, and every
// |code| <= 127 is exact in bf16 (its top half).
__device__ __forceinline__ uint4 bf16x8(uint32_t lo4, uint32_t hi4,
                                        float bias) {
  uint32_t f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t word = j < 4 ? lo4 : hi4;
    f[j] = __float_as_uint(
        __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7650u | (j & 3))) -
        bias);
  }
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// The stage's codes, as TMA left them ([k][n] bytes; int4: [k/2][n], low
// nibble k even), to the bf16 B tile (MN-major, see desc_sw128): row k,
// 16-byte chunk j (n = 8j .. 8j + 7) at half j / 8, chunk j % 8 swizzled
// by k % 8.  Thread t converts chunk t % 16 of a code row per load, so a
// warp reads two whole rows and writes four 128-byte half-rows: no bank
// conflicts either way.
__device__ __forceinline__ void store_chunk(uint8_t* bs, int k, int j,
                                            uint4 q) {
  *reinterpret_cast<uint4*>(bs + (j >> 3) * (kBK * 128) + k * 128 +
                            (((j & 7) ^ (k & 7)) << 4)) = q;
}

template <bool kInt4>
__device__ __forceinline__ void convert_codes(const uint8_t* cs, uint8_t* bs,
                                              int tid) {
  const int j = tid & 15;
#pragma unroll
  for (int i = 0; i < (kInt4 ? 4 : 8); ++i) {
    const int row = (tid >> 4) + 8 * i;      // a code row (int4: a byte row)
    const uint2 w = *reinterpret_cast<const uint2*>(cs + row * kBN + 8 * j);
    if constexpr (kInt4) {
      const float bias = 8388616.0f;         // 2^23 + 8
      store_chunk(bs, 2 * row, j,
                  bf16x8((w.x & 0x0F0F0F0Fu) ^ 0x08080808u,
                         (w.y & 0x0F0F0F0Fu) ^ 0x08080808u, bias));
      store_chunk(bs, 2 * row + 1, j,
                  bf16x8(((w.x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                         ((w.y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, bias));
    } else {
      store_chunk(bs, row, j, bf16x8(w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                     8388736.0f));   // 2^23 + 128
    }
  }
}

template <bool kInt4>
__global__ void __launch_bounds__(kThreads)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_s,
                 float* __restrict__ out, float* __restrict__ ws,
                 int* __restrict__ counters, int m, int k, int n, int group,
                 int splits) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last_block;
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* bs = smem + kStages * kStageBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bs + 2 * kBBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  // this block's K range: whole groups, split `blockIdx.z` of `splits`
  const int units = k / group;
  const int kbeg = static_cast<int>(
      static_cast<long long>(blockIdx.z) * units / splits) * group;
  const int kend = static_cast<int>(
      static_cast<long long>(blockIdx.z + 1) * units / splits) * group;
  const int nst = (kend - kbeg + kBK - 1) / kBK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto slot = [&](int s) { return smem + (s % kStages) * kStageBytes; };
  // copy `op` (0: the arrival with the stage's byte count and the first x
  // box, 1: the second x box, 2: the codes, 3: the scale rows) of stage s
  // of this block's range into slot s % kStages; a copy may land before
  // the arrival, which alone lets the phase complete
  auto issue = [&](int s, int op) {
    const int k0 = kbeg + s * kBK;
    uint8_t* st = slot(s);
    const uint32_t bar = smem_u32(&bars[s % kStages]);
    const bool second = k0 + 32 < kend;   // x columns k0 + 32 .. used?
    if (op == 0) {
      mbar_expect_tx(bar, kStageBytes - (second ? 0 : kXBytes / 2) -
                              (kInt4 ? kCodeBytes / 2 : 0));
      tma_load_2d(smem_u32(st), &tm_x, bar, k0, m0);
    } else if (op == 1) {
      if (second) {
        tma_load_2d(smem_u32(st + kXBytes / 2), &tm_x, bar, k0 + 32, m0);
      }
    } else if (op == 2) {
      tma_load_2d(smem_u32(st + kXBytes), &tm_w, bar, n0,
                  kInt4 ? k0 / 2 : k0);
    } else {
      tma_load_2d(smem_u32(st + kXBytes + kCodeBytes), &tm_s, bar, n0,
                  k0 / group);
    }
  };
  if (tid == 0) {
    for (const CUtensorMap* map : {&tm_x, &tm_w, &tm_s}) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(map))
                   : "memory");
    }
    for (int s = 0; s < kStages && s < nst; ++s) {
      for (int op = 0; op < 4; ++op) issue(s, op);
    }
  }

  float part[64], total[64];   // the group's partial, the promoted sum
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = total[i] = 0.0f;
  const int r0 = warp * 16 + (lane >> 2);   // A rows r0, r0 + 8
  const int kq = (lane & 3) * 2;            // A columns kq, kq + 1 (+ 8)

  // stage s's codes, once landed, to the bf16 tile bs[s % 2]
  auto convert = [&](int s) {
    mbar_wait(smem_u32(&bars[s % kStages]), (s / kStages) & 1);
    convert_codes<kInt4>(slot(s) + kXBytes, bs + (s & 1) * kBBytes, tid);
  };
  // stage s's x to the three pieces' A fragments (issued chunks only)
  uint32_t a[3][4][4];   // [piece][chunk][register]
  auto split = [&](int s) {
    const uint8_t* st = slot(s);
    const int k0 = kbeg + s * kBK;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (k0 + c * kChunk < kend) {
        const int kk = c * kChunk + kq;
        split_pair(st, r0, kk, a[0][c][0], a[1][c][0], a[2][c][0]);
        split_pair(st, r0 + 8, kk, a[0][c][1], a[1][c][1], a[2][c][1]);
        split_pair(st, r0, kk + 8, a[0][c][2], a[1][c][2], a[2][c][2]);
        split_pair(st, r0 + 8, kk + 8, a[0][c][3], a[1][c][3], a[2][c][3]);
      }
    }
  };
  // the three pieces of chunk c; `accumulate` 0 starts a group afresh
  auto mma = [&](int c, uint64_t desc, int accumulate) {
    wgmma_rs(part, a[0][c], desc, accumulate);
    wgmma_rs(part, a[1][c], desc, 1);
    wgmma_rs(part, a[2][c], desc, 1);
  };
  // total += partial * scale, row `row` of stage s's scale rows
  auto promote = [&](int s, int row) {
    const float* sc =
        reinterpret_cast<const float*>(slot(s) + kXBytes + kCodeBytes) +
        row * kBN;
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      total[r] = fmaf(part[r], sc[8 * (r >> 2) + kq + (r & 1)], total[r]);
    }
  };

  convert(0);
  split(0);
  // the bf16 codes (generic-proxy stores) become visible to wgmma
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  for (int s = 0; s < nst; ++s) {
    const int k0 = kbeg + s * kBK;
    STAGE_CLOCK(0);
    const uint64_t desc0 = desc_sw128(smem_u32(bs + (s & 1) * kBBytes));
    fence_regs(a);
    fence_acc(part);
    wgmma_fence();
    int pending = -1;   // scale row of a group ending at the stage's end
    if (k0 + kBK <= kend && group % kBK == 0) {
      // a whole stage inside one group (every main-path stage): twelve
      // wgmmas with no branch between them
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        mma(c, desc0 + 128 * c, c > 0 || k0 % group != 0);
      }
      if ((k0 + kBK) % group == 0) pending = (k0 + kBK) / group - 1 - k0 / group;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = k0 + c * kChunk;
        if (kc < kend) {
          mma(c, desc0 + 128 * c, kc % group != 0);
          if ((kc + kChunk) % group == 0) {
            const int row = (kc + kChunk) / group - 1 - k0 / group;
            if (c < 3 && kc + kChunk < kend) {
              // a group ends inside the stage: promote before going on
              wgmma_commit();
              wgmma_wait0();
              fence_acc(part);
              promote(s, row);
              fence_acc(part);
              wgmma_fence();
            } else {
              pending = row;
            }
          }
        }
      }
    }
    wgmma_commit();
    STAGE_CLOCK(1);
    // the next stage's codes convert while this stage's wgmmas run
    if (s + 1 < nst) convert(s + 1);
    STAGE_CLOCK(2);
    wgmma_wait0();
    fence_acc(part);
    fence_regs(a);
    STAGE_CLOCK(3);
    if (pending >= 0) promote(s, pending);
    STAGE_CLOCK(4);
    if (s + 1 < nst) split(s + 1);
    STAGE_CLOCK(5);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    STAGE_CLOCK(6);
    // every thread is done with stage s, its scales included
    // (one copy per warp, so no warp waits long on its lane 0)
    if (lane == 0 && s + kStages < nst) issue(s + kStages, warp);
    STAGE_CLOCK(7);
  }

  // registers r: row r0 (+ 8 when r & 2), column 8 (r / 4) + kq + (r & 1)
  auto for_each_pair = [&](auto&& fn) {
#pragma unroll
    for (int r = 0; r < 64; r += 2) {
      const int row = m0 + r0 + ((r & 2) ? 8 : 0);
      const int col = n0 + 8 * (r >> 2) + kq;
      if (row < m && col < n) fn(static_cast<long long>(row) * n + col, r);
    }
  };
  if (splits == 1) {
    for_each_pair([&](long long i, int r) {
      *reinterpret_cast<float2*>(out + i) = make_float2(total[r], total[r + 1]);
    });
    return;
  }
  // split K: every split's total to the workspace; the last block of the
  // tile to arrive sums them in ascending split order
  float* mine = ws + static_cast<long long>(blockIdx.z) * m * n;
  for_each_pair([&](long long i, int r) {
    *reinterpret_cast<float2*>(mine + i) = make_float2(total[r], total[r + 1]);
  });
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last_block = atomicAdd(&counters[tile], 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // split 0's totals, then each later split's added in turn (the loads of
  // one split all in flight together)
  const long long plane = static_cast<long long>(m) * n;
  for_each_pair([&](long long i, int r) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(ws + i));
    total[r] = v.x;
    total[r + 1] = v.y;
  });
  for (int sp = 1; sp < splits; ++sp) {
    for_each_pair([&](long long i, int r) {
      const float2 v =
          __ldcg(reinterpret_cast<const float2*>(ws + sp * plane + i));
      total[r] += v.x;
      total[r + 1] += v.y;
    });
  }
  for_each_pair([&](long long i, int r) {
    *reinterpret_cast<float2*>(out + i) = make_float2(total[r], total[r + 1]);
  });
  if (tid == 0) counters[tile] = 0;   // ready for the next launch
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime
// (so the library needs no link against libcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major [rows, cols] tensor cut into [box_rows, box_cols] boxes; out
// of bounds reads as zero
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                unsigned long long cols, unsigned long long rows,
                unsigned long long row_bytes, unsigned box_cols,
                unsigned box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The <kInt4> instance may take kSmemBytes (over the 48 KB default): set
// once per device rather than on every launch.
template <bool kInt4>
cudaError_t allow_smem() {
  static std::atomic<unsigned> done{0};          // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(qmm_wgmma_kernel<kInt4>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kInt4>
int launch(const void* x, const void* w, const void* scales, void* out,
           void* ws, void* counters, int m, int k, int n, int group,
           int splits, void* stream) {
  // the shapes qmm.route() sends here; anything else is the SIMT route's
  if (group < kChunk || group % kChunk != 0 || k % group != 0 ||
      n % 16 != 0 || splits < 1 || splits > k / group || m < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(x) || !aligned16(w) || !aligned16(scales) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tx, tw, ts;
  const int wrows = kInt4 ? k / 2 : k;
  if (!tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, k, m, 4ull * k,
                  32, kBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, n, wrows, n, kBN,
                  kInt4 ? kBK / 2 : kBK, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, n, k / group,
                  4ull * n, kBN, kScaleRows, CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = allow_smem<kInt4>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, splits);
  qmm_wgmma_kernel<kInt4>
      <<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
          tx, tw, ts, static_cast<float*>(out), static_cast<float*>(ws),
          static_cast<int*>(counters), m, k, n, group, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// The tensor-core route.  x [m, k] f32, codes [k, n] int8, scales
// [k / group, n] f32 -> out [m, n] f32; group a multiple of 16 and n of 16,
// every pointer 16-byte aligned.  With splits > 1: ws [splits, m, n] f32
// scratch and counters, ceil(m / 64) * ceil(n / 64) int32 zeros (left
// zero again).
extern "C" int qmm_wgmma_f32(const void* x, const void* codes,
                             const void* scales, void* out, void* ws,
                             void* counters, int m, int k, int n, int group,
                             int splits, void* stream) {
  return tc::launch<false>(x, codes, scales, out, ws, counters, m, k, n,
                           group, splits, stream);
}

// the same with packed [k / 2, n] int4 codes
extern "C" int qmm_int4_wgmma_f32(const void* x, const void* packed,
                                  const void* scales, void* out, void* ws,
                                  void* counters, int m, int k, int n,
                                  int group, int splits, void* stream) {
  return tc::launch<true>(x, packed, scales, out, ws, counters, m, k, n,
                          group, splits, stream);
}

// The SIMT route: any G dividing K, any N.
// x [m, k] f32, codes [k, n] int8, scales [k / group, n] f32 -> out [m, n]
extern "C" int qmm_f32(const void* x, const void* codes, const void* scales,
                       void* out, int m, int k, int n, int group,
                       void* stream) {
  return simt::launch<false>(x, codes, scales, out, m, k, n, group, stream);
}

// x [m, k] f32, packed [k / 2, n] int8, scales [k / group, n] f32
extern "C" int qmm_int4_f32(const void* x, const void* packed,
                            const void* scales, void* out, int m, int k,
                            int n, int group, void* stream) {
  return simt::launch<true>(x, packed, scales, out, m, k, n, group, stream);
}
