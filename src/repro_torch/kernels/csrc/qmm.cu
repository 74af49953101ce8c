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
// What bounds it on an H100: at the serving shapes (M = batch x sequence =
// 256 rows, K and N in the hundreds to thousands) the product does
// 2*M*N*K float32 operations on K*N bytes of codes, far above the card's
// float32 balance, so it is bound by operations: 67 TFLOP/s of non-tensor
// float32 FMA.  At M = 1 it is bound by the bytes of the codes.  This first
// version is a plain tiled SIMT GEMM that aims to be right, not fast: a
// 64x64 output tile per block of 256 threads, each thread owning a 4x4
// micro-tile, and a K step of 32 staged in shared memory.  Each step's
// global loads go to registers one step ahead, so they are in flight while
// the previous step computes.  Codes are dequantized to f32
// (`code * scale`, the product the reference forms) as they are staged, so
// the inner loop is pure FMA on shared-memory operands.
// No TF32, no bf16 tensor cores and no wgmma/TMA yet: float32 parity with
// the reference comes first.
//
// Row independence: every output element is one fmaf chain over k = 0..K-1
// in ascending order, started from 0, whatever M is and whichever tile the
// element lands in.  A row's result is therefore bitwise the same when it is
// computed alone (M = 1) or inside a batch; the serving engine's
// batched == sequential property rests on this.  The ragged M, N and K
// edges are masked here (no padding by the caller), and no alignment of K,
// N or G is assumed: any G dividing K works.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

}  // namespace

// x [m, k] f32, codes [k, n] int8, scales [k / group, n] f32 -> out [m, n]
extern "C" int qmm_f32(const void* x, const void* codes, const void* scales,
                       void* out, int m, int k, int n, int group,
                       void* stream) {
  return launch<false>(x, codes, scales, out, m, k, n, group, stream);
}

// x [m, k] f32, packed [k / 2, n] int8, scales [k / group, n] f32
extern "C" int qmm_int4_f32(const void* x, const void* packed,
                            const void* scales, void* out, int m, int k,
                            int n, int group, void* stream) {
  return launch<true>(x, packed, scales, out, m, k, n, group, stream);
}
