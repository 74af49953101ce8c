// Row-independent batched float32 GEMM for the decode step's projections
// and head: y [M, N] = x [M, K] @ w [K, N], M <= 16.
//
// Replaces no TPU kernel.  The reference's decode step runs its
// projections through XLA's batched dot, whose row m does not depend on M
// or on the other rows; that is what makes its batched decode equal its
// batch-1 oracle bit for bit.  cuBLAS gives no such promise (it picks
// split-K and tiles by M), and the port's first answer, one product per
// row (`layers.row_matmul`'s loop), reads every weight matrix once per
// row and costs M launches.  This kernel reads each weight once for all M
// rows, in one launch per product.
//
// What bounds it on an H100: bytes.  At M = 4 it does 2 * M = 8 flops per
// 4-byte weight, two flops a byte against the card's f32 balance of ~20,
// so a step's 169 products (24 layers x 7, and the tied head) are bound by
// their 1.98 GB of weights: 0.59 ms at 3.35 TB/s.  Tensor cores buy
// nothing at M <= 16; the design keeps enough 16-byte loads in flight.
//
// Two layouts of w, two kernels:
// * `kn` (w [K, N] row-major, leading stride ldw): a block owns a tile of
//   128 columns and a chunk of the k axis; each of its 4 warps takes a
//   contiguous quarter of the chunk, each lane 4 adjacent columns (one
//   16-byte load of w per k, coalesced across the warp), all M rows in
//   registers.  The warps' sums meet in shared memory and add in warp
//   order; with more than one chunk, each block writes its chunk's sums to
//   a workspace, counts itself in on an arrival counter of its tile, and
//   the last block to arrive adds the chunks in ascending order and resets
//   the counter (the qmm split-K pattern: no float atomics).
// * `nk` (w is the transposed view of a row-major [N, K] matrix, the tied
//   embedding: w[k, n] = t[n, k], leading stride ldt): a warp owns 32
//   columns, taken one at a time; lane l reads t[n, 4l + 128i .. +3] with
//   16-byte loads for i = 0, 1, ..., a chain per lane, then a butterfly of
//   shuffles (xor 16, 8, 4, 2, 1) sums the lanes, and lane c keeps column
//   c for one coalesced store.  No copy of the 545 MB transpose is made.
//
// Row independence holds by construction: every output is one `fmaf`
// chain per (warp, lane) slice in ascending k, and the slices combine in a
// fixed order; the slicing (the chunk and the number of chunks) is chosen
// by the wrapper from (K, N) alone, never from M, and row m's arithmetic
// reads only row m of x.  The template width MB (the registers held for
// rows) changes which rows are computed, not how.  One launch per call;
// the kernel allocates nothing and does not synchronise the host, so a
// decode step can be captured in a CUDA graph.  No fast math in the build.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                  // kn: warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = 128;                // kn: columns of a block
constexpr int kNkWarps = 8;                // nk: warps of a block
constexpr int kNkCols = 32;                // nk: columns of a warp
constexpr int kCombine = 4;                // chunks loaded at a time

template <int MB>
__global__ void __launch_bounds__(kThreads)
row_gemm_kn(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ y, float* __restrict__ ws,
            int* __restrict__ counters, int m, int k, int n,
            long long ldw, int chunk, int splits) {
  __shared__ __align__(16) float red[kWarps][MB][kTileN];
  __shared__ bool last_block;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int c0 = tile * kTileN + lane * 4;
  const int k_lo = split * chunk;
  const int k_hi = min(k_lo + chunk, k);
  const int per_warp = chunk / kWarps;
  const int kw_lo = min(k_lo + warp * per_warp, k_hi);
  const int kw_hi = min(kw_lo + per_warp, k_hi);

  float acc[MB][4];
#pragma unroll
  for (int r = 0; r < MB; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;

  if (c0 < n) {                            // n % 4 == 0: all 4 columns
    const float* wp = w + static_cast<long long>(kw_lo) * ldw + c0;
#pragma unroll 16
    for (int kk = kw_lo; kk < kw_hi; ++kk, wp += ldw) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(wp));
#pragma unroll
      for (int r = 0; r < MB; ++r) {
        if (r < m) {
          const float xv = __ldg(x + static_cast<long long>(r) * k + kk);
          acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
          acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
          acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
          acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MB; ++r)
    if (r < m)
      *reinterpret_cast<float4*>(&red[warp][r][lane * 4]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();

  // thread t owns column tile * 128 + t: the warps' slices in warp order
  const int col = tile * kTileN + tid;
  float tot[MB];
#pragma unroll
  for (int r = 0; r < MB; ++r) {
    tot[r] = 0.0f;
    if (r < m) {
      float s = red[0][r][tid];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) s += red[v][r][tid];
      tot[r] = s;
    }
  }
  if (splits == 1) {
    if (col < n) {
#pragma unroll
      for (int r = 0; r < MB; ++r)
        if (r < m) y[static_cast<long long>(r) * n + col] = tot[r];
    }
    return;
  }

  // more than one chunk: this chunk's sums to the workspace, then the
  // last block of the tile adds the chunks in ascending order
  const long long plane = static_cast<long long>(m) * n;
  if (col < n) {
#pragma unroll
    for (int r = 0; r < MB; ++r)
      if (r < m) ws[split * plane + static_cast<long long>(r) * n + col] =
          tot[r];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(&counters[tile], 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if (col < n) {
    float s[MB];
#pragma unroll
    for (int r = 0; r < MB; ++r) s[r] = 0.0f;
    for (int sp0 = 0; sp0 < splits; sp0 += kCombine) {
      float a[MB][kCombine];
#pragma unroll
      for (int r = 0; r < MB; ++r)
#pragma unroll
        for (int u = 0; u < kCombine; ++u)
          a[r][u] = (r < m && sp0 + u < splits)
                        ? __ldcg(ws + (sp0 + u) * plane +
                                 static_cast<long long>(r) * n + col)
                        : 0.0f;
#pragma unroll
      for (int r = 0; r < MB; ++r)
#pragma unroll
        for (int u = 0; u < kCombine; ++u)
          if (sp0 + u < splits) s[r] += a[r][u];
    }
#pragma unroll
    for (int r = 0; r < MB; ++r)
      if (r < m) y[static_cast<long long>(r) * n + col] = s[r];
  }
  if (tid == 0) counters[tile] = 0;        // ready for the next launch
}

template <int MB>
__global__ void __launch_bounds__(32 * kNkWarps)
row_gemm_nk(const float* __restrict__ x, const float* __restrict__ t,
            float* __restrict__ y, int m, int k, int n, long long ldt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * kNkWarps + warp) * kNkCols;
  float out[MB];
#pragma unroll
  for (int r = 0; r < MB; ++r) out[r] = 0.0f;
  for (int c = 0; c < kNkCols; ++c) {
    const int col = n0 + c;
    if (col >= n) break;                   // warp-uniform
    const float* tp = t + static_cast<long long>(col) * ldt;
    float acc[MB];
#pragma unroll
    for (int r = 0; r < MB; ++r) acc[r] = 0.0f;
#pragma unroll 4
    for (int kk = lane * 4; kk < k; kk += 128) {
      const float4 tv = __ldg(reinterpret_cast<const float4*>(tp + kk));
#pragma unroll
      for (int r = 0; r < MB; ++r) {
        if (r < m) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(
              x + static_cast<long long>(r) * k + kk));
          acc[r] = fmaf(xv.x, tv.x, acc[r]);
          acc[r] = fmaf(xv.y, tv.y, acc[r]);
          acc[r] = fmaf(xv.z, tv.z, acc[r]);
          acc[r] = fmaf(xv.w, tv.w, acc[r]);
        }
      }
    }
    // a butterfly: every lane ends with the same sum (each add is
    // commutative in its two operands), lane c keeps column c
#pragma unroll
    for (int r = 0; r < MB; ++r) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
      if (lane == c) out[r] = acc[r];
    }
  }
  const int col = n0 + lane;
  if (col < n) {
#pragma unroll
    for (int r = 0; r < MB; ++r)
      if (r < m) y[static_cast<long long>(r) * n + col] = out[r];
  }
}

template <int MB>
int launch(const float* x, const float* w, float* y, float* ws,
           int* counters, int m, int k, int n, long long ld, int transposed,
           int chunk, int splits, cudaStream_t stream) {
  if (transposed) {
    const int cols = kNkWarps * kNkCols;
    row_gemm_nk<MB><<<(n + cols - 1) / cols, 32 * kNkWarps, 0, stream>>>(
        x, w, y, m, k, n, ld);
  } else {
    const dim3 grid((n + kTileN - 1) / kTileN, splits);
    row_gemm_kn<MB><<<grid, kThreads, 0, stream>>>(
        x, w, y, ws, counters, m, k, n, ld, chunk, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [m, k] f32 row-major; y [m, n] f32 row-major; 1 <= m <= 16.
// transposed = 0: w [k, n] f32 with rows ld floats apart, n % 4 == 0;
//   chunk (a multiple of 4) k positions per block, splits = ceil(k /
//   chunk) blocks along k; ws: f32 workspace of splits * m * n when
//   splits > 1; counters: ceil(n / 128) zeroed int32, left zero.
// transposed = 1: w is t [n, k] f32 with rows ld floats apart (y = x @
//   t^T); k % 4 == 0; ws, counters, chunk and splits unused.
// Every pointer 16-byte aligned, ld % 4 == 0.
extern "C" int row_gemm_f32(const void* x, const void* w, void* y, void* ws,
                            void* counters, int m, int k, int n,
                            long long ld, int transposed, int chunk,
                            int splits, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 1)
    return launch<1>(xf, wf, yf, wsf, cnt, m, k, n, ld, transposed, chunk,
                     splits, s);
  if (m <= 2)
    return launch<2>(xf, wf, yf, wsf, cnt, m, k, n, ld, transposed, chunk,
                     splits, s);
  if (m <= 4)
    return launch<4>(xf, wf, yf, wsf, cnt, m, k, n, ld, transposed, chunk,
                     splits, s);
  if (m <= 8)
    return launch<8>(xf, wf, yf, wsf, cnt, m, k, n, ld, transposed, chunk,
                     splits, s);
  return launch<16>(xf, wf, yf, wsf, cnt, m, k, n, ld, transposed, chunk,
                    splits, s);
}
