// Row-independent batched float32 GEMM for the decode step's projections
// and head: y [M, N] = x [M, K] @ w [K, N] (+ bias [N]), any M.
//
// Replaces no TPU kernel.  The reference's decode step runs its
// projections through XLA's batched dot, whose row m does not depend on M
// or on the other rows; that is what makes its batched decode equal its
// batch-1 oracle bit for bit.  cuBLAS gives no such promise (it picks
// split-K and tiles by M).  This kernel reads each weight once for the
// rows of a launch and computes every row with the same chains whatever M.
//
// What bounds it on an H100: bytes.  At M = 4 it does 2 * M = 8 flops per
// 4-byte weight, two flops a byte against the card's f32 balance of ~20,
// so a qwen2-0.5b step's products (1.99 GB of weights) are bound at 0.59
// ms by 3.35 TB/s.  Tensor cores buy nothing at M <= 16 (TF32 is off; an
// f32 MMA does not exist).  So the design keeps many bytes in flight and
// spends few launches:
//
// * Weights reach shared memory asynchronously, each stage of a ring
//   completing on its own mbarrier: the row-major route by TMA (one 2-D
//   tensor copy of a 32-row x 64-column box a stage, the tensor map
//   encoded on the host and passed by value in the launch's parameters, so
//   a captured graph replays it as it is), the head by `cp.async.bulk`
//   (1-D bulk copies of whole rows of t).  Small 1-D copies (a 256-byte
//   row segment each) held the first version of this design at a fifth of
//   the head's rate per byte.  A block issues its whole ring at once: a
//   block of the row-major route has its chunk (up to `stages` x 8 KB) in
//   flight, the head's persistent block `stages` column tiles.
// * `kn` (w [K, N] row-major, leading stride ldw): a block owns a tile of
//   kTileN = 64 columns and a chunk of k rows; the blocks sharing a tile
//   and splitting K form one thread-block cluster (cluster dims (1, cs, 1),
//   cs <= 8).  The block's 128 threads are kParts = 8 k-parts x 16 groups
//   of 4 columns; stage s holds rows [32 s, 32 s + 32) of the chunk and
//   part p takes rows 32 s + 4 p .. + 3 of each stage (one float4 of w a
//   row, from shared memory; x's slice of the chunk staged beside it by
//   plain loads while the weights are in flight, read as broadcasts).  The
//   parts' sums add in part order into the block's tile total; the cluster
//   then adds the ranks' totals in rank order through distributed shared
//   memory (each rank writes a 1/cs share of the outputs), and the bias,
//   when given, is one f32 add after that: no workspace, no fence, no
//   atomic, no second pass over device memory.  Where one chunk covers K,
//   cs = 1 and the combine is within the block.
// * A grouped launch: up to kMaxProducts products of the same x (q | k | v,
//   gate | up) in one grid, a table of (w, y, bias, N, ldw) entries passed
//   by value; each product's blocks follow its own schedule, which is a
//   function of K alone (as the cluster shape must be the launch's), so
//   every output is bitwise what a launch of that product alone gives.
// * `nk` (w is the transposed view of a row-major [N, K] matrix, the tied
//   embedding: w[k, n] = t[n, k], leading stride ldt): one wave of
//   persistent blocks, each walking its column tiles through a ring of
//   `stages` tiles; a tile is `cols` whole rows of t (one bulk copy each,
//   padded in shared memory so the columns' 16-byte reads fall on distinct
//   banks), and the block's 256 threads are 256 / cols k-parts x cols
//   columns; part p takes k = 4 p, 4 p + 4 P, ... of its column, one
//   float4 of t and one of x a step, and the parts add in part order.  No
//   copy of the 545 MB transpose is made; the next tiles' copies are in
//   flight while a tile is computed.
// * Any M: the rows go in slices of kSlice = 16 inside the block, after
//   the weights are staged; where a block's chunk fits its ring (a chunk
//   of qwen2-0.5b's d_model rows; the head's tiles always) every slice
//   reads the staged tile, so the weights cross device memory once a
//   launch.  A chunk longer than the ring (the down projection's) streams
//   through it again for each slice past the first, from L2 where it
//   stayed.  A short ring (4 stages) leaves room for more blocks on an SM,
//   which bought more than a deep one in tools/row_gemm_tune.py's sweep;
//   where a long chunk's x slice leaves less than 4 stages' room in the
//   block's shared memory (K = 24,576: 3,072 rows), the wrapper's schedule
//   gives the ring fewer (3 there), so 16 rows still fit.
//   MB (the registers held for rows, min(M, 16) rounded up to a power of
//   two) changes which rows are computed, not how.
//
// Row independence holds by construction: every output is one `fmaf`
// chain per (part, column) in a fixed order of k, the parts and the ranks
// add in a fixed order, and the schedule (chunk, cs, stages, cols) is
// chosen by the wrapper from (K, N) alone, never from M; row m's
// arithmetic reads only row m of x.  One launch per call; the kernel
// allocates nothing and does not synchronise the host.  No fast math.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// the row-major route's block shape (tools/row_gemm_tune.py builds others
// to compare; the wrapper's THREADS, TILE_N, PARTS and PIECE follow these)
#ifndef ROW_GEMM_THREADS
#define ROW_GEMM_THREADS 128
#endif
#ifndef ROW_GEMM_TILE_N
#define ROW_GEMM_TILE_N 64
#endif

constexpr int kThreads = ROW_GEMM_THREADS;  // kn: threads of a block
constexpr int kNkThreads = 256;            // nk: threads of a block
constexpr int kTileN = ROW_GEMM_TILE_N;     // kn: columns of a block
constexpr int kGroups = kTileN / 4;         // kn: 4-column groups
constexpr int kParts = kThreads / kGroups;  // kn: k-parts of a block (8)
constexpr int kPiece = 4 * kParts;          // kn: rows of a stage (32)
constexpr int kSlice = 16;                  // rows of x a slice computes
constexpr int kMaxProducts = 4;
constexpr int kMaxCluster = 8;

struct Product {
  CUtensorMap map;     // w as a 2-D tensor, boxes of 32 rows x 64 columns
  const float* w;
  float* y;
  const float* bias;   // [n] or null
  long long ldw;
  int n;
  int tile0;           // the product's first tile in the grid's x axis
};

struct Table {
  Product p[kMaxProducts];
  int count;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the box of 32 rows x 64 columns at (row, col) of map's tensor, columns
// and rows past its edge zero-filled; the full box's bytes complete on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void init_bars(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) bar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

template <int MB>
__global__ void __launch_bounds__(kThreads)
row_gemm_kn(const float* __restrict__ x, const __grid_constant__ Table table,
            int m, int k, int chunk, int stages) {
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                               // [stages][32][64]
  // the slice's x [MB][chunk], then (once it is read) the parts' sums
  // [8][MB][64]
  float* xs = ring + stages * kPiece * kTileN;
  float* red = xs;
  float* tot = xs + max(MB * chunk, kParts * MB * kTileN);   // [MB][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(tot + MB * kTileN);

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  int e = 0;
  for (int i = 1; i < table.count; ++i)
    if (static_cast<int>(blockIdx.x) >= table.p[i].tile0) e = i;
  const Product& pr = table.p[e];
  const int col0 = (blockIdx.x - pr.tile0) * kTileN;
  const int cols = min(kTileN, pr.n - col0);        // a multiple of 4
  const int rank = blockIdx.y, cs = gridDim.y;
  const int k_lo = rank * chunk;
  const int rows = min(k_lo + chunk, k) - k_lo;     // >= 1
  const int pieces = (rows + kPiece - 1) / kPiece;
  const int slices = (m + kSlice - 1) / kSlice;
  // every slice reads the staged chunk when it fits the ring; else each
  // slice streams it through the ring again (load events slice x piece)
  const bool resident = pieces <= stages;
  const int loads = resident ? pieces : pieces * slices;

  // thread 0: stage `ev`'s 32 rows, one tensor copy (rows past the
  // chunk are the next rank's or zeros, and are not used)
  auto issue = [&](int ev) {
    const int slot = ev % stages;
    bar_expect(&full[slot], kPiece * kTileN * 4);
    tma_load(ring + slot * kPiece * kTileN, &pr.map, col0,
             k_lo + (ev % pieces) * kPiece, &full[slot]);
  };

  init_bars(full, stages);
  if (tid == 0)
    for (int ev = 0; ev < min(stages, loads); ++ev) issue(ev);

  const int part = tid / kGroups, grp = tid % kGroups;
  for (int sl = 0; sl < slices; ++sl) {
    const int s0 = sl * kSlice;
    const int nrow = min(kSlice, m - s0);
    // the slice's x over this chunk, while the weights are in flight
    for (int i = tid; i < nrow * rows; i += kThreads) {
      const int r = i / rows, c = i - r * rows;
      xs[r * chunk + c] = __ldg(x + static_cast<long long>(s0 + r) * k +
                                k_lo + c);
    }
    __syncthreads();
    float acc[MB][4];
#pragma unroll
    for (int r = 0; r < MB; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;

    for (int pc = 0; pc < pieces; ++pc) {
      const int ev = resident ? pc : sl * pieces + pc;
      const int slot = ev % stages;
      bar_wait(&full[slot], (ev / stages) & 1);
      const int r0 = pc * kPiece + part * 4;        // this part's 4 rows
      const int nr = min(4, rows - r0);
      if (nr > 0) {
        const float* wt =
            ring + (slot * kPiece + part * 4) * kTileN + grp * 4;
        float4 wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = j < nr ? *reinterpret_cast<const float4*>(wt + j * kTileN)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int r = 0; r < MB; ++r) {
          if (r < nrow) {
            const float4 x4 =
                *reinterpret_cast<const float4*>(xs + r * chunk + r0);
            const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j < nr) {
                acc[r][0] = fmaf(xv[j], wv[j].x, acc[r][0]);
                acc[r][1] = fmaf(xv[j], wv[j].y, acc[r][1]);
                acc[r][2] = fmaf(xv[j], wv[j].z, acc[r][2]);
                acc[r][3] = fmaf(xv[j], wv[j].w, acc[r][3]);
              }
            }
          }
        }
      }
      if (!resident) {                  // the slot is free once all read it
        __syncthreads();
        if (tid == 0 && ev + stages < loads) issue(ev + stages);
      }
    }
    __syncthreads();                    // xs is read: red takes its place

    // the parts in part order, then the cluster's ranks in rank order
#pragma unroll
    for (int r = 0; r < MB; ++r)
      if (r < nrow)
        *reinterpret_cast<float4*>(&red[(part * MB + r) * kTileN + grp * 4]) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
    for (int o = tid; o < nrow * kTileN; o += kThreads) {
      const int r = o / kTileN, c = o % kTileN;
      float s = red[r * kTileN + c];
#pragma unroll
      for (int p = 1; p < kParts; ++p) s += red[(p * MB + r) * kTileN + c];
      tot[o] = s;
    }
    cluster.sync();                     // every rank's total is complete
    for (int o = rank + cs * tid; o < nrow * kTileN; o += cs * kThreads) {
      float v[kMaxCluster];
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j)
        v[j] = j < cs ? *cluster.map_shared_rank(tot + o, j) : 0.0f;
      float t = v[0];
#pragma unroll
      for (int j = 1; j < kMaxCluster; ++j)
        if (j < cs) t += v[j];
      const int r = o / kTileN, c = o % kTileN;
      if (c < cols) {
        if (pr.bias != nullptr) t += pr.bias[col0 + c];
        pr.y[static_cast<long long>(s0 + r) * pr.n + col0 + c] = t;
      }
    }
    cluster.sync();                     // the peers are done with tot, and
  }                                     // xs may be written again
}

// warp 0 of a head block: its i-th column tile (columns (blockIdx.x + i
// gridDim.x) cols ..) into ring slot i % stages, one bulk copy a column
__device__ __forceinline__ void issue_columns(float* ring, uint64_t* full,
                                              const float* t, int i,
                                              int stages, int cols, int n,
                                              int k, long long ldt, int ldk,
                                              int lane) {
  const int slot = i % stages;
  const int n0 = (blockIdx.x + i * gridDim.x) * cols;
  const int nc = min(cols, n - n0);
  if (lane == 0) bar_expect(&full[slot], nc * k * 4);
  __syncwarp();
  for (int c = lane; c < nc; c += 32)
    bulk_load(ring + (slot * cols + c) * ldk,
              t + static_cast<long long>(n0 + c) * ldt, k * 4, &full[slot]);
}

// A persistent block walks the column tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... through a ring of `stages` tiles, the next tiles' copies
// in flight while it computes one.
template <int MB>
__global__ void __launch_bounds__(kNkThreads)
row_gemm_nk(const float* __restrict__ x, const float* __restrict__ t,
            float* __restrict__ y, int m, int k, int n, long long ldt,
            int cols, int ldk, int stages) {
  extern __shared__ __align__(128) float smem[];
  const int parts = kNkThreads / cols;
  float* ring = smem;                               // [stages][cols][ldk]
  float* red = ring + stages * cols * ldk;          // [parts][MB][cols]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + parts * MB * cols);

  const int tid = threadIdx.x, lane = tid & 31;
  const int n_tiles = (n + cols - 1) / cols;
  const int count =
      (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  init_bars(full, stages);
  if (tid < 32)
    for (int i = 0; i < min(stages, count); ++i)
      issue_columns(ring, full, t, i, stages, cols, n, k, ldt, ldk, lane);

  const int c = tid % cols, p = tid / cols;
  for (int i = 0; i < count; ++i) {
    const int slot = i % stages;
    const int n0 = (blockIdx.x + i * gridDim.x) * cols;
    const int nc = min(cols, n - n0);
    const float* tc = ring + (slot * cols + c) * ldk;
    bar_wait(&full[slot], (i / stages) & 1);
    for (int s0 = 0; s0 < m; s0 += kSlice) {
      const int nrow = min(kSlice, m - s0);
      const float* xs = x + static_cast<long long>(s0) * k;
      float acc[MB];
#pragma unroll
      for (int r = 0; r < MB; ++r) acc[r] = 0.0f;
      // (unrolled less at 8 and 16 rows: no spill)
#pragma unroll(MB >= 8 ? 2 : 4)
      for (int kk = 4 * p; kk < k; kk += 4 * parts) {
        const float4 tv = *reinterpret_cast<const float4*>(tc + kk);
#pragma unroll
        for (int r = 0; r < MB; ++r) {
          if (r < nrow) {
            const float4 xv = __ldg(reinterpret_cast<const float4*>(
                xs + static_cast<long long>(r) * k + kk));
            acc[r] = fmaf(xv.x, tv.x, acc[r]);
            acc[r] = fmaf(xv.y, tv.y, acc[r]);
            acc[r] = fmaf(xv.z, tv.z, acc[r]);
            acc[r] = fmaf(xv.w, tv.w, acc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MB; ++r)
        if (r < nrow) red[(p * MB + r) * cols + c] = acc[r];
      __syncthreads();
      for (int o = tid; o < nrow * cols; o += kNkThreads) {
        const int r = o / cols, cc = o - r * cols;
        float s = red[r * cols + cc];
        for (int q = 1; q < parts; ++q) s += red[(q * MB + r) * cols + cc];
        if (cc < nc) y[static_cast<long long>(s0 + r) * n + n0 + cc] = s;
      }
      __syncthreads();                  // red and the slot are free
    }
    if (tid < 32 && i + stages < count)
      issue_columns(ring, full, t, i + stages, stages, cols, n, k, ldt, ldk,
                    lane);
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int MB>
int launch(const float* x, const Table& table, int tiles, int m, int k,
           int transposed, int cluster, int chunk, int stages, int cols,
           int smem, cudaStream_t stream) {
  if (transposed) {
    const Product& pr = table.p[0];
    auto kernel = row_gemm_nk<MB>;
    int err = allow_smem(kernel, smem);
    if (err) return err;
    // one wave of persistent blocks: as many as fit the card at once
    int device = 0, sms = 0, per_sm = 0;
    err = static_cast<int>(cudaGetDevice(&device));
    if (!err)
      err = static_cast<int>(cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, device));
    if (!err)
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kNkThreads, smem));
    if (err) return err;
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int n_tiles = (pr.n + cols - 1) / cols;
    const int grid = min(n_tiles, per_sm * sms);
    // the smem row stride: k padded to 4 (mod 32) floats, so the 8 columns
    // of a quarter-warp's 16-byte reads start on distinct banks
    const int ldk = k + (36 - k % 32) % 32;
    kernel<<<grid, kNkThreads, smem, stream>>>(x, pr.w, pr.y, m, k, pr.n,
                                               pr.ldw, cols, ldk, stages);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = row_gemm_kn<MB>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, cluster, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, x, table, m, k, chunk, stages);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// w [k, n] with rows ldw floats apart as a tensor map of 32 x 64 boxes
// (the driver's encoder, found through the runtime: no -lcuda)
int encode_map(CUtensorMap* map, const float* w, int k, int n,
               long long ldw) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(k)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldw) * 4};
  const cuuint32_t box[2] = {kTileN, kPiece};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(w), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [m, k] f32 row-major (m >= 1, k >= 1); `count` products (1 <= count
// <= 4; 1 when transposed) y_i [m, n_i] = x @ w_i (+ bias_i), y_i f32
// row-major, bias_i [n_i] f32 or null.
// transposed = 0: w_i [k, n_i] f32 with rows ldw_i floats apart, n_i % 4
//   == 0, ldw_i % 4 == 0; cluster = ceil(k / chunk) <= 8 blocks split k
//   in chunks of `chunk` rows (a multiple of 4) and form one cluster;
//   `stages` ring slots of 32 rows x 64 columns.
// transposed = 1: w_0 is t [n_0, k] f32 with rows ldw_0 floats apart (y =
//   x @ t^T), k % 4 == 0; tiles of `cols` (dividing 256) columns through a
//   ring of `stages` tiles a block.
// smem: the dynamic shared bytes of a block (the wrapper's smem_bytes).
// Every pointer 16-byte aligned.
extern "C" int row_gemm_f32(const void* x, int m, int k, int count,
                            const void* const* w, const long long* ldw,
                            void* const* y, const void* const* bias,
                            const int* n, int transposed, int cluster,
                            int chunk, int stages, int cols, int smem,
                            void* stream) {
  if (count < 1 || count > kMaxProducts || cluster < 1 ||
      cluster > kMaxCluster || m < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Table table = {};
  int tiles = 0;
  for (int i = 0; i < count; ++i) {
    table.p[i].w = static_cast<const float*>(w[i]);
    table.p[i].y = static_cast<float*>(y[i]);
    table.p[i].bias = static_cast<const float*>(bias[i]);
    table.p[i].ldw = ldw[i];
    table.p[i].n = n[i];
    table.p[i].tile0 = tiles;
    tiles += (n[i] + kTileN - 1) / kTileN;
    if (!transposed) {
      const int err = encode_map(&table.p[i].map, table.p[i].w, k, n[i],
                                 ldw[i]);
      if (err) return err;
    }
  }
  table.count = count;
  const float* xf = static_cast<const float*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mb = m < kSlice ? m : kSlice;
  if (mb <= 1)
    return launch<1>(xf, table, tiles, m, k, transposed, cluster, chunk,
                     stages, cols, smem, s);
  if (mb <= 2)
    return launch<2>(xf, table, tiles, m, k, transposed, cluster, chunk,
                     stages, cols, smem, s);
  if (mb <= 4)
    return launch<4>(xf, table, tiles, m, k, transposed, cluster, chunk,
                     stages, cols, smem, s);
  if (mb <= 8)
    return launch<8>(xf, table, tiles, m, k, transposed, cluster, chunk,
                     stages, cols, smem, s);
  return launch<16>(xf, table, tiles, m, k, transposed, cluster, chunk,
                    stages, cols, smem, s);
}
