// Row-independent float32 GEMM on the tensor cores, for the co-inference
// split forward's server products and head: y [M, N] = x [M, K] @ w, any M.
//
// Replaces no TPU kernel.  The reference's split forward runs its
// projections through XLA's dots, whose row m depends neither on M nor on
// the other rows, so a request served in a padded batch equals the request
// served alone bit for bit.  cuBLAS gives no such promise: it picks its
// tiles and its split of K by M (at M = 256, N = 896 a 128 x 128 tiling
// leaves 14 blocks for 132 SMs, so its choice moves with M), and a row's
// sum changes order between a 4 x 512 bucket and the request alone.
//
// What bounds it on an H100: operations.  A 4 x 64 forward's server
// products are 207 GFLOP (qwen2-0.5b: 18 layers 137.4 + the tied head
// 69.7), 1.26 ms for the three TF32 passes this kernel issues at 495
// TFLOP/s against 3.09 ms on the f32 SIMT peak (67 TFLOP/s); the bytes
// (the weights once, x and y) take a fifth of that.  `wgmma` is the only
// route to the tensor-core rate, so every product is three TF32 `wgmma`
// passes.
//
// Products.  One TF32 pass keeps 11 significant bits of each operand, too
// few for float32.  Each operand v is split into hi = tf32(v) (round to
// nearest, ties away: two integer instructions) and lo = tf32(v - hi), and
// each 8-deep step of the sum is formed as lo_x hi_w + hi_x lo_w +
// hi_x hi_w into one f32 accumulator, dropping lo lo (~2^-22 relative):
// the error-compensated product of csrc/flash_attn.cu.  TF32 `wgmma` reads
// its B operand K-major from shared memory, so the pass that splits a
// staged tile of w writes hi and lo K-major under the 128-byte swizzle:
// a row-major w [K, N] is transposed there, in shared memory, and no
// transposed copy of the weights lives in device memory; the tied head's
// w = tok^T is K-major as it stands.  x's fragments are split in registers
// (A from registers, as flash's q).
//
// Design.  A block is one warpgroup (128 threads) and computes a 64-row x
// BN-column tile of y (BN = 64 or 128, chosen with the split of K from
// (K, N) alone: kernels/tc_gemm.py `route`).  It walks its range of K in
// 32-deep tiles in ascending order: x's tile (64 x 32) and w's (32 x BN)
// are copied by 16-byte `cp.async` into a ring of three or four slots
// (the next tiles in flight while tile t is split and multiplied), w's
// tile is split into the K-major hi and lo tiles, and each 8-deep step
// issues 3 x BN / 64 `wgmma.m64n64k8` into the tile's partial sums, which
// one f32 add then takes into the block's sums: the tensor cores add at
// their own internal precision, so their chain of additions is kept to
// one tile's twelve (a chain over all of K measured up to 1.05e-5 x
// max|y| off float32 at K = 1,280; H100 80GB HBM3, 700 W).  Rows past M,
// columns past N and k past the range are zero-filled by the copies
// (src-size 0).  Where the route splits K (few column tiles: the q, k, v,
// o and down projections), the z-th block of a tile sums k in [z chunk,
// (z + 1) chunk) into a float32 workspace [splits, M, N] and a second
// launch adds the parts in order z = 0, 1, ... per element.
//
// Row independence holds by construction (chip_smoke.py checks it
// bitwise across M in {1, 17, 256, 506, 2048}): the tiles, the split and
// the order of the K walk are functions of (K, N) alone; a tensor-core
// product's output row depends on its own row of A alone; the epilogue
// and the combine work per element.  So row m's bits depend on row m of
// x and on w only, never on M, on the row's place in its tile or on the
// padding rows.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;           // rows of a block (the m64 of wgmma)
constexpr int kTileK = 32;           // k of a staged tile (one swizzle atom)
constexpr int kThreads = 128;        // one warpgroup, 16 rows a warp
constexpr int kMaxSplits = 8;

// Shared memory of a block: the split w tile (hi and lo, BN rows of 32
// tf32 each, K-major under the 128-byte swizzle, 1 KB aligned), then a
// ring of kStages slots, each x's tile (64 rows of 128 B, swizzled as the
// split tiles: the fragment loads fall on distinct banks) and w's as
// copied (nk: BN rows of 128 B, swizzled; kn: 32 rows of BN + 4 floats,
// so the transposing reads of a column fall on distinct banks).  Four
// slots at BN = 64, three at 128: two blocks an SM either way.
template <int BN, bool kNK> struct Layout {
  static constexpr int kStages = BN == 64 ? 4 : 3;
  static constexpr int kSplitB = BN * 128;              // bytes of hi (lo)
  static constexpr int kXf = kTileM * kTileK;           // floats
  static constexpr int kWr = BN + 4;                    // kn's row stride
  static constexpr int kWf = kNK ? BN * kTileK : kTileK * kWr;
  static constexpr int kSlot = kXf + kWf;               // floats
  static constexpr int kBytes = 1024 + 2 * kSplitB + 4 * kStages * kSlot;
};

// byte offset of element (r, k) of a K-major tf32 tile (k < 32) under the
// 128-byte swizzle: row r at 128 B, its 16-byte chunk k / 4 xor r % 8
__device__ __forceinline__ int sw_off(int r, int k) {
  return r * 128 + ((((k >> 2) & 7) ^ (r & 7)) << 4) + ((k & 3) << 2);
}

// cvt.rna.tf32.f32 for a finite v in two integer instructions
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v -> (hi, lo): hi = tf32(v), lo = tf32(v - hi)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// descriptor of a K-major tile under the 128-byte swizzle: 8-row groups
// 1024 B apart, base 1 KB aligned; an 8-deep step (32 B) further on within
// the atom is 2 more in the address field, 64 rows on 512 more
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(64) << 32) | (static_cast<uint64_t>(1) << 62);
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
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
template <int U>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[U][4]) {
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[u][i])::"memory");
}

// d[64 x 64] f32 (+)= a[64 x 8] tf32 (registers, each warp 16 rows as in
// mma.m16n8k8) . b[8 x 64] tf32 (shared, K-major); d[n][e] is row
// 16 warp + lane / 4 (+ 8 for e >= 2), column 8n + 2 (lane % 4) + e % 2;
// `accumulate` 0 starts d afresh
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = smem_u32(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

struct Args {
  const float* x;        // [m, k], row stride k
  const float* w;        // kn: w[k][n] at w + k ldw + n; nk: at w + n ldw + k
  float* y;              // [m, n] (splits == 1) or the workspace [splits, m, n]
  long long ldw;
  int m, k, n, chunk;
};

// copies tile t of this block's k range into ring slot `slot`
template <int BN, bool kNK>
__device__ __forceinline__ void load_tile(const Args& a, float* slot, int m0,
                                          int n0, int k0, int kend,
                                          int tid) {
  using L = Layout<BN, kNK>;
  uint8_t* xs = reinterpret_cast<uint8_t*>(slot);
  for (int i = tid; i < kTileM * (kTileK / 4); i += kThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 4;
    const bool in = m0 + r < a.m && k0 + c < kend;
    cp_async16(reinterpret_cast<float*>(xs + sw_off(r, c)),
               a.x + (in ? static_cast<long long>(m0 + r) * a.k + k0 + c : 0),
               in);
  }
  if constexpr (kNK) {
    uint8_t* ws = xs + 4 * L::kXf;
    for (int i = tid; i < BN * (kTileK / 4); i += kThreads) {
      const int r = i >> 3;
      const int c = (i & 7) * 4;
      const bool in = n0 + r < a.n && k0 + c < kend;
      cp_async16(reinterpret_cast<float*>(ws + sw_off(r, c)),
                 a.w + (in ? (n0 + r) * a.ldw + k0 + c : 0), in);
    }
  } else {
    float* ws = slot + L::kXf;
    constexpr int kChunks = BN / 4;
    for (int i = tid; i < kTileK * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 4;
      const bool in = k0 + r < kend && n0 + c < a.n;
      cp_async16(ws + r * L::kWr + c,
                 a.w + (in ? (k0 + r) * a.ldw + n0 + c : 0), in);
    }
  }
}

template <int BN, bool kNK>
__global__ void __launch_bounds__(kThreads)
tc_gemm_kernel(Args a) {
  using L = Layout<BN, kNK>;
  constexpr int kHalves = BN / 64;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* bh = smem_raw + (((raw + 1023) & ~1023u) - raw);   // w hi
  uint8_t* bl = bh + L::kSplitB;                              // w lo
  float* ring = reinterpret_cast<float*>(bl + L::kSplitB);
  const uint64_t dbh = desc_sw128(smem_u32(bh));
  const uint64_t dbl = desc_sw128(smem_u32(bl));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * a.chunk;
  const int kend = min(a.k, kbeg + a.chunk);
  const int tiles = (kend - kbeg + kTileK - 1) / kTileK;

  float acc[kHalves][8][4];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][n][e] = 0.0f;

  // tiles 0 .. kStages - 2 in flight first (an empty group where there is
  // none, so every wait is "all but the kStages - 1 newest")
#pragma unroll
  for (int t = 0; t < L::kStages - 1; ++t) {
    if (t < tiles)
      load_tile<BN, kNK>(a, ring + t * L::kSlot, m0, n0, kbeg + t * kTileK,
                         kend, tid);
    cp_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    float* slot = ring + (t % L::kStages) * L::kSlot;
    const int next = t + L::kStages - 1;
    if (next < tiles)
      load_tile<BN, kNK>(a, ring + (next % L::kStages) * L::kSlot, m0, n0,
                         kbeg + next * kTileK, kend, tid);
    cp_commit();
    cp_wait<L::kStages - 1>();         // tile t has landed
    __syncthreads();

    // w's tile -> K-major hi and lo: row n, its k in 16-byte chunks of 4
    const uint8_t* xs = reinterpret_cast<const uint8_t*>(slot);
    for (int i = tid; i < BN * (kTileK / 4); i += kThreads) {
      int n, c;
      float v[4];
      if constexpr (kNK) {
        n = i >> 3;
        c = i & 7;
        const float4 f = *reinterpret_cast<const float4*>(
            xs + 4 * L::kXf + sw_off(n, 4 * c));
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      } else {
        n = i % BN;                    // lanes on consecutive columns
        c = i / BN;
        const float* src = slot + L::kXf + 4 * c * L::kWr + n;
        v[0] = src[0];
        v[1] = src[L::kWr];
        v[2] = src[2 * L::kWr];
        v[3] = src[3 * L::kWr];
      }
      uint4 h4, l4;
      split(v[0], h4.x, l4.x);
      split(v[1], h4.y, l4.y);
      split(v[2], h4.z, l4.z);
      split(v[3], h4.w, l4.w);
      const int off = sw_off(n, 4 * c);
      *reinterpret_cast<uint4*>(bh + off) = h4;
      *reinterpret_cast<uint4*>(bl + off) = l4;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    // x's fragments of the tile's four 8-deep steps, split in registers;
    // per step lo hi, hi lo, hi hi into the tile's partial sums, which
    // start at zero; then one f32 add of each into the block's sums.  A
    // tile's 12 tensor-core additions run on its partial (the tensor
    // cores add at their own internal precision); the long sum over K is
    // a chain of IEEE adds.
    const int r = 16 * warp + gr;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = 8 * u + tq;
      split(*reinterpret_cast<const float*>(xs + sw_off(r, k)), ah[u][0],
            al[u][0]);
      split(*reinterpret_cast<const float*>(xs + sw_off(r + 8, k)),
            ah[u][1], al[u][1]);
      split(*reinterpret_cast<const float*>(xs + sw_off(r, k + 4)),
            ah[u][2], al[u][2]);
      split(*reinterpret_cast<const float*>(xs + sw_off(r + 8, k + 4)),
            ah[u][3], al[u][3]);
    }
    float part[kHalves][8][4];
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const uint64_t off = (u * 32 + h * 64 * 128) >> 4;
        wgmma_tf32(part[h], al[u], dbh + off, u > 0);
        wgmma_tf32(part[h], ah[u], dbl + off, 1);
        wgmma_tf32(part[h], ah[u], dbh + off, 1);
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      fence_acc(part[h]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][n][e] += part[h][n][e];
    }
    fence_regs(ah);
    fence_regs(al);
    __syncthreads();                   // the slot and the split tiles are
  }                                    // free for the next tile
  cp_wait<0>();                        // no copy outlives the block

  float* yb = a.y + static_cast<long long>(blockIdx.z) * a.m * a.n;
  const bool pairs = (a.n & 1) == 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = m0 + 16 * warp + gr + 8 * hr;
    if (row >= a.m) continue;
    float* yr = yb + static_cast<long long>(row) * a.n;
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = n0 + 64 * h + 8 * n + 2 * tq;
        const float v0 = acc[h][n][2 * hr];
        const float v1 = acc[h][n][2 * hr + 1];
        if (pairs && col + 1 < a.n) {
          *reinterpret_cast<float2*>(yr + col) = make_float2(v0, v1);
        } else {
          if (col < a.n) yr[col] = v0;
          if (col + 1 < a.n) yr[col + 1] = v1;
        }
      }
  }
}

// y[i] = part[0][i] + part[1][i] + ... in that order
__global__ void tc_gemm_combine(const float* __restrict__ part,
                                float* __restrict__ y, long long mn,
                                int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < mn; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s = s + part[z * mn + i];
    y[i] = s;
  }
}

// Lets an instance take its shared memory (over the 48 KB default), once
// per device.
template <int BN, bool kNK>
cudaError_t allow_smem() {
  static std::atomic<unsigned> done{0};          // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(tc_gemm_kernel<BN, kNK>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Layout<BN, kNK>::kBytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <int BN, bool kNK>
int launch_one(const Args& a, int splits, cudaStream_t stream) {
  const cudaError_t e = allow_smem<BN, kNK>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.m + kTileM - 1) / kTileM, (a.n + BN - 1) / BN, splits);
  tc_gemm_kernel<BN, kNK>
      <<<grid, kThreads, Layout<BN, kNK>::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = x [m, k] @ w in float32.  transposed 0: w [k, n] row-major, leading
// stride ldw (n % 4 == 0, ldw % 4 == 0); 1: w[k][n] = t[n * ldw + k], the
// transposed view of a row-major [n, k] (ldw % 4 == 0).  k % 4 == 0, x
// contiguous, every pointer 16-byte aligned.  block_n in {64, 128};
// splits >= 1 blocks share a tile's k, chunk (a multiple of 32) each: for
// splits > 1 `work` is a float32 [splits, m, n] workspace and the parts
// are added in order into y by a second launch.  Returns a cudaError_t.
extern "C" int tc_gemm_f32(const void* x, const void* w, void* y, void* work,
                           int m, int k, int n, long long ldw,
                           int transposed, int block_n, int splits,
                           int chunk, void* stream) {
  if (m < 1 || k < 1 || n < 1 || k % 4 != 0 || ldw % 4 != 0 ||
      (!transposed && n % 4 != 0) || splits < 1 || splits > kMaxSplits ||
      chunk < 1 || chunk % kTileK != 0 ||
      static_cast<long long>(splits - 1) * chunk >= k ||
      static_cast<long long>(splits) * chunk < k ||
      (block_n != 64 && block_n != 128) ||
      (n + block_n - 1) / block_n > 65535 || (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.y = static_cast<float*>(splits > 1 ? work : y);
  a.ldw = ldw;
  a.m = m;
  a.k = k;
  a.n = n;
  a.chunk = chunk;
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  int status;
  if (transposed) {
    status = block_n == 64 ? launch_one<64, true>(a, splits, cs)
                           : launch_one<128, true>(a, splits, cs);
  } else {
    status = block_n == 64 ? launch_one<64, false>(a, splits, cs)
                           : launch_one<128, false>(a, splits, cs);
  }
  if (status != 0 || splits == 1) return status;
  const long long mn = static_cast<long long>(m) * n;
  const long long blocks = (mn + 255) / 256;
  tc_gemm_combine<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256,
                    0, cs>>>(static_cast<const float*>(work),
                             static_cast<float*>(y), mn, splits);
  return static_cast<int>(cudaGetLastError());
}
