// Causal / windowed / bidirectional GQA flash attention, forward, on the
// tensor cores with f32 parity.
//
// Replaces the TPU kernel `flash_attention_fwd` in
// src/repro/kernels/flash.py (body `_flash_fwd_kernel`).  Every
// full-sequence attention of the port runs it once per layer: the forward
// of the agent and server stages, prefill, and the training forward (and
// its recompute under remat).  q [B, H, S, dh] attends k/v [B, KV, T, dh]
// with H = KV * G; every operand is read, and the output written, through
// element strides (the last axis contiguous), so the model's [B, S, H, dh]
// activations need no transposed copy.  f32 or bf16 in, f32 arithmetic,
// out in the input's type; dh <= 128.
//
// What bounds it on an H100: causal attention does 4 * dh flops per
// visible (query, key) pair, ~2 * S^2 * dh * H in all, against q + k + v +
// out bytes.  At the serve shape (B = 4, S = 64) the bytes bound it (0.63
// us); from S = 128 on the operations: at B = 1, S = 1024 0.028 ms on the
// f32 SIMT peak (67 TFLOP/s), 0.011 ms for the three TF32 passes this
// kernel issues at 495 TFLOP/s (dense; `wgmma` is the only route to it).
//
// Products.  One TF32 pass keeps only 11 significant bits of each operand
// (~3 digits), too few for the reference's 2e-5.  So each f32 operand x is
// split into hi = tf32(x) (the rounding of `cvt.rna.tf32.f32`, done as two
// integer instructions: the PTX instruction lowers to several on sm_90)
// and lo = tf32(x - hi), and a product is formed as lo_a hi_b + hi_a lo_b
// + hi_a hi_b, dropping lo_a lo_b (~2^-22 relative): three TF32 `wgmma`
// passes into one f32 accumulator, each operand exact to ~2^-22 and each
// product of two TF32 values exact.  bf16 inputs are exact in TF32, so
// q k^T takes one pass and p V two (p split, V exact).  This
// error-compensated product is the kernel's own; torch's TF32 flags stay
// off (device.py).  tests/test_torch_attn_split.py emulates the products
// and the schedule on the CPU against the reference within 2e-5.
//
// Design.  One block is one warpgroup (4 warps) per (row b, query head,
// 64-row query tile): the m64 of `wgmma.m64n64k8.f32.tf32.tf32`, each
// warp 16 rows, 224 warps at the serve shape where the SIMT kernel had 56
// blocks.  The block walks 64-position kv tiles in ascending order, as
// the Pallas grid's sequential kv axis did.  K and V each have one buffer
// and their own `cp.async` group (16-byte copies; bf16 or misaligned
// operands are staged by plain loads, converted to f32): K(j + 1) is
// copied while tile j's softmax and p V run, V(j + 1) while tile j + 1's
// q k^T runs.  Per tile
//   1. K, copied into a K-major tile under the 128-byte swizzle, is split
//      in place (hi) and beside it (lo); q k^T takes q's fragments from
//      registers (split per step) and K from shared memory, 3 x DH / 8
//      wgmmas into the 16 x 64 score fragment of each warp, times
//      dh**-0.5, the finite NEG_INF = -1e30 where masked;
//   2. `_flash_fwd_kernel`'s online-softmax update runs on the
//      accumulator fragments, in f32: tile max (a quad shuffle), m_new,
//      p = exp(s - m_new) or 0 where masked, corr = exp(m - m_new),
//      l = l * corr + sum p (a tile whose keys the warp's 16 rows all see
//      skips the mask test: same arithmetic);
//   3. V is transposed into V^T hi and lo tiles (K-major, swizzled), its
//      kv positions in each group of 8 stored as 0 2 4 6 1 3 5 7, so that
//      p's accumulator fragment is the wgmma's A fragment as it stands;
//   4. pv = p V is formed fresh for the tile (3 x 8 wgmmas per 64
//      columns) and acc = fmaf(acc, corr, pv);
// and writes acc / max(l, 1e-30).  `expf`, no fast math in the build.
// ~100 KB of shared memory a block at dh <= 64 (two blocks an SM), ~195 KB
// at dh <= 128.  The longest causal walks are scheduled first.
// The seven query heads of a kv head stage the same K/V tiles separately
// (from L2): a block that shared them would hold 7 x 64 query rows, leave
// 8 blocks for 132 SMs at the serve shape, and the stage clock
// (tools/attn_time.py --clock) puts the waits for K and V at ~2 % of a
// tile step at S = 1024, so parallelism was kept.
//
// Masking: a key is visible to a query when kpos < kend (kend = min(T,
// kv_len[b]): keys past the true length never enter the softmax, causal or
// not), kpos <= qpos when causal, and qpos - kpos < window when window >
// 0, where query row r sits at qpos = q_off + r (q_off > 0: a sequence
// chunk's queries against the whole sequence's keys).  Only the kv tiles
// that hold a position visible to some row of the query tile are walked.
//
// Two properties hold by construction (chip_smoke.py checks them bitwise):
// * Row independence: a block reads only its own row's q, k, v and kv_len,
//   the tile sizes are constants, and a tensor-core product's output row
//   depends on its own row of A alone, so a row's output depends on
//   neither B nor any other row.
// * Padding is invisible: a fully masked tile is an exact no-op on (m, l,
//   acc) (max with NEG_INF leaves m, corr = expf(0) = 1, p = 0 so pv = 0),
//   so whether the walk includes it changes no bit; tiles sit at fixed
//   multiples of 64, so right-padding S and T (with kv_len, or causally)
//   walks the same tiles with the same arithmetic on the real positions
//   (a masked key's p is 0 whatever the padding holds).

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kTile = 64;            // query rows and kv positions per tile
constexpr int kWarps = 4;            // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

struct Strides {                     // element strides of q, k, v, out
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// Shared memory of a block.  K is a K-major tile of 64 rows (kv
// positions) x DH (d), V^T one of DH rows (d) x 64 (kv positions), each as
// TF32 hi and lo parts under the 128-byte swizzle wgmma reads (kTileB
// bytes each, 1 KB aligned); q and the V tile as copied, row-major f32
// with rows of DH + 4 (the fragment loads fall on distinct banks, rows
// stay 16-byte multiples for cp.async).
template <int DH> struct Layout {
  static constexpr int kRow = DH + 4;
  static constexpr int kTileB = DH * 256;
  static constexpr int kQ = kTile * kRow;         // floats of the q tile
  static constexpr int kVr = kTile * kRow;        // of the copied V tile
  static constexpr int kBytes = 1024 + 4 * kTileB + 4 * (kQ + kVr);
};

// byte offset of element (r, k) of a K-major tf32 tile of R rows under the
// 128-byte swizzle: k in atoms of 32 (R x 128 B each), row r at 128 B, its
// 16-byte chunk (k % 32) / 4 xor r % 8
template <int R>
__device__ __forceinline__ int sw_off(int r, int k) {
  return (k >> 5) * (R * 128) + r * 128 + ((((k >> 2) & 7) ^ (r & 7)) << 4) +
         ((k & 3) << 2);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);          // round to nearest even, as torch
}

// cvt.rna.tf32.f32 for a finite x (round to 10 stored mantissa bits, ties
// away from zero) in two integer instructions: the PTX instruction lowers
// to several on sm_90
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x -> (hi, lo): hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// descriptor of a K-major tile under the 128-byte swizzle: 8-row groups
// 1024 B apart (SBO = 64 x 16 B), base 1 KB aligned; a k-step (8 tf32,
// 32 B) further on within an atom is 2 more in the address field
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
// keep the compiler from touching accumulators, or reusing the registers
// of in-flight A fragments, across a wgmma
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int u = 0; u < 8; ++u)
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

// `_flash_fwd_kernel`'s online-softmax update on a warp's 16 x 64 score
// fragment (rows qpos and qpos + 8, columns kpos + 8n + e): masked to
// NEG_INF, tile max over the quad, m_new, p = exp(s - m_new) or 0 where
// masked, corr = exp(m - m_new), l = l * corr + sum p; p overwrites s
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&sc)[8][4],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&corr)[2], float scale,
                                             int qpos, int kpos, int kend,
                                             int causal, int window) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = qpos + 8 * hr;
    // the key is visible (see Masking above) iff klo <= kpos <= khi
    const int klo = window > 0 ? qp - window + 1 : INT_MIN;
    const int khi = causal ? min(qp, kend - 1) : kend - 1;
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[n][2 * hr + e];
        const int kp = kpos + 8 * n + e;
        x = !kMasked || ((kp >= klo) & (kp <= khi)) ? x * scale : kNegInf;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[hr], mx);
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[n][2 * hr + e];
        const int kp = kpos + 8 * n + e;
        x = !kMasked || ((kp >= klo) & (kp <= khi)) ? expf(x - m_new) : 0.0f;
        sum += x;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    corr[hr] = expf(m_run[hr] - m_new);
    l_run[hr] = l_run[hr] * corr[hr] + sum;
    m_run[hr] = m_new;
  }
}

// x -> (hi, lo) for each element; an operand exact in TF32 (bf16 input)
// is its own hi and has no lo
template <bool kExact, int N>
__device__ __forceinline__ void split_all(const float (&x)[N],
                                          uint32_t (&hi)[N],
                                          uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (kExact) {
      hi[i] = __float_as_uint(x[i]);
      lo[i] = 0u;
    } else {
      split(x[i], hi[i], lo[i]);
    }
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
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

// rows [r0, r0 + 64) of a [rows, dh] operand (row stride `rs` elements)
// into shared memory with row stride `ld` floats; rows >= n_rows as 0,
// columns >= dh untouched.  kAsync: 16-byte cp.async copies (f32, dh % 4
// == 0, aligned); otherwise plain loads converted to f32.  A thread's
// column is fixed (compile-time strides), its rows step by
// kThreads / columns.
template <typename T, bool kAsync, int DH>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long rs, int r0, int n_rows,
                                      int dh, int tid) {
  constexpr int kCols = kAsync ? DH / 4 : DH;    // 16-byte chunks or values
  constexpr int kStep = kThreads / kCols;        // rows a pass covers
  const int c = (tid % kCols) * (kAsync ? 4 : 1);
  if (c >= dh) return;
  for (int r = tid / kCols; r < kTile; r += kStep) {
    const bool in = r0 + r < n_rows;
    if constexpr (kAsync) {                      // T is float here
      cp_async16(dst + r * ld + c,
                 reinterpret_cast<const float*>(src) +
                     (in ? (r0 + r) * rs + c : 0),
                 in);
    } else {
      dst[r * ld + c] = in ? to_f32(src[(r0 + r) * rs + c]) : 0.0f;
    }
  }
}

// the same into the 64-row K-major swizzled tile at `dst` (sw_off)
template <typename T, bool kAsync, int DH>
__device__ __forceinline__ void stage_sw(uint8_t* dst, const T* src,
                                         long long rs, int r0, int n_rows,
                                         int dh, int tid) {
  constexpr int kCols = kAsync ? DH / 4 : DH;
  constexpr int kStep = kThreads / kCols;
  const int c = (tid % kCols) * (kAsync ? 4 : 1);
  if (c >= dh) return;
  for (int r = tid / kCols; r < kTile; r += kStep) {
    const bool in = r0 + r < n_rows;
    float* d = reinterpret_cast<float*>(dst + sw_off<kTile>(r, c));
    if constexpr (kAsync) {
      cp_async16(d,
                 reinterpret_cast<const float*>(src) +
                     (in ? (r0 + r) * rs + c : 0),
                 in);
    } else {
      *d = in ? to_f32(src[(r0 + r) * rs + c]) : 0.0f;
    }
  }
}

// Built with -DFLASH_STAGE_CLOCK (tools/attn_time.py --clock, never in the
// port's build), lane 0 of each warp of block (0, 0) (the longest causal
// walk) sums the clock64() cycles of each of the 9 parts of a tile step
// and writes them, and the number of steps, to clock_out[10 * warp ...].
#ifdef FLASH_STAGE_CLOCK
#define STAGE_CLOCK(part)                                                  \
  do {                                                                     \
    const long long now_ = clock64();                                      \
    clk[part] += now_ - clk_last;                                          \
    clk_last = now_;                                                       \
  } while (0)
#else
#define STAGE_CLOCK(part)
#endif

template <typename T, int DH, bool kAsync>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 const int* __restrict__ kv_len, Strides st, int h, int g,
                 int s_len, int t_len, int dh, int causal, int window,
                 int q_off, float scale, long long* clock_out) {
  using L = Layout<DH>;
  constexpr bool kExact = !std::is_same<T, float>::value;   // bf16
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* kh = smem_raw + (((raw + 1023) & ~1023u) - raw);  // K hi
  uint8_t* kl = kh + L::kTileB;                              // K lo
  uint8_t* vh = kl + L::kTileB;                              // V^T hi
  uint8_t* vl = vh + L::kTileB;                              // V^T lo
  float* qs = reinterpret_cast<float*>(vl + L::kTileB);      // q tile
  float* vr = qs + L::kQ;                                    // V tile
  const uint64_t dkh = desc_sw128(smem_u32(kh));
  const uint64_t dkl = desc_sw128(smem_u32(kl));
  const uint64_t dvh = desc_sw128(smem_u32(vh));
  const uint64_t dvl = desc_sw128(smem_u32(vl));

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int kvh = hh / g;
  // the longest walks (last query tiles, when causal) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;                // the MMA's row group
  const int tq = lane & 3;                 // and thread in the group
  const int r0 = 16 * warp;                // the warp's first query row

  int kend = t_len;
  if (kv_len != nullptr) kend = max(min(kend, kv_len[b]), 0);
  const T* qb = q + b * st.qb + hh * st.qh;
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;

  // kv tiles holding a position visible to some row of this query tile
  // (query row r sits at position q_off + r for the masks)
  const int q_last = min(q0 + kTile, s_len) - 1 + q_off;
  const int hi = causal ? min(kend, q_last + 1) : kend;
  const int lo = window > 0 ? max(q0 + q_off - window + 1, 0) : 0;
  const int j_first = lo / kTile;
  const int j_end = hi > lo ? (hi + kTile - 1) / kTile : j_first;

  // columns dh..DH stay 0 (the contraction's padding)
  if (dh < DH) {
    for (int i = tid; i < kTile * (DH - dh); i += kThreads) {
      const int r = i / (DH - dh);
      const int c = dh + i - r * (DH - dh);
      qs[r * L::kRow + c] = 0.0f;
      vr[r * L::kRow + c] = 0.0f;
      *reinterpret_cast<float*>(kh + sw_off<kTile>(r, c)) = 0.0f;
    }
  }
  // K and V each have one buffer and their own cp.async group: K(j + 1)
  // is copied while tile j's softmax and p V run, V(j + 1) while tile
  // j + 1's q k^T runs (an empty group when there is none, so every wait
  // is "all but the newest group")
  const int t_first = j_first * kTile;
  stage<T, kAsync, DH>(qs, L::kRow, qb, st.qs, q0, s_len, dh, tid);
  if (j_first < j_end)
    stage_sw<T, kAsync, DH>(kh, kb, st.ks, t_first, t_len, dh, tid);
  if constexpr (kAsync) cp_commit();
  if (j_first < j_end)
    stage<T, kAsync, DH>(vr, L::kRow, vb, st.vs, t_first, t_len, dh, tid);
  if constexpr (kAsync) cp_commit();

  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};     // rows gr and gr + 8
  float l_run[2] = {0.0f, 0.0f};

#ifdef FLASH_STAGE_CLOCK
  long long clk[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long clk_last = clock64();
#endif
  for (int j = j_first; j < j_end; ++j) {
    if constexpr (kAsync) cp_wait<1>();    // K(j) (and q) have landed
    __syncthreads();
    STAGE_CLOCK(0);
    const int t0 = j * kTile;
    const bool more = j + 1 < j_end;

    // K split in place: hi stays, lo beside it
    if constexpr (!kExact) {
      for (int i = tid; i < L::kTileB / 16; i += kThreads) {
        uint4* x = reinterpret_cast<uint4*>(kh) + i;
        uint4 h4 = *x, l4;
        split(__uint_as_float(h4.x), h4.x, l4.x);
        split(__uint_as_float(h4.y), h4.y, l4.y);
        split(__uint_as_float(h4.z), h4.z, l4.z);
        split(__uint_as_float(h4.w), h4.w, l4.w);
        *x = h4;
        reinterpret_cast<uint4*>(kl)[i] = l4;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    STAGE_CLOCK(1);

    // 1. S = q k^T: q's fragment of step kk (k index tq, tq + 4 = d 8kk +
    // tq, + 4) from registers, K from shared memory, pass by pass; eight
    // steps' fragments stay live until their products are done
    float sc[8][4];
#pragma unroll
    for (int k0 = 0; k0 < DH / 8; k0 += 8) {
      uint32_t ah[8][4], al[8][4];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* qa = qs + (r0 + gr) * L::kRow + 8 * (k0 + u) + tq;
        const float a[4] = {qa[0], qa[8 * L::kRow], qa[4],
                            qa[8 * L::kRow + 4]};
        split_all<kExact>(a, ah[u], al[u]);
      }
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int kk = k0 + u;
        const uint64_t off = ((kk >> 2) * (kTile * 128) + (kk & 3) * 32) >> 4;
        if constexpr (!kExact) {
          wgmma_tf32(sc, al[u], dkh + off, kk > 0);
          wgmma_tf32(sc, ah[u], dkl + off, 1);
        }
        wgmma_tf32(sc, ah[u], dkh + off, !kExact || kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(sc);
      fence_regs(ah);
      fence_regs(al);
    }
    STAGE_CLOCK(2);
    __syncthreads();                       // every warp is done with K(j)
    if (more)
      stage_sw<T, kAsync, DH>(kh, kb, st.ks, t0 + kTile, t_len, dh, tid);
    if constexpr (kAsync) cp_commit();
    STAGE_CLOCK(3);

    // 2. the online-softmax update; no mask to test where the warp's 16
    // rows see every key of the tile
    const int row0 = q0 + r0 + q_off;      // the warp's first position
    float corr[2];
    if (t0 + kTile <= kend && (!causal || t0 + kTile - 1 <= row0) &&
        (window <= 0 || row0 + 15 - t0 < window)) {
      softmax_tile<false>(sc, m_run, l_run, corr, scale, row0 + gr,
                          t0 + 2 * tq, kend, causal, window);
    } else {
      softmax_tile<true>(sc, m_run, l_run, corr, scale, row0 + gr,
                         t0 + 2 * tq, kend, causal, window);
    }
    STAGE_CLOCK(4);

    // 3. V^T split: row d, its kv positions in each group of 8 stored as
    // 0 2 4 6 1 3 5 7, so that k index tq (tq + 4) of a step is position
    // 2tq (+ 1), where p's accumulator fragment holds it
    if constexpr (kAsync) cp_wait<1>();    // V(j) has landed
    __syncthreads();
    STAGE_CLOCK(5);
    // one 16-byte chunk of V^T a step: row d, stored positions 4c .. 4c + 3
    // = kv positions 8 (c / 2) + (c % 2) + 0, 2, 4, 6 (lanes take
    // consecutive d: reads and writes both conflict-free)
    for (int i = tid; i < DH * (kTile / 4); i += kThreads) {
      const int d = i % DH;
      const int c = i / DH;
      const float* src = vr + (8 * (c >> 1) + (c & 1)) * L::kRow + d;
      const float xs[4] = {src[0], src[2 * L::kRow], src[4 * L::kRow],
                           src[6 * L::kRow]};
      const int off = sw_off<DH>(d, 4 * c);
      uint4 h4, l4;
      if constexpr (kExact) {
        h4 = make_uint4(__float_as_uint(xs[0]), __float_as_uint(xs[1]),
                        __float_as_uint(xs[2]), __float_as_uint(xs[3]));
      } else {
        split(xs[0], h4.x, l4.x);
        split(xs[1], h4.y, l4.y);
        split(xs[2], h4.z, l4.z);
        split(xs[3], h4.w, l4.w);
        *reinterpret_cast<uint4*>(vl + off) = l4;
      }
      *reinterpret_cast<uint4*>(vh + off) = h4;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    STAGE_CLOCK(6);
    if (more)
      stage<T, kAsync, DH>(vr, L::kRow, vb, st.vs, t0 + kTile, t_len, dh,
                           tid);
    if constexpr (kAsync) cp_commit();
    STAGE_CLOCK(7);

    // 4. pv = p V fresh for the tile, 64 columns at a time, then
    // acc = fmaf(acc, corr, pv)
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int s8 = 0; s8 < 8; ++s8) {
      const float a[4] = {sc[s8][0], sc[s8][2], sc[s8][1], sc[s8][3]};
      split_all<false>(a, ph[s8], pl[s8]);
    }
#pragma unroll
    for (int dc = 0; dc < DH / 64; ++dc) {
      float pv[8][4];
      wgmma_fence();
#pragma unroll
      for (int s8 = 0; s8 < 8; ++s8) {
        const uint64_t off =
            ((s8 >> 2) * (DH * 128) + (s8 & 3) * 32 + dc * 64 * 128) >> 4;
        wgmma_tf32(pv, pl[s8], dvh + off, s8 > 0);
        if constexpr (!kExact) wgmma_tf32(pv, ph[s8], dvl + off, 1);
        wgmma_tf32(pv, ph[s8], dvh + off, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(pv);
      fence_regs(ph);
      fence_regs(pl);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[8 * dc + n][e] =
              fmaf(acc[8 * dc + n][e], corr[e >> 1], pv[n][e]);
    }
    STAGE_CLOCK(8);
  }
  if constexpr (kAsync) cp_wait<0>();      // no copy outlives the block
#ifdef FLASH_STAGE_CLOCK
  if (blockIdx.x == 0 && blockIdx.y == 0 && lane == 0) {
    clk[9] = j_end - j_first;
    for (int i = 0; i < 10; ++i) clock_out[10 * warp + i] = clk[i];
  }
#endif

  T* ob = out + b * st.ob + hh * st.oh;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qpos = q0 + r0 + gr + 8 * hr;
    if (qpos >= s_len) continue;
    const float l = fmaxf(l_run[hr], 1e-30f);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * tq + e;
        if (d < dh) ob[qpos * st.os + d] = from_f32<T>(acc[n][2 * hr + e] / l);
      }
  }
}

// Lets the instance take its shared memory (over the 48 KB default), once
// per device rather than on every launch.
template <typename T, int DH, bool kAsync>
cudaError_t allow_smem() {
  static std::atomic<unsigned> done{0};          // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(flash_fwd_kernel<T, DH, kAsync>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Layout<DH>::kBytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <typename T, int DH, bool kAsync>
int launch_one(const T* q, const T* k, const T* v, T* out, const int* kv_len,
               const Strides& st, int b, int h, int kv, int s, int t, int dh,
               int causal, int window, int q_off, float scale,
               cudaStream_t stream,
               long long* clock_out) {
  const cudaError_t e = allow_smem<T, DH, kAsync>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(b * h, (s + kTile - 1) / kTile);
  flash_fwd_kernel<T, DH, kAsync>
      <<<grid, kThreads, Layout<DH>::kBytes, stream>>>(
          q, k, v, out, kv_len, st, h, h / kv, s, t, dh, causal, window,
          q_off, scale, clock_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const void* kv_len, const long long* strides, int b, int h,
           int kv, int s, int t, int dh, int causal, int window, int q_off,
           float scale, int async_copy, void* stream,
           long long* clock_out = nullptr) {
  if (dh < 1 || dh > 128 || kv < 1 || h % kv != 0 || s > 65535 * kTile ||
      q_off < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st;
  st.qb = strides[0]; st.qh = strides[1]; st.qs = strides[2];
  st.kb = strides[3]; st.kh = strides[4]; st.ks = strides[5];
  st.vb = strides[6]; st.vh = strides[7]; st.vs = strides[8];
  st.ob = strides[9]; st.oh = strides[10]; st.os = strides[11];
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  const int* lp = static_cast<const int*>(kv_len);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  // cp.async copies f32 only (bf16 is converted as it is staged)
  if constexpr (std::is_same<T, float>::value) {
    if (async_copy) {
      return dh <= 64
          ? launch_one<T, 64, true>(qp, kp, vp, op, lp, st, b, h, kv, s, t,
                                    dh, causal, window, q_off, scale, cs,
                                    clock_out)
          : launch_one<T, 128, true>(qp, kp, vp, op, lp, st, b, h, kv, s, t,
                                     dh, causal, window, q_off, scale, cs,
                                     clock_out);
    }
  }
  return dh <= 64
      ? launch_one<T, 64, false>(qp, kp, vp, op, lp, st, b, h, kv, s, t, dh,
                                 causal, window, q_off, scale, cs, clock_out)
      : launch_one<T, 128, false>(qp, kp, vp, op, lp, st, b, h, kv, s, t, dh,
                                  causal, window, q_off, scale, cs,
                                  clock_out);
}

}  // namespace

// q [b, h, s, dh], k/v [b, kv, t, dh], out like q, all f32, addressed
// through `strides` (12 element strides: batch, head, position of q, k,
// v, out); kv_len [b] int32 or null (= t); q_off >= 0: query row r sits
// at position q_off + r for the causal and window masks (a sequence
// chunk's queries against the whole sequence's keys; 0 otherwise).
// async_copy: dh % 4 == 0 and the q, k, v addresses and their batch, head
// and position strides are 16-byte multiples, so tiles are copied 16
// bytes at a time.
extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* out, const void* kv_len,
                              const long long* strides, int b, int h, int kv,
                              int s, int t, int dh, int causal, int window,
                              int q_off, float scale, int async_copy,
                              void* stream) {
  return launch<float>(q, k, v, out, kv_len, strides, b, h, kv, s, t, dh,
                       causal, window, q_off, scale, async_copy, stream);
}

// the same with bf16 q, k, v and out (f32 arithmetic inside)
extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* out, const void* kv_len,
                               const long long* strides, int b, int h,
                               int kv, int s, int t, int dh, int causal,
                               int window, int q_off, float scale,
                               int async_copy, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, kv_len, strides, b, h, kv, s,
                               t, dh, causal, window, q_off, scale, 0,
                               stream);
}

#ifdef FLASH_STAGE_CLOCK
// flash_attn_f32 that also writes the stage clock (kWarps x 10 long longs)
// to the device buffer clock_out
extern "C" int flash_attn_f32_clock(const void* q, const void* k,
                                    const void* v, void* out,
                                    const void* kv_len,
                                    const long long* strides, int b, int h,
                                    int kv, int s, int t, int dh, int causal,
                                    int window, int q_off, float scale,
                                    int async_copy, void* stream,
                                    void* clock_out) {
  return launch<float>(q, k, v, out, kv_len, strides, b, h, kv, s, t, dh,
                       causal, window, q_off, scale, async_copy, stream,
                       static_cast<long long*>(clock_out));
}
#endif
