// Causal / windowed / bidirectional GQA flash attention, forward.
//
// Replaces the TPU kernel `flash_attention_fwd` in
// src/repro/kernels/flash.py (body `_flash_fwd_kernel`).  Every
// full-sequence attention of the port runs it once per layer: the forward
// of the agent and server stages, prefill, and the training forward (and
// its recompute under remat).  q [B, H, S, dh] attends k/v [B, KV, T, dh]
// with H = KV * G; every operand is read, and the output written, through
// element strides (the last axis contiguous), so the model's [B, S, H, dh]
// activations need no transposed copy.  f32 or bf16 in, f32 arithmetic,
// out in the input's type.
//
// What bounds it on an H100: causal attention does 4 * dh f32 flops per
// visible (query, key) pair, ~2 * S^2 * dh * H in all, against q + k + v +
// out bytes; at the serve shape (B = 4, S = 64) the bytes bound it
// (0.63 us against 0.44 us of f32 flops), from S = 128 on the operations.
// This first version aims to be right, not fast: CUDA-core
// f32 FMAs (the reference's parity needs f32, and wgmma has no f32 inputs;
// TF32 would keep only ~3 digits).  One block of 256 threads per
// (row b, query head, 64-row query tile) walks 64-position kv tiles in
// ascending order, as the Pallas grid's sequential kv axis did:
//   1. stage the K tile (padded to dh + 1 against bank conflicts) and the
//      V tile in shared memory, as f32;
//   2. each thread forms a 4 x 4 patch of the 64 x 64 scores, each score
//      one ascending-d `fmaf` chain, scaled by dh**-0.5 and set to the
//      finite NEG_INF = -1e30 where masked;
//   3. one warp per query row runs `_flash_fwd_kernel`'s online-softmax
//      update in a fixed order (tile max, m_new, p = exp(s - m_new) or 0
//      where masked, corr = exp(m - m_new), l = l * corr + sum p);
//   4. acc = acc * corr + p . V, each output one ascending-position
//      `fmaf` chain, acc [64, dh] held in registers across the kv tiles;
// and writes acc / max(l, 1e-30).  `expf`, no fast math in the build.
//
// Masking: a key is visible to a query when kpos < kend (kend = min(T,
// kv_len[b]): keys past the true length never enter the softmax, causal or
// not), kpos <= qpos when causal, and qpos - kpos < window when window >
// 0.  Only the kv tiles that hold a position visible to some row of the
// query tile are walked.
//
// Two properties hold by construction (chip_smoke.py checks them bitwise):
// * Row independence: a block reads only its own row's q, k, v and kv_len,
//   and the tile sizes are constants, so a row's output depends on neither
//   B nor any other row.
// * Padding is invisible: a fully masked tile is an exact no-op on (m, l,
//   acc) (max with NEG_INF leaves m, corr = expf(0) = 1, p = 0), so
//   whether the walk includes it changes no bit; tiles sit at fixed
//   multiples of 64, so right-padding S and T (with kv_len, or causally)
//   walks the same tiles with the same arithmetic on the real positions.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;            // query rows and kv positions per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPs = kTile + 16;      // score row stride: the two half-warps
                                     // of a store land on disjoint banks
constexpr float kNegInf = -1e30f;

struct Strides {                     // element strides of q, k, v, out
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

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

__device__ __forceinline__ bool visible(int qpos, int kpos, int kend,
                                        int causal, int window) {
  return kpos < kend && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// DC = output columns per thread = ceil(dh / 16): 4 for dh <= 64, 8 for
// dh <= 128
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 const int* __restrict__ kv_len, Strides st, int h, int g,
                 int s_len, int t_len, int dh, int causal, int window,
                 float scale) {
  extern __shared__ float smem[];
  const int qld = dh + 1;
  float* qs = smem;                        // [64][dh + 1] query tile
  float* ks = qs + kTile * qld;            // [64][dh + 1] K tile
  float* vs = ks + kTile * qld;            // [64][dh]     V tile
  float* ps = vs + kTile * dh;             // [64][kPs]    scores, then p
  float* ms = ps + kTile * kPs;            // [64] running max
  float* ls = ms + kTile;                  // [64] running sum
  float* cs = ls + kTile;                  // [64] this tile's exp(m - m_new)

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh - b * h;
  const int kvh = hh / g;
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int tx = tid & 15;                 // score / output column group
  const int ty = tid >> 4;                 // query row group
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int kend = t_len;
  if (kv_len != nullptr) kend = max(min(kend, kv_len[b]), 0);
  const T* qb = q + b * st.qb + hh * st.qh;
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;

  for (int i = tid; i < kTile * dh; i += kThreads) {
    const int r = i / dh;
    const int d = i - r * dh;
    qs[r * qld + d] =
        q0 + r < s_len ? to_f32(qb[(q0 + r) * st.qs + d]) : 0.0f;
  }
  for (int i = tid; i < kTile; i += kThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.0f;
  }

  // kv tiles holding a position visible to some row of this query tile
  const int q_last = min(q0 + kTile, s_len) - 1;
  const int hi = causal ? min(kend, q_last + 1) : kend;
  const int lo = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int j_first = lo / kTile;
  const int j_end = hi > lo ? (hi + kTile - 1) / kTile : j_first;

  float acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.0f;
  int dcol[DC];                            // clamped: read in range, and
#pragma unroll                             // only columns < dh are stored
  for (int c = 0; c < DC; ++c) dcol[c] = min(tx + 16 * c, dh - 1);
  __syncthreads();

  for (int j = j_first; j < j_end; ++j) {
    const int t0 = j * kTile;
    for (int i = tid; i < kTile * dh; i += kThreads) {
      const int r = i / dh;
      const int d = i - r * dh;
      const bool in = t0 + r < t_len;
      ks[r * qld + d] = in ? to_f32(kb[(t0 + r) * st.ks + d]) : 0.0f;
      vs[r * dh + d] = in ? to_f32(vb[(t0 + r) * st.vs + d]) : 0.0f;
    }
    __syncthreads();

    // scores: rows ty + 16 r, positions tx + 16 c
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.0f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[(ty + 16 * r) * qld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tx + 16 * c) * qld + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        ps[row * kPs + col] =
            visible(q0 + row, t0 + col, kend, causal, window)
                ? sc[r][c] * scale
                : kNegInf;
      }
    }
    __syncthreads();

    // the online-softmax update, one warp per query row
    for (int row = warp; row < kTile; row += kWarps) {
      float* p = ps + row * kPs;
      const int qpos = q0 + row;
      const float a = p[lane];
      const float c = p[lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[row];
      const float m_new = fmaxf(m_old, mx);
      const float ea =
          visible(qpos, t0 + lane, kend, causal, window) ? expf(a - m_new)
                                                         : 0.0f;
      const float ec = visible(qpos, t0 + lane + 32, kend, causal, window)
                           ? expf(c - m_new)
                           : 0.0f;
      p[lane] = ea;
      p[lane + 32] = ec;
      float sum = ea + ec;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        ls[row] = ls[row] * corr + sum;
        cs[row] = corr;
        ms[row] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . V
    float pv[4][DC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c) pv[r][c] = 0.0f;
    for (int tt = 0; tt < kTile; ++tt) {
      float pr[4], vv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = ps[(ty + 16 * r) * kPs + tt];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[tt * dh + dcol[c]];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) pv[r][c] = fmaf(pr[r], vv[c], pv[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float corr = cs[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] = acc[r][c] * corr + pv[r][c];
    }
    __syncthreads();   // the next tile overwrites ks, vs and ps
  }

  T* ob = out + b * st.ob + hh * st.oh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    if (q0 + row >= s_len) continue;
    const float l = fmaxf(ls[row], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) ob[(q0 + row) * st.os + d] = from_f32<T>(acc[r][c] / l);
    }
  }
}

// dynamic shared memory of a block at head size dh: K (padded) and V
// tiles, the scores, and the per-row (m, l, corr)
constexpr int smem_bytes(int dh) {
  return static_cast<int>(sizeof(float) * (2 * kTile * (dh + 1) + kTile * dh +
                                           kTile * kPs + 3 * kTile));
}

// Lets the <T, DC> instance take the shared memory of its largest head
// size (16 * DC; over the 48 KB default even at dh = 64), once per device
// rather than on every launch.
template <typename T, int DC>
cudaError_t allow_smem() {
  static std::atomic<unsigned> done{0};          // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(flash_fwd_kernel<T, DC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes(16 * DC));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const void* kv_len, const long long* strides, int b, int h,
           int kv, int s, int t, int dh, int causal, int window, float scale,
           void* stream) {
  if (dh < 1 || dh > 128 || kv < 1 || h % kv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = dh <= 64 ? allow_smem<T, 4>() : allow_smem<T, 8>();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = dh <= 64 ? flash_fwd_kernel<T, 4> : flash_fwd_kernel<T, 8>;
  const int smem = smem_bytes(dh);
  Strides st;
  st.qb = strides[0]; st.qh = strides[1]; st.qs = strides[2];
  st.kb = strides[3]; st.kh = strides[4]; st.ks = strides[5];
  st.vb = strides[6]; st.vh = strides[7]; st.vs = strides[8];
  st.ob = strides[9]; st.oh = strides[10]; st.os = strides[11];
  const dim3 grid(b * h, (s + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<const int*>(kv_len), st, h, h / kv, s, t, dh, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, h, s, dh], k/v [b, kv, t, dh], out like q, all f32, addressed
// through `strides` (12 element strides: batch, head, position of q, k,
// v, out); kv_len [b] int32 or null (= t)
extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* out, const void* kv_len,
                              const long long* strides, int b, int h, int kv,
                              int s, int t, int dh, int causal, int window,
                              float scale, void* stream) {
  return launch<float>(q, k, v, out, kv_len, strides, b, h, kv, s, t, dh,
                       causal, window, scale, stream);
}

// the same with bf16 q, k, v and out (f32 arithmetic inside)
extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* out, const void* kv_len,
                               const long long* strides, int b, int h,
                               int kv, int s, int t, int dh, int causal,
                               int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, kv_len, strides, b, h, kv, s,
                               t, dh, causal, window, scale, stream);
}
