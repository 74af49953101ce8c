// One-token GQA attention straight over a quantized KV cache.
//
// Replaces the TPU kernel `quantized_decode_attention` in
// src/repro/kernels/decode_attn.py (body `_qdecode_kernel`, per-tile
// arithmetic `_tile_update`).  Every decode step of the engine runs it once
// per layer: q [B, 1, H, dh] f32 attends codes [B, T, KV, dh] (int8 codes
// for b_kv < 16, or the raw f32 container with unit scales) times per-vector
// scales [B, T, KV], masked to positions < cache_len[b] (and >= cache_len -
// window when window > 0).  Output [B, 1, H, dh] f32 = acc / max(l, 1e-30).
//
// What bounds it on an H100: it reads each live cache entry once and does
// 2 * G = 14 float32 flops per int8 code byte (q . k and p . v), below the
// card's f32 balance of ~20 flops per byte, so it is bound by
// the bytes of the codes (about 1.1 MB per launch at B = 4, T = 1024, int8:
// 0.33 us at 3.35 TB/s).  This first version aims to be right, not fast:
// one block of 256 threads per (row, kv-head) owns that head's G queries
// and walks the kv tiles of bt = min(block_t, T) positions in ascending
// order, as the Pallas grid's sequential tile axis did.  Each tile's codes
// are dequantized into shared memory (`code * scale`, the product the
// reference forms), the G x bt scores are formed there, and the online
// softmax update runs in `_tile_update`'s order: running max with the
// finite NEG_INF = -1e30, p zeroed where masked, l and acc rescaled by
// exp(m - m_new), then acc += p . V.  `expf` (no fast math in the build).
// The grid is only B * KV blocks, so the card is mostly idle at decode
// batch sizes; a split-T combine and TMA/wgmma staging are later work.
//
// Two properties hold by construction, and chip_smoke.py checks them
// bitwise:
// * Row independence: a block reads only its own row's q, cache and
//   length, so a row's output does not depend on B or on any other row.
// * Bucket padding is invisible: only tiles that hold a valid position are
//   walked.  A fully masked tile is an exact no-op on (m, l, acc) (max over
//   NEG_INF leaves m, corr = exp(0) = 1, p = 0), so skipping it changes no
//   bit, and growing T with cache_len fixed (bt unchanged) walks the same
//   tiles with the same arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool live(int kpos, int len, int window) {
  return kpos < len && (window <= 0 || kpos >= len - window);
}

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q, const CodeT* __restrict__ kc,
                   const CodeT* __restrict__ vc,
                   const float* __restrict__ ks,
                   const float* __restrict__ vs,
                   const int* __restrict__ lens, float* __restrict__ out,
                   int t_len, int kv, int g, int dh, int bt, int window,
                   float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [g][dh]      queries
  float* acc = qs + g * dh;          // [g][dh]      running p . V
  float* kt = acc + g * dh;          // [bt][dh + 1] dequantized K tile
  float* vt = kt + bt * (dh + 1);    // [bt][dh]     dequantized V tile
  float* ps = vt + bt * dh;          // [g][bt]      scores, then p
  float* ms = ps + g * bt;           // [g]          running max
  float* ls = ms + g;                // [g]          running sum
  float* cs = ls + g;                // [g]          this tile's exp(m - m_new)

  const int row = blockIdx.x / kv;
  const int head = blockIdx.x % kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lens[row];
  const long long qoff =
      (static_cast<long long>(row) * kv * g + static_cast<long long>(head) * g)
      * dh;

  for (int i = tid; i < g * dh; i += kThreads) {
    qs[i] = q[qoff + i];
    acc[i] = 0.0f;
  }
  for (int i = tid; i < g; i += kThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.0f;
  }
  // the tiles that hold a valid position: [lo, hi) clipped to the cache
  const int hi = min(len, t_len);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int j_first = hi > lo ? lo / bt : 0;
  const int j_end = hi > lo ? (hi + bt - 1) / bt : 0;
  __syncthreads();

  for (int j = j_first; j < j_end; ++j) {
    const int t0 = j * bt;
    for (int i = tid; i < bt * dh; i += kThreads) {
      const int tt = i / dh;
      const int d = i - tt * dh;
      const long long vec =
          (static_cast<long long>(row) * t_len + t0 + tt) * kv + head;
      kt[tt * (dh + 1) + d] = static_cast<float>(kc[vec * dh + d]) * ks[vec];
      vt[tt * dh + d] = static_cast<float>(vc[vec * dh + d]) * vs[vec];
    }
    __syncthreads();

    // scores: one ascending-d FMA chain per (query, position); the +1 pad
    // of the K tile keeps a warp's 32 positions on 32 banks
    for (int i = tid; i < g * bt; i += kThreads) {
      const int gg = i / bt;
      const int tt = i - gg * bt;
      const float* qv = qs + gg * dh;
      const float* kv_row = kt + tt * (dh + 1);
      float s = 0.0f;
      for (int d = 0; d < dh; ++d) s = fmaf(qv[d], kv_row[d], s);
      s *= scale;
      ps[i] = live(t0 + tt, len, window) ? s : kNegInf;
    }
    __syncthreads();

    // the online-softmax update, one warp per query
    for (int gg = warp; gg < g; gg += kWarps) {
      float* p = ps + gg * bt;
      float mx = kNegInf;
      for (int tt = lane; tt < bt; tt += 32) mx = fmaxf(mx, p[tt]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[gg];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int tt = lane; tt < bt; tt += 32) {
        const float e = live(t0 + tt, len, window) ? expf(p[tt] - m_new)
                                                   : 0.0f;
        p[tt] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        ls[gg] = ls[gg] * corr + sum;
        cs[gg] = corr;
        ms[gg] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * dh; i += kThreads) {
      const int gg = i / dh;
      const int d = i - gg * dh;
      const float* p = ps + gg * bt;
      float a = 0.0f;
      for (int tt = 0; tt < bt; ++tt) a = fmaf(p[tt], vt[tt * dh + d], a);
      acc[i] = acc[i] * cs[gg] + a;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * dh; i += kThreads)
    out[qoff + i] = acc[i] / fmaxf(ls[i / dh], 1e-30f);
}

template <typename CodeT>
int launch(const void* q, const void* kc, const void* vc, const void* ks,
           const void* vs, const void* lens, void* out, int smem, int b,
           int t, int kv, int g, int dh, int bt, int window, float scale,
           void* stream) {
  auto kernel = decode_attn_kernel<CodeT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<b * kv, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const CodeT*>(kc),
      static_cast<const CodeT*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lens),
      static_cast<float*>(out), t, kv, g, dh, bt, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, 1, kv * g, dh] f32, codes [b, t, kv, dh] int8, scales [b, t, kv]
// f32, lens [b] int32 -> out [b, 1, kv * g, dh] f32; smem bytes per block
extern "C" int decode_attn_i8(const void* q, const void* kc, const void* vc,
                              const void* ks, const void* vs,
                              const void* lens, void* out, int smem, int b,
                              int t, int kv, int g, int dh, int bt,
                              int window, float scale, void* stream) {
  return launch<int8_t>(q, kc, vc, ks, vs, lens, out, smem, b, t, kv, g, dh,
                        bt, window, scale, stream);
}

// the same with the raw f32 container (b_kv >= 16, unit scales)
extern "C" int decode_attn_f32(const void* q, const void* kc, const void* vc,
                               const void* ks, const void* vs,
                               const void* lens, void* out, int smem, int b,
                               int t, int kv, int g, int dh, int bt,
                               int window, float scale, void* stream) {
  return launch<float>(q, kc, vc, ks, vs, lens, out, smem, b, t, kv, g, dh,
                       bt, window, scale, stream);
}
