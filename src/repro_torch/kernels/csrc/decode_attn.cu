// One-token GQA attention straight over a quantized KV cache, split over
// the cache with a fixed-order combine.
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
// card's f32 balance of ~20 flops per byte, so the bytes of the live codes
// bound it: ~1 MB per launch at B = 4, T = 1024, int8, 0.3 us at 3.35
// TB/s.  In practice one launch and one round of block latency set the
// floor, so the design fills the card in one wave and reads the codes with
// 16-byte loads.  Tensor cores and TMA buy nothing here: a chunk is a few
// KB and G = 7 queries are too few rows for an MMA tile.
//
// Design.  The cache axis is cut into chunks of kChunk = 64 positions at
// fixed multiples of kChunk (a constant: it depends on neither B, T,
// cache_len nor the plain version's block_t).  The grid is
// ceil(T / kChunk) x (B * KV); a block owns one (row, kv head, chunk) and
// the G queries of that head, and exits at once unless its chunk holds a
// live position (in [max(len - window, 0), min(len, T))).  At B = 4,
// T = 1024 and lengths [1024, 800, 532, 300] that is 86 live blocks of 256
// threads, where one block per (row, kv head) gave 8.  A live block
//   1. stages its chunk's codes with 16-byte loads (a 64-code int8 vector
//      is four), dequantized as `code * scale` (the reference's product)
//      into shared memory; positions outside the live range stage as 0;
//   2. forms the G x 64 scores, each one ascending-d `fmaf` chain, times
//      dh**-0.5, NEG_INF = -1e30 (finite) where not live;
//   3. takes the chunk's (m, l, acc) as `_tile_update` takes a tile from
//      the initial state: m = max(NEG_INF, tile max), p = exp(s - m) or 0
//      where not live, l = sum p, acc = p . V, each output's chain split
//      over four fixed 16-position ranges summed (r0 + r1) + (r2 + r3);
//   4. writes (m, l, acc) to a workspace the wrapper allocates, and counts
//      itself in, on an arrival counter of its (row, kv head).
// The last block of a (row, kv head) to arrive combines the live chunks'
// states in ascending chunk order, in the same launch:
//   m* = max m_c,  w_c = exp(m_c - m*),  l = sum w_c l_c,  acc = sum w_c
//   acc_c (each an `fmaf` chain),  out = acc / max(l, 1e-30),
// its loads of the chunks' states issued together (a warp per query for
// m* and w; eight chunks' acc, w and l at a time), not one round trip a
// chunk; w_c is written over m_c in the workspace, so the block's shared
// memory does not depend on T and any cache length runs (8,192 chunks at
// T = 524,288 are one combining block's serial walk); and resets the
// counter to 0 for the next launch (the qmm split-K pattern: no atomic
// add of floats).  A (row, kv head) with no live
// position gets out = 0 from its chunk-0 block.  One launch per call; the
// kernel neither allocates nor synchronises the host, so a decode step can
// be captured in a CUDA graph.  `expf`, no fast math in the build.
//
// Two properties hold by construction, and chip_smoke.py checks them
// bitwise:
// * Row independence: a block reads only its own row's q, cache and
//   length, and the chunk set and combine order are functions of that
//   row's (len, window) alone, so a row's output depends on neither B nor
//   any other row.
// * Bucket padding is invisible: growing T to 2T with cache_len fixed
//   leaves the chunk boundaries (fixed multiples of kChunk) and the live
//   chunks where they were; the added chunks hold no live position and
//   exit, and inside a live chunk the positions past cache_len stage as 0
//   whatever the cache holds there.  The same blocks do the same
//   arithmetic in the same order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;           // positions per chunk: decode_attn.CHUNK
constexpr int kRange = kChunk / 4;   // p . V chain ranges
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q, const CodeT* __restrict__ kc,
                   const CodeT* __restrict__ vc,
                   const float* __restrict__ ks,
                   const float* __restrict__ vs,
                   const int* __restrict__ lens, float* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ counters,
                   int t_len, int kv, int g, int dh, int window, int vec,
                   float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [g][dh]          queries
  float* kt = qs + g * dh;           // [64][dh + 1]     dequantized K
  float* vt = kt + kChunk * (dh + 1);  // [64][dh]       dequantized V
  float* ps = vt + kChunk * dh;      // [g][64]          scores, then p
  __shared__ int last_block;

  const int chunk = blockIdx.x;
  const int rh = blockIdx.y;         // row * kv + kv head
  const int row = rh / kv;
  const int head = rh - row * kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gd = g * dh;
  const long long qoff = static_cast<long long>(rh) * gd;

  for (int i = tid; i < gd; i += kThreads) qs[i] = q[qoff + i];

  // the live positions [lo, hi) and the chunks that hold one
  const int len = lens[row];
  const int hi = min(len, t_len);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  if (hi <= lo) {                    // nothing to attend: out = 0
    if (chunk == 0)
      for (int i = tid; i < gd; i += kThreads) out[qoff + i] = 0.0f;
    return;
  }
  const int c_first = lo / kChunk;
  const int c_end = (hi + kChunk - 1) / kChunk;
  if (chunk < c_first || chunk >= c_end) return;
  const int t0 = chunk * kChunk;
  const int p_lo = max(lo - t0, 0);           // live range in the chunk
  const int p_hi = min(hi - t0, kChunk);

  // 1. stage the chunk, dequantized; positions outside [p_lo, p_hi) as 0
  const long long vec0 = (static_cast<long long>(row) * t_len + t0) * kv +
                         head;               // (row, t0, head) vector index
  if (vec) {                                 // dh * sizeof(CodeT) % 16 == 0
    constexpr int kPer = 16 / sizeof(CodeT);
    const int per_pos = dh / kPer;
    union Pack { int4 raw; CodeT c[kPer]; };
    for (int i = tid; i < kChunk * per_pos; i += kThreads) {
      const int tt = i / per_pos;
      const int d0 = (i - tt * per_pos) * kPer;
      const bool in = tt >= p_lo && tt < p_hi;
      Pack pk, pv;
      pk.raw = pv.raw = make_int4(0, 0, 0, 0);
      float sk = 0.0f, sv = 0.0f;
      if (in) {
        const long long v = vec0 + static_cast<long long>(tt) * kv;
        pk.raw = *reinterpret_cast<const int4*>(kc + v * dh + d0);
        pv.raw = *reinterpret_cast<const int4*>(vc + v * dh + d0);
        sk = ks[v];
        sv = vs[v];
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        kt[tt * (dh + 1) + d0 + e] =
            in ? static_cast<float>(pk.c[e]) * sk : 0.0f;
        vt[tt * dh + d0 + e] = in ? static_cast<float>(pv.c[e]) * sv : 0.0f;
      }
    }
  } else {
    for (int i = tid; i < kChunk * dh; i += kThreads) {
      const int tt = i / dh;
      const int d = i - tt * dh;
      const bool in = tt >= p_lo && tt < p_hi;
      const long long v = vec0 + static_cast<long long>(tt) * kv;
      kt[tt * (dh + 1) + d] =
          in ? static_cast<float>(kc[v * dh + d]) * ks[v] : 0.0f;
      vt[tt * dh + d] = in ? static_cast<float>(vc[v * dh + d]) * vs[v]
                           : 0.0f;
    }
  }
  __syncthreads();

  // 2. scores, two (query, position) chains a thread at a time; the +1 pad
  // of the K rows keeps a warp's 32 positions on 32 banks
  const int n_sc = g * kChunk;
  for (int i0 = tid; i0 < n_sc; i0 += 2 * kThreads) {
    const int i1 = min(i0 + kThreads, n_sc - 1);
    const int g0 = i0 / kChunk, tt0 = i0 - g0 * kChunk;
    const int g1 = i1 / kChunk, tt1 = i1 - g1 * kChunk;
    const float* q0 = qs + g0 * dh;
    const float* q1 = qs + g1 * dh;
    const float* k0 = kt + tt0 * (dh + 1);
    const float* k1 = kt + tt1 * (dh + 1);
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 8
    for (int d = 0; d < dh; ++d) {
      a0 = fmaf(q0[d], k0[d], a0);
      a1 = fmaf(q1[d], k1[d], a1);
    }
    ps[i0] = tt0 >= p_lo && tt0 < p_hi ? a0 * scale : kNegInf;
    if (i0 + kThreads < n_sc)
      ps[i1] = tt1 >= p_lo && tt1 < p_hi ? a1 * scale : kNegInf;
  }
  __syncthreads();

  // 3. the chunk's (m, l), one warp per query; to the workspace
  float* part = ws + (static_cast<long long>(rh) * gridDim.x + chunk) *
                         (gd + 2 * g);       // [g][dh] acc, [g] m, [g] l
  for (int gg = warp; gg < g; gg += kWarps) {
    float* p = ps + gg * kChunk;
    float mx = kNegInf;
    for (int tt = lane; tt < kChunk; tt += 32) mx = fmaxf(mx, p[tt]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int tt = lane; tt < kChunk; tt += 32) {
      const float e = tt >= p_lo && tt < p_hi ? expf(p[tt] - mx) : 0.0f;
      p[tt] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      part[gd + gg] = mx;
      part[gd + g + gg] = sum;
    }
  }
  __syncthreads();

  // acc = p . V: four 16-position chains an output, summed in fixed order
  for (int o = tid; o < gd; o += kThreads) {
    const int gg = o / dh;
    const int d = o - gg * dh;
    const float* p = ps + gg * kChunk;
    const float* v = vt + d;
    float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int u = 0; u < kRange; ++u) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        r[c] = fmaf(p[c * kRange + u], v[(c * kRange + u) * dh], r[c]);
    }
    part[o] = (r[0] + r[1]) + (r[2] + r[3]);
  }

  // 4. count in; the last block of the (row, kv head) combines
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_block = atomicAdd(&counters[rh], 1) == c_end - c_first - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int n_live = c_end - c_first;
  const long long stride = gd + 2 * g;
  float* base =
      ws + (static_cast<long long>(rh) * gridDim.x + c_first) * stride;
  // m* and the weights, one warp a query, the chunks' loads in parallel;
  // w_c = exp(m_c - m*) replaces m_c in the workspace (the block's only
  // storage that grows with T, so any cache length fits)
  for (int gg = warp; gg < g; gg += kWarps) {
    float m = kNegInf;
    for (int c = lane; c < n_live; c += 32)
      m = fmaxf(m, __ldcg(base + c * stride + gd + gg));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    for (int c = lane; c < n_live; c += 32) {
      float* mc = base + c * stride + gd + gg;
      __stcg(mc, expf(__ldcg(mc) - m));
    }
  }
  __syncthreads();
  // l and acc summed in ascending chunk order, the loads 8 chunks at a
  // time
  for (int o = tid; o < gd; o += kThreads) {
    const int gg = o / dh;
    const float* w = base + gd + gg;       // w_c at w[c * stride]
    const float* lc = base + gd + g + gg;  // l_c at lc[c * stride]
    float l = 0.0f, acc = 0.0f;
    for (int c0 = 0; c0 < n_live; c0 += 8) {
      float a[8], wc[8], lv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool in = c0 + u < n_live;
        const long long at = (c0 + u) * stride;
        a[u] = in ? __ldcg(base + at + o) : 0.0f;
        wc[u] = in ? __ldcg(w + at) : 0.0f;
        lv[u] = in ? __ldcg(lc + at) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (c0 + u < n_live) {
          l = fmaf(lv[u], wc[u], l);
          acc = fmaf(a[u], wc[u], acc);
        }
      }
    }
    out[qoff + o] = acc / fmaxf(l, 1e-30f);
  }
  if (tid == 0) counters[rh] = 0;     // ready for the next launch
}

template <typename CodeT>
int launch(const void* q, const void* kc, const void* vc, const void* ks,
           const void* vs, const void* lens, void* out, void* ws,
           void* counters, int smem, int b, int t, int kv, int g, int dh,
           int window, int vec, float scale, void* stream) {
  auto kernel = decode_attn_kernel<CodeT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((t + kChunk - 1) / kChunk, b * kv);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const CodeT*>(kc),
      static_cast<const CodeT*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lens),
      static_cast<float*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), t, kv, g, dh, window, vec, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, 1, kv * g, dh] f32, codes [b, t, kv, dh] int8, scales [b, t, kv]
// f32, lens [b] int32 -> out [b, 1, kv * g, dh] f32.  ws: f32 workspace of
// b * kv * ceil(t / 64) * g * (dh + 2); counters: b * kv zeroed int32, left
// zero.  vec: codes rows are 16-byte multiples at 16-byte-aligned
// addresses.  smem: dynamic shared bytes per block.
extern "C" int decode_attn_i8(const void* q, const void* kc, const void* vc,
                              const void* ks, const void* vs,
                              const void* lens, void* out, void* ws,
                              void* counters, int smem, int b, int t, int kv,
                              int g, int dh, int window, int vec,
                              float scale, void* stream) {
  return launch<int8_t>(q, kc, vc, ks, vs, lens, out, ws, counters, smem, b,
                        t, kv, g, dh, window, vec, scale, stream);
}

// the same with the raw f32 container (b_kv >= 16, unit scales)
extern "C" int decode_attn_f32(const void* q, const void* kc, const void* vc,
                               const void* ks, const void* vs,
                               const void* lens, void* out, void* ws,
                               void* counters, int smem, int b, int t,
                               int kv, int g, int dh, int window, int vec,
                               float scale, void* stream) {
  return launch<float>(q, kc, vc, ks, vs, lens, out, ws, counters, smem, b,
                       t, kv, g, dh, window, vec, scale, stream);
}
