// Fused group quantizer: absmax -> scale -> round -> clip, one pass.
//
// Replaces the TPU kernel `group_quantize` in src/repro/kernels/quantize.py
// (body `_group_quant_kernel`), reached through `ops.group_quantize` and
// `ops.quantize_linear`.  It runs when the serving engine materializes the
// agent's int8 / packed-int4 weights: every matrix of one configure (7 per
// agent layer) in one launch.
//
// For each (group of G contraction rows, column): scale = amax * fl(1/levels)
// (1.0 for an all-zero group), codes = clip(rint(w / scale), +-levels).
//
// What bounds it on an H100: bytes.  Each f32 weight is read once and one
// int8 code (half a byte when packed) written, with a handful of operations
// in between (abs, max, one divide, a rint, a clip), far below the card's
// ~20 operations per byte of float32 balance.  The whole configure of
// qwen2-0.5b (42 matrices, 89.5 M weights) is 0.134 ms of bytes at
// 3.35 TB/s.
//
// Two routes, chosen by the wrapper from the shape alone (quantize.route):
//
// * vector (group_quantize_vec_f32): N a multiple of 4, G a multiple of 16
//   and at most 256 (every main-path shape).  One launch covers a table of
//   matrices, each cut into [G, 128] tiles, one 256-thread block a tile:
//   lane l of warp w owns columns 4l..4l+3 and the G/8 consecutive rows
//   w*G/8.. of the tile.  Every thread issues all of its 16-byte loads
//   (G/8 of them, 16 at G = 128) before it uses any, so w is read from
//   DRAM exactly once and held in registers; a warp's load is one 512-byte
//   row.  Each thread reduces its rows, the eight warps' partial column
//   maxima meet in shared memory, and every thread then scales, rounds and
//   clips its own registers and stores 4 codes (char4) per row, or, for
//   bits <= 4 with packing asked for, one byte per row pair and column
//   (low nibble the even row, two's complement: pack_int4_ref's layout),
//   which a thread can form because its rows are consecutive.  The
//   matrices' table (pointers, K, N, G, levels, packed, first block) rides
//   in the kernel's parameter space (__grid_constant__, up to 64 matrices a
//   launch): each block finds its matrix by a binary search over the
//   first-block column in the constant cache, with no dependent DRAM read
//   before its loads.  One launch per configure replaces the 42 of the
//   first design, whose fixed costs alone were of the order of the bound.
// * SIMT (group_quantize_f32): any other shape (G = 1, N = 127, ...).  One
//   thread owns one (group, column); it walks its G rows twice (absmax,
//   then the codes, the second pass from L1/L2), coalesced across the warp
//   along N.  No alignment assumption.
//
// Numerics match the reference bitwise.  XLA compiles the reference's
// `amax / levels` (a division by a compile-time constant) into
// `amax * fl(1 / levels)`, so the scale is formed the same way here; a true
// division disagrees with the reference in 1 ulp of 4% (int8) to 59% (int4)
// of the scales, and then flips codes.  `1 / levels` and `w / scale` are
// IEEE divisions (this file is built without --use_fast_math, so nvcc keeps
// -prec-div=true), and rintf rounds half to even like jnp.round.  A max is
// exact in any order, so the tile's reduction order changes no bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// SIMT route
// ---------------------------------------------------------------------------

__global__ void group_quantize_kernel(const float* __restrict__ w,
                                      int8_t* __restrict__ codes,
                                      float* __restrict__ scales,
                                      int n_groups, int n, int group,
                                      int levels) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const float lv = static_cast<float>(levels);
  const float inv_lv = 1.0f / lv;  // IEEE division, see the note above
  // grid.y is capped at 65535, so a block strides over the groups
  for (int g = blockIdx.y; g < n_groups; g += gridDim.y) {
    const long long row0 = static_cast<long long>(g) * group;
    float amax = 0.0f;
    for (int r = 0; r < group; ++r) {
      amax = fmaxf(amax, fabsf(w[(row0 + r) * n + col]));
    }
    const float scale = amax > 0.0f ? amax * inv_lv : 1.0f;
    for (int r = 0; r < group; ++r) {
      const long long idx = (row0 + r) * n + col;
      float q = rintf(w[idx] / scale);
      q = fminf(fmaxf(q, -lv), lv);
      codes[idx] = static_cast<int8_t>(q);
    }
    scales[static_cast<long long>(g) * n + col] = scale;
  }
}

// ---------------------------------------------------------------------------
// vector route
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;                 // row slices of a tile
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;                // columns of a tile: 32 lanes x 4
constexpr int kMaxDescs = 64;             // matrices per launch (4 KB of
                                          // kernel parameters)

struct Desc {
  const float* w;        // [K, N] f32, row-major, 16-byte aligned
  int8_t* codes;         // [K, N] int8, or [K/2, N] packed
  float* scales;         // [K/G, N] f32, 16-byte aligned
  int k, n, group, levels, packed, first_block;
};

struct Table {
  Desc d[kMaxDescs];
  int count;
};

__device__ __forceinline__ float4 absmax4(float4 m, float4 v) {
  return make_float4(fmaxf(m.x, fabsf(v.x)), fmaxf(m.y, fabsf(v.y)),
                     fmaxf(m.z, fabsf(v.z)), fmaxf(m.w, fabsf(v.w)));
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

__device__ __forceinline__ int code(float x, float scale, float lv) {
  return static_cast<int>(fminf(fmaxf(rintf(x / scale), -lv), lv));
}

// R: register slots per thread for rows, a power of two >= G / 8.
template <int R>
__global__ void __launch_bounds__(kThreads, R >= 32 ? 1 : 2)
group_quantize_vec_kernel(const __grid_constant__ Table t) {
  // this block's matrix: the last one whose first block is <= blockIdx.x
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.d[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  const Desc& d = t.d[lo];
  const int n = d.n;
  const int col_tiles = (n + kCols - 1) / kCols;
  const int local = b - d.first_block;
  const int grp = local / col_tiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = (local % col_tiles) * kCols + lane * 4;
  const bool live = col < n;               // N % 4 == 0: all 4 columns
  const int rows = d.group / kWarps;       // even: G % 16 == 0
  const long long row0 =
      static_cast<long long>(grp) * d.group + static_cast<long long>(warp) * rows;

  // every load of the tile in flight before any is used
  float4 v[R];
  const float* src = d.w + row0 * n + col;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    v[i] = (i < rows && live)
               ? __ldcs(reinterpret_cast<const float4*>(src + static_cast<long long>(i) * n))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // column absmax: own rows in registers, then the eight row slices
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < R; ++i) m = absmax4(m, v[i]);
  __shared__ float4 part[kWarps][32];
  part[warp][lane] = m;
  __syncthreads();
  m = part[0][lane];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = max4(m, part[i][lane]);

  const float lv = static_cast<float>(d.levels);
  const float inv_lv = 1.0f / lv;          // IEEE division
  const float4 sc = make_float4(m.x > 0.f ? m.x * inv_lv : 1.f,
                                m.y > 0.f ? m.y * inv_lv : 1.f,
                                m.z > 0.f ? m.z * inv_lv : 1.f,
                                m.w > 0.f ? m.w * inv_lv : 1.f);
  if (!live) return;
  if (warp == 0) {
    *reinterpret_cast<float4*>(d.scales + static_cast<long long>(grp) * n + col) = sc;
  }
  if (!d.packed) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < rows) {
        char4 c;
        c.x = static_cast<signed char>(code(v[i].x, sc.x, lv));
        c.y = static_cast<signed char>(code(v[i].y, sc.y, lv));
        c.z = static_cast<signed char>(code(v[i].z, sc.z, lv));
        c.w = static_cast<signed char>(code(v[i].w, sc.w, lv));
        *reinterpret_cast<char4*>(d.codes + (row0 + i) * n + col) = c;
      }
    }
  } else {
    // byte (r/2, c) = code(r, c) & 0xF | (code(r + 1, c) & 0xF) << 4
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      if (2 * i < rows) {
        const float4 e = v[2 * i], o = v[2 * i + 1];
        char4 c;
        c.x = static_cast<signed char>((code(e.x, sc.x, lv) & 0xF) |
                                       ((code(o.x, sc.x, lv) & 0xF) << 4));
        c.y = static_cast<signed char>((code(e.y, sc.y, lv) & 0xF) |
                                       ((code(o.y, sc.y, lv) & 0xF) << 4));
        c.z = static_cast<signed char>((code(e.z, sc.z, lv) & 0xF) |
                                       ((code(o.z, sc.z, lv) & 0xF) << 4));
        c.w = static_cast<signed char>((code(e.w, sc.w, lv) & 0xF) |
                                       ((code(o.w, sc.w, lv) & 0xF) << 4));
        *reinterpret_cast<char4*>(d.codes + (row0 / 2 + i) * n + col) = c;
      }
    }
  }
}

template <int R>
cudaError_t launch_vec(const Table& t, int blocks, cudaStream_t stream) {
  group_quantize_vec_kernel<R><<<blocks, kThreads, 0, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

extern "C" int group_quantize_f32(const void* w, void* codes, void* scales,
                                  int k, int n, int group, int bits,
                                  void* stream) {
  const int levels = (1 << (bits - 1)) - 1;
  const int threads = 128;
  const int n_groups = k / group;
  dim3 grid((n + threads - 1) / threads, n_groups < 65535 ? n_groups : 65535);
  group_quantize_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<int8_t*>(codes),
      static_cast<float*>(scales), n_groups, n, group, levels);
  return static_cast<int>(cudaGetLastError());
}

// table: `count` host rows of 9 int64 (w, codes, scales, k, n, group,
// levels, packed, first_block), first blocks ascending from 0 (the wrapper's
// quantize.schedule); `rows`: the register slots R, a power of two in 2..32
// at least every matrix's G / 8.
extern "C" int group_quantize_vec_f32(const long long* table, int count,
                                      int blocks, int rows, void* stream) {
  if (count < 1 || count > kMaxDescs || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t;
  for (int i = 0; i < count; ++i) {
    const long long* r = table + 9 * i;
    t.d[i].w = reinterpret_cast<const float*>(r[0]);
    t.d[i].codes = reinterpret_cast<int8_t*>(r[1]);
    t.d[i].scales = reinterpret_cast<float*>(r[2]);
    t.d[i].k = static_cast<int>(r[3]);
    t.d[i].n = static_cast<int>(r[4]);
    t.d[i].group = static_cast<int>(r[5]);
    t.d[i].levels = static_cast<int>(r[6]);
    t.d[i].packed = static_cast<int>(r[7]);
    t.d[i].first_block = static_cast<int>(r[8]);
  }
  t.count = count;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 2: return static_cast<int>(launch_vec<2>(t, blocks, s));
    case 4: return static_cast<int>(launch_vec<4>(t, blocks, s));
    case 8: return static_cast<int>(launch_vec<8>(t, blocks, s));
    case 16: return static_cast<int>(launch_vec<16>(t, blocks, s));
    case 32: return static_cast<int>(launch_vec<32>(t, blocks, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
