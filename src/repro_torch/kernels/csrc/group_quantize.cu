// Fused group quantizer: absmax -> scale -> round -> clip, one pass.
//
// Replaces the TPU kernel `group_quantize` in src/repro/kernels/quantize.py
// (body `_group_quant_kernel`), reached through `ops.group_quantize` and
// `ops.quantize_linear`.  It runs once per weight matrix when the serving
// engine materializes the agent's int8 / packed-int4 weights.
//
// What bounds it on an H100: bytes.  Each f32 weight is read, and one int8
// code written, with a handful of operations in between (abs, max, one
// divide, a rint, a clip), far below the card's ~20 operations per byte of
// float32 balance.  The design therefore only has to stream w once at full
// width: one thread owns one (group, column) pair, neighbouring threads own
// neighbouring columns, so every row a warp reads is 32 consecutive floats
// (coalesced).  The thread walks its G rows twice: once for the absmax,
// once to write the codes; the second pass hits L1/L2 since the group was
// just read.  Any G that divides K and any N work, with no alignment
// assumption.
//
// Numerics match the reference bitwise.  XLA compiles the reference's
// `amax / levels` (a division by a compile-time constant) into
// `amax * fl(1 / levels)`, so the scale is formed the same way here; a true
// division disagrees with the reference in 1 ulp of 4% (int8) to 59% (int4)
// of the scales, and then flips codes.  `1 / levels` and `w / scale` are
// IEEE divisions (this file is built without --use_fast_math, so nvcc keeps
// -prec-div=true), and rintf rounds half to even like jnp.round.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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
