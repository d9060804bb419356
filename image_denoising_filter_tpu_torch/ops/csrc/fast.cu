// Hand-written Hopper (sm_90a) kernels of the turbo grids. The bilateral
// grid: the d x d mean pool, the grid build (per-level range weights,
// Gaussian blur, normalize, bf16 store), the grid slice (tent interpolation
// across the levels of the bilinearly upsampled grid), and the two fused per
// slice tile. The layer-guided grid: the guided build (weights from a layer,
// payload from the target, unnormalized; one kernel body with the bilateral
// build), the guided slice, and the two fused per slice tile.
//
// Layouts: images (H, W, 4) float32, one pixel one float4; the pooled image
// (hs, ws, 4) float32, hs = ceil(H/d), ws = ceil(W/d); the bilateral grid
// (K, hs, ws, 4) bfloat16, so that one cell of one level is one 8-byte load,
// channels r, g, b, a. Alpha is payload under green's range weights; under
// uniform alpha its slot holds zero and the slice writes the constant. The
// guided grid (K, hs, ws, 8) bfloat16, one cell one 16-byte load: num r, g,
// b, a, den r, g, b and a zero pad. Borders are handled by clamping the cell
// index (CLAMP) or by substituting a zero pixel (ZERO): nothing is padded on
// the host.
//
// Every launcher takes raw device pointers, sizes, parameters and a stream,
// launches on that stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() as an int. The blur taps come from Python and
// travel by value in the kernel's parameter space. The grid range (lmin and
// step, per RGB channel) stays on the device: the kernels read it there, so
// no host round trip sits between the pool and the build.
//
// Rounding: the products and sums whose order the plain PyTorch versions
// (ops/fast.py) fix are written with __fmul_rn/__fadd_rn, so the compiler
// does not contract them into FMAs and each kernel computes the same
// roundings as its plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

// Device queries, defined in stencils.cu.
namespace idf {
cudaError_t max_shared_bytes(int* bytes);
cudaError_t kernel_info(const void* kernel, int threads, int shared_bytes, int* info);
}  // namespace idf

namespace {

constexpr int kBlockX = 32;  // a warp spans 32 neighbouring cells of a row
constexpr int kBlockY = 8;
constexpr int kMaxTaps = 64;

struct Taps {
  int n;  // 2r + 1
  float t[kMaxTaps];
};

struct __align__(8) Bf16x4 {
  __nv_bfloat162 lo;  // channels r, g
  __nv_bfloat162 hi;  // channels b, a
};

// One cell of the guided grid: num r, g, b, a; den r, g, b; pad.
constexpr int kGuided = 7;
struct __align__(16) Bf16x8 {
  __nv_bfloat162 v[4];
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 load_cell(const Bf16x4* level, int y, int x, int ws) {
  const Bf16x4 v = level[static_cast<size_t>(y) * ws + x];
  const float2 lo = __bfloat1622float2(v.lo);
  const float2 hi = __bfloat1622float2(v.hi);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// a * (1 - w) + b * w, in that order, per channel.
__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float w) {
  const float u = 1.f - w;
  return make_float4(__fadd_rn(__fmul_rn(a.x, u), __fmul_rn(b.x, w)),
                     __fadd_rn(__fmul_rn(a.y, u), __fmul_rn(b.y, w)),
                     __fadd_rn(__fmul_rn(a.z, u), __fmul_rn(b.z, w)),
                     __fadd_rn(__fmul_rn(a.w, u), __fmul_rn(b.w, w)));
}

// max(a, b) and min(a, b) that return NaN where either operand is NaN
// (max.NaN / min.NaN, sm_80 and later); fmaxf and fminf return the other
// operand. On other operands the same value as fmaxf and fminf, in one
// instruction.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A slice's t_c = clip((v - lmin) * inv_step, 0, K-1) and its tent weight at
// level k, max(1 - |t - k|, 0), both NaN where the level coordinate is NaN
// (a NaN guide value, or a range that is not finite), as the plain
// versions' clamp (and jnp.clip) keeps it: every level's tent is then NaN,
// no level is skipped, and the channel's sums are NaN.
__device__ __forceinline__ float level_t(float v, float lmin, float inv_step, float kmax) {
  return min_nan(max_nan(__fmul_rn(v - lmin, inv_step), 0.f), kmax);
}

__device__ __forceinline__ float tent(float t, float k) {
  return max_nan(1.f - fabsf(t - k), 0.f);
}

// d x d mean pool with the TPU kernel's roundings.
//
// Replaces image_denoising_filter_tpu/ops/fast.py:_pool_pallas. The input is
// read as if padded to multiples of d (edge pixels under CLAMP, zeros under
// ZERO). Each pixel is cast to bf16; the mean over the d rows of a column is
// cast to bf16 again; the mean over the d columns stays float32. The 1/d
// weights are powers of two, so every product is exact, as in the TPU's
// banded bf16 matmuls.
//
// Bound on the H100: device memory. A 4K frame is read once (133 MB) and a
// 1/d^2 image written, with ~3 FP32 operations per input value. Design: one
// thread per pooled cell in 32x8 blocks; for each of its d input rows a
// warp reads 32*d consecutive float4, one contiguous run.
template <bool ZERO>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    pool_kernel(const float4* __restrict__ img, float4* __restrict__ out, int h, int w,
                int hs, int ws, int d, float inv_d) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= ws || y >= hs) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < d; ++j) {
    const int xx = x * d + j;
    float4 col = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < d; ++i) {
      const int yy = y * d + i;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!ZERO || (yy < h && xx < w))
        v = __ldg(img + static_cast<size_t>(min(yy, h - 1)) * w + min(xx, w - 1));
      col.x = __fadd_rn(col.x, __fmul_rn(bf16_round(v.x), inv_d));
      col.y = __fadd_rn(col.y, __fmul_rn(bf16_round(v.y), inv_d));
      col.z = __fadd_rn(col.z, __fmul_rn(bf16_round(v.z), inv_d));
      col.w = __fadd_rn(col.w, __fmul_rn(bf16_round(v.w), inv_d));
    }
    acc.x = __fadd_rn(acc.x, __fmul_rn(bf16_round(col.x), inv_d));
    acc.y = __fadd_rn(acc.y, __fmul_rn(bf16_round(col.y), inv_d));
    acc.z = __fadd_rn(acc.z, __fmul_rn(bf16_round(col.z), inv_d));
    acc.w = __fadd_rn(acc.w, __fmul_rn(bf16_round(col.w), inv_d));
  }
  out[static_cast<size_t>(y) * ws + x] = acc;
}

// Grid slice: for each full-resolution pixel and RGB channel c,
//   t_c = clip((guide_c - lmin_c) * inv_step_c, 0, K-1),
//   out_c = sum_k max(1 - |t_c - k|, 0) * up(g_{k,c}),
// where up is the bilinear upsample with half-pixel centres,
// gy = (y + 0.5)/d - 0.5, over the edge-replicated grid (the cell index is
// clamped). Alpha uses green's t and the alpha slot; under uniform alpha
// it is the constant *alpha.
//
// Replaces image_denoising_filter_tpu/ops/fast.py:_slice_grid_pallas. A
// pixel's tent is nonzero at levels floor(t) and floor(t)+1 only, so the
// TPU's per-tile level culling has no counterpart: a level whose tents are
// zero for all three channels is skipped per pixel, which adds exactly the
// zeros it would have added. The TPU telescopes the sum over bf16-rounded
// level deltas; this sums the stored levels themselves, and the two differ
// by exactly that delta rounding (tests/test_torch_fast.py).
//
// Bound on the H100: device memory, 16 B read and 16 B written per pixel
// plus the grid (83 MB at 4K, d=2, K=5), read about once; at most two levels
// of four 8-byte cells per pixel, served by L1. Design: one thread per pixel
// in 32x8 blocks; the bilinear taps are computed in closed form, so no
// matrix and no padded grid exist.
//
// Slab form, for the sharded turbo (image_denoising_filter_tpu/parallel/
// spatial.py:280-311): the guide is a band of rows whose first row is the
// image's row y_cell_off * d, and the grid holds hs of the image's hs_all
// grid rows, from grid row gy_off. The cell row is the image's,
// floor(gy) + y_cell_off clamped to [0, hs_all - 1], taken relative to the
// slab; gy and its weight stay the band's, which is exact because the band
// starts on a multiple of d. y_cell_off = gy_off = 0 with hs_all = hs is the
// whole-image slice.
template <bool UNIFORM_ALPHA>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    slice_grid_kernel(const float4* __restrict__ guide, const Bf16x4* __restrict__ grid,
                      const float* __restrict__ lmin, const float* __restrict__ inv_step,
                      const float* __restrict__ alpha, float4* __restrict__ out, int h,
                      int w, int hs, int ws, int levels, float inv_d, int y_cell_off,
                      int hs_all, int gy_off) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t idx = static_cast<size_t>(y) * w + x;
  const float4 g = guide[idx];
  const float kmax = static_cast<float>(levels - 1);
  const float t0 = level_t(g.x, lmin[0], inv_step[0], kmax);
  const float t1 = level_t(g.y, lmin[1], inv_step[1], kmax);
  const float t2 = level_t(g.z, lmin[2], inv_step[2], kmax);
  // (y + 0.5)/d - 0.5 is exact in float32 for d a power of two.
  const float gy = __fmul_rn(static_cast<float>(y) + 0.5f, inv_d) - 0.5f;
  const float gx = __fmul_rn(static_cast<float>(x) + 0.5f, inv_d) - 0.5f;
  const float fy = floorf(gy);
  const float fx = floorf(gx);
  const float wy = gy - fy;
  const float wx = gx - fx;
  const int cy = static_cast<int>(fy) + y_cell_off;
  const int y0 = min(max(cy, 0), hs_all - 1) - gy_off;
  const int y1 = min(max(cy + 1, 0), hs_all - 1) - gy_off;
  const int x0 = min(max(static_cast<int>(fx), 0), ws - 1);
  const int x1 = min(max(static_cast<int>(fx) + 1, 0), ws - 1);
  const size_t plane = static_cast<size_t>(hs) * ws;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < levels; ++k) {
    const float kf = static_cast<float>(k);
    const float e0 = tent(t0, kf);
    const float e1 = tent(t1, kf);
    const float e2 = tent(t2, kf);
    if (e0 == 0.f && e1 == 0.f && e2 == 0.f) continue;
    const Bf16x4* level = grid + static_cast<size_t>(k) * plane;
    const float4 row0 = lerp4(load_cell(level, y0, x0, ws), load_cell(level, y0, x1, ws), wx);
    const float4 row1 = lerp4(load_cell(level, y1, x0, ws), load_cell(level, y1, x1, ws), wx);
    const float4 up = lerp4(row0, row1, wy);
    acc.x = __fadd_rn(acc.x, __fmul_rn(e0, up.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(e1, up.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(e2, up.z));
    if (!UNIFORM_ALPHA) acc.w = __fadd_rn(acc.w, __fmul_rn(e1, up.w));
  }
  if (UNIFORM_ALPHA) acc.w = *alpha;
  out[idx] = acc;
}

// ---------------------------------------------------------------------------
// The layer-guided grid
// ---------------------------------------------------------------------------

__device__ __forceinline__ Bf16x8 pack_guided(const float (&s)[kGuided]) {
  Bf16x8 c;
  c.v[0] = __floats2bfloat162_rn(s[0], s[1]);
  c.v[1] = __floats2bfloat162_rn(s[2], s[3]);
  c.v[2] = __floats2bfloat162_rn(s[4], s[5]);
  c.v[3] = __floats2bfloat162_rn(s[6], 0.f);
  return c;
}

__device__ __forceinline__ void unpack_guided(const Bf16x8& c, float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(c.v[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The bilinear sample of one level of the guided grid, rows y0 and y1,
// columns x0 and x1 of a cell array with row stride `stride`, in the slice's
// lerp order (along W, then along H).
__device__ __forceinline__ void sample_guided(const Bf16x8* cells, int stride, int y0, int y1,
                                              int x0, int x1, float wx, float wy,
                                              float (&up)[8]) {
  float a[8], b[8], c[8], d[8];
  unpack_guided(cells[y0 * stride + x0], a);
  unpack_guided(cells[y0 * stride + x1], b);
  unpack_guided(cells[y1 * stride + x0], c);
  unpack_guided(cells[y1 * stride + x1], d);
  const float ux = 1.f - wx;
  const float uy = 1.f - wy;
#pragma unroll
  for (int i = 0; i < kGuided; ++i) {
    const float row0 = __fadd_rn(__fmul_rn(a[i], ux), __fmul_rn(b[i], wx));
    const float row1 = __fadd_rn(__fmul_rn(c[i], ux), __fmul_rn(d[i], wx));
    up[i] = __fadd_rn(__fmul_rn(row0, uy), __fmul_rn(row1, wy));
  }
}

// acc += tent * up for the seven partials; the r, g, b tents e0, e1, e2,
// alpha's numerator under green's.
__device__ __forceinline__ void add_guided_level(float (&acc)[kGuided], const float (&up)[8],
                                                 float e0, float e1, float e2) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(e0, up[0]));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(e1, up[1]));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(e2, up[2]));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(e1, up[3]));
  acc[4] = __fadd_rn(acc[4], __fmul_rn(e0, up[4]));
  acc[5] = __fadd_rn(acc[5], __fmul_rn(e1, up[5]));
  acc[6] = __fadd_rn(acc[6], __fmul_rn(e2, up[6]));
}

// t for the fused kernels' level window: clip with fminf/fmaxf, a NaN taken
// as 0, which only widens the window (a tile whose every t is NaN still
// slices a level, into NaN sums).
__device__ __forceinline__ float clip_t(float v, float lmin, float inv_step, float kmax) {
  return fminf(fmaxf(__fmul_rn(v - lmin, inv_step), 0.f), kmax);
}

// Guided grid slice: for each full-resolution pixel, t_c = clip((l_c -
// lmin_c) * inv_step_c, 0, K-1) from the full-resolution layer, and the
// seven partials sum_k max(1 - |t - k|, 0) * up(g_k) over the bilinearly
// upsampled, edge-replicated grid (alpha's numerator under green's t).
// Writes wc (H, W, 4) and nw (H, W, 3) float32.
//
// Replaces image_denoising_filter_tpu/ops/fast.py:_slice_guided_grid_pallas.
// As slice_grid_kernel: the two levels a pixel touches are summed directly
// (the TPU telescopes over bf16-rounded level deltas and culls per tile).
//
// Bound on the H100: device memory. 16 B of layer read and 28 B of partials
// written per pixel, and the grid (166 MB at 4K, d=2, K=5) read about once;
// at most two levels of four 16-byte cells per pixel, served by L1. Design:
// one thread per pixel in 32x8 blocks, closed-form bilinear taps. The slab
// form (y_cell_off, hs_all, gy_off) is slice_grid_kernel's.
__global__ void __launch_bounds__(kBlockX* kBlockY)
    slice_guided_grid_kernel(const float4* __restrict__ guide, const Bf16x8* __restrict__ grid,
                             const float* __restrict__ lmin, const float* __restrict__ inv_step,
                             float4* __restrict__ out_wc, float* __restrict__ out_nw, int h,
                             int w, int hs, int ws, int levels, float inv_d, int y_cell_off,
                             int hs_all, int gy_off) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t idx = static_cast<size_t>(y) * w + x;
  const float4 g = guide[idx];
  const float kmax = static_cast<float>(levels - 1);
  const float t0 = level_t(g.x, lmin[0], inv_step[0], kmax);
  const float t1 = level_t(g.y, lmin[1], inv_step[1], kmax);
  const float t2 = level_t(g.z, lmin[2], inv_step[2], kmax);
  const float gy = __fmul_rn(static_cast<float>(y) + 0.5f, inv_d) - 0.5f;
  const float gx = __fmul_rn(static_cast<float>(x) + 0.5f, inv_d) - 0.5f;
  const float fy = floorf(gy);
  const float fx = floorf(gx);
  const int cy = static_cast<int>(fy) + y_cell_off;
  const int y0 = min(max(cy, 0), hs_all - 1) - gy_off;
  const int y1 = min(max(cy + 1, 0), hs_all - 1) - gy_off;
  const int x0 = min(max(static_cast<int>(fx), 0), ws - 1);
  const int x1 = min(max(static_cast<int>(fx) + 1, 0), ws - 1);
  const size_t plane = static_cast<size_t>(hs) * ws;
  float acc[kGuided] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < levels; ++k) {
    const float kf = static_cast<float>(k);
    const float e0 = tent(t0, kf);
    const float e1 = tent(t1, kf);
    const float e2 = tent(t2, kf);
    if (e0 == 0.f && e1 == 0.f && e2 == 0.f) continue;
    float up[8];
    sample_guided(grid + k * plane, ws, y0, y1, x0, x1, gx - fx, gy - fy, up);
    add_guided_level(acc, up, e0, e1, e2);
  }
  out_wc[idx] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  out_nw[3 * idx] = acc[4];
  out_nw[3 * idx + 1] = acc[5];
  out_nw[3 * idx + 2] = acc[6];
}

// ---------------------------------------------------------------------------
// The bilateral grid's slice at d = 1
// ---------------------------------------------------------------------------

// One RGB channel's levels at d = 1: its tent is nonzero at floor(t) and
// floor(t) + 1 only (t in [0, K-1]). lo = floor(t), its tent 1 - frac(t) > 0;
// hi = lo + 1 clamped to K - 1, its tent zero where t is whole or lo is the
// last level. Both tents are the d >= 2 kernels' expression. A NaN t
// converts to level 0 and its tents are NaN.
struct Levels {
  int lo, hi;
  float e_lo, e_hi;
};

__device__ __forceinline__ Levels channel_levels(float t, int levels) {
  Levels v;
  v.lo = static_cast<int>(t);  // t >= 0: truncation is floor
  v.hi = min(v.lo + 1, levels - 1);
  v.e_lo = tent(t, static_cast<float>(v.lo));
  v.e_hi = v.lo + 1 < levels ? tent(t, static_cast<float>(v.lo + 1)) : 0.f;
  return v;
}

// One channel's slice from its own cell's values at its two levels, summed
// from +0 in level order; a zero tent adds nothing (a finite cell gives +-0,
// and the sum never holds -0).
__device__ __forceinline__ float sum_levels(const Levels& v, float at_lo, float at_hi) {
  float acc = __fadd_rn(0.f, __fmul_rn(v.e_lo, at_lo));
  if (v.e_hi != 0.f) acc = __fadd_rn(acc, __fmul_rn(v.e_hi, at_hi));
  return acc;
}

// Grid slice at d = 1: slice_grid_kernel's output where gy = y and gx = x,
// so the bilinear taps fall on the pixel's own cell with weights wy = wx = 0.
//
// Replaces image_denoising_filter_tpu/ops/fast.py:_slice_grid_pallas (502)
// as image_denoising_filter_tpu/parallel/spatial.py:spatial_bilateral_fast
// runs it at d = 1 (the sharded --turbo 1). Each channel's sum is its own
// cell at its two levels (channel_levels), in ascending order from +0. On a
// finite grid, which a finite frame always gives (build_grid clamps the
// normaliser to at least 1e-20), that is slice_grid_kernel's (and
// slice_grid_plain's) sum bit for bit: there a corner enters as b * 0 = +-0
// and the own cell as a * 1 = a, and the levels where the channel's tent is
// zero add +-0 to a sum that is never -0. On a non-finite grid the two
// differ where this kernel does not read a cell the others weigh by zero
// (0 * inf = NaN): a cell beside the pixel's own, or its own cell at a level
// that only another channel's tent touches (slice_grid_plain sums every
// level, so any level's).
//
// Bound on the H100: device memory, 48 B a pixel: the guide read (16 B),
// the output written (16 B) and the own cell at 2 of the K levels (16 B);
// the grid (K x 8 B a pixel, 99.5 MB at 1080p, K = 6) does not fit the 50 MB
// L2. slice_grid_kernel walks the levels one after another, each level's
// loads waiting on the last, so a thread has one level's bytes in flight.
// Design: a thread takes one pixel, reads its guide, then issues all six
// cell loads (the lo and hi cell of each RGB channel; repeats served by L1)
// before it uses the first. Alpha rides green's levels; under uniform alpha
// it is the constant *alpha. The slab form is slice_grid_kernel's: the cell
// row is clamp(y + y_off, 0, hs_all - 1) - gy_off, the column x.
template <bool UNIFORM_ALPHA>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    slice_grid_d1_kernel(const float4* __restrict__ guide, const Bf16x4* __restrict__ grid,
                         const float* __restrict__ lmin, const float* __restrict__ inv_step,
                         const float* __restrict__ alpha, float4* __restrict__ out, int h,
                         int w, int hs, int levels, int y_off, int hs_all, int gy_off) {
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  if (y >= h || x >= w) return;
  const float kmax = static_cast<float>(levels - 1);
  const size_t idx = static_cast<size_t>(y) * w + x;
  const size_t plane = static_cast<size_t>(hs) * w;
  const Bf16x4* own =
      grid + static_cast<size_t>(min(max(y + y_off, 0), hs_all - 1) - gy_off) * w + x;
  const float4 g = guide[idx];
  const Levels r = channel_levels(level_t(g.x, lmin[0], inv_step[0], kmax), levels);
  const Levels gr = channel_levels(level_t(g.y, lmin[1], inv_step[1], kmax), levels);
  const Levels b = channel_levels(level_t(g.z, lmin[2], inv_step[2], kmax), levels);
  const Bf16x4 r_lo = own[r.lo * plane], r_hi = own[r.hi * plane];
  const Bf16x4 g_lo = own[gr.lo * plane], g_hi = own[gr.hi * plane];
  const Bf16x4 b_lo = own[b.lo * plane], b_hi = own[b.hi * plane];
  float4 acc;  // r: lo.x, g: lo.y, b: hi.x, a: hi.y
  acc.x = sum_levels(r, __low2float(r_lo.lo), __low2float(r_hi.lo));
  acc.y = sum_levels(gr, __high2float(g_lo.lo), __high2float(g_hi.lo));
  acc.z = sum_levels(b, __low2float(b_lo.hi), __low2float(b_hi.hi));
  acc.w = UNIFORM_ALPHA ? *alpha : sum_levels(gr, __high2float(g_lo.hi), __high2float(g_hi.hi));
  out[idx] = acc;
}

// The blocks below are defined in ops/fast.py and passed to nvcc as macros
// by ops/_build.py. Room kept beside a fused kernel's dynamic shared memory
// for its static arrays.
constexpr size_t kStaticSharedReserve = IDF_STATIC_SHARED_RESERVE;
// The grid build: kBuildThreads threads, and a vertical-pass thread sums
// kBuildStrip cell rows.
constexpr int kBuildThreads = IDF_BUILD_THREADS;
constexpr int kBuildStrip = IDF_BUILD_STRIP;
// The fused kernels: kFusedThreads threads, and a vertical-pass thread sums
// kFusedStrip cell rows. The guided kernel: at most kGuidedPixels pixels a
// thread, the cells of kGuidedLevels levels built before a slice, compiled
// for kGuidedMinBlocks blocks a multiprocessor; the bilateral kernel:
// kGridLevels levels, kGridMinBlocks blocks.
constexpr int kFusedThreads = IDF_FUSED_THREADS;
constexpr int kFusedStrip = IDF_FUSED_STRIP;
constexpr int kGuidedPixels = IDF_FUSED_GUIDED_PIXELS;
constexpr int kGuidedLevels = IDF_FUSED_GUIDED_LEVELS;
constexpr int kGuidedMinBlocks = IDF_FUSED_GUIDED_MIN_BLOCKS;
constexpr int kGridLevels = IDF_FUSED_GRID_LEVELS;
constexpr int kGridMinBlocks = IDF_FUSED_GRID_MIN_BLOCKS;
// The staging loops and the range-weight planes stride by kFusedThreads.
static_assert(kBuildThreads == kFusedThreads, "the build and the fused kernels stage alike");

// The cell window of a slice tile of ph x pw pixels from (py0, px0): the
// cells its pixels' bilinear taps read, clamped to the grid, as (first row,
// first column, rows, columns).
__device__ __forceinline__ int4 tile_window(int py0, int px0, int ph, int pw, int h, int w,
                                            int hs, int ws, float inv_d) {
  const int py_last = min(py0 + ph, h) - 1;
  const int px_last = min(px0 + pw, w) - 1;
  const int ay0 = min(max(static_cast<int>(floorf(
                              __fmul_rn(static_cast<float>(py0) + 0.5f, inv_d) - 0.5f)), 0), hs - 1);
  const int ay1 = min(max(static_cast<int>(floorf(
                              __fmul_rn(static_cast<float>(py_last) + 0.5f, inv_d) - 0.5f)) + 1, 0), hs - 1);
  const int ax0 = min(max(static_cast<int>(floorf(
                              __fmul_rn(static_cast<float>(px0) + 0.5f, inv_d) - 0.5f)), 0), ws - 1);
  const int ax1 = min(max(static_cast<int>(floorf(
                              __fmul_rn(static_cast<float>(px_last) + 0.5f, inv_d) - 0.5f)) + 1, 0), ws - 1);
  return make_int4(ay0, ax0, ay1 - ay0 + 1, ax1 - ax0 + 1);
}

// Stage a pooled image's window of srows x scols cells from (y0, x0) into
// shared memory with the build kernels' border rule: edge cells (CLAMP) or
// zero pixels (ZERO).
template <bool ZERO>
__device__ __forceinline__ void stage_window(const float4* __restrict__ small, float4* dst,
                                             int y0, int x0, int srows, int scols, int hs,
                                             int ws) {
  for (int i = threadIdx.x; i < srows * scols; i += kFusedThreads) {
    const int yy = y0 + i / scols;
    const int xx = x0 + i % scols;
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!ZERO || (yy >= 0 && yy < hs && xx >= 0 && xx < ws))
      p = __ldg(small + static_cast<size_t>(min(max(yy, 0), hs - 1)) * ws + min(max(xx, 0), ws - 1));
    dst[i] = p;
  }
}

// The block's level range from each thread's (tmin_c, tmax_c): the levels
// [floor(tmin_c), ceil(tmax_c)] that the block's pixels touch over the three
// RGB channels, as (first, last). Synchronises the block.
__device__ __forceinline__ int2 reduce_levels(float (&tmin)[3], float (&tmax)[3], float kmax) {
  __shared__ float red[kFusedThreads / 32][6];
  __shared__ int level_range[2];
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    for (int off = 16; off > 0; off >>= 1) {
      tmin[c] = fminf(tmin[c], __shfl_xor_sync(0xffffffffu, tmin[c], off));
      tmax[c] = fmaxf(tmax[c], __shfl_xor_sync(0xffffffffu, tmax[c], off));
    }
  }
  if (tid % 32 == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      red[tid / 32][c] = tmin[c];
      red[tid / 32][3 + c] = tmax[c];
    }
  }
  __syncthreads();
  if (tid == 0) {
    float lo = kmax, hi = 0.f;
    for (int wp = 0; wp < kFusedThreads / 32; ++wp) {
      for (int c = 0; c < 3; ++c) {
        lo = fminf(lo, red[wp][c]);
        hi = fmaxf(hi, red[wp][3 + c]);
      }
    }
    level_range[0] = static_cast<int>(floorf(lo));
    level_range[1] = static_cast<int>(ceilf(hi));
  }
  __syncthreads();
  return make_int2(level_range[0], level_range[1]);
}

// The block's level range (reduce_levels) and each thread's pixels' t per
// RGB channel, t_c = clip((guide_c - lmin_c) * inv_step_c, 0, K - 1). The
// thread's pixel i is (py0 + row_step i, px), i < P, unrolled; one at or
// below row py_end or outside the image gets t = -2, which no tent reaches.
template <int P>
__device__ __forceinline__ int2 tile_levels(const float4* __restrict__ guide, int w, int px,
                                            int py0, int row_step, int py_end,
                                            const float* __restrict__ lmin,
                                            const float* __restrict__ inv_step, int levels,
                                            float (&t)[P][3]) {
  const float kmax = static_cast<float>(levels - 1);
  const float lmin0 = lmin[0], lmin1 = lmin[1], lmin2 = lmin[2];
  const float is0 = inv_step[0], is1 = inv_step[1], is2 = inv_step[2];
  float tmin[3] = {kmax, kmax, kmax}, tmax[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int py = py0 + row_step * i;
    if (px < w && py < py_end) {
      const float4 g = guide[static_cast<size_t>(py) * w + px];
      t[i][0] = clip_t(g.x, lmin0, is0, kmax);
      t[i][1] = clip_t(g.y, lmin1, is1, kmax);
      t[i][2] = clip_t(g.z, lmin2, is2, kmax);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tmin[c] = fminf(tmin[c], t[i][c]);
        tmax[c] = fmaxf(tmax[c], t[i][c]);
      }
    } else {
      t[i][0] = t[i][1] = t[i][2] = -2.f;  // no tent reaches a level
    }
  }
  return reduce_levels(tmin, tmax, kmax);
}

// The block's level range (reduce_levels) where a thread's pixels, (py, px)
// for py = py0, py0 + row_step, ... below py_end (none where px is outside
// the image), are too many to unroll.
__device__ __forceinline__ int2 block_levels(const float4* __restrict__ guide, int w, int px,
                                             int py0, int row_step, int py_end, float3 lmin,
                                             float3 inv_step, int levels) {
  const float kmax = static_cast<float>(levels - 1);
  float tmin[3] = {kmax, kmax, kmax}, tmax[3] = {0.f, 0.f, 0.f};
  if (px < w) {
#pragma unroll 4
    for (int py = py0; py < py_end; py += row_step) {
      const float4 g = guide[static_cast<size_t>(py) * w + px];
      const float t[3] = {clip_t(g.x, lmin.x, inv_step.x, kmax),
                          clip_t(g.y, lmin.y, inv_step.y, kmax),
                          clip_t(g.z, lmin.z, inv_step.z, kmax)};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tmin[c] = fminf(tmin[c], t[c]);
        tmax[c] = fmaxf(tmax[c], t[c]);
      }
    }
  }
  return reduce_levels(tmin, tmax, kmax);
}

// The horizontal blur pass of one cell (cy, cx): the weighted sum of the
// vertical sums of its 2r + 1 columns, the build kernels' outer loop.
__device__ __forceinline__ void fused_horizontal_sums(const float* vsum, int cy, int cx,
                                                      int vstride, int vplane,
                                                      const Taps& taps,
                                                      float (&sum)[kGuided]) {
#pragma unroll
  for (int j = 0; j < kGuided; ++j) sum[j] = 0.f;
  for (int b = 0; b < taps.n; ++b) {
    const float tb = taps.t[b];
#pragma unroll
    for (int j = 0; j < kGuided; ++j)
      sum[j] = __fadd_rn(sum[j], __fmul_rn(tb, vsum[j * vplane + cy * vstride + cx + b]));
  }
}

// The range weight exp2(-(l - lv)^2 * coef) of one channel value l at the
// level centre lv, computed once a staged pixel and level.
__device__ __forceinline__ float range_weight(float l, float lv, float coef) {
  const float d = l - lv;
  return exp2f(__fmul_rn(-__fmul_rn(d, d), coef));
}

// The range weights of one layer pixel at one level, per RGB channel.
__device__ __forceinline__ float3 guided_range_weights(float4 l, float3 lv, float coef) {
  return make_float3(range_weight(l.x, lv.x, coef), range_weight(l.y, lv.y, coef),
                     range_weight(l.z, lv.z, coef));
}

// The seven fields of one tap of a grid build, under the range weights
// (w0, w1, w2) of the layer pixel, with payload p: num r, g, b, a (alpha
// under green's weight), den r, g, b. Each field is added to its sum as
// tap * field, in the plain versions' order (fields first, then the tap
// product).
__device__ __forceinline__ void add_guided_fields(float (&s)[kGuided], float tap, float4 p,
                                                  float w0, float w1, float w2) {
  s[0] = __fadd_rn(s[0], __fmul_rn(tap, __fmul_rn(w0, p.x)));
  s[1] = __fadd_rn(s[1], __fmul_rn(tap, __fmul_rn(w1, p.y)));
  s[2] = __fadd_rn(s[2], __fmul_rn(tap, __fmul_rn(w2, p.z)));
  s[3] = __fadd_rn(s[3], __fmul_rn(tap, __fmul_rn(w1, p.w)));
  s[4] = __fadd_rn(s[4], __fmul_rn(tap, w0));
  s[5] = __fadd_rn(s[5], __fmul_rn(tap, w1));
  s[6] = __fadd_rn(s[6], __fmul_rn(tap, w2));
}

// The level centres lv_c = lmin_c + step_c * k.
__device__ __forceinline__ float3 level_centres(float3 lmin, float3 step, int k) {
  const float kf = static_cast<float>(k);
  return make_float3(__fadd_rn(lmin.x, __fmul_rn(step.x, kf)),
                     __fadd_rn(lmin.y, __fmul_rn(step.y, kf)),
                     __fadd_rn(lmin.z, __fmul_rn(step.z, kf)));
}

// The range weights of the n_st staged layer pixels st_l at one level, once
// each, into three planes: wgt[c * n_st + i].
__device__ __forceinline__ void range_weight_planes(const float4* st_l, float* wgt, int n_st,
                                                    float3 lv, float coef) {
  for (int i = threadIdx.x; i < n_st; i += kFusedThreads) {
    const float3 wv = guided_range_weights(st_l[i], lv, coef);
    wgt[i] = wv.x;
    wgt[n_st + i] = wv.y;
    wgt[2 * n_st + i] = wv.z;
  }
}

// The vertical blur pass of one level over a staged window of srows x scols
// pixels (payload st_p, range weights in the planes wgt): per cell row cy <
// rows and staged column sx < vcols, the seven fields (add_guided_fields)
// summed over the column's taps in order. A thread sums STRIP consecutive
// cell rows cy0 .. cy0 + STRIP - 1 of one column from its 2r + STRIP staged
// pixels: staged row cy0 + a is tap a - j of cell row cy0 + j. Writes
// vsum[j * vplane + cy * scols + sx].
template <int STRIP>
__device__ __forceinline__ void vertical_strips(const float4* st_p, const float* wgt, int n_st,
                                                int srows, int scols, int rows, int vcols,
                                                float* vsum, int vplane, const Taps& taps) {
  const int n_strips = (rows + STRIP - 1) / STRIP;
  for (int task = threadIdx.x; task < n_strips * vcols; task += kFusedThreads) {
    const int g = task / vcols;
    const int sx = task - g * vcols;
    const int cy0 = g * STRIP;
    float col[STRIP][kGuided];
#pragma unroll
    for (int j = 0; j < STRIP; ++j)
#pragma unroll
      for (int i = 0; i < kGuided; ++i) col[j][i] = 0.f;
    for (int a = 0; a < taps.n + STRIP - 1 && cy0 + a < srows; ++a) {
      const int s = (cy0 + a) * scols + sx;
      const float4 p = st_p[s];
      const float w0 = wgt[s];
      const float w1 = wgt[n_st + s];
      const float w2 = wgt[2 * n_st + s];
#pragma unroll
      for (int j = 0; j < STRIP; ++j) {
        const int tap = a - j;
        if (tap >= 0 && tap < taps.n) add_guided_fields(col[j], taps.t[tap], p, w0, w1, w2);
      }
    }
#pragma unroll
    for (int j = 0; j < STRIP; ++j) {
      if (cy0 + j < rows) {
#pragma unroll
        for (int i = 0; i < kGuided; ++i) vsum[i * vplane + (cy0 + j) * scols + sx] = col[j][i];
      }
    }
  }
}

// The bilateral grid's cell from the seven sums: num / max(den, 1e-20) per
// RGB channel, alpha's numerator over green's den (0 under uniform alpha),
// as four bf16. IEEE division (no fast math), as the plain version divides.
__device__ __forceinline__ Bf16x4 normalized_cell(const float (&s)[kGuided], bool uniform_alpha) {
  const float safe1 = fmaxf(s[5], 1e-20f);
  Bf16x4 cell;
  cell.lo = __floats2bfloat162_rn(s[0] / fmaxf(s[4], 1e-20f), s[1] / safe1);
  cell.hi = __floats2bfloat162_rn(s[2] / fmaxf(s[6], 1e-20f), uniform_alpha ? 0.f : s[3] / safe1);
  return cell;
}

// Grid build: per level k and RGB channel c, the range weights
//   w_c = exp2(-(l_c - lv_c)^2 * coef),  lv_c = lmin_c + step_c * k,
// with coef = log2(e) / (2 sigma_c^2), of the pooled layer l, and the blur
// (the separable Gaussian of the pool-compensated taps) of the seven fields
// of the pooled payload p: num_c = blur(w_c p_c), den_c = blur(w_c), num_a =
// blur(w_g p_a). One body, two kernels:
//   - GUIDED = false, the bilateral grid: the layer is the payload itself
//     (one staged image); each cell is normalized (normalized_cell) and
//     stored as four bf16, (K, hs, ws, 4). Replaces
//     image_denoising_filter_tpu/ops/fast.py:_build_grid_pallas (the legacy
//     layout; the slab-layout `extend_to` emission is TPU DMA machinery).
//   - GUIDED = true, the guided grid: layer and payload (the target) pooled
//     apart (two staged images); unnormalized, stored as eight bf16
//     (pack_guided), (K, hs, ws, 8). Replaces
//     image_denoising_filter_tpu/ops/fast.py:_build_guided_grid_pallas.
// Under ZERO the cells outside the pooled images are zero pixels that keep
// the range weight exp2(-lv^2 * coef), as the TPU kernels sum their
// zero-padded tiles. Each cell's products and sums are add_guided_fields' in
// its order (the vertical sum of each tap column, then the weighted sum of
// the columns: the TPU kernels' rows-then-columns banded matmuls), so each
// grid equals its plain version bit for bit. The wrappers launch it at d >=
// 2; at d = 1 they launch build_grid_d1_kernel, the same grid.
//
// Bound on the H100, at 4K, d = 2, K = 5, 9 taps (chip_smoke.py's
// kernel_work): device memory for the guided grid, the two pooled images
// read once and 14 bytes a cell and level written (0.063 ms); the blur's 28
// operations a tap, cell and level (7 fields, two passes) for the bilateral
// grid (0.042 ms). A kernel of one thread a cell evaluates the (2r + 1)^2
// taps' range weights of every cell (3 exp2 each: 2.5 G exp2 there); this
// one evaluates (th + 2r)(tw + 2r) / (th tw) staged pixels a cell, 1.9 at 9
// taps on a 16 x 32 tile, 3.0 at 17.
// Design: a block of kBuildThreads threads owns a th x tw tile of cells
// (ops/fast.py:build_tile: 16 x 32 where the window fits, shrinking as the
// taps widen). It stages the pooled image(s) over the tile plus the blur
// halo r on each side with the build's border rule (stage_window), then per
// level, with two barriers:
//   1. each staged pixel's three range weights, once (range_weight_planes);
//   2. the vertical pass in strips of kBuildStrip cell rows (vertical_strips);
//   3. the horizontal pass: per cell the weighted sum of its 2r + 1 columns
//      in order (fused_horizontal_sums), the cell, and one 8- or 16-byte
//      store, a warp's stores along ws.
// The shared-memory layout (byte offsets in `tile`) is build_tile's.
struct BuildTile {
  int th, tw;
  // byte offsets: the staged layer (0 with one staged image: the payload is
  // the layer), the range weights (three planes), the vertical sums (seven
  // planes of th x (tw + 2r)); the staged payload is at 0
  int l_at, w_at, v_at;
};
// The ints of a tile as the launcher takes them: BuildTile's, then the bytes.
constexpr int kBuildTileFields = 6;

template <bool ZERO, bool GUIDED>
__global__ void __launch_bounds__(kBuildThreads)
    build_grid_kernel(const float4* __restrict__ small_p, const float4* __restrict__ small_l,
                      const float* __restrict__ lmin, const float* __restrict__ step,
                      void* __restrict__ grid, int hs, int ws, int levels, const Taps taps,
                      float coef, const BuildTile tile, int uniform_alpha) {
  extern __shared__ __align__(16) unsigned char build_smem[];
  const int r = taps.n / 2;
  const int y0 = blockIdx.y * tile.th;
  const int x0 = blockIdx.x * tile.tw;
  const int srows = tile.th + 2 * r;
  const int scols = tile.tw + 2 * r;
  const int n_st = srows * scols;
  const int vplane = tile.th * scols;
  float4* st_p = reinterpret_cast<float4*>(build_smem);
  float4* st_l = GUIDED ? reinterpret_cast<float4*>(build_smem + tile.l_at) : st_p;
  float* wgt = reinterpret_cast<float*>(build_smem + tile.w_at);
  float* vsum = reinterpret_cast<float*>(build_smem + tile.v_at);
  // The block's cells inside the grid.
  const int rows = min(tile.th, hs - y0);
  const int cols = min(tile.tw, ws - x0);
  stage_window<ZERO>(small_p, st_p, y0 - r, x0 - r, srows, scols, hs, ws);
  if (GUIDED) stage_window<ZERO>(small_l, st_l, y0 - r, x0 - r, srows, scols, hs, ws);
  __syncthreads();

  const float3 lmin3 = make_float3(lmin[0], lmin[1], lmin[2]);
  const float3 step3 = make_float3(step[0], step[1], step[2]);
  for (int k = 0; k < levels; ++k) {
    // 1. The range weights. The last level's vertical pass read them before
    // its barrier.
    range_weight_planes(st_l, wgt, n_st, level_centres(lmin3, step3, k), coef);
    __syncthreads();
    // 2. The vertical pass. The last level's horizontal pass read vsum
    // before the barrier above.
    vertical_strips<kBuildStrip>(st_p, wgt, n_st, srows, scols, rows, cols + 2 * r, vsum, vplane,
                                 taps);
    __syncthreads();
    // 3. The horizontal pass and the store. The next level's weights may be
    // written meanwhile: this pass reads vsum alone.
    for (int task = threadIdx.x; task < rows * tile.tw; task += kBuildThreads) {
      const int cy = task / tile.tw;
      const int cx = task - cy * tile.tw;
      if (cx >= cols) continue;
      float sum[kGuided];
      fused_horizontal_sums(vsum, cy, cx, scols, vplane, taps, sum);
      const size_t at = (static_cast<size_t>(k) * hs + y0 + cy) * ws + x0 + cx;
      if constexpr (GUIDED) {
        static_cast<Bf16x8*>(grid)[at] = pack_guided(sum);
      } else {
        static_cast<Bf16x4*>(grid)[at] = normalized_cell(sum, uniform_alpha);
      }
    }
  }
}

// Stage a pooled image's window as stage_window does, with asynchronous
// copies (cp.async, 16 bytes each; a zero pixel is a copy of no bytes, which
// fills zeros): the block goes on while they land, until
// cp_async_wait_all().
template <bool ZERO>
__device__ __forceinline__ void stage_window_async(const float4* __restrict__ small, float4* dst,
                                                   int y0, int x0, int srows, int scols, int hs,
                                                   int ws) {
  for (int i = threadIdx.x; i < srows * scols; i += kFusedThreads) {
    const int yy = y0 + i / scols;
    const int xx = x0 + i % scols;
    const bool inside = !ZERO || (yy >= 0 && yy < hs && xx >= 0 && xx < ws);
    const float4* src =
        small + static_cast<size_t>(min(max(yy, 0), hs - 1)) * ws + min(max(xx, 0), ws - 1);
    const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(at), "l"(src),
                 "r"(inside ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The grid build at d = 1
// ---------------------------------------------------------------------------

// The blocks of the d = 1 build, defined in ops/fast.py like the others: a
// vertical-pass thread sums kD1Rows cell rows of one staged column; a
// horizontal-pass thread sums kD1Cells neighbouring cells of one row (one
// float4 of each vertical-sum row a load); the taps sit in shared memory in
// kD1TapSlots floats, the table and the zeros the passes' tap windows read
// past its end; a block has kD1Threads threads.
constexpr int kD1Rows = IDF_BUILD_D1_ROWS;
constexpr int kD1Cells = 4;
constexpr int kD1TapSlots = IDF_BUILD_D1_TAP_SLOTS;
constexpr int kD1Threads = IDF_BUILD_D1_THREADS;
static_assert(kD1TapSlots >= kMaxTaps + kD1Rows && kD1TapSlots >= kMaxTaps + 8 &&
                  kD1TapSlots % 4 == 0,
              "the tap slots hold every tap window's reads");

// The grid build at d = 1, one body for both grids (GUIDED as in
// build_grid_kernel), which it computes bit for bit: each cell's seven
// sums are add_guided_fields' in its order, the vertical sum of each tap
// column, then the weighted sum of the columns. Replaces, at d = 1 (the
// sharded --turbo 1 bilateral grid; the --turbo 1 layers' guided grid),
// image_denoising_filter_tpu/ops/fast.py:_build_grid_pallas and
// :_build_guided_grid_pallas, as build_grid_kernel does at d >= 2.
//
// Bound on the H100 at 1080p, K = 6 (chip_smoke.py's kernel_work): the
// blur's 28 operations a tap, cell and level (7 fields, two passes, one
// multiply-add each), 0.09 ms at 17 taps, 0.26 ms at 49. Each cell keeps
// its products and sums apart (__fmul_rn, __fadd_rn), so each counted
// operation is one issue slot: the floor under that order is about twice
// the bound. At d = 1 there is a cell a pixel and the blur is wide: a 2-D
// tile of build_grid_kernel stages (th + 2r)(tw + 2r) / (th tw) pixels a
// cell (3.0 at 17 taps, 10.0 at 49) and evaluates three range weights for
// each, sums 1.5x (2.5x) the vertical work for the halo columns, forms each
// w * p product at every tap that reads it, and at 49 taps holds one block
// a multiprocessor.
// Design: the grid is cut into bands of tw cell columns (ops/fast.py:
// build_d1_tile) and each band into strips of groups * kD1Rows cell rows;
// the launcher starts as many blocks as the card holds at once, and each
// walks an equal run of strips, band by band, down each band. A ring of 2r
// + (strip rows) staged rows of the pooled image(s) (tw + 2r columns, the
// build's border rule) holds what a strip reads; each staged row is copied
// in once a band walk (cp.async), the next strip's rows while the last
// level of this one runs its horizontal pass, into the slots of rows no
// later strip reads (or, where the walk moves to the next band, the whole
// ring). Only the tw + 2r columns carry halo, and no block waits on a last
// partial wave. Per strip and level, with two barriers:
//   1. the vertical pass: thread (group g, staged column sx) computes each
//      pixel of its n + kD1Rows - 1 staged rows' three range weights and
//      four products w * p once (d1_fields), adds them to its kD1Rows cell
//      rows at their taps (14 operations a tap), and writes the seven sums
//      to shared memory;
//   2. the horizontal pass: a thread sums kD1Cells neighbouring cells of a
//      row from float4 loads of the vertical sums (each load feeds every
//      cell it reaches) and stores them, a warp's stores along ws: the
//      bilateral grid's 8-byte cells straight to the grid; the guided
//      grid's 16-byte cells through shared memory, which the next level's
//      vertical pass (or the block's end) first copies out, each store
//      instruction on consecutive cells (stored straight, a thread's four
//      16-byte cells put a store instruction's lanes 64 bytes apart).
// The tile and the shared-memory layout (byte offsets in `tile`) are
// build_d1_tile's.
struct BuildD1Tile {
  int tw;       // cell columns of the band, a multiple of kD1Cells
  int groups;   // vertical-pass thread groups: a strip is groups * kD1Rows cell rows
  // byte offsets: the staged layer's ring (0 with one staged image: the
  // payload is the layer), the vertical sums (seven planes of the strip's
  // rows x vstride), the guided strip's cells (rows x tw, d1_swizzle'd;
  // none for the bilateral grid), the taps; the staged payload's ring is at 0
  int l_at, v_at, o_at, t_at;
};
// The ints of a tile as the launcher takes them: BuildD1Tile's, then the bytes.
constexpr int kBuildD1TileFields = 7;

// Where cell u (row-major in the strip's rows x tw) sits in the guided
// grid's staged cells: within its 128-byte group of G cells (G = 128 / the
// cell's bytes), at u ^ (its group's index mod G), so that both the
// horizontal pass's stores (kD1Cells neighbouring cells a thread) and the
// copy out (one cell a thread, a row at a time) meet no bank twice in a
// wavefront.
template <int G>
__device__ __forceinline__ int d1_swizzle(int u) {
  return u ^ ((u / G) & (G - 1));
}

// Copy a strip's staged cells (rows x tw, d1_swizzle'd) of level k, rows y
// .. y + rows - 1 and columns x0 .. x0 + cols - 1 of the grid, to the grid:
// one cell a thread, consecutive threads on consecutive cells of a row.
template <typename Cell>
__device__ __forceinline__ void d1_copy_out(const Cell* cells, Cell* grid, int k, int y, int x0,
                                            int rows, int cols, int tw, int hs, int ws) {
  constexpr int kG = 128 / sizeof(Cell);
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int cy = i / cols;
    const int cx = i - cy * cols;
    grid[(static_cast<size_t>(k) * hs + y + cy) * ws + x0 + cx] =
        cells[d1_swizzle<kG>(cy * tw + cx)];
  }
}

// A vertical-sum row's stride: tw + 2r columns, rounded up so that every
// float4 load of the horizontal pass lies in its row.
__host__ __device__ __forceinline__ int d1_vstride(int tw, int r) { return (tw + 2 * r + 3) & ~3; }

// Stage n_rows rows of a pooled image from row row0, columns x0 ..
// x0 + scols - 1, into the ring's slots (row - ring_row0) % ring_rows with
// asynchronous copies and the build's border rule: edge cells (CLAMP) or
// zero pixels (ZERO, a copy of no bytes, which fills zeros). Lands by
// cp_async_wait_all().
template <bool ZERO>
__device__ __forceinline__ void stage_ring_rows(const float4* __restrict__ small, float4* ring,
                                                int row0, int n_rows, int x0, int scols,
                                                int ring_row0, int ring_rows, int hs, int ws) {
  for (int i = threadIdx.x; i < n_rows * scols; i += blockDim.x) {
    const int dy = i / scols;
    const int sx = i - dy * scols;
    const int yy = row0 + dy;
    const int xx = x0 + sx;
    const bool inside = !ZERO || (yy >= 0 && yy < hs && xx >= 0 && xx < ws);
    const float4* src =
        small + static_cast<size_t>(min(max(yy, 0), hs - 1)) * ws + min(max(xx, 0), ws - 1);
    float4* dst = ring + ((yy - ring_row0) % ring_rows) * scols + sx;
    const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(at), "l"(src),
                 "r"(inside ? 16 : 0));
  }
}

// The seven fields of one staged pixel at one level (add_guided_fields'):
// num r, g, b, a as w * p, alpha under green's weight, then den r, g, b.
__device__ __forceinline__ void d1_fields(float4 p, float4 l, float3 lv, float coef,
                                          float (&f)[kGuided]) {
  const float3 w = guided_range_weights(l, lv, coef);
  f[0] = __fmul_rn(w.x, p.x);
  f[1] = __fmul_rn(w.y, p.y);
  f[2] = __fmul_rn(w.z, p.z);
  f[3] = __fmul_rn(w.y, p.w);
  f[4] = w.x;
  f[5] = w.y;
  f[6] = w.z;
}

// One staged row i (i = 0 at the group's first row, r rows above its first
// cell row) of the vertical pass, software-pipelined: f holds row i's
// fields, p and l row i + 1's pixel. Computes row i + 1's fields and loads
// row i + 2's pixel (from ring slot `slot`, which then advances; rows past
// the walk's end are read and never used) ahead of adding f to cell row j
// as tap i - j (tap[j] holds taps[i - j] after the shift), so that the
// loads' and the exp2s' latency hides behind the adds. TAKE says which
// cell rows j take the row, so that no add is issued for one that does not:
// every row (kAllRows); j <= t (kRowsUpTo, the walk's first kD1Rows - 1
// rows, t = i); j > t (kRowsAbove, its last kD1Rows - 1, t = i - n); those
// with i - j in [0, n) (kRowsInTable, any n).
enum D1Take { kAllRows, kRowsUpTo, kRowsAbove, kRowsInTable };

template <bool GUIDED, D1Take TAKE>
__device__ __forceinline__ void d1_vertical_row(const float4* ring_p, const float4* ring_l,
                                                int& slot, int ring_rows, int scols, int sx,
                                                const float* s_taps, int i, int t, int n,
                                                float3 lv, float coef, float (&tap)[kD1Rows],
                                                float (&acc)[kD1Rows][kGuided],
                                                float (&f)[kGuided], float4& p, float4& l) {
  float next[kGuided];
  d1_fields(p, l, lv, coef, next);
  p = ring_p[slot * scols + sx];
  l = GUIDED ? ring_l[slot * scols + sx] : p;
  if (++slot == ring_rows) slot = 0;
#pragma unroll
  for (int j = kD1Rows - 1; j > 0; --j) tap[j] = tap[j - 1];
  tap[0] = s_taps[i];
#pragma unroll
  for (int j = 0; j < kD1Rows; ++j) {
    const bool take = TAKE == kAllRows    ? true
                      : TAKE == kRowsUpTo ? j <= t
                      : TAKE == kRowsAbove ? j > t
                                           : i - j >= 0 && i - j < n;
    if (take) {
#pragma unroll
      for (int q = 0; q < kGuided; ++q) acc[j][q] = __fadd_rn(acc[j][q], __fmul_rn(tap[j], f[q]));
    }
  }
#pragma unroll
  for (int q = 0; q < kGuided; ++q) f[q] = next[q];
}

// The vertical pass of one level for one thread: staged column sx, cell
// rows vrow0 .. vrow0 + kD1Rows - 1 of the strip, whose staged rows start
// at ring slot `slot`. Writes vsum[q * v_plane + row * vstride + sx].
template <bool GUIDED>
__device__ __forceinline__ void d1_vertical(const float4* ring_p, const float4* ring_l,
                                            int ring_rows, int scols, int sx, int slot,
                                            const float* s_taps, int n, float3 lv, float coef,
                                            float* vsum, int vrow0, int vstride, int v_plane) {
  float acc[kD1Rows][kGuided];
  float tap[kD1Rows];
#pragma unroll
  for (int j = 0; j < kD1Rows; ++j) {
    tap[j] = 0.f;
#pragma unroll
    for (int q = 0; q < kGuided; ++q) acc[j][q] = 0.f;
  }
  // The pipeline's first stage: row 0's fields, row 1's pixel.
  float f[kGuided];
  float4 p = ring_p[slot * scols + sx];
  float4 l = GUIDED ? ring_l[slot * scols + sx] : p;
  if (++slot == ring_rows) slot = 0;
  d1_fields(p, l, lv, coef, f);
  p = ring_p[slot * scols + sx];
  l = GUIDED ? ring_l[slot * scols + sx] : p;
  if (++slot == ring_rows) slot = 0;
  if (n >= kD1Rows - 1) {
    // rows 0 .. kD1Rows - 2 reach the first cell rows only, rows n .. n +
    // kD1Rows - 2 the last ones; the rows between reach them all
#pragma unroll
    for (int t = 0; t < kD1Rows - 1; ++t)
      d1_vertical_row<GUIDED, kRowsUpTo>(ring_p, ring_l, slot, ring_rows, scols, sx, s_taps, t,
                                         t, n, lv, coef, tap, acc, f, p, l);
    for (int i = kD1Rows - 1; i < n; ++i)
      d1_vertical_row<GUIDED, kAllRows>(ring_p, ring_l, slot, ring_rows, scols, sx, s_taps, i,
                                        0, n, lv, coef, tap, acc, f, p, l);
#pragma unroll
    for (int t = 0; t < kD1Rows - 1; ++t)
      d1_vertical_row<GUIDED, kRowsAbove>(ring_p, ring_l, slot, ring_rows, scols, sx, s_taps,
                                          n + t, t, n, lv, coef, tap, acc, f, p, l);
  } else {
    for (int i = 0; i < n + kD1Rows - 1; ++i)
      d1_vertical_row<GUIDED, kRowsInTable>(ring_p, ring_l, slot, ring_rows, scols, sx, s_taps,
                                            i, 0, n, lv, coef, tap, acc, f, p, l);
  }
#pragma unroll
  for (int j = 0; j < kD1Rows; ++j)
#pragma unroll
    for (int q = 0; q < kGuided; ++q) vsum[q * v_plane + (vrow0 + j) * vstride + sx] = acc[j][q];
}

// One float4 column chunk m of the horizontal pass, software-pipelined: v
// holds the chunk's vertical sums (columns cx0 + 4m .. cx0 + 4m + 3 of a
// row, one float4 a plane), and is refilled with chunk m + 1's (the last
// chunk's again at the end) ahead of adding them to cell cx0 + c as tap 4m
// + e - c, in tap order. t8 slides to taps 4m - 4 .. 4m + 3. A cell takes
// the chunk's column e where DMIN <= e - c <= DMAX (the taps in [0, n) of
// the first chunk, the middle ones, and the last one or two at n = 1 or 3
// mod 4), or, with CHECK, where its tap 4m + e - c is in [0, n): no add is
// issued for a tap outside the table.
template <int DMIN, int DMAX, bool CHECK>
__device__ __forceinline__ void d1_horizontal_chunk(const float* row, int v_plane,
                                                    const float* s_taps, int m, int chunks,
                                                    int n, float (&t8)[8],
                                                    float4 (&v)[kGuided],
                                                    float (&out)[kD1Cells][kGuided]) {
  const float4 t4 = *reinterpret_cast<const float4*>(s_taps + 4 * m);
  t8[0] = t8[4];
  t8[1] = t8[5];
  t8[2] = t8[6];
  t8[3] = t8[7];
  t8[4] = t4.x;
  t8[5] = t4.y;
  t8[6] = t4.z;
  t8[7] = t4.w;
  const int ahead = 4 * min(m + 1, chunks - 1);
  float4 next[kGuided];
#pragma unroll
  for (int q = 0; q < kGuided; ++q)
    next[q] = *reinterpret_cast<const float4*>(row + q * v_plane + ahead);
#pragma unroll
  for (int q = 0; q < kGuided; ++q) {
    const float e4[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int c = 0; c < kD1Cells; ++c) {
        const int b = 4 * m + e - c;
        if (CHECK ? b >= 0 && b < n : DMIN <= e - c && e - c <= DMAX)
          out[c][q] = __fadd_rn(out[c][q], __fmul_rn(t8[4 + e - c], e4[e]));
      }
    }
    v[q] = next[q];
  }
}

template <bool ZERO, bool GUIDED>
__global__ void __launch_bounds__(kD1Threads)
    build_grid_d1_kernel(const float4* __restrict__ small_p, const float4* __restrict__ small_l,
                         const float* __restrict__ lmin, const float* __restrict__ step,
                         void* __restrict__ grid, int hs, int ws, int levels, const Taps taps,
                         float coef, const BuildD1Tile tile, int uniform_alpha) {
  extern __shared__ __align__(16) unsigned char d1_smem[];
  const int n = taps.n;
  const int r = n / 2;
  const int rows = tile.groups * kD1Rows;  // cell rows of a strip
  const int ring_rows = 2 * r + rows;
  const int scols = tile.tw + 2 * r;
  const int vstride = d1_vstride(tile.tw, r);
  const int v_plane = rows * vstride;
  float4* ring_p = reinterpret_cast<float4*>(d1_smem);
  float4* ring_l = GUIDED ? reinterpret_cast<float4*>(d1_smem + tile.l_at) : ring_p;
  float* vsum = reinterpret_cast<float*>(d1_smem + tile.v_at);
  using Cell = std::conditional_t<GUIDED, Bf16x8, Bf16x4>;
  constexpr int kG = 128 / sizeof(Cell);
  Cell* cells = reinterpret_cast<Cell*>(d1_smem + tile.o_at);
  Cell* out_grid = static_cast<Cell*>(grid);
  float* s_taps = reinterpret_cast<float*>(d1_smem + tile.t_at);
  // The block's run of work items, strip s of band b being item b *
  // strips + s: an equal share of them, in order.
  const int strips = (hs + rows - 1) / rows;
  const long long items = static_cast<long long>((ws + tile.tw - 1) / tile.tw) * strips;
  const int begin = static_cast<int>(items * blockIdx.x / gridDim.x);
  const int end = static_cast<int>(items * (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;
  for (int i = threadIdx.x; i < kD1TapSlots; i += blockDim.x) s_taps[i] = i < n ? taps.t[i] : 0.f;
  // The staged row of ring slot 0 of this band walk: a row's slot is
  // (row - ring_row0) % ring_rows.
  int ring_row0 = (begin % strips) * rows - r;
  stage_ring_rows<ZERO>(small_p, ring_p, ring_row0, ring_rows, (begin / strips) * tile.tw - r,
                        scols, ring_row0, ring_rows, hs, ws);
  if (GUIDED)
    stage_ring_rows<ZERO>(small_l, ring_l, ring_row0, ring_rows, (begin / strips) * tile.tw - r,
                          scols, ring_row0, ring_rows, hs, ws);
  cp_async_wait_all();
  __syncthreads();

  const float3 lmin3 = make_float3(lmin[0], lmin[1], lmin[2]);
  const float3 step3 = make_float3(step[0], step[1], step[2]);
  const int group = threadIdx.x / scols;  // the vertical pass's thread (group, sx)
  const int sx = threadIdx.x - group * scols;
  const int groups_x = tile.tw / kD1Cells;
  // The staged cells still to copy out: level pend_k (-1: none) of the
  // strip at (pend_y, pend_x0), pend_rows x pend_cols cells.
  int pend_k = -1, pend_y = 0, pend_x0 = 0, pend_rows = 0, pend_cols = 0;
  for (int item = begin; item < end; ++item) {
    const int band = item / strips;
    const int y = (item - band * strips) * rows;
    const int x0 = band * tile.tw;
    const int rows_in = min(rows, hs - y);
    const int cols = min(tile.tw, ws - x0);
    int next_row0 = ring_row0;
    for (int k = 0; k < levels; ++k) {
      const float3 lv = level_centres(lmin3, step3, k);
      // 1. The vertical pass. The last level's horizontal pass read vsum
      // before the barrier that ended it, and staged its cells, which go
      // out first.
      if (GUIDED && pend_k >= 0)
        d1_copy_out(cells, out_grid, pend_k, pend_y, pend_x0, pend_rows, pend_cols, tile.tw, hs,
                    ws);
      if (group < tile.groups)
        d1_vertical<GUIDED>(ring_p, ring_l, ring_rows, scols, sx,
                            (y - r + group * kD1Rows - ring_row0) % ring_rows, s_taps, n, lv,
                            coef, vsum, group * kD1Rows, vstride, v_plane);
      __syncthreads();
      // Nothing reads the ring again in this item: the next item's rows go
      // in while the horizontal pass runs. Down the band, its new rows, into
      // the slots of this strip's first rows, which no later strip reads;
      // at the next band, the whole ring from a new origin.
      const bool last = k == levels - 1;
      if (last && item + 1 < end) {
        const int next_band = (item + 1) / strips;
        const int next_y = (item + 1 - next_band * strips) * rows;
        const bool down = next_band == band;
        if (!down) next_row0 = next_y - r;
        const int from = down ? y + rows + r : next_row0;
        const int count = down ? rows : ring_rows;
        stage_ring_rows<ZERO>(small_p, ring_p, from, count, next_band * tile.tw - r, scols,
                              next_row0, ring_rows, hs, ws);
        if (GUIDED)
          stage_ring_rows<ZERO>(small_l, ring_l, from, count, next_band * tile.tw - r, scols,
                                next_row0, ring_rows, hs, ws);
      }
      // 2. The horizontal pass and the stores.
      for (int task = threadIdx.x; task < rows_in * groups_x; task += blockDim.x) {
        const int cy = task / groups_x;
        const int cx0 = (task - cy * groups_x) * kD1Cells;
        const float* row = vsum + cy * vstride + cx0;
        float out[kD1Cells][kGuided];
#pragma unroll
        for (int c = 0; c < kD1Cells; ++c)
#pragma unroll
          for (int q = 0; q < kGuided; ++q) out[c][q] = 0.f;
        // t8: taps 4m - 4 .. 4m + 3; a cell's last tap is read by chunk
        // (n + kD1Cells - 2) / 4: for n = 4a + 1 chunks 1 .. a - 1 take every
        // tap and chunk a the first of its column; for n = 4a + 3 chunk a
        // three, a + 1 one
        float t8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const int chunks = (n + kD1Cells + 2) / 4;
        const int a = n / 4;
        float4 v[kGuided];  // the pipeline's first stage: chunk 0's sums
#pragma unroll
        for (int q = 0; q < kGuided; ++q) v[q] = *reinterpret_cast<const float4*>(row + q * v_plane);
        if (n < 4) {
          for (int m = 0; m < chunks; ++m)
            d1_horizontal_chunk<0, 0, true>(row, v_plane, s_taps, m, chunks, n, t8, v, out);
        } else {
          d1_horizontal_chunk<0, 3, false>(row, v_plane, s_taps, 0, chunks, n, t8, v, out);
          for (int m = 1; m < a; ++m)
            d1_horizontal_chunk<-3, 3, false>(row, v_plane, s_taps, m, chunks, n, t8, v, out);
          if (n % 4 == 1) {
            d1_horizontal_chunk<-3, 0, false>(row, v_plane, s_taps, a, chunks, n, t8, v, out);
          } else {
            d1_horizontal_chunk<-3, 2, false>(row, v_plane, s_taps, a, chunks, n, t8, v, out);
            d1_horizontal_chunk<-3, -2, false>(row, v_plane, s_taps, a + 1, chunks, n, t8, v,
                                               out);
          }
        }
#pragma unroll
        for (int c = 0; c < kD1Cells; ++c) {
          if constexpr (GUIDED) {
            cells[d1_swizzle<kG>(cy * tile.tw + cx0 + c)] = pack_guided(out[c]);
          } else if (cx0 + c < cols) {
            out_grid[(static_cast<size_t>(k) * hs + y + cy) * ws + x0 + cx0 + c] =
                normalized_cell(out[c], uniform_alpha);
          }
        }
      }
      pend_k = k;
      pend_y = y;
      pend_x0 = x0;
      pend_rows = rows_in;
      pend_cols = cols;
      if (last) cp_async_wait_all();
      // The next level's vertical pass writes vsum and copies the cells
      // out; the next item reads the rows that just landed.
      __syncthreads();
    }
    ring_row0 = next_row0;
  }
  if (GUIDED)
    d1_copy_out(cells, out_grid, pend_k, pend_y, pend_x0, pend_rows, pend_cols, tile.tw, hs, ws);
}

// Fused guided build + slice: one block per slice tile of ph x pw pixels.
//
// Replaces image_denoising_filter_tpu/ops/fast.py:
// _fused_guided_pipeline_planar. The block stages the pooled target and
// layer of the cells its pixels' bilinear taps read (with the blur halo) in
// shared memory, finds the levels the tile's t touch, [floor(tmin_c),
// ceil(tmax_c)] over the three channels, and builds each of them in shared
// memory with build_grid_kernel's guided passes (each staged pixel's range
// weights once, the vertical pass in strips, the horizontal pass into bf16
// cells), kGuidedLevels levels at a time; then it slices those levels into
// its pixels' partials. The 7 K hs ws grid never goes to device memory.
// Each cell's sums are the build kernel's, in its order, and each pixel's
// the slice kernel's (a tile whose levels take more than one pass leaves
// the partials in the outputs and adds the next levels to them, in level
// order), so the output equals the two-kernel path bit for bit; cells
// outside the grid are the edge cells (clamped index), as the two-kernel
// path's edge replication gives them.
//
// Bound on the H100: device memory, the full-resolution layer read (16 B a
// pixel) and the partials written (28 B a pixel) beside the two pooled
// images read once: 0.129 ms at 4K, d = 2, K = 5 (chip_smoke.py's
// kernel_work). Against it: per level the tile's cells and halo, about 1.3
// cells built a cell at d = 2 (10 x 34 for 8 x 32) and 2.9 staged range
// weights a cell; two barriers a level; and a block's steps in series
// (staging, the guide read, the levels, the slice), which only other
// blocks on the multiprocessor overlap.
// Design: the tile (ops/fast.py:fused_tile) is 16 x 64 pixels where
// its window fits, shrinking as the taps widen; each of the kFusedThreads
// threads takes one column and every (kFusedThreads / pw)-th row. The
// window is staged with cp.async while the block reads the guide for its
// level range. No pixel's partials live across the build: the slice reads
// the guide again, so the build's registers are #9's and the block is
// compiled for kGuidedMinBlocks blocks a multiprocessor. Per level: the
// vertical pass; barrier; the horizontal pass beside the next level's range
// weights; barrier. The shared-memory layout (byte offsets in `tile`) is
// fused_tile's.
struct FusedTile {
  int ph, pw;      // the slice tile in pixels
  int rows, cols;  // the most cells a tile's window holds
  // byte offsets: the staged layer (0 with one staged image, the payload
  // being the layer), the range weights (three planes), the vertical sums
  // (seven planes of rows x (cols + 2r)), a batch of levels' cells; the
  // staged payload (the guided grid's target) is at 0
  int l_at, w_at, v_at, c_at;
};
// The ints of a tile as the launchers take them: FusedTile's, then the
// bytes.
constexpr int kFusedTileFields = 9;

template <bool ZERO>
__global__ void __launch_bounds__(kFusedThreads, kGuidedMinBlocks)
    fused_guided_kernel(const float4* __restrict__ small_t, const float4* __restrict__ small_l,
                        const float4* __restrict__ guide, const float* __restrict__ lmin,
                        const float* __restrict__ step, const float* __restrict__ inv_step,
                        float4* __restrict__ out_wc, float* __restrict__ out_nw, int h, int w,
                        int hs, int ws, int levels, const Taps taps, float coef, float inv_d,
                        const FusedTile tile) {
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int r = taps.n / 2;
  const int ty0 = blockIdx.y * tile.ph;
  const int tx0 = blockIdx.x * tile.pw;
  const int4 win = tile_window(ty0, tx0, tile.ph, tile.pw, h, w, hs, ws, inv_d);
  const int ay0 = win.x, ax0 = win.y, rows = win.z, cols = win.w;
  const int srows = rows + 2 * r;
  const int scols = cols + 2 * r;
  const int n_st = srows * scols;
  const int vplane = rows * scols;
  float4* st_t = reinterpret_cast<float4*>(fused_smem);
  float4* st_l = reinterpret_cast<float4*>(fused_smem + tile.l_at);
  float* wgt = reinterpret_cast<float*>(fused_smem + tile.w_at);
  float* vsum = reinterpret_cast<float*>(fused_smem + tile.v_at);
  Bf16x8* cells = reinterpret_cast<Bf16x8*>(fused_smem + tile.c_at);

  // Stage the pooled window with the build kernel's border rule, and
  // meanwhile read the guide for the tile's level range.
  stage_window_async<ZERO>(small_t, st_t, ay0 - r, ax0 - r, srows, scols, hs, ws);
  stage_window_async<ZERO>(small_l, st_l, ay0 - r, ax0 - r, srows, scols, hs, ws);
  const int px = tx0 + threadIdx.x % tile.pw;
  const int py0 = ty0 + threadIdx.x / tile.pw;
  const int row_step = kFusedThreads / tile.pw;
  const int py_end = min(ty0 + tile.ph, h);
  int2 k_range;
  {
    float t[kGuidedPixels][3];
    k_range = tile_levels<kGuidedPixels>(guide, w, px, py0, row_step, py_end, lmin, inv_step,
                                         levels, t);
  }
  cp_async_wait_all();
  __syncthreads();

  const float3 lmin3 = make_float3(lmin[0], lmin[1], lmin[2]);
  const float3 step3 = make_float3(step[0], step[1], step[2]);
  range_weight_planes(st_l, wgt, n_st, level_centres(lmin3, step3, k_range.x), coef);
  __syncthreads();
  const int n_cells = rows * cols;
  for (int k0 = k_range.x; k0 <= k_range.y; k0 += kGuidedLevels) {
    const int k1 = min(k0 + kGuidedLevels - 1, k_range.y);
    for (int k = k0; k <= k1; ++k) {
      vertical_strips<kFusedStrip>(st_t, wgt, n_st, srows, scols, rows, scols, vsum, vplane,
                                    taps);
      __syncthreads();
      // The horizontal pass into this level's bf16 cells, and the next
      // level's range weights (this level's vertical pass read the planes
      // before the barrier above).
      Bf16x8* level = cells + (k - k0) * n_cells;
      for (int i = threadIdx.x; i < n_cells; i += kFusedThreads) {
        float sum[kGuided];
        fused_horizontal_sums(vsum, i / cols, i % cols, scols, vplane, taps, sum);
        level[i] = pack_guided(sum);
      }
      if (k < k_range.y)
        range_weight_planes(st_l, wgt, n_st, level_centres(lmin3, step3, k + 1), coef);
      __syncthreads();
    }
    // Slice levels k0 .. k1 into the pixels' partials (slice_guided_grid_kernel's
    // sums): from zero, or from what the last pass left in the outputs. The
    // next pass's horizontal pass overwrites the cells only after its
    // vertical pass's barrier.
    const float kmax = static_cast<float>(levels - 1);
    const float gx = __fmul_rn(static_cast<float>(px) + 0.5f, inv_d) - 0.5f;
    const float fx = floorf(gx);
    const int x0 = min(max(static_cast<int>(fx), 0), ws - 1) - ax0;
    const int x1 = min(max(static_cast<int>(fx) + 1, 0), ws - 1) - ax0;
#pragma unroll
    for (int i = 0; i < kGuidedPixels; ++i) {
      const int py = py0 + row_step * i;
      if (px >= w || py >= py_end) continue;
      const size_t idx = static_cast<size_t>(py) * w + px;
      const float4 g = guide[idx];
      const float t0 = level_t(g.x, lmin3.x, inv_step[0], kmax);
      const float t1 = level_t(g.y, lmin3.y, inv_step[1], kmax);
      const float t2 = level_t(g.z, lmin3.z, inv_step[2], kmax);
      float acc[kGuided] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 > k_range.x) {
        const float4 wc = out_wc[idx];
        acc[0] = wc.x;
        acc[1] = wc.y;
        acc[2] = wc.z;
        acc[3] = wc.w;
        acc[4] = out_nw[3 * idx];
        acc[5] = out_nw[3 * idx + 1];
        acc[6] = out_nw[3 * idx + 2];
      }
      const float gy = __fmul_rn(static_cast<float>(py) + 0.5f, inv_d) - 0.5f;
      const float fy = floorf(gy);
      const int y0 = min(max(static_cast<int>(fy), 0), hs - 1) - ay0;
      const int y1 = min(max(static_cast<int>(fy) + 1, 0), hs - 1) - ay0;
      for (int k = k0; k <= k1; ++k) {
        const float kf = static_cast<float>(k);
        const float e0 = tent(t0, kf);
        const float e1 = tent(t1, kf);
        const float e2 = tent(t2, kf);
        if (e0 == 0.f && e1 == 0.f && e2 == 0.f) continue;
        float up[8];
        sample_guided(cells + (k - k0) * n_cells, cols, y0, y1, x0, x1, gx - fx, gy - fy, up);
        add_guided_level(acc, up, e0, e1, e2);
      }
      out_wc[idx] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      out_nw[3 * idx] = acc[4];
      out_nw[3 * idx + 1] = acc[5];
      out_nw[3 * idx + 2] = acc[6];
    }
  }
}

// Fused bilateral build + slice: one block per slice tile of ph x pw pixels.
//
// Replaces image_denoising_filter_tpu/ops/fast.py:
// _fused_grid_pipeline_planar. fused_guided_kernel's design with one staged
// pooled image, which is payload and layer at once: the block stages the
// pooled image of the cells its pixels' bilinear taps read (with the blur
// halo, cp.async) while it reads the guide for its level range, builds each
// level it touches with build_grid_kernel's passes into normalized bf16
// cells (normalized_cell, alpha by green's weights), kGridLevels levels at a
// time, then slices them into its pixels' outputs with slice_grid_kernel's
// sums (alpha under green's tent, or *alpha under UNIFORM_ALPHA): from
// zero, or from what the last batch left in the output, in level order. The
// (K, hs, ws, 4) grid never goes to device memory; the output equals
// build_grid_kernel -> slice_grid_kernel bit for bit. With read_range = 0
// (ops/fast.py: at d = 4 and 8, where a tile touches nearly every level) the
// block builds every level and reads the guide once, in the slice: levels no
// pixel touches add nothing to any pixel, as in the slice kernel.
//
// Bound on the H100: device memory, the image read (16 B a pixel) and the
// output written (16 B a pixel) beside the pooled image read once: 0.089 ms
// at 4K, d = 2, K = 5 (chip_smoke.py's kernel_work). Against it, as for
// fused_guided_kernel: the window's halo cells (10 x 34 built for 8 x 32 at
// d = 2), the levels a tile touches (nearly all of them on a noisy frame),
// two barriers a level and a block's steps in series.
// Design: the tile (ops/fast.py:fused_tile) grows with d, 16 x 64 pixels at
// d = 2, 32 x 128 at 4 and 32 x 256 at 8, so that its window holds about as
// many cells at every d; a thread's pixels (4, 16 or 32) are a run-time
// loop. No pixel's partials live across the build, and the kernel is
// compiled for kGridMinBlocks blocks a multiprocessor: 64 registers, four
// blocks (32 warps), which hide more of the block's serial steps than
// three (tools/fused_tile_sweep.py).
template <bool ZERO, bool UNIFORM_ALPHA>
__global__ void __launch_bounds__(kFusedThreads, kGridMinBlocks)
    fused_grid_kernel(const float4* __restrict__ small, const float4* __restrict__ guide,
                      const float* __restrict__ lmin, const float* __restrict__ step,
                      const float* __restrict__ inv_step, const float* __restrict__ alpha,
                      float4* __restrict__ out, int h, int w, int hs, int ws, int levels,
                      const Taps taps, float coef, float inv_d, const FusedTile tile,
                      int read_range) {
  extern __shared__ __align__(16) unsigned char grid_smem[];
  const int r = taps.n / 2;
  const int ty0 = blockIdx.y * tile.ph;
  const int tx0 = blockIdx.x * tile.pw;
  const int4 win = tile_window(ty0, tx0, tile.ph, tile.pw, h, w, hs, ws, inv_d);
  const int ay0 = win.x, ax0 = win.y, rows = win.z, cols = win.w;
  const int srows = rows + 2 * r;
  const int scols = cols + 2 * r;
  const int n_st = srows * scols;
  const int vplane = rows * scols;
  float4* staged = reinterpret_cast<float4*>(grid_smem);
  float* wgt = reinterpret_cast<float*>(grid_smem + tile.w_at);
  float* vsum = reinterpret_cast<float*>(grid_smem + tile.v_at);
  Bf16x4* cells = reinterpret_cast<Bf16x4*>(grid_smem + tile.c_at);

  // Stage the pooled window with the build kernel's border rule, and
  // meanwhile read the guide for the tile's level range.
  stage_window_async<ZERO>(small, staged, ay0 - r, ax0 - r, srows, scols, hs, ws);
  const int px = tx0 + threadIdx.x % tile.pw;
  const int py0 = ty0 + threadIdx.x / tile.pw;
  const int row_step = kFusedThreads / tile.pw;
  const int py_end = min(ty0 + tile.ph, h);
  const float3 lmin3 = make_float3(lmin[0], lmin[1], lmin[2]);
  const float3 inv3 = make_float3(inv_step[0], inv_step[1], inv_step[2]);
  const int2 k_range = read_range
                           ? block_levels(guide, w, px, py0, row_step, py_end, lmin3, inv3, levels)
                           : make_int2(0, levels - 1);
  cp_async_wait_all();
  __syncthreads();

  const float3 step3 = make_float3(step[0], step[1], step[2]);
  range_weight_planes(staged, wgt, n_st, level_centres(lmin3, step3, k_range.x), coef);
  __syncthreads();
  const int n_cells = rows * cols;
  for (int k0 = k_range.x; k0 <= k_range.y; k0 += kGridLevels) {
    const int k1 = min(k0 + kGridLevels - 1, k_range.y);
    for (int k = k0; k <= k1; ++k) {
      vertical_strips<kFusedStrip>(staged, wgt, n_st, srows, scols, rows, scols, vsum, vplane,
                                   taps);
      __syncthreads();
      // The horizontal pass into this level's cells, and the next level's
      // range weights (this level's vertical pass read the planes before the
      // barrier above).
      Bf16x4* level = cells + (k - k0) * n_cells;
      for (int i = threadIdx.x; i < n_cells; i += kFusedThreads) {
        float sum[kGuided];
        fused_horizontal_sums(vsum, i / cols, i % cols, scols, vplane, taps, sum);
        level[i] = normalized_cell(sum, UNIFORM_ALPHA);
      }
      if (k < k_range.y)
        range_weight_planes(staged, wgt, n_st, level_centres(lmin3, step3, k + 1), coef);
      __syncthreads();
    }
    // Slice levels k0 .. k1 into the pixels' outputs. The next batch's
    // horizontal pass overwrites the cells only after its vertical pass's
    // barrier.
    if (px >= w) continue;
    const float kmax = static_cast<float>(levels - 1);
    const float gx = __fmul_rn(static_cast<float>(px) + 0.5f, inv_d) - 0.5f;
    const float fx = floorf(gx);
    const int x0 = min(max(static_cast<int>(fx), 0), ws - 1) - ax0;
    const int x1 = min(max(static_cast<int>(fx) + 1, 0), ws - 1) - ax0;
    const float wx = gx - fx;
#pragma unroll 4
    for (int py = py0; py < py_end; py += row_step) {
      const size_t idx = static_cast<size_t>(py) * w + px;
      const float4 g = guide[idx];
      const float t0 = level_t(g.x, lmin3.x, inv3.x, kmax);
      const float t1 = level_t(g.y, lmin3.y, inv3.y, kmax);
      const float t2 = level_t(g.z, lmin3.z, inv3.z, kmax);
      const float gy = __fmul_rn(static_cast<float>(py) + 0.5f, inv_d) - 0.5f;
      const float fy = floorf(gy);
      const int y0 = min(max(static_cast<int>(fy), 0), hs - 1) - ay0;
      const int y1 = min(max(static_cast<int>(fy) + 1, 0), hs - 1) - ay0;
      const float wy = gy - fy;
      float4 acc = k0 > k_range.x ? out[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = k0; k <= k1; ++k) {
        const float kf = static_cast<float>(k);
        const float e0 = tent(t0, kf);
        const float e1 = tent(t1, kf);
        const float e2 = tent(t2, kf);
        if (e0 == 0.f && e1 == 0.f && e2 == 0.f) continue;
        const Bf16x4* lv = cells + (k - k0) * n_cells;
        const float4 row0 = lerp4(load_cell(lv, y0, x0, cols), load_cell(lv, y0, x1, cols), wx);
        const float4 row1 = lerp4(load_cell(lv, y1, x0, cols), load_cell(lv, y1, x1, cols), wx);
        const float4 up = lerp4(row0, row1, wy);
        acc.x = __fadd_rn(acc.x, __fmul_rn(e0, up.x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(e1, up.y));
        acc.z = __fadd_rn(acc.z, __fmul_rn(e2, up.z));
        if (!UNIFORM_ALPHA) acc.w = __fadd_rn(acc.w, __fmul_rn(e1, up.w));
      }
      if (UNIFORM_ALPHA) acc.w = *alpha;
      out[idx] = acc;
    }
  }
}

dim3 grid_for(int w, int h) {
  return dim3((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
}

// The slab form's arguments of the slice kernels: a band that starts on a
// multiple of d, and a slab of hs rows that starts inside the image's
// hs_all grid rows (or one row above them, a row the clamp never reads).
bool slab_ok(int y_off, int d, int hs, int hs_all, int gy_off) {
  return y_off >= 0 && y_off % d == 0 && hs > 0 && hs_all > 0 && gy_off >= -1 &&
         gy_off < hs_all;
}

// Whether `bytes` of dynamic shared memory, beside `reserve` bytes of a
// kernel's static arrays, fit the current device's opt-in shared memory per
// block.
cudaError_t shared_fits(size_t bytes, size_t reserve, bool* fits) {
  int max_bytes = 0;
  const cudaError_t err = idf::max_shared_bytes(&max_bytes);
  *fits = err == cudaSuccess && bytes + reserve <= static_cast<size_t>(max_bytes);
  return err;
}

// Whether n_taps is a tap count the kernels take: odd, at most kMaxTaps.
bool taps_ok(int n_taps) { return n_taps > 0 && n_taps <= kMaxTaps && n_taps % 2 == 1; }

// The blur taps as the kernels take them, by value.
Taps tap_table(const float* taps, int n_taps) {
  Taps table;
  table.n = n_taps;
  for (int i = 0; i < n_taps; ++i) table.t[i] = taps[i];
  return table;
}

// shared_fits for a kernel's launch, and where they fit above the default
// 48 KB, the kernel's opt-in to them.
cudaError_t opt_in(const void* kernel, int bytes, size_t reserve, bool* fits) {
  cudaError_t err = shared_fits(bytes, reserve, fits);
  if (*fits && bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

// Whether a build tile for blur radius r lays out what build_grid_kernel
// indexes: the staged payload at 0, the staged layer (two images) after it,
// then the weight planes and the vertical sums, back to back within `bytes`.
bool build_tile_ok(const BuildTile& t, bool guided, int r, int bytes) {
  if (t.th < 1 || t.tw < 1) return false;
  const int n_st = (t.th + 2 * r) * (t.tw + 2 * r);
  const bool staged = guided ? t.l_at >= 16 * n_st && t.l_at % 16 == 0 &&
                                   t.w_at >= t.l_at + 16 * n_st
                             : t.l_at == 0 && t.w_at >= 16 * n_st;
  return staged && t.w_at % 4 == 0 && t.v_at >= t.w_at + 12 * n_st && t.v_at % 4 == 0 &&
         bytes >= t.v_at + 4 * kGuided * t.th * (t.tw + 2 * r);
}

template <bool GUIDED>
int launch_build(const void* small_p, const void* small_l, const void* lmin, const void* step,
                 void* grid, int hs, int ws, int levels, const float* taps, int n_taps,
                 float coef, int zero_border, int uniform_alpha, const int* tile, void* stream) {
  const cudaError_t invalid = cudaErrorInvalidValue;
  if (!taps_ok(n_taps) || levels <= 0) return static_cast<int>(invalid);
  const BuildTile geom{tile[0], tile[1], tile[2], tile[3], tile[4]};
  const int shared_bytes = tile[kBuildTileFields - 1];
  if (!build_tile_ok(geom, GUIDED, n_taps / 2, shared_bytes)) return static_cast<int>(invalid);
  auto kernel = zero_border ? build_grid_kernel<true, GUIDED> : build_grid_kernel<false, GUIDED>;
  bool fits = false;
  const cudaError_t err =
      opt_in(reinterpret_cast<const void*>(kernel), shared_bytes, 0, &fits);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!fits) return static_cast<int>(invalid);
  if (hs <= 0 || ws <= 0) return static_cast<int>(cudaSuccess);
  const dim3 blocks((ws + geom.tw - 1) / geom.tw, (hs + geom.th - 1) / geom.th);
  kernel<<<blocks, kBuildThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(small_p), static_cast<const float4*>(small_l),
      static_cast<const float*>(lmin), static_cast<const float*>(step), grid, hs, ws, levels,
      tap_table(taps, n_taps), coef, geom, uniform_alpha);
  return static_cast<int>(cudaGetLastError());
}

// Whether a d = 1 build tile for blur radius r lays out what
// build_grid_d1_kernel indexes: the block's threads cover the vertical
// pass's groups x (tw + 2r) columns, and the payload's ring at 0, the
// layer's ring (two images) after it, the vertical sums, the strip's cells
// and the taps lie back to back, 16-byte aligned, within `bytes`.
bool build_d1_tile_ok(const BuildD1Tile& t, bool guided, int r, int bytes) {
  const int scols = t.tw + 2 * r;
  if (t.tw < kD1Cells || t.tw % kD1Cells != 0 || t.groups < 1 || t.groups * scols > kD1Threads)
    return false;
  const int ring = 16 * (2 * r + t.groups * kD1Rows) * scols;
  const bool staged = guided ? t.l_at >= ring && t.l_at % 16 == 0 && t.v_at >= t.l_at + ring
                             : t.l_at == 0 && t.v_at >= ring;
  const int rows = t.groups * kD1Rows;
  return staged && t.v_at % 16 == 0 &&
         t.o_at >= t.v_at + 4 * kGuided * rows * d1_vstride(t.tw, r) && t.o_at % 16 == 0 &&
         t.t_at >= t.o_at + (guided ? 16 * rows * t.tw : 0) && t.t_at % 16 == 0 &&
         bytes >= t.t_at + 4 * kD1TapSlots;
}

template <bool GUIDED>
int launch_build_d1(const void* small_p, const void* small_l, const void* lmin, const void* step,
                    void* grid, int hs, int ws, int levels, const float* taps, int n_taps,
                    float coef, int zero_border, int uniform_alpha, const int* tile,
                    void* stream) {
  const cudaError_t invalid = cudaErrorInvalidValue;
  if (!taps_ok(n_taps) || levels <= 0) return static_cast<int>(invalid);
  const BuildD1Tile geom{tile[0], tile[1], tile[2], tile[3], tile[4], tile[5]};
  const int shared_bytes = tile[kBuildD1TileFields - 1];
  if (!build_d1_tile_ok(geom, GUIDED, n_taps / 2, shared_bytes)) return static_cast<int>(invalid);
  auto kernel =
      zero_border ? build_grid_d1_kernel<true, GUIDED> : build_grid_d1_kernel<false, GUIDED>;
  bool fits = false;
  const cudaError_t err = opt_in(reinterpret_cast<const void*>(kernel), shared_bytes, 0, &fits);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!fits) return static_cast<int>(invalid);
  if (hs <= 0 || ws <= 0) return static_cast<int>(cudaSuccess);
  // As many blocks as the card holds at once, at most one a work item.
  int per_sm = 0, sms = 0, device = 0;
  cudaError_t q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(kernel), kD1Threads, shared_bytes);
  if (q == cudaSuccess) q = cudaGetDevice(&device);
  if (q == cudaSuccess) q = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (q != cudaSuccess) return static_cast<int>(q);
  if (per_sm < 1) return static_cast<int>(invalid);
  const long long items = static_cast<long long>((ws + geom.tw - 1) / geom.tw) *
                          ((hs + geom.groups * kD1Rows - 1) / (geom.groups * kD1Rows));
  const int blocks = static_cast<int>(std::min<long long>(items, 1LL * per_sm * sms));
  kernel<<<blocks, kD1Threads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(small_p), static_cast<const float4*>(small_l),
      static_cast<const float*>(lmin), static_cast<const float*>(step), grid, hs, ws, levels,
      tap_table(taps, n_taps), coef, geom, uniform_alpha);
  return static_cast<int>(cudaGetLastError());
}

// The d = 1 build kernel of a grid and a border as compiled, and its
// occupancy at shared_bytes a block (kernel_info's).
int build_d1_info(bool guided, int zero_border, int shared_bytes, int* info) {
  const void* kernel =
      guided ? (zero_border ? reinterpret_cast<const void*>(build_grid_d1_kernel<true, true>)
                            : reinterpret_cast<const void*>(build_grid_d1_kernel<false, true>))
             : (zero_border ? reinterpret_cast<const void*>(build_grid_d1_kernel<true, false>)
                            : reinterpret_cast<const void*>(build_grid_d1_kernel<false, false>));
  return static_cast<int>(idf::kernel_info(kernel, kD1Threads, shared_bytes, info));
}

// Whether a fused tile for downsample d and blur radius r is one the fused
// kernels take: its threads cover the tile (each one column and every
// (kFusedThreads / pw)-th row; the guided kernel's at most kGuidedPixels
// rows), d divides it, its rows x cols cells hold every tile's window
// (ph / d + 2 rows, ph + 1 at d = 1; columns alike), and the staged payload
// at 0, the staged layer (guided), the weight planes, the vertical sums and
// a batch of levels' cells lie back to back within `bytes`.
bool fused_tile_ok(const FusedTile& t, bool guided, int d, int r, int bytes) {
  if (t.ph < 1 || t.pw < 1 || t.pw > kFusedThreads || kFusedThreads % t.pw != 0 || d < 1 ||
      t.ph % d != 0 || t.pw % d != 0 || (guided && kFusedThreads / t.pw * kGuidedPixels < t.ph))
    return false;
  const int halo = d == 1 ? 1 : 2;
  if (t.rows < t.ph / d + halo || t.cols < t.pw / d + halo) return false;
  const int n_st = (t.rows + 2 * r) * (t.cols + 2 * r);
  const bool staged = guided ? t.l_at >= 16 * n_st && t.l_at % 16 == 0 &&
                                   t.w_at >= t.l_at + 16 * n_st
                             : t.l_at == 0 && t.w_at >= 16 * n_st;
  const int cell_bytes = guided ? sizeof(Bf16x8) : sizeof(Bf16x4);
  const int batch = guided ? kGuidedLevels : kGridLevels;
  return staged && t.w_at % 4 == 0 && t.v_at >= t.w_at + 12 * n_st && t.v_at % 4 == 0 &&
         t.c_at >= t.v_at + 4 * kGuided * t.rows * (t.cols + 2 * r) && t.c_at % 16 == 0 &&
         bytes >= t.c_at + cell_bytes * batch * t.rows * t.cols;
}

// A fused launch's checks and shared-memory opt-in: the tile's ints as a
// FusedTile and its bytes; cudaErrorInvalidValue where fused_tile_ok refuses
// them or they do not fit the device beside the kernel's static arrays.
cudaError_t fused_prologue(const void* kernel, const int* tile, bool guided, int d, int n_taps,
                           int levels, FusedTile* geom, int* bytes) {
  if (!taps_ok(n_taps) || levels <= 0) return cudaErrorInvalidValue;
  *geom = FusedTile{tile[0], tile[1], tile[2], tile[3], tile[4], tile[5], tile[6], tile[7]};
  *bytes = tile[kFusedTileFields - 1];
  if (!fused_tile_ok(*geom, guided, d, n_taps / 2, *bytes)) return cudaErrorInvalidValue;
  bool fits = false;
  const cudaError_t err = opt_in(kernel, *bytes, kStaticSharedReserve, &fits);
  if (err != cudaSuccess) return err;
  return fits ? cudaSuccess : cudaErrorInvalidValue;
}

// The fused bilateral kernel of a border and an alpha form.
auto fused_grid_instance(int zero_border, bool uniform_alpha) {
  if (zero_border)
    return uniform_alpha ? fused_grid_kernel<true, true> : fused_grid_kernel<true, false>;
  return uniform_alpha ? fused_grid_kernel<false, true> : fused_grid_kernel<false, false>;
}

// The bilateral slice's launcher: own_cell (d == 1 only, so ws == w)
// launches slice_grid_d1_kernel, else slice_grid_kernel, which takes every d.
int launch_slice_grid(const void* guide, const void* grid, const void* lmin, const void* inv_step,
                      const void* alpha, void* out, int h, int w, int hs, int ws, int levels,
                      int d, int y_off, int hs_all, int gy_off, bool own_cell, void* stream) {
  if (d <= 0 || levels <= 0 || !slab_ok(y_off, d, hs, hs_all, gy_off) ||
      (own_cell && (d != 1 || ws != w))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kBlockX, kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* gd = static_cast<const float4*>(guide);
  const Bf16x4* g = static_cast<const Bf16x4*>(grid);
  const float* lm = static_cast<const float*>(lmin);
  const float* is = static_cast<const float*>(inv_step);
  const float* a = static_cast<const float*>(alpha);
  float4* o = static_cast<float4*>(out);
  if (own_cell) {  // d == 1: ws == w, the cell row y + y_off
    const dim3 blocks = grid_for(w, h);
    if (a != nullptr) {
      slice_grid_d1_kernel<true><<<blocks, block, 0, s>>>(gd, g, lm, is, a, o, h, w, hs, levels,
                                                            y_off, hs_all, gy_off);
    } else {
      slice_grid_d1_kernel<false><<<blocks, block, 0, s>>>(gd, g, lm, is, a, o, h, w, hs,
                                                             levels, y_off, hs_all, gy_off);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const float inv_d = 1.f / static_cast<float>(d);
  if (a != nullptr) {
    slice_grid_kernel<true><<<grid_for(w, h), block, 0, s>>>(
        gd, g, lm, is, a, o, h, w, hs, ws, levels, inv_d, y_off / d, hs_all, gy_off);
  } else {
    slice_grid_kernel<false><<<grid_for(w, h), block, 0, s>>>(
        gd, g, lm, is, a, o, h, w, hs, ws, levels, inv_d, y_off / d, hs_all, gy_off);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// img: (h, w, 4) float32; out: (ceil(h/d), ceil(w/d), 4) float32.
int idf_pool(const void* img, void* out, int h, int w, int d, int zero_border, void* stream) {
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  const int hs = (h + d - 1) / d;
  const int ws = (w + d - 1) / d;
  const dim3 block(kBlockX, kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* in = static_cast<const float4*>(img);
  float4* o = static_cast<float4*>(out);
  const float inv_d = 1.f / static_cast<float>(d);
  if (zero_border) {
    pool_kernel<true><<<grid_for(ws, hs), block, 0, s>>>(in, o, h, w, hs, ws, d, inv_d);
  } else {
    pool_kernel<false><<<grid_for(ws, hs), block, 0, s>>>(in, o, h, w, hs, ws, d, inv_d);
  }
  return static_cast<int>(cudaGetLastError());
}

// small: (hs, ws, 4) float32; lmin, step: device arrays of 3 floats;
// taps: host array of n_taps floats (odd); grid: (levels, hs, ws, 4) bf16.
// tile: host array of kBuildTileFields ints from ops/fast.py:build_tile
// with one staged image: th x tw cells, the byte offsets of BuildTile (l_at
// 0), the block's dynamic shared memory in bytes, which must fit the
// device; regions that overlap or are short of what the kernel indexes are
// refused (cudaErrorInvalidValue, no launch).
int idf_build_grid(const void* small, const void* lmin, const void* step, void* grid, int hs,
                   int ws, int levels, const float* taps, int n_taps, float coef,
                   int zero_border, int uniform_alpha, const int* tile, void* stream) {
  return launch_build<false>(small, small, lmin, step, grid, hs, ws, levels, taps, n_taps, coef,
                             zero_border, uniform_alpha, tile, stream);
}

// The bilateral build kernel of a border as compiled, and its occupancy at
// shared_bytes a block (kernel_info's).
int idf_build_grid_info(int zero_border, int shared_bytes, int* info) {
  auto kernel = zero_border ? build_grid_kernel<true, false> : build_grid_kernel<false, false>;
  return static_cast<int>(
      idf::kernel_info(reinterpret_cast<const void*>(kernel), kBuildThreads, shared_bytes, info));
}

// idf_build_grid's inputs at d = 1, through build_grid_d1_kernel. tile: host
// array of kBuildD1TileFields ints from ops/fast.py:build_d1_tile with one
// staged image: BuildD1Tile's (l_at 0), then the block's dynamic shared
// memory in bytes, which must fit the device; a tile the kernel cannot take
// (build_d1_tile_ok) is refused (cudaErrorInvalidValue, no launch).
int idf_build_grid_d1(const void* small, const void* lmin, const void* step, void* grid, int hs,
                      int ws, int levels, const float* taps, int n_taps, float coef,
                      int zero_border, int uniform_alpha, const int* tile, void* stream) {
  return launch_build_d1<false>(small, small, lmin, step, grid, hs, ws, levels, taps, n_taps,
                                coef, zero_border, uniform_alpha, tile, stream);
}

// The bilateral d = 1 build kernel of a border as compiled, and its
// occupancy at shared_bytes a block (kernel_info's).
int idf_build_grid_d1_info(int zero_border, int shared_bytes, int* info) {
  return build_d1_info(false, zero_border, shared_bytes, info);
}

// guide: (h, w, 4) float32 (its RGB guides the tents); grid: (levels, hs, ws,
// 4) bf16; lmin, inv_step: device arrays of 3 floats; alpha: device float,
// or nullptr for the full alpha slice; out: (h, w, 4) float32. y_off, hs_all,
// gy_off: the slab form (slice_grid_kernel), the guide's first row in the
// image (a multiple of d), the image's grid rows, the grid's first row among
// them; 0, hs, 0 for the whole image. ops/fast.py:check_slab checks that
// the grid holds every row the band reads. d = 1 launches
// slice_grid_d1_kernel, any other d slice_grid_kernel.
int idf_slice_grid(const void* guide, const void* grid, const void* lmin, const void* inv_step,
                   const void* alpha, void* out, int h, int w, int hs, int ws, int levels, int d,
                   int y_off, int hs_all, int gy_off, void* stream) {
  return launch_slice_grid(guide, grid, lmin, inv_step, alpha, out, h, w, hs, ws, levels, d,
                           y_off, hs_all, gy_off, d == 1, stream);
}

// idf_slice_grid's arguments, through slice_grid_kernel at every d: the
// bilinear form at d = 1, whose bytes the card tests hold
// slice_grid_d1_kernel to. The port's wrappers never call it.
int idf_slice_grid_bilinear(const void* guide, const void* grid, const void* lmin,
                            const void* inv_step, const void* alpha, void* out, int h, int w,
                            int hs, int ws, int levels, int d, int y_off, int hs_all,
                            int gy_off, void* stream) {
  return launch_slice_grid(guide, grid, lmin, inv_step, alpha, out, h, w, hs, ws, levels, d,
                           y_off, hs_all, gy_off, false, stream);
}

// small_t, small_l: (hs, ws, 4) float32 pooled target and layer; lmin, step:
// device arrays of 3 floats; taps: host array of n_taps floats (odd); grid:
// (levels, hs, ws, 8) bf16. tile: as idf_build_grid's, from
// ops/fast.py:build_tile with two staged images.
int idf_build_guided_grid(const void* small_t, const void* small_l, const void* lmin,
                          const void* step, void* grid, int hs, int ws, int levels,
                          const float* taps, int n_taps, float coef, int zero_border,
                          const int* tile, void* stream) {
  return launch_build<true>(small_t, small_l, lmin, step, grid, hs, ws, levels, taps, n_taps,
                            coef, zero_border, 0, tile, stream);
}

// The guided build kernel of a border as compiled, and its occupancy at
// shared_bytes a block (kernel_info's).
int idf_build_guided_grid_info(int zero_border, int shared_bytes, int* info) {
  auto kernel = zero_border ? build_grid_kernel<true, true> : build_grid_kernel<false, true>;
  return static_cast<int>(
      idf::kernel_info(reinterpret_cast<const void*>(kernel), kBuildThreads, shared_bytes, info));
}

// idf_build_guided_grid's inputs at d = 1, through build_grid_d1_kernel.
// tile: as idf_build_grid_d1's, from ops/fast.py:build_d1_tile with two
// staged images.
int idf_build_guided_grid_d1(const void* small_t, const void* small_l, const void* lmin,
                             const void* step, void* grid, int hs, int ws, int levels,
                             const float* taps, int n_taps, float coef, int zero_border,
                             const int* tile, void* stream) {
  return launch_build_d1<true>(small_t, small_l, lmin, step, grid, hs, ws, levels, taps, n_taps,
                               coef, zero_border, 0, tile, stream);
}

// The guided d = 1 build kernel of a border as compiled, and its occupancy
// at shared_bytes a block (kernel_info's).
int idf_build_guided_grid_d1_info(int zero_border, int shared_bytes, int* info) {
  return build_d1_info(true, zero_border, shared_bytes, info);
}

// guide: (h, w, 4) float32 full-resolution layer; grid: (levels, hs, ws, 8)
// bf16; lmin, inv_step: device arrays of 3 floats; out_wc: (h, w, 4) and
// out_nw: (h, w, 3) float32. y_off, hs_all, gy_off: the slab form, as
// idf_slice_grid's.
int idf_slice_guided_grid(const void* guide, const void* grid, const void* lmin,
                          const void* inv_step, void* out_wc, void* out_nw, int h, int w, int hs,
                          int ws, int levels, int d, int y_off, int hs_all, int gy_off,
                          void* stream) {
  if (d <= 0 || levels <= 0 || !slab_ok(y_off, d, hs, hs_all, gy_off)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  slice_guided_grid_kernel<<<grid_for(w, h), dim3(kBlockX, kBlockY), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(guide), static_cast<const Bf16x8*>(grid),
      static_cast<const float*>(lmin), static_cast<const float*>(inv_step),
      static_cast<float4*>(out_wc), static_cast<float*>(out_nw), h, w, hs, ws, levels,
      1.f / static_cast<float>(d), y_off / d, hs_all, gy_off);
  return static_cast<int>(cudaGetLastError());
}

// The fused bilateral build + slice: the inputs of idf_build_grid and
// idf_slice_grid (step and inv_step both), with img the slice's guide, and
// its output. tile: host array of kFusedTileFields ints from
// ops/fast.py:fused_tile with one staged image: the slice tile, its cell
// window, the byte offsets of FusedTile (l_at 0), the block's dynamic shared
// memory in bytes, which must fit the device beside the kernel's static
// arrays; a tile the kernel cannot take (fused_tile_ok: short, overlapping,
// or one that stages a second image) is refused (cudaErrorInvalidValue, no
// launch). read_range: 1 reads each tile's level range from the guide, 0
// builds every level.
int idf_fused_grid(const void* small, const void* img, const void* lmin, const void* step,
                   const void* inv_step, const void* alpha, void* out, int h, int w, int hs,
                   int ws, int levels, const float* taps, int n_taps, float coef, int d,
                   int zero_border, int read_range, const int* tile, void* stream) {
  auto kernel = fused_grid_instance(zero_border, alpha != nullptr);
  FusedTile geom;
  int shared_bytes = 0;
  const cudaError_t err = fused_prologue(reinterpret_cast<const void*>(kernel), tile, false, d,
                                         n_taps, levels, &geom, &shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (read_range != 0 && read_range != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((w + geom.pw - 1) / geom.pw, (h + geom.ph - 1) / geom.ph);
  kernel<<<grid, kFusedThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(small), static_cast<const float4*>(img),
      static_cast<const float*>(lmin), static_cast<const float*>(step),
      static_cast<const float*>(inv_step), static_cast<const float*>(alpha),
      static_cast<float4*>(out), h, w, hs, ws, levels, tap_table(taps, n_taps), coef,
      1.f / static_cast<float>(d), geom, read_range);
  return static_cast<int>(cudaGetLastError());
}

// The fused bilateral kernel of a border and an alpha form as compiled, and
// its occupancy at shared_bytes a block (kernel_info's).
int idf_fused_grid_info(int zero_border, int uniform_alpha, int shared_bytes, int* info) {
  auto kernel = fused_grid_instance(zero_border, uniform_alpha);
  return static_cast<int>(idf::kernel_info(reinterpret_cast<const void*>(kernel), kFusedThreads,
                                           shared_bytes, info));
}

// The fused guided build + slice: the inputs of idf_build_guided_grid and
// idf_slice_guided_grid (step and inv_step both), the same outputs. tile:
// as idf_fused_grid's, from ops/fast.py:fused_tile with two staged images.
int idf_fused_guided(const void* small_t, const void* small_l, const void* guide,
                     const void* lmin, const void* step, const void* inv_step, void* out_wc,
                     void* out_nw, int h, int w, int hs, int ws, int levels, const float* taps,
                     int n_taps, float coef, int d, int zero_border, const int* tile,
                     void* stream) {
  auto kernel = zero_border ? fused_guided_kernel<true> : fused_guided_kernel<false>;
  FusedTile geom;
  int shared_bytes = 0;
  const cudaError_t err = fused_prologue(reinterpret_cast<const void*>(kernel), tile, true, d,
                                         n_taps, levels, &geom, &shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((w + geom.pw - 1) / geom.pw, (h + geom.ph - 1) / geom.ph);
  kernel<<<grid, kFusedThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(small_t), static_cast<const float4*>(small_l),
      static_cast<const float4*>(guide), static_cast<const float*>(lmin),
      static_cast<const float*>(step), static_cast<const float*>(inv_step),
      static_cast<float4*>(out_wc), static_cast<float*>(out_nw), h, w, hs, ws, levels,
      tap_table(taps, n_taps), coef, 1.f / static_cast<float>(d), geom);
  return static_cast<int>(cudaGetLastError());
}

// The fused guided kernel of a border as compiled, and its occupancy at
// shared_bytes a block (kernel_info's).
int idf_fused_guided_info(int zero_border, int shared_bytes, int* info) {
  auto kernel = zero_border ? fused_guided_kernel<true> : fused_guided_kernel<false>;
  return static_cast<int>(
      idf::kernel_info(reinterpret_cast<const void*>(kernel), kFusedThreads, shared_bytes, info));
}

}  // extern "C"
