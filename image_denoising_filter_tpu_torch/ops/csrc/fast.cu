// Hand-written Hopper (sm_90a) kernels of the turbo bilateral grid: the d x d
// mean pool, the grid build (per-level range weights, Gaussian blur,
// normalize, bf16 store) and the grid slice (tent interpolation across the
// levels of the bilinearly upsampled grid).
//
// Layouts: images (H, W, 4) float32, one pixel one float4; the pooled image
// (hs, ws, 4) float32, hs = ceil(H/d), ws = ceil(W/d); the grid
// (K, hs, ws, 4) bfloat16, so that one cell of one level is one 8-byte load,
// channels r, g, b, a. Alpha is payload under green's range weights; under
// uniform alpha its slot holds zero and the slice writes the constant.
// Borders are handled by clamping the cell index (CLAMP) or by substituting a
// zero pixel (ZERO): nothing is padded on the host.
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

// Grid build: per level k and RGB channel c, over the pooled image p,
//   w_c  = exp2(-(p_c - lv_c)^2 * coef),  lv_c = lmin_c + step_c * k,
//   g_c  = blur(w_c * p_c) / max(blur(w_c), 1e-20),
// with coef = log2(e) / (2 sigma_c^2) and blur the separable Gaussian of the
// pool-compensated taps; alpha's payload is p_a under green's weights,
// divided by green's den. Stored as bf16.
//
// Replaces image_denoising_filter_tpu/ops/fast.py:_build_grid_pallas (the
// legacy layout; the slab-layout `extend_to` emission is TPU DMA machinery).
// Under ZERO the cells outside the pooled image are zero pixels that still
// carry the range weight exp2(-lv^2 * coef) with payload 0: they are summed,
// not skipped, as the TPU kernel sums its zero-padded tile.
//
// Bound on the H100: FP32 and SFU instruction throughput. Each cell recomputes the
// range weights of its (2r+1)^2 taps for every level: at 4K, d=2 (r=4),
// K=5 that is 2.07 M cells x 5 x 81 taps x 3 exp2 = 2.5 G exp2; device
// memory sees the 33 MB pooled image about once and the 83 MB grid once.
// Design: one thread per cell in 32x8 blocks, tap loads served by L1; the
// blur runs column by column (the vertical sum of each tap column first,
// then the weighted sum of the columns), the order of the TPU kernel's
// rows-then-columns banded matmuls. Sharing the range weights through
// shared memory would divide the exp2 work by ~30 and is later work.
template <bool ZERO>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    build_grid_kernel(const float4* __restrict__ small, const float* __restrict__ lmin,
                      const float* __restrict__ step, Bf16x4* __restrict__ grid, int hs,
                      int ws, int levels, const Taps taps, float coef, int uniform_alpha) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= ws || y >= hs) return;
  const int r = taps.n / 2;
  const float lmin0 = lmin[0], lmin1 = lmin[1], lmin2 = lmin[2];
  const float step0 = step[0], step1 = step[1], step2 = step[2];
  for (int k = 0; k < levels; ++k) {
    const float kf = static_cast<float>(k);
    const float lv0 = __fadd_rn(lmin0, __fmul_rn(step0, kf));
    const float lv1 = __fadd_rn(lmin1, __fmul_rn(step1, kf));
    const float lv2 = __fadd_rn(lmin2, __fmul_rn(step2, kf));
    float den0 = 0.f, den1 = 0.f, den2 = 0.f;
    float num0 = 0.f, num1 = 0.f, num2 = 0.f, numa = 0.f;
    for (int b = 0; b < taps.n; ++b) {
      const int xx = x + b - r;
      const bool col_ok = xx >= 0 && xx < ws;
      const float4* col_ptr = small + min(max(xx, 0), ws - 1);
      float cden0 = 0.f, cden1 = 0.f, cden2 = 0.f;
      float cnum0 = 0.f, cnum1 = 0.f, cnum2 = 0.f, cnuma = 0.f;
      for (int a = 0; a < taps.n; ++a) {
        const int yy = y + a - r;
        float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!ZERO || (col_ok && yy >= 0 && yy < hs))
          p = __ldg(col_ptr + static_cast<size_t>(min(max(yy, 0), hs - 1)) * ws);
        const float d0 = p.x - lv0;
        const float d1 = p.y - lv1;
        const float d2 = p.z - lv2;
        const float w0 = exp2f(__fmul_rn(-__fmul_rn(d0, d0), coef));
        const float w1 = exp2f(__fmul_rn(-__fmul_rn(d1, d1), coef));
        const float w2 = exp2f(__fmul_rn(-__fmul_rn(d2, d2), coef));
        const float ta = taps.t[a];
        cden0 = __fadd_rn(cden0, __fmul_rn(ta, w0));
        cden1 = __fadd_rn(cden1, __fmul_rn(ta, w1));
        cden2 = __fadd_rn(cden2, __fmul_rn(ta, w2));
        cnum0 = __fadd_rn(cnum0, __fmul_rn(ta, __fmul_rn(w0, p.x)));
        cnum1 = __fadd_rn(cnum1, __fmul_rn(ta, __fmul_rn(w1, p.y)));
        cnum2 = __fadd_rn(cnum2, __fmul_rn(ta, __fmul_rn(w2, p.z)));
        if (!uniform_alpha) cnuma = __fadd_rn(cnuma, __fmul_rn(ta, __fmul_rn(w1, p.w)));
      }
      const float tb = taps.t[b];
      den0 = __fadd_rn(den0, __fmul_rn(tb, cden0));
      den1 = __fadd_rn(den1, __fmul_rn(tb, cden1));
      den2 = __fadd_rn(den2, __fmul_rn(tb, cden2));
      num0 = __fadd_rn(num0, __fmul_rn(tb, cnum0));
      num1 = __fadd_rn(num1, __fmul_rn(tb, cnum1));
      num2 = __fadd_rn(num2, __fmul_rn(tb, cnum2));
      numa = __fadd_rn(numa, __fmul_rn(tb, cnuma));
    }
    // IEEE division (no fast math), as the plain version divides.
    const float safe1 = fmaxf(den1, 1e-20f);
    Bf16x4 cell;
    cell.lo = __floats2bfloat162_rn(num0 / fmaxf(den0, 1e-20f), num1 / safe1);
    cell.hi = __floats2bfloat162_rn(num2 / fmaxf(den2, 1e-20f),
                                    uniform_alpha ? 0.f : numa / safe1);
    grid[(static_cast<size_t>(k) * hs + y) * ws + x] = cell;
  }
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
template <bool UNIFORM_ALPHA>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    slice_grid_kernel(const float4* __restrict__ guide, const Bf16x4* __restrict__ grid,
                      const float* __restrict__ lmin, const float* __restrict__ inv_step,
                      const float* __restrict__ alpha, float4* __restrict__ out, int h,
                      int w, int hs, int ws, int levels, float inv_d) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t idx = static_cast<size_t>(y) * w + x;
  const float4 g = guide[idx];
  const float kmax = static_cast<float>(levels - 1);
  const float t0 = fminf(fmaxf(__fmul_rn(g.x - lmin[0], inv_step[0]), 0.f), kmax);
  const float t1 = fminf(fmaxf(__fmul_rn(g.y - lmin[1], inv_step[1]), 0.f), kmax);
  const float t2 = fminf(fmaxf(__fmul_rn(g.z - lmin[2], inv_step[2]), 0.f), kmax);
  // (y + 0.5)/d - 0.5 is exact in float32 for d a power of two.
  const float gy = __fmul_rn(static_cast<float>(y) + 0.5f, inv_d) - 0.5f;
  const float gx = __fmul_rn(static_cast<float>(x) + 0.5f, inv_d) - 0.5f;
  const float fy = floorf(gy);
  const float fx = floorf(gx);
  const float wy = gy - fy;
  const float wx = gx - fx;
  const int y0 = min(max(static_cast<int>(fy), 0), hs - 1);
  const int y1 = min(max(static_cast<int>(fy) + 1, 0), hs - 1);
  const int x0 = min(max(static_cast<int>(fx), 0), ws - 1);
  const int x1 = min(max(static_cast<int>(fx) + 1, 0), ws - 1);
  const size_t plane = static_cast<size_t>(hs) * ws;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < levels; ++k) {
    const float kf = static_cast<float>(k);
    const float e0 = fmaxf(1.f - fabsf(t0 - kf), 0.f);
    const float e1 = fmaxf(1.f - fabsf(t1 - kf), 0.f);
    const float e2 = fmaxf(1.f - fabsf(t2 - kf), 0.f);
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

dim3 grid_for(int w, int h) {
  return dim3((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
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
int idf_build_grid(const void* small, const void* lmin, const void* step, void* grid, int hs,
                   int ws, int levels, const float* taps, int n_taps, float coef,
                   int zero_border, int uniform_alpha, void* stream) {
  if (n_taps <= 0 || n_taps > kMaxTaps || n_taps % 2 == 0 || levels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hs <= 0 || ws <= 0) return static_cast<int>(cudaSuccess);
  Taps table;
  table.n = n_taps;
  for (int i = 0; i < n_taps; ++i) table.t[i] = taps[i];
  const dim3 block(kBlockX, kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* in = static_cast<const float4*>(small);
  const float* lm = static_cast<const float*>(lmin);
  const float* st = static_cast<const float*>(step);
  Bf16x4* g = static_cast<Bf16x4*>(grid);
  if (zero_border) {
    build_grid_kernel<true><<<grid_for(ws, hs), block, 0, s>>>(
        in, lm, st, g, hs, ws, levels, table, coef, uniform_alpha);
  } else {
    build_grid_kernel<false><<<grid_for(ws, hs), block, 0, s>>>(
        in, lm, st, g, hs, ws, levels, table, coef, uniform_alpha);
  }
  return static_cast<int>(cudaGetLastError());
}

// guide: (h, w, 4) float32 (its RGB guides the tents); grid: (levels, hs, ws,
// 4) bf16; lmin, inv_step: device arrays of 3 floats; alpha: device float,
// or nullptr for the full alpha slice; out: (h, w, 4) float32.
int idf_slice_grid(const void* guide, const void* grid, const void* lmin, const void* inv_step,
                   const void* alpha, void* out, int h, int w, int hs, int ws, int levels, int d,
                   void* stream) {
  if (d <= 0 || levels <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kBlockX, kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* gd = static_cast<const float4*>(guide);
  const Bf16x4* g = static_cast<const Bf16x4*>(grid);
  const float* lm = static_cast<const float*>(lmin);
  const float* is = static_cast<const float*>(inv_step);
  const float* a = static_cast<const float*>(alpha);
  float4* o = static_cast<float4*>(out);
  const float inv_d = 1.f / static_cast<float>(d);
  if (a != nullptr) {
    slice_grid_kernel<true><<<grid_for(w, h), block, 0, s>>>(gd, g, lm, is, a, o, h, w, hs, ws,
                                                             levels, inv_d);
  } else {
    slice_grid_kernel<false><<<grid_for(w, h), block, 0, s>>>(gd, g, lm, is, a, o, h, w, hs, ws,
                                                              levels, inv_d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
