// Hand-written Hopper (sm_90a) kernels of the exact denoising battery:
// bilateral (fused or guided partials), frame-batched NLM accumulation and
// the normalize epilogue.
//
// Images keep the public (H, W, 4) float32 layout: one pixel is one 16-byte
// float4, the natural coalesced load of this card. Borders are handled inside
// the kernels by clamping the tap index (CLAMP) or by substituting a zero
// pixel (ZERO), so nothing is padded on the host.
//
// Every launcher takes raw device pointers, sizes, parameters and a stream,
// launches on that stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() as an int. Static tables (the bilateral disk
// runs, the NLM candidate offsets) come from Python and travel by value in
// the kernel's parameter space: every thread of a warp reads the same entry,
// which the constant cache broadcasts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kBlockX = 32;  // a warp spans 32 neighbouring pixels of a row
constexpr int kBlockY = 8;
constexpr int kMaxRuns = 128;
constexpr int kMaxCands = 1024;  // (2s)^2 candidates up to s = 16
// The NLM kernel's blocks, defined in ops/stencils.py and passed to nvcc as
// macros by ops/_build.py. For patch radii 1 to kNlmRegisterPatch (the
// sliding body) a warp's 32 lanes are 32 consecutive rows of squared
// differences, the first 33 - 2p of them output rows, each lane owning
// kNlmSeg output columns of its row; a block is up to kNlmSlideThreads / 32
// such warps side by side. Wider radii (the staged body): kNlmThreads
// threads own an output tile of kNlmTileW columns and up to kNlmMaxTileH
// rows.
constexpr int kNlmThreads = IDF_NLM_THREADS;
constexpr int kNlmSeg = IDF_NLM_SEG;
constexpr int kNlmTileW = IDF_NLM_TILE_W;
constexpr int kNlmMaxTileH = IDF_NLM_MAX_TILE_H;
constexpr int kNlmRegisterPatch = IDF_NLM_REGISTER_PATCH;
constexpr int kNlmSlideThreads = IDF_NLM_SLIDE_THREADS;  // the sliding body's widest block
constexpr int kNlmMinBlocks = IDF_NLM_MIN_BLOCKS;         // and its blocks a SM at the least
static_assert(kNlmMaxTileH * kNlmTileW % kNlmThreads == 0 && kNlmThreads % kNlmTileW == 0,
              "a thread of the staged body owns whole output rows of one column");
static_assert(kNlmSlideThreads % 32 == 0 && 2 * kNlmRegisterPatch - 1 < 32,
              "the sliding body's warps have output rows");
constexpr int kNlmOutPerThread = kNlmMaxTileH * kNlmTileW / kNlmThreads;
// The half-row NLM kernel's block, from ops/stencils.py likewise: kHrwThreads
// threads own an output tile of kHrwTileW columns and up to kHrwMaxTileH
// rows, each thread one pixel pair (rows 2i, 2i+1) of one column, and keep
// the target's half-row cells of kHrwEPerThread squared-difference positions
// in registers. kHrwLanes is the 2p-lane box at patch radius 3.
constexpr int kHrwThreads = IDF_HRW_THREADS;
constexpr int kHrwTileW = IDF_HRW_TILE_W;
constexpr int kHrwMaxTileH = IDF_HRW_MAX_TILE_H;
constexpr int kHrwEPerThread = IDF_HRW_E_PER_THREAD;
constexpr int kHrwLanes = IDF_HRW_LANES;
constexpr int kHrwEW = kHrwTileW + kHrwLanes - 1;  // lanes of the e region
static_assert((kHrwMaxTileH / 2 + 4) * kHrwEW <= kHrwThreads * kHrwEPerThread,
              "the e region of the largest tile must fit the threads' registers");
static_assert(kHrwMaxTileH % 2 == 0 && kHrwThreads % kHrwTileW == 0 &&
                  kHrwMaxTileH / 2 <= kHrwThreads / kHrwTileW,
              "a thread owns one pixel pair of one column");
constexpr int kNormThreads = 256;  // the normalize kernel: one pixel a thread

struct Runs {
  int n;
  short dy0[kMaxRuns];
  short rows[kMaxRuns];
  short hw[kMaxRuns];
};

struct Cands {
  int n;
  signed char dy[kMaxCands];
  signed char dx[kMaxCands];
};

// Row pointer for tap row y: clamped to the image (CLAMP), or flagged as
// outside (ZERO), in which case every tap of the row reads zero.
template <bool ZERO>
__device__ __forceinline__ const float4* row_ptr(const float4* img, int y, int h,
                                                 int w, bool& ok) {
  if (ZERO) {
    ok = y >= 0 && y < h;
    return img + static_cast<size_t>(ok ? y : 0) * w;
  }
  ok = true;
  return img + static_cast<size_t>(min(max(y, 0), h - 1)) * w;
}

template <bool ZERO>
__device__ __forceinline__ float4 col_tap(const float4* row, bool row_ok, int x,
                                          int w) {
  if (ZERO) {
    if (!row_ok || x < 0 || x >= w) return make_float4(0.f, 0.f, 0.f, 0.f);
    return __ldg(row + x);
  }
  return __ldg(row + min(max(x, 0), w - 1));
}

// The exact bilateral's staged block, defined in ops/stencils.py and passed
// to nvcc as macros by ops/_build.py: a warp owns kBilTileW = 32 * kBilPx
// neighbouring pixels of one output row, each thread kBilPx of them side by
// side, and a block of th warps (th <= kBilMaxTileH) owns th such rows.
constexpr int kBilPx = IDF_BIL_PX;
constexpr int kBilTileW = 32 * kBilPx;
constexpr int kBilMaxTileH = IDF_BIL_MAX_TILE_H;
// exp2f's range test passes from this exponent up (bil_exp2).
constexpr float kBilExp2Min = IDF_BIL_EXP2_MIN;
static_assert(kBilPx % 2 == 1, "an odd stride of 16- or 8-byte pixels spreads a warp's loads "
                                "over the shared-memory banks");

// A pixel's RGB as the bf16 forms (bilateral, NLM) stage it: red and green
// in one bfloat162, blue and a zero in the other.
struct alignas(8) RgbBf16 {
  __nv_bfloat162 rg;
  __nv_bfloat162 b0;
};

__device__ __forceinline__ RgbBf16 to_rgb_bf16(float4 v) {
  return {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, 0.f)};
}

// A value tap as the bf16 forms accumulate it: the bf16 RGB widened, the
// float32 alpha beside it.
__device__ __forceinline__ float4 widen(RgbBf16 p, float alpha) {
  return make_float4(__low2float(p.rg), __high2float(p.rg), __low2float(p.b0), alpha);
}

// The colour distance ||c - t||^2 of the bilateral, as _bilateral_kernel
// computes it (stencils.py:253-261). Float32 in the operations ptxas emitted
// for the one-thread-a-pixel loop before any staging existed: dr*dr +
// round(dg*dg) in one fused multiply-add, the blue term added after its own
// rounding; the intrinsics pin them, so every instance computes those bits.
// The blue term is compiled out under blue_bug (a blue weight of 0 added
// 0 * db^2, exactly 0).
template <bool BLUE>
__device__ __forceinline__ float bil_sq_diff(float4 c, float4 t) {
  const float dr = __fsub_rn(c.x, t.x);
  const float dg = __fsub_rn(c.y, t.y);
  float e = __fmaf_rn(dr, dr, __fmul_rn(dg, dg));
  if constexpr (BLUE) {
    const float db = __fsub_rn(c.z, t.z);
    e = __fadd_rn(e, __fmul_rn(db, db));
  }
  return e;
}

// With bf16 taps (cdtype bfloat16): every operation rounds to bf16, in the
// order (dr*dr + dg*dg) + db*db, and the sum is widened to float32. Red and
// green go through one bfloat162 operation each, and the sum is lane 0 of
// the squares added to themselves swapped (bf16 addition commutes); each
// lane rounds as the scalar operation does.
template <bool BLUE>
__device__ __forceinline__ float bil_sq_diff(RgbBf16 c, RgbBf16 t) {
  const __nv_bfloat162 d = __hsub2_rn(c.rg, t.rg);
  const __nv_bfloat162 sq = __hmul2_rn(d, d);
  __nv_bfloat162 e = __hadd2_rn(sq, __lowhigh2highlow(sq));
  if constexpr (BLUE) {
    const __nv_bfloat162 db = __hsub2_rn(c.b0, t.b0);
    e = __hadd2_rn(e, __hmul2_rn(db, db));
  }
  return __low2float(e);
}

// Two pixels' centres, channel by channel, as the lanes of a bfloat162.
struct BilPair {
  __nv_bfloat162 r, g, b;
};

__device__ __forceinline__ BilPair bil_pair(RgbBf16 a, RgbBf16 b) {
  return {__lows2bfloat162(a.rg, b.rg), __highs2bfloat162(a.rg, b.rg),
          __lows2bfloat162(a.b0, b.b0)};
}

// The bf16 colour distance of two pixels at once: lane 0 is centre c.x
// against tap ta, lane 1 centre c.y against tap tb; the same roundings as
// the scalar form, lane by lane.
template <bool BLUE>
__device__ __forceinline__ float2 bil_sq_diff2(const BilPair& c, RgbBf16 ta, RgbBf16 tb) {
  const BilPair t = bil_pair(ta, tb);
  const __nv_bfloat162 dr = __hsub2_rn(c.r, t.r);
  const __nv_bfloat162 dg = __hsub2_rn(c.g, t.g);
  __nv_bfloat162 e = __hadd2_rn(__hmul2_rn(dr, dr), __hmul2_rn(dg, dg));
  if constexpr (BLUE) {
    const __nv_bfloat162 db = __hsub2_rn(c.b, t.b);
    e = __hadd2_rn(e, __hmul2_rn(db, db));
  }
  return __bfloat1622float2(e);
}

// exp2f, with its range test taken by the caller where it is known to pass.
// For x >= -126 exp2f is MUFU.EX2 of x itself (its SASS: FSETP.GEU x,
// -126, and the halving before and squaring after MUFU.EX2 only below it),
// which is what ex2.approx.ftz.f32 compiles to: the same bits.
template <bool IN_RANGE>
__device__ __forceinline__ float bil_exp2(float x) {
  if constexpr (IN_RANGE) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
  } else {
    return exp2f(x);
  }
}

// The rest of a tap, shared by both kernels and all forms: the weight
//   exp2(sp - ssd * col_coef),  sp = sp_coef * (dy^2 + dx^2),
// with log2(e) folded into both coefficients, then the weighted value into
// the accumulators (alpha only where it is accumulated). IN_RANGE: the
// exponent is known to be -126 or more (bil_exp2).
template <bool ALPHA, bool IN_RANGE = false>
__device__ __forceinline__ void bil_accumulate(float4& acc, float& nw, float ssd, float sp,
                                               float col_coef, float4 v) {
  const float wgt = bil_exp2<IN_RANGE>(__fmaf_rn(-ssd, col_coef, sp));
  acc.x = __fmaf_rn(v.x, wgt, acc.x);
  acc.y = __fmaf_rn(v.y, wgt, acc.y);
  acc.z = __fmaf_rn(v.z, wgt, acc.z);
  if constexpr (ALPHA) acc.w = __fmaf_rn(v.w, wgt, acc.w);
  nw = __fadd_rn(nw, wgt);
}

// The epilogue of both kernels: alpha from the norm where it is uniform
// (sum(w * a) == a * sum(w) when alpha is one constant everywhere), the
// fused normalize (IEEE division, no fast math: x / x is exactly 1), the
// stores.
__device__ __forceinline__ void bil_store(float4 acc, float nw, const float4* __restrict__ img,
                                          float4* __restrict__ out_wc, float* __restrict__ out_nw,
                                          size_t idx, bool uniform_alpha, bool fuse_normalize) {
  if (uniform_alpha) acc.w = __fmul_rn(img[idx].w, nw);
  if (fuse_normalize) {
    acc.x /= nw;
    acc.y /= nw;
    acc.z /= nw;
    acc.w /= nw;
  }
  out_wc[idx] = acc;
  if (out_nw != nullptr) out_nw[idx] = nw;
}

// Bilateral over the truncation disk.
//
// Replaces image_denoising_filter_tpu/ops/stencils.py:_bilateral_kernel
// (launched by _bilateral_planar). Weight of tap (dy, dx):
//   exp2(sp_coef * (dy^2 + dx^2) - col_coef * ||c - t||^2)
// with log2(e) folded into both coefficients; c and t come from the guide
// when GUIDED, and the values from img. Alpha is accumulated with the
// RGB-derived weight. With BF16 (TilingConfig.compute_dtype "bfloat16") the
// colour distance is bil_sq_diff's bf16 form and the accumulated RGB is the
// tap's RGB rounded to bf16; alpha, weights and sums stay float32.
//
// Bound on the H100: at the reference parameters the disk holds 499 taps, so
// a 1080p frame costs ~1.0 G taps. The least a tap needs is ~12 FP32
// operations and one exp2 (the spatial term and the loads shared); it is
// bound by instruction issue, not by device memory, which delivers the image
// about once. The staged kernel issues 13 instructions a tap (the distance
// 7: three subtracts, two products, a fused multiply-add and an add; the
// exponent 1; MUFU.EX2 1; the weighted colour 3, or 4 with alpha; the
// weight 1) and per step of three taps a load of the column and one of the
// spatial term, where the direct-load loop issues 25 (exp2f's range test,
// an int to float conversion, address arithmetic and a 16-byte L1 load a
// tap). Measured on an H100 80GB HBM3 at 700 W (tools/torch_kernel_ab.py):
// 0.63 ms at 1080p under uniform alpha, 2.0x its 0.31 ms bound, ~19 issue
// slots a tap at the 1.98 GHz SM clock; tools/bilateral_probe.py reads 0.05
// ms of it as staging and stores, 0.04 ms as MUFU.EX2 and 0.32 ms as the
// colour distance with the exponents it feeds.
//
// Design (bilateral_staged_kernel): a block of th warps owns th x kBilTileW
// output pixels (th from ops/stencils.py:bilateral_tile, 16 where the tile
// fits). It stages the tile plus the disk's halo in shared memory once, with
// the border policy applied as it stages (the clamped pixel, or a zero one),
// so no tap clamps or tests an index: the float32 forms copy whole 16-byte
// pixels with cp.async, the bf16 forms round RGB to bf16 once as they stage
// (8 bytes a pixel) and keep alpha as float32 only where it is accumulated.
// A thread owns kBilPx neighbouring pixels of one row. For each tap row dy
// it walks dx from -hw to hw: one step loads one new column of the row into
// a ring of kBilPx registers and the spatial term from a table the block
// computes once, and evaluates its pixels' taps, each pixel reading its
// column from the ring. Per pixel the taps come in _circle_runs order (dy
// ascending, then dx ascending) with the direct-load loop's operations, so
// the two give the same bits. A warp's load reads columns kBilPx apart,
// 16 (or 8) bytes each: an odd stride maps a quarter-warp (half-warp) to
// distinct banks. With bf16 taps pixels 2j and 2j + 1 take their colour
// distance as one bfloat162 chain, the last pixel with red and green
// paired. exp2f's range test (x >= -126, three of a tap's issue slots) is
// taken once a tap row: the block reduces its staged pixels' channel ranges
// to the largest colour distance any of its taps can have (the taps' own
// operations on the ranges; each is monotone), and a row whose farthest tap
// passes with that distance walks with bil_exp2<true>, the others with
// exp2f.
struct BilTile {
  int th, hy, hx;
  // byte offsets: the value taps (GUIDED: the target's pixels; the weight
  // source's are at 0), the float32 alpha plane (bf16 forms that accumulate
  // alpha), the spatial terms ((2 hy + 1) x (2 hx + 1) floats) and th x 6
  // floats for the block's channel ranges
  int vals_at, alpha_at, sp_at, range_at;
};
// The ints of a tile as the launcher takes them: BilTile's, then the bytes.
constexpr int kBilTileFields = 8;

template <bool BF16>
using BilPx = typename std::conditional<BF16, RgbBf16, float4>::type;

// One 16-byte pixel into shared memory, or 16 zero bytes (a copy of none).
__device__ __forceinline__ void cp_async_pixel(float4* dst, const float4* src, bool copy) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(at), "l"(src),
               "r"(copy ? 16 : 0));
}

template <bool GUIDED, bool BF16, bool UA, bool BLUE>
__global__ void __launch_bounds__(32 * kBilMaxTileH)
    bilateral_staged_kernel(const float4* __restrict__ img, const float4* __restrict__ guide,
                            float4* __restrict__ out_wc, float* __restrict__ out_nw, int h,
                            int w, const Runs runs, float sp_coef, float col_coef,
                            int zero_border, int fuse_normalize, const BilTile tile) {
  using Px = BilPx<BF16>;
  constexpr int N = kBilPx;
  extern __shared__ __align__(16) unsigned char bil_smem[];
  Px* wpx = reinterpret_cast<Px*>(bil_smem);
  Px* vpx = GUIDED ? reinterpret_cast<Px*>(bil_smem + tile.vals_at) : wpx;
  float* apx = reinterpret_cast<float*>(bil_smem + tile.alpha_at);
  const int sw = kBilTileW + 2 * tile.hx;
  const int n_staged = (tile.th + 2 * tile.hy) * sw;
  const int y0 = blockIdx.y * tile.th;
  const int x0 = blockIdx.x * kBilTileW;

  // The spatial terms of the disk's square, spw = 2 hx + 1 a row: entry
  // (dy + hy) * spw + dx + hx is sp_coef * dy^2 + sp_coef * dx^2 as the
  // direct-load loop computes it (one multiply a row, one fused multiply-add
  // a tap).
  float* sp_tab = reinterpret_cast<float*>(bil_smem + tile.sp_at);
  const int spw = 2 * tile.hx + 1;
  for (int i = threadIdx.x; i < (2 * tile.hy + 1) * spw; i += blockDim.x) {
    const int dy = i / spw - tile.hy;
    const int dx = i % spw - tile.hx;
    sp_tab[i] = __fmaf_rn(static_cast<float>(dx * dx), sp_coef,
                          __fmul_rn(sp_coef, static_cast<float>(dy * dy)));
  }
  // Staged pixel i is image pixel (y0 - hy + i / sw, x0 - hx + i % sw).
  const float4* wsrc = GUIDED ? guide : img;
  for (int i = threadIdx.x; i < n_staged; i += blockDim.x) {
    const int r = i / sw;
    const int yy = y0 - tile.hy + r;
    const int xx = x0 - tile.hx + i - r * sw;
    const bool inside = !zero_border || (yy >= 0 && yy < h && xx >= 0 && xx < w);
    const size_t at = static_cast<size_t>(min(max(yy, 0), h - 1)) * w + min(max(xx, 0), w - 1);
    if constexpr (BF16) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 wv = inside ? __ldg(wsrc + at) : zero;
      wpx[i] = to_rgb_bf16(wv);
      float4 vv = wv;
      if constexpr (GUIDED) {
        vv = inside ? __ldg(img + at) : zero;
        vpx[i] = to_rgb_bf16(vv);
      }
      if constexpr (!UA) apx[i] = vv.w;
    } else {
      cp_async_pixel(wpx + i, wsrc + at, inside);
      if constexpr (GUIDED) cp_async_pixel(vpx + i, img + at, inside);
    }
  }
  if constexpr (!BF16) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // This thread's pixels: row `row` of the tile, columns N * lane + i; the
  // staged index of pixel 0's own pixel is `centre`.
  const int lane = threadIdx.x & 31;
  const int row = threadIdx.x >> 5;
  const int centre = (row + tile.hy) * sw + N * lane + tile.hx;
  Px c[N];
  float4 acc[N];
  float nw[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c[i] = wpx[centre + i];
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    nw[i] = 0.f;
  }
  // With bf16 taps, pixels 2j and 2j + 1 as the lanes of one bfloat162.
  BilPair pairs[N / 2];
  if constexpr (BF16) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) pairs[j] = bil_pair(c[2 * j], c[2 * j + 1]);
  }

  // The largest colour distance of any tap of the block: that of its staged
  // channel ranges (hi - lo), computed as a tap computes its own.
  const float inf = __int_as_float(0x7f800000);
  float4 lo = make_float4(inf, inf, inf, 0.f);
  float4 hi = make_float4(-inf, -inf, -inf, 0.f);
  for (int i = threadIdx.x; i < n_staged; i += blockDim.x) {
    float4 v;
    if constexpr (BF16) {
      v = widen(wpx[i], 0.f);
    } else {
      v = wpx[i];
    }
    lo = make_float4(fminf(lo.x, v.x), fminf(lo.y, v.y), fminf(lo.z, v.z), 0.f);
    hi = make_float4(fmaxf(hi.x, v.x), fmaxf(hi.y, v.y), fmaxf(hi.z, v.z), 0.f);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    lo.x = fminf(lo.x, __shfl_xor_sync(0xffffffffu, lo.x, o));
    lo.y = fminf(lo.y, __shfl_xor_sync(0xffffffffu, lo.y, o));
    lo.z = fminf(lo.z, __shfl_xor_sync(0xffffffffu, lo.z, o));
    hi.x = fmaxf(hi.x, __shfl_xor_sync(0xffffffffu, hi.x, o));
    hi.y = fmaxf(hi.y, __shfl_xor_sync(0xffffffffu, hi.y, o));
    hi.z = fmaxf(hi.z, __shfl_xor_sync(0xffffffffu, hi.z, o));
  }
  float* ranges = reinterpret_cast<float*>(bil_smem + tile.range_at);
  if (lane == 0) {
    float* mine = ranges + 6 * row;
    mine[0] = lo.x, mine[1] = lo.y, mine[2] = lo.z;
    mine[3] = hi.x, mine[4] = hi.y, mine[5] = hi.z;
  }
  __syncthreads();
  for (int wr = 0; wr < tile.th; ++wr) {
    const float* theirs = ranges + 6 * wr;
    lo = make_float4(fminf(lo.x, theirs[0]), fminf(lo.y, theirs[1]), fminf(lo.z, theirs[2]), 0.f);
    hi = make_float4(fmaxf(hi.x, theirs[3]), fmaxf(hi.y, theirs[4]), fmaxf(hi.z, theirs[5]), 0.f);
  }
  float ssd_max;
  if constexpr (BF16) {
    ssd_max = bil_sq_diff<BLUE>(to_rgb_bf16(hi), to_rgb_bf16(lo));
  } else {
    ssd_max = bil_sq_diff<BLUE>(hi, lo);
  }

  for (int r = 0; r < runs.n; ++r) {
    const int hw = runs.hw[r];
    const int n_steps = 2 * hw + 1;
    const int n_groups = n_steps / N;
    const int rem = n_steps - n_groups * N;
    const int dy_end = runs.dy0[r] + runs.rows[r];
    for (int dy = runs.dy0[r]; dy < dy_end; ++dy) {
      // Step s (dx = s - hw) gives pixel i the staged column first + s + i:
      // ring slot (s + i) % N; it loads column first + s + N - 1, and the
      // spatial term sp_row[s].
      const int first = centre + dy * sw - hw;
      const float* sp_row = sp_tab + (dy + tile.hy) * spw + tile.hx - hw;
      auto walk = [&](auto in_range) {
        constexpr bool kInRange = decltype(in_range)::value;
        Px ring[N];
        float4 vring[N];
        auto load = [&](int slot, int at) {
          ring[slot] = wpx[at];
          if constexpr (BF16) {
            vring[slot] = widen(GUIDED ? vpx[at] : ring[slot], UA ? 0.f : apx[at]);
          } else if constexpr (GUIDED) {
            vring[slot] = vpx[at];
          } else {
            vring[slot] = ring[slot];
          }
        };
        auto step = [&](int k, int at, float sp) {
          load((k + N - 1) % N, at);
          float ssd[N];
          if constexpr (BF16) {
#pragma unroll
            for (int j = 0; j < N / 2; ++j) {
              const float2 e = bil_sq_diff2<BLUE>(pairs[j], ring[(k + 2 * j) % N],
                                                  ring[(k + 2 * j + 1) % N]);
              ssd[2 * j] = e.x;
              ssd[2 * j + 1] = e.y;
            }
            ssd[N - 1] = bil_sq_diff<BLUE>(c[N - 1], ring[(k + N - 1) % N]);
          } else {
#pragma unroll
            for (int i = 0; i < N; ++i) ssd[i] = bil_sq_diff<BLUE>(c[i], ring[(k + i) % N]);
          }
#pragma unroll
          for (int i = 0; i < N; ++i)
            bil_accumulate<!UA, kInRange>(acc[i], nw[i], ssd[i], sp, col_coef,
                                          vring[(k + i) % N]);
        };
#pragma unroll
        for (int j = 0; j < N - 1; ++j) load(j, first + j);
        int at = first + N - 1;
        const float* sp = sp_row;
        for (int g = 0; g < n_groups; ++g) {
#pragma unroll
          for (int k = 0; k < N; ++k) step(k, at + k, sp[k]);
          at += N;
          sp += N;
        }
#pragma unroll
        for (int k = 0; k < N - 1; ++k)
          if (k < rem) step(k, at + k, sp[k]);
      };
      // The row's farthest taps (dx = +-hw) have its least spatial term; with
      // the block's largest distance their exponent bounds every tap's
      // (ops/stencils.py:bilateral_row_walks mirrors the test). An infinite
      // range makes the bound -inf: the row takes exp2f.
      if (__fmaf_rn(-ssd_max, col_coef, sp_row[0]) >= kBilExp2Min) {
        walk(std::true_type{});
      } else {
        walk(std::false_type{});
      }
    }
  }
  const int y = y0 + row;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int x = x0 + N * lane + i;
    if (y < h && x < w)
      bil_store(acc[i], nw[i], img, out_wc, out_nw, static_cast<size_t>(y) * w + x, UA,
                fuse_normalize);
  }
}

// The direct-load instance: one thread a pixel, every tap loaded from device
// memory through L1 with the border applied per tap. No shared memory, so
// it takes every radius of the runs table; bilateral_tile picks it where no
// staged tile of the radius fits the card's shared memory. The same
// operations as the staged kernel, tap by tap.
template <bool GUIDED, bool ZERO, bool BF16>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    bilateral_kernel(const float4* __restrict__ img, const float4* __restrict__ guide,
                     float4* __restrict__ out_wc, float* __restrict__ out_nw, int h,
                     int w, const Runs runs, float sp_coef, float col_coef, int blue_bug,
                     int uniform_alpha, int fuse_normalize) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const float4* wsrc = GUIDED ? guide : img;
  const size_t idx = static_cast<size_t>(y) * w + x;
  const float4 c = wsrc[idx];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float nw = 0.f;
  for (int r = 0; r < runs.n; ++r) {
    const int hw = runs.hw[r];
    const int dy_end = runs.dy0[r] + runs.rows[r];
    for (int dy = runs.dy0[r]; dy < dy_end; ++dy) {
      bool ok;
      const float4* grow = row_ptr<ZERO>(wsrc, y + dy, h, w, ok);
      const float4* vrow = GUIDED ? row_ptr<ZERO>(img, y + dy, h, w, ok) : grow;
      const float row_term = __fmul_rn(sp_coef, static_cast<float>(dy * dy));
      for (int dx = -hw; dx <= hw; ++dx) {
        const float4 g = col_tap<ZERO>(grow, ok, x + dx, w);
        float4 v = GUIDED ? col_tap<ZERO>(vrow, ok, x + dx, w) : g;
        float ssd;
        if constexpr (BF16) {
          ssd = blue_bug ? bil_sq_diff<false>(to_rgb_bf16(c), to_rgb_bf16(g))
                         : bil_sq_diff<true>(to_rgb_bf16(c), to_rgb_bf16(g));
          v = widen(to_rgb_bf16(v), v.w);
        } else {
          ssd = blue_bug ? bil_sq_diff<false>(c, g) : bil_sq_diff<true>(c, g);
        }
        const float sp = __fmaf_rn(static_cast<float>(dx * dx), sp_coef, row_term);
        bil_accumulate<true>(acc, nw, ssd, sp, col_coef, v);
      }
    }
  }
  bil_store(acc, nw, img, out_wc, out_nw, idx, uniform_alpha, fuse_normalize);
}

// The RGB squared difference e = |t - n|^2 of two pixels, in float32, or
// with bf16 taps (TilingConfig.compute_dtype "bfloat16", the turbo NLM): as
// the TPU kernel with cdtype bfloat16 (stencils.py:532-534, 560-563), target
// and neighbour RGB are rounded to bf16, and d = t - n, d*d and the two adds
// each round to bf16, in the order d0*d0 + d1*d1 + d2*d2; the sum is
// widened to float32 before the patch sum and the exp2. One bf16 intrinsic
// an operation, so the kernel rounds where its plain version does: the _rn
// forms (add.rn / sub.rn / mul.rn.bf16), since ptxas may contract a plain
// __hmul and __hadd into one fused multiply-add with one rounding fewer.
// Value taps and accumulators stay float32.
__device__ __forceinline__ float sq_diff(float4 t, float4 n) {
  const float d0 = t.x - n.x;
  const float d1 = t.y - n.y;
  const float d2 = t.z - n.z;
  return d0 * d0 + d1 * d1 + d2 * d2;
}

// The sliding NLM body's bf16 taps: red and green go through their
// difference and square as one bfloat162, each half rounded as its scalar
// operation would round it.
__device__ __forceinline__ float sq_diff(RgbBf16 t, RgbBf16 n) {
  const __nv_bfloat162 d01 = __hsub2_rn(t.rg, n.rg);
  const __nv_bfloat162 s01 = __hmul2_rn(d01, d01);
  const __nv_bfloat16 d2 = __hsub_rn(__low2bfloat16(t.b0), __low2bfloat16(n.b0));
  const __nv_bfloat16 e = __hadd_rn(__low2bfloat16(s01), __high2bfloat16(s01));
  return __bfloat162float(__hadd_rn(e, __hmul_rn(d2, d2)));
}

// The staged NLM bodies' bf16 taps (nlm_wide_kernel, nlm_hrw_kernel): four
// bf16 and scalar operations, the same bits. The half-row kernel ran ~10%
// slower with RgbBf16 taps (tools/torch_kernel_ab.py, nlm_hrw_bf16).
struct alignas(8) Bf16x4 {
  __nv_bfloat16 x, y, z, w;
};

__device__ __forceinline__ Bf16x4 to_bf16x4(float4 v) {
  return {__float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y), __float2bfloat16_rn(v.z),
          __float2bfloat16_rn(0.f)};
}

__device__ __forceinline__ float sq_diff(Bf16x4 t, Bf16x4 n) {
  const __nv_bfloat16 d0 = __hsub_rn(t.x, n.x);
  const __nv_bfloat16 d1 = __hsub_rn(t.y, n.y);
  const __nv_bfloat16 d2 = __hsub_rn(t.z, n.z);
  const __nv_bfloat16 e = __hadd_rn(__hmul_rn(d0, d0), __hmul_rn(d1, d1));
  return __bfloat162float(__hadd_rn(e, __hmul_rn(d2, d2)));
}

// A pixel as the squared difference reads it: float4, or its RGB in bf16,
// in the sliding body's form and in the staged bodies'.
template <bool BF16>
using NlmTap = typename std::conditional<BF16, RgbBf16, float4>::type;
template <bool BF16>
using StagedTap = typename std::conditional<BF16, Bf16x4, float4>::type;

template <typename Tap>
__device__ __forceinline__ Tap nlm_tap(float4 v) {
  if constexpr (std::is_same<Tap, RgbBf16>::value) {
    return to_rgb_bf16(v);
  } else if constexpr (std::is_same<Tap, Bf16x4>::value) {
    return to_bf16x4(v);
  } else {
    return v;
  }
}

// Frame-batched NLM accumulation.
//
// Replaces image_denoising_filter_tpu/ops/stencils.py:_nlm_kernel (launched
// by _nlm_planar_frames; its weights_halfres body is nlm_hrw_kernel's). The
// TPU's sequential frame grid axis becomes the loop over frames here, with
// the accumulators in registers. For every candidate (dy, dx) of the table,
// the patch SSD is the 2p x 2p box sum of the RGB squared difference e
// (patch offsets [-p, p)^2); the weight is exp2(ssd_coef * SSD + bias), with
// bias log2(stride^2) for every candidate but the self match (0 when stride
// is 1). Each frame seeds nw with norm_seed, and the frame's partial, seed
// included, is scaled by valid[f]. Both bodies below add each box pass's 2p
// terms in the plain version's order (ops/eager.py:_box_sum: rows, then
// lanes), so the SSD matches nlm_plain's up to the contraction of e's own
// multiply-adds; at a radius both can take, the sliding body's outputs are
// the staged body's bit for bit (tools/torch_kernel_ab.py against the tree
// whose staged body took every radius).
//
// Bound on the H100: chip_smoke.py's kernel_work counts 24 operations a
// candidate, pixel and frame with the box sums (e 8, two running sums 4,
// exponent and exp2 3, weighted colour 8, weight 1): at the reference
// parameters a 1080p frame is 196 x 2.07 M candidate-pixels, 9.8 GFLOP,
// 0.146 ms at 67 TFLOP/s. The kernel does more: each box pass adds 2p - 1
// terms a sum in the plain version's order, where running sums would add
// two, and e is computed over the patch halo as well.
//
// The staged window. A block owns an output tile of th x tw pixels (from
// ops/stencils.py:nlm_tile) and makes one pass over the frames. Per frame it
// stages the neighbour window, the tile plus the search and patch halo ((th +
// 2p - 1 + dy range) x (tw + 2p - 1 + dx range) pixels, rows `pitch` pixels
// apart), in shared memory, applying the border policy (index clamp, or a
// zero pixel) as it stages, and with bf16 taps also the window's RGB rounded
// to bf16. Candidate (dy, dx) reads e(r, c)'s neighbour at window index (r +
// dy - dy_min) * pitch + c + dx - dx_min and output (i, j)'s value tap at
// (i + p + dy - dy_min) * pitch + j + p + dx - dx_min.
//
// NlmTile is nlm_tile's: the window's geometry and the byte offsets of the
// regions of nlm_layout, each body's own beside the window.
struct NlmTile {
  int th, tw, oy, ox, win_h, win_w, pitch;
  // byte offsets: the window's bf16 RGB (the window itself with float32
  // taps); the sliding body's frame sums; the staged body's target taps, e
  // and row sums
  int taps_at, sums_at, tgt_at, e_at, rows_at;
};
// The ints of a tile as the launcher takes them: NlmTile's, then the bytes.
constexpr int kNlmTileFields = 13;

// Stages frame `nbr`'s window for the block at (y0, x0): pixel (i, j) of the
// win_h x win_w window at index i * pitch + j.
template <bool ZERO, typename Tap>
__device__ __forceinline__ void nlm_stage(const float4* __restrict__ nbr, int h, int w, int y0,
                                          int x0, const NlmTile& tile, float4* win,
                                          Tap* win_taps) {
  const int n_win = tile.win_h * tile.win_w;
  for (int i = threadIdx.x; i < n_win; i += blockDim.x) {
    const int wr = i / tile.win_w;
    const int wc = i - wr * tile.win_w;
    bool ok;
    const float4* row = row_ptr<ZERO>(nbr, y0 + tile.oy + wr, h, w, ok);
    const float4 v = col_tap<ZERO>(row, ok, x0 + tile.ox + wc, w);
    win[wr * tile.pitch + wc] = v;
    if constexpr (!std::is_same<Tap, float4>::value)
      win_taps[wr * tile.pitch + wc] = nlm_tap<Tap>(v);
  }
}

__device__ __forceinline__ float nlm_bias(int dy, int dx, float log_m) {
  return (dy != 0 || dx != 0) ? log_m : 0.f;
}

// The sliding body, patch radius P of 1 to kNlmRegisterPatch (the staged
// body below takes the wider radii).
//
// What bounded the staged body on this card was shared memory: per 16 x 32
// tile and candidate at p = 3 it moved ~400 wavefronts of 128 bytes (e
// written and read back, the row sums written and read back, the value
// taps), with two barriers a candidate, and took ~607 cycles a tile and
// candidate on each SM. Here only the staged window (and each thread's sums
// of the frames so far) is in shared memory, written once a frame with one
// barrier after it; the candidate loop keeps everything else in registers
// and warp shuffles:
//   - lane l of a warp is e row l (target row y0 - P + l) and owns output
//     row l (the first kRows = 33 - 2P lanes; the rest complete the patches
//     of the rows above them) at kNlmSeg columns: its e positions are a row
//     segment of kW = kNlmSeg + 2P - 1 columns;
//   - the target's taps of those positions stay in registers for the call
//     (tv), and the window's taps of the current candidate in a ring of kW
//     registers: nlm_candidates orders the candidates dy-major with dx
//     rising, so a candidate dx - dx' columns right of the one before it
//     in the same row loads only that many new taps into the ring (one
//     LDS a stride), and any other candidate reloads the ring. The ring
//     turns by one slot a column; the loop is unrolled over a whole turn,
//     so every register index is static;
//   - the row pass sums e over lanes l .. l + 2P - 1 of each column through
//     __shfl_down_sync, top to bottom, the lane pass 2P row sums left to
//     right in the thread, then exp2, one value tap (LDS.128 of the
//     window) and five multiply-adds an output.
// Every branch of the loop is warp-uniform (the table, the counters), so
// the shuffles need no divergence handling; a warp whose columns lie past
// the image computes them all the same.
//
// What bounds it: the shared-memory pipe, which serves one SHFL or 128
// bytes of LDS a cycle on each SM. Per warp and candidate at P = 3 and
// kNlmSeg 8 (13 columns, 27 x 8 outputs): 65 SHFL, 8 LDS.128 value taps and
// one LDS of the ring, ~101 pipe cycles, against ~350 issued instructions
// (78 for e, 65 + 65 for the row pass, 40 lane adds, 40 for the weights, 40
// multiply-adds, the loop), ~88 cycles of issue on the SM's four
// schedulers: per 27 x 32 tile and candidate ~404 pipe cycles. Measured on
// an H100 80GB HBM3 (700 W, SM clock 1980 MHz by nvidia-smi;
// tools/torch_kernel_ab.py): ~630 cycles a tile and candidate on each SM
// (~375 per 512 outputs, against the staged body's ~607), 2 blocks of 4
// warps a SM with float32 taps (221 registers), 3 with bf16 taps (167),
// no spills. kNlmSeg 8 took the least time of 2, 4, 6, 8, 10 and 12 at
// both tap forms together (tools/nlm_slide_sweep.py): a wider segment
// shares each column's 2P - 1 shuffles among more outputs, and past 8 the
// registers cut the warps a SM.
// The window's pitch is odd, so a warp's lanes, one row apart, load
// 16-byte (8-byte) taps from distinct banks.
template <int P, bool BF16>
__device__ __forceinline__ void nlm_candidate(const NlmTap<BF16> (&tv)[kNlmSeg + 2 * P - 1],
                                              const NlmTap<BF16> (&ring)[kNlmSeg + 2 * P - 1],
                                              int rot, const float4* vwin, float bias,
                                              float ssd_coef, float4 (&acc)[kNlmSeg],
                                              float (&nw)[kNlmSeg]) {
  constexpr int kBox = 2 * P;
  constexpr int kW = kNlmSeg + kBox - 1;
  // 1. e of each column of the segment, 2. the row pass
  float rs[kW];
#pragma unroll
  for (int c = 0; c < kW; ++c) {
    const float e = sq_diff(tv[c], ring[(c + rot) % kW]);
    float s = e;
#pragma unroll
    for (int i = 1; i < kBox; ++i) s += __shfl_down_sync(0xffffffffu, e, i);
    rs[c] = s;
  }
  // 3. the lane pass, weight and value tap
#pragma unroll
  for (int j = 0; j < kNlmSeg; ++j) {
    float ssd = rs[j];
#pragma unroll
    for (int i = 1; i < kBox; ++i) ssd += rs[j + i];
    const float wgt = exp2f(ssd * ssd_coef + bias);
    const float4 v = vwin[j];
    acc[j].x += v.x * wgt;
    acc[j].y += v.y * wgt;
    acc[j].z += v.z * wgt;
    acc[j].w += v.w * wgt;
    nw[j] += wgt;
  }
}

// The columns the ring turns by to reach candidate k from (dy, dx): dx[k] -
// dx in the same row, 1 to kW - 1; 0 where candidate k reloads the ring or
// the table ends.
template <int kW>
__device__ __forceinline__ int nlm_slide(const Cands& cands, int k, int dy, int dx) {
  if (k >= cands.n || cands.dy[k] != dy) return 0;
  const int step = cands.dx[k] - dx;
  return step > 0 && step < kW ? step : 0;
}

template <int P, bool ZERO, bool BF16>
__global__ void __launch_bounds__(kNlmSlideThreads, kNlmMinBlocks)
    nlm_kernel(const float4* __restrict__ tgt, const float4* __restrict__ frames,
               const float* __restrict__ valid, float4* __restrict__ out_wc,
               float* __restrict__ out_nw, int h, int w, int n_frames, int patch,
               const Cands cands, float ssd_coef, float log_m, float norm_seed,
               int uniform_alpha, const NlmTile tile) {
  using Tap = NlmTap<BF16>;
  constexpr int kRows = 33 - 2 * P;
  constexpr int kW = kNlmSeg + 2 * P - 1;
  extern __shared__ __align__(16) unsigned char nlm_smem[];
  float4* win = reinterpret_cast<float4*>(nlm_smem);
  Tap* win_taps = reinterpret_cast<Tap*>(nlm_smem + tile.taps_at);
  // The frames' sums so far of this thread's outputs: output j's at [j *
  // blockDim.x], read and written by this thread alone.
  float4* sum_wc = reinterpret_cast<float4*>(nlm_smem + tile.sums_at) + threadIdx.x;
  float* sum_nw = reinterpret_cast<float*>(nlm_smem + tile.sums_at +
                                           16 * kNlmSeg * blockDim.x) + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const int y0 = blockIdx.y * kRows;
  const int x0 = blockIdx.x * tile.tw;
  const int seg = threadIdx.x / 32 * kNlmSeg;  // the warp's first column in the tile
  const int y = y0 + lane;
  const int dy_min = tile.oy + P;
  const int dx_min = tile.ox + P;
  const size_t plane = static_cast<size_t>(h) * w;

  // e(lane, c) pairs target pixel (y0 - P + lane, x0 + seg - P + c) with the
  // window tap at e_at + (dy - dy_min) * pitch + dx - dx_min + c.
  Tap tv[kW];
  {
    bool ok;
    const float4* row = row_ptr<ZERO>(tgt, y0 - P + lane, h, w, ok);
#pragma unroll
    for (int c = 0; c < kW; ++c) tv[c] = nlm_tap<Tap>(col_tap<ZERO>(row, ok, x0 + seg - P + c, w));
  }
  const int e_at = lane * tile.pitch + seg;
  // output (lane, j)'s value tap at v_at + (dy - dy_min) * pitch + dx -
  // dx_min + j (the lanes past the output rows read the last output row's,
  // inside the window); the self match's is the neighbour's own pixel
  const int v_at = (min(lane, kRows - 1) + P) * tile.pitch + seg + P;
  const int self_at = v_at - dy_min * tile.pitch - dx_min;
#pragma unroll
  for (int j = 0; j < kNlmSeg; ++j) {
    sum_wc[j * blockDim.x] = make_float4(0.f, 0.f, 0.f, 0.f);
    sum_nw[j * blockDim.x] = 0.f;
  }

  for (int f = 0; f < n_frames; ++f) {
    __syncthreads();  // the previous frame's last window reads are done
    nlm_stage<ZERO>(frames + f * plane, h, w, y0, x0, tile, win, win_taps);
    __syncthreads();
    float4 acc[kNlmSeg];
    float nw[kNlmSeg];
#pragma unroll
    for (int j = 0; j < kNlmSeg; ++j) {
      acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      nw[j] = norm_seed;
    }
    for (int k = 0; k < cands.n;) {
      // A run of candidates: load the ring at candidate k, then slide it.
      const int dy = cands.dy[k];
      int dx = cands.dx[k];
      const int row_off = (dy - dy_min) * tile.pitch - dx_min;
      const Tap* next = win_taps + e_at + row_off + dx;
      Tap ring[kW];
#pragma unroll
      for (int c = 0; c < kW; ++c) ring[c] = next[c];
      next += kW;
      nlm_candidate<P, BF16>(tv, ring, 0, win + v_at + row_off + dx,
                                   nlm_bias(dy, dx, log_m), ssd_coef, acc, nw);
      int step = nlm_slide<kW>(cands, ++k, dy, dx);
      while (step > 0) {
        // One turn of the ring: after u more columns, e column c's tap is
        // in slot (c + u) % kW.
#pragma unroll
        for (int u = 1; u <= kW; ++u) {
          if (step > 0) {
            ring[(u - 1) % kW] = *next++;
            if (--step == 0) {
              dx = cands.dx[k];
              nlm_candidate<P, BF16>(tv, ring, u % kW, win + v_at + row_off + dx,
                                           nlm_bias(dy, dx, log_m), ssd_coef, acc, nw);
              step = nlm_slide<kW>(cands, ++k, dy, dx);
            }
          }
        }
      }
    }
    const float vf = valid[f];
#pragma unroll
    for (int j = 0; j < kNlmSeg; ++j) {
      // This frame's tap alphas are one constant a: sum(w * a) = a * (nw -
      // seed); the seed is not alpha-weighted.
      if (uniform_alpha && lane < kRows && y < h && x0 + seg + j < w)
        acc[j].w = win[self_at + j].w * (nw[j] - norm_seed);
      float4 total = sum_wc[j * blockDim.x];
      total.x += acc[j].x * vf;
      total.y += acc[j].y * vf;
      total.z += acc[j].z * vf;
      total.w += acc[j].w * vf;
      sum_wc[j * blockDim.x] = total;
      sum_nw[j * blockDim.x] += nw[j] * vf;
    }
  }
#pragma unroll
  for (int j = 0; j < kNlmSeg; ++j) {
    const int x = x0 + seg + j;
    if (lane < kRows && y < h && x < w) {
      const size_t idx = static_cast<size_t>(y) * w + x;
      out_wc[idx] = sum_wc[j * blockDim.x];
      out_nw[idx] = sum_nw[j * blockDim.x];
    }
  }
}

// The staged body, for patch radii above kNlmRegisterPatch: the radius
// `patch` at run time. A block of kNlmThreads threads owns a tile of th x
// kNlmTileW outputs (th from NLM_TILE_HS, 16 where the window fits); the
// target's taps over the e region, tile plus patch halo, are staged once a
// block. Per candidate, with two barriers:
//   1. e once per position of the (th + 2p - 1) x (kNlmTileW + 2p - 1)
//      region, into shared memory;
//   2. the row pass: each row sum adds 2p values of e, top to bottom;
//   3. the lane pass: each output adds 2p row sums left to right, then
//      exp2, one value tap from the window and five multiply-adds.
template <bool ZERO, bool BF16>
__global__ void __launch_bounds__(kNlmThreads)
    nlm_wide_kernel(const float4* __restrict__ tgt, const float4* __restrict__ frames,
                    const float* __restrict__ valid, float4* __restrict__ out_wc,
                    float* __restrict__ out_nw, int h, int w, int n_frames, int patch,
                    const Cands cands, float ssd_coef, float log_m, float norm_seed,
                    int uniform_alpha, const NlmTile tile) {
  using Tap = StagedTap<BF16>;
  const int p = patch;
  const int box = 2 * patch;
  const int e_w = kNlmTileW + box - 1;
  const int th = tile.th;
  const int pitch = tile.pitch;
  extern __shared__ __align__(16) unsigned char nlm_smem[];
  const int e_h = th + box - 1;
  const int n_e = e_h * e_w;
  float4* win = reinterpret_cast<float4*>(nlm_smem);
  Tap* win_taps = reinterpret_cast<Tap*>(nlm_smem + tile.taps_at);
  Tap* tgt_taps = reinterpret_cast<Tap*>(nlm_smem + tile.tgt_at);
  float* e_buf = reinterpret_cast<float*>(nlm_smem + tile.e_at);
  float* row_buf = reinterpret_cast<float*>(nlm_smem + tile.rows_at);

  const int t = threadIdx.x;
  const int y0 = blockIdx.y * th;
  const int x0 = blockIdx.x * kNlmTileW;
  // Window index of candidate (dy, dx) relative to (dy_min, dx_min):
  // off = (dy - dy_min) * pitch + dx - dx_min.
  const int dy_min = tile.oy + p;
  const int dx_min = tile.ox + p;
  const size_t plane = static_cast<size_t>(h) * w;

  // The target's e positions: e(r, c) pairs target pixel (y0 - p + r,
  // x0 - p + c) with the window's pixel r * pitch + c + off.
  for (int pos = t; pos < n_e; pos += kNlmThreads) {
    const int r = pos / e_w;
    bool ok;
    const float4* row = row_ptr<ZERO>(tgt, y0 - p + r, h, w, ok);
    tgt_taps[pos] = nlm_tap<Tap>(col_tap<ZERO>(row, ok, x0 - p + pos - r * e_w, w));
  }
  // This thread's outputs: rows (t / kNlmTileW) + q * (kNlmThreads /
  // kNlmTileW) of column t % kNlmTileW, the value tap of candidate (dy, dx)
  // at window index o_win + off.
  const int ocol = t % kNlmTileW;
  int o_win[kNlmOutPerThread];
  float4 total[kNlmOutPerThread];
  float total_nw[kNlmOutPerThread];
#pragma unroll
  for (int q = 0; q < kNlmOutPerThread; ++q) {
    const int orow = t / kNlmTileW + q * (kNlmThreads / kNlmTileW);
    o_win[q] = (orow + p) * pitch + ocol + p;
    total[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    total_nw[q] = 0.f;
  }

  for (int f = 0; f < n_frames; ++f) {
    const float4* nbr = frames + f * plane;
    __syncthreads();  // the previous frame's last window reads are done
    nlm_stage<ZERO>(nbr, h, w, y0, x0, tile, win, win_taps);
    __syncthreads();
    float4 acc[kNlmOutPerThread];
    float nw[kNlmOutPerThread];
#pragma unroll
    for (int q = 0; q < kNlmOutPerThread; ++q) {
      acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      nw[q] = norm_seed;
    }
    for (int k = 0; k < cands.n; ++k) {
      const int dy = cands.dy[k];
      const int dx = cands.dx[k];
      const int off = (dy - dy_min) * pitch + dx - dx_min;
      // 1. e over the tile and its patch halo.
      for (int pos = t; pos < n_e; pos += kNlmThreads) {
        const int r = pos / e_w;
        e_buf[pos] = sq_diff(tgt_taps[pos], win_taps[r * pitch + pos - r * e_w + off]);
      }
      __syncthreads();
      // 2. Row pass: rs(r, c) = e(r, c) + e(r + 1, c) + ... + e(r + 2p - 1,
      // c), added in that order; task = r * e_w + c indexes both.
      for (int task = t; task < th * e_w; task += kNlmThreads) {
        float rs = e_buf[task];
        for (int j = 1; j < box; ++j) rs += e_buf[task + j * e_w];
        row_buf[task] = rs;
      }
      __syncthreads();
      // 3. Lane pass, weight and value tap. The next candidate's e and row
      // sums are written only after the barriers that follow these reads.
      const float bias = nlm_bias(dy, dx, log_m);
#pragma unroll
      for (int q = 0; q < kNlmOutPerThread; ++q) {
        const int orow = t / kNlmTileW + q * (kNlmThreads / kNlmTileW);
        if (orow < th) {
          const float* rs = row_buf + orow * e_w + ocol;
          float ssd = rs[0];
#pragma unroll
          for (int j = 1; j < box; ++j) ssd += rs[j];
          const float wgt = exp2f(ssd * ssd_coef + bias);
          const float4 v = win[o_win[q] + off];
          acc[q].x += v.x * wgt;
          acc[q].y += v.y * wgt;
          acc[q].z += v.z * wgt;
          acc[q].w += v.w * wgt;
          nw[q] += wgt;
        }
      }
    }
    const float vf = valid[f];
#pragma unroll
    for (int q = 0; q < kNlmOutPerThread; ++q) {
      const int y = y0 + t / kNlmTileW + q * (kNlmThreads / kNlmTileW);
      const int x = x0 + ocol;
      // This frame's tap alphas are one constant a: sum(w * a) = a * (nw -
      // seed); the seed is not alpha-weighted.
      if (uniform_alpha && y < h && x < w)
        acc[q].w = nbr[static_cast<size_t>(y) * w + x].w * (nw[q] - norm_seed);
      total[q].x += acc[q].x * vf;
      total[q].y += acc[q].y * vf;
      total[q].z += acc[q].z * vf;
      total[q].w += acc[q].w * vf;
      total_nw[q] += nw[q] * vf;
    }
  }
#pragma unroll
  for (int q = 0; q < kNlmOutPerThread; ++q) {
    const int orow = t / kNlmTileW + q * (kNlmThreads / kNlmTileW);
    const int y = y0 + orow;
    const int x = x0 + ocol;
    if (orow < th && y < h && x < w) {
      const size_t idx = static_cast<size_t>(y) * w + x;
      out_wc[idx] = total[q];
      out_nw[idx] = total_nw[q];
    }
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Half-row cell ci of an image at column x, as the half-row NLM's weight path
// reads it: 0.5 * (row 2ci + row 2ci+1), the rows and columns past the image
// given by the border policy (edge pixels, or zero pixels). Every cell before
// -1 equals cell -1 and every cell past hc = ceil(h / 2) equals cell hc under
// either policy, so ci is clamped into [-1, hc] first. With BF16, as the TPU
// kernel's bf16 pool matmul rounds them (stencils.py:727-742): bf16(0.5 *
// (bf16(a) + bf16(b))), the sum in float32, returned as the bf16 tap. Alpha
// is not pooled (zero).
template <bool ZERO, bool BF16>
__device__ __forceinline__ StagedTap<BF16> half_row_cell(const float4* __restrict__ img, int ci,
                                                     int x, int h, int w, int hc) {
  ci = min(max(ci, -1), hc);
  bool ok_a, ok_b;
  const float4 a = col_tap<ZERO>(row_ptr<ZERO>(img, 2 * ci, h, w, ok_a), ok_a, x, w);
  const float4 b = col_tap<ZERO>(row_ptr<ZERO>(img, 2 * ci + 1, h, w, ok_b), ok_b, x, w);
  if constexpr (BF16) {
    return {__float2bfloat16_rn(__fmul_rn(0.5f, __fadd_rn(bf16_round(a.x), bf16_round(b.x)))),
            __float2bfloat16_rn(__fmul_rn(0.5f, __fadd_rn(bf16_round(a.y), bf16_round(b.y)))),
            __float2bfloat16_rn(__fmul_rn(0.5f, __fadd_rn(bf16_round(a.z), bf16_round(b.z)))),
            __float2bfloat16_rn(0.f)};
  } else {
    return make_float4(__fmul_rn(0.5f, __fadd_rn(a.x, b.x)), __fmul_rn(0.5f, __fadd_rn(a.y, b.y)),
                       __fmul_rn(0.5f, __fadd_rn(a.z, b.z)), 0.f);
  }
}

// Frame-batched NLM accumulation with the weights at half row resolution
// (NlmParams.weights_halfres; search stride 2, patch radius 3).
//
// Replaces image_denoising_filter_tpu/ops/stencils.py:_nlm_hrw_kernel (the
// weights_halfres body of _nlm_planar_frames). For each candidate (dy, dx),
// dy even, the weight cells live on the half-row lattice: cell c of the
// target's and the neighbour's half-row cells (half_row_cell) give the RGB
// squared difference e(c, x') = |t(c, x') - n(c + dy/2, x' + dx)|^2
// (nlm_kernel's, bf16 taps included), summed over the 3 cells c-1, c, c+1
// in that order, then over the 6 lanes x-3 .. x+2 left to right, and
//   w(c) = exp2(ssd_coef * ssd(c)),  ssd_coef = -kappa log2(e) / h^2,
// kappa = 2; with BF16 each weight cell is rounded to bf16 (the TPU kernel's
// wh.astype(bf16) ahead of its upsample matmul, stencils.py:786-788). Pixel
// row y = 2i reads 0.25 w(i-1) + 0.75 w(i), row 2i+1 0.75 w(i) + 0.25
// w(i+1) (the x2 bilinear row upsample, float32); non-self candidates are
// multiplied by stride^2 (exact, a power of two). Value taps, the frame
// loop, the validity mask, the per-frame seed and uniform alpha are
// nlm_kernel's. The sums and products are those of a kernel of one thread
// a pixel, in the same order, so the output does not depend on the tile.
//
// Bound on the H100: chip_smoke.py's kernel_work counts 19.5 operations a
// candidate, pixel and frame (nlm_kernel's 15 before the weighted colour
// halve, the row upsample adds 3), 4 of them bf16 with bf16 taps: 49
// candidates at 1080p are ~2 G operations, ~0.027 ms. What limits the design
// is a hand count, which no profiler reading backs: per th = 16 tile and
// candidate ~1,000 warp instructions (e ~280, the two sums ~300, the pixels
// ~400) and ~250 shared-memory wavefronts, so issue and shared memory about
// alike, where one thread a pixel evaluates 24 squared differences a pixel
// from two 16-byte loads each.
//
// Design: a block of kHrwThreads threads owns an output tile of th x
// kHrwTileW pixels (th even, so that its rows start on the absolute even-row
// lattice of the cells; from ops/stencils.py:hrw_tile, 16 where the windows
// fit) and makes one pass over the frames. Per frame it stages, with the
// border policy applied as it stages, the neighbour's half-row cells (th/2
// + 4 + dy range/2 cell rows x kHrwEW + dx range lanes, pooled from the two
// full-resolution rows as they are staged, as bf16 RGB with BF16) and its
// value window (th + dy range rows x kHrwTileW + dx range columns). The
// target's cells over the e region, (th/2 + 4) x kHrwEW, are pooled once a
// block into registers, kHrwEPerThread a thread. Per candidate, with three
// barriers:
//   1. e once per position of the e region;
//   2. the 3-cell sums, (th/2 + 2) x kHrwEW;
//   3. the 6-lane sums and exp2 once per weight cell, (th/2 + 2) x
//      kHrwTileW, rounded to bf16 with BF16;
//   4. per pixel pair (rows 2i, 2i+1 of one column, three weight cells): the
//      upsample, one value tap a pixel and five multiply-adds.
// The shared-memory layout (byte offsets in `tile`) is hrw_tile's.
struct HrwTile {
  int th, oy, ox, win_h, win_w, cell_h, cell_w;
  // byte offsets: the half-row cells, e, the 3-cell sums, the weight cells
  // (the value window is at 0)
  int cells_at, e_at, sums_at, w_at;
};
// The ints of a tile as the launcher takes them: HrwTile's, then the bytes.
constexpr int kHrwTileFields = 12;

template <bool ZERO, bool BF16>
__global__ void __launch_bounds__(kHrwThreads)
    nlm_hrw_kernel(const float4* __restrict__ tgt, const float4* __restrict__ frames,
                   const float* __restrict__ valid, float4* __restrict__ out_wc,
                   float* __restrict__ out_nw, int h, int w, int n_frames, const Cands cands,
                   float ssd_coef, float stride_w, float norm_seed, int uniform_alpha,
                   const HrwTile tile) {
  using Tap = StagedTap<BF16>;
  extern __shared__ __align__(16) unsigned char hrw_smem[];
  const int th = tile.th;
  const int win_w = tile.win_w;
  const int cell_w = tile.cell_w;
  const int n_win = tile.win_h * win_w;
  const int n_cells = tile.cell_h * cell_w;
  const int n_e = (th / 2 + 4) * kHrwEW;
  const int n_sums = (th / 2 + 2) * kHrwEW;
  const int n_w = (th / 2 + 2) * kHrwTileW;
  float4* win = reinterpret_cast<float4*>(hrw_smem);
  Tap* cells = reinterpret_cast<Tap*>(hrw_smem + tile.cells_at);
  float* e_buf = reinterpret_cast<float*>(hrw_smem + tile.e_at);
  float* sums = reinterpret_cast<float*>(hrw_smem + tile.sums_at);
  float* wbuf = reinterpret_cast<float*>(hrw_smem + tile.w_at);

  const int t = threadIdx.x;
  const int y0 = blockIdx.y * th;
  const int x0 = blockIdx.x * kHrwTileW;
  const int hc = (h + 1) / 2;
  const size_t plane = static_cast<size_t>(h) * w;
  // e(r, c) pairs the target's cell y0/2 - 2 + r, lane x0 - kHrwLanes/2 + c,
  // with the staged cell r * cell_w + c + off_c of candidate (dy, dx),
  // off_c = (dy - oy)/2 * cell_w + dx - ox: the staged cells start at cell
  // y0/2 - 2 + oy/2, lane x0 - kHrwLanes/2 + ox. This thread's positions t +
  // q * kHrwThreads, the target's cells in registers.
  const int cy0 = y0 / 2 - 2;
  const int cx0 = x0 - kHrwLanes / 2;
  Tap tv[kHrwEPerThread];
  int e_cell[kHrwEPerThread];
#pragma unroll
  for (int q = 0; q < kHrwEPerThread; ++q) {
    const int pos = t + q * kHrwThreads;
    const int r = pos / kHrwEW;
    const int c = pos - r * kHrwEW;
    e_cell[q] = r * cell_w + c;
    tv[q] = half_row_cell<ZERO, BF16>(tgt, cy0 + r, cx0 + c, h, w, hc);
  }
  // This thread's pixels: local rows 2 * pair and 2 * pair + 1 of column
  // ocol, which read weight cell rows pair .. pair + 2; their value taps of
  // candidate (dy, dx) at window index o_win + off_v (and one row below),
  // off_v = (dy - oy) * win_w + dx - ox.
  const int ocol = t % kHrwTileW;
  const int pair = t / kHrwTileW;
  const bool owns = 2 * pair < th;
  const int o_win = 2 * pair * win_w + ocol;
  float4 total[2];
  float total_nw[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    total[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    total_nw[q] = 0.f;
  }

  for (int f = 0; f < n_frames; ++f) {
    const float4* nbr = frames + f * plane;
    __syncthreads();  // the previous frame's last window reads are done
    for (int i = t; i < n_win; i += kHrwThreads) {
      const int wr = i / win_w;
      bool ok;
      const float4* row = row_ptr<ZERO>(nbr, y0 + tile.oy + wr, h, w, ok);
      win[i] = col_tap<ZERO>(row, ok, x0 + tile.ox + i - wr * win_w, w);
    }
    for (int i = t; i < n_cells; i += kHrwThreads) {
      const int cr = i / cell_w;
      cells[i] = half_row_cell<ZERO, BF16>(nbr, cy0 + tile.oy / 2 + cr,
                                           cx0 + tile.ox + i - cr * cell_w, h, w, hc);
    }
    __syncthreads();
    float4 acc[2];
    float nw[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      nw[q] = norm_seed;
    }
    for (int k = 0; k < cands.n; ++k) {
      const int dy = cands.dy[k];
      const int dx = cands.dx[k];
      const int off_c = (dy - tile.oy) / 2 * cell_w + dx - tile.ox;
      const int off_v = (dy - tile.oy) * win_w + dx - tile.ox;
      // 1. e over the e region.
#pragma unroll
      for (int q = 0; q < kHrwEPerThread; ++q) {
        const int pos = t + q * kHrwThreads;
        if (pos < n_e) e_buf[pos] = sq_diff(tv[q], cells[e_cell[q] + off_c]);
      }
      __syncthreads();
      // 2. Row r of the 3-cell sums is weight cell y0/2 - 1 + r: e rows r,
      // r + 1 and r + 2, added in that order.
      for (int i = t; i < n_sums; i += kHrwThreads)
        sums[i] = __fadd_rn(__fadd_rn(e_buf[i], e_buf[i + kHrwEW]), e_buf[i + 2 * kHrwEW]);
      __syncthreads();
      // 3. Each weight cell: its 6 lanes left to right, then exp2.
      for (int i = t; i < n_w; i += kHrwThreads) {
        const int r = i / kHrwTileW;
        const float* s = sums + r * kHrwEW + i - r * kHrwTileW;
        float ssd = 0.f;
#pragma unroll
        for (int j = 0; j < kHrwLanes; ++j) ssd = __fadd_rn(ssd, s[j]);
        float wv = exp2f(ssd * ssd_coef);
        if constexpr (BF16) wv = bf16_round(wv);
        wbuf[i] = wv;
      }
      __syncthreads();
      // 4. The row upsample, value taps and accumulation. The next
      // candidate's e, sums and weight cells are written only after the
      // barriers that follow these reads.
      if (owns) {
        const float* wc = wbuf + pair * kHrwTileW + ocol;
        const float wa = wc[0];
        const float wb = wc[kHrwTileW];
        const float wn = wc[2 * kHrwTileW];
        float w_even = __fadd_rn(__fmul_rn(0.25f, wa), __fmul_rn(0.75f, wb));
        float w_odd = __fadd_rn(__fmul_rn(0.75f, wb), __fmul_rn(0.25f, wn));
        if (dy != 0 || dx != 0) {
          w_even *= stride_w;
          w_odd *= stride_w;
        }
        const float4 v0 = win[o_win + off_v];
        const float4 v1 = win[o_win + win_w + off_v];
        acc[0].x += v0.x * w_even;
        acc[0].y += v0.y * w_even;
        acc[0].z += v0.z * w_even;
        acc[0].w += v0.w * w_even;
        nw[0] += w_even;
        acc[1].x += v1.x * w_odd;
        acc[1].y += v1.y * w_odd;
        acc[1].z += v1.z * w_odd;
        acc[1].w += v1.w * w_odd;
        nw[1] += w_odd;
      }
    }
    const float vf = valid[f];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int y = y0 + 2 * pair + q;
      const int x = x0 + ocol;
      // This frame's tap alphas are one constant a: sum(w * a) = a * (nw -
      // seed); the seed is not alpha-weighted.
      if (uniform_alpha && owns && y < h && x < w)
        acc[q].w = nbr[static_cast<size_t>(y) * w + x].w * (nw[q] - norm_seed);
      total[q].x += acc[q].x * vf;
      total[q].y += acc[q].y * vf;
      total[q].z += acc[q].z * vf;
      total[q].w += acc[q].w * vf;
      total_nw[q] += nw[q] * vf;
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int y = y0 + 2 * pair + q;
    const int x = x0 + ocol;
    if (owns && y < h && x < w) {
      const size_t idx = static_cast<size_t>(y) * w + x;
      out_wc[idx] = total[q];
      out_nw[idx] = total_nw[q];
    }
  }
}

// Normalize: wc / nw, with the sentinel where nw == 0 exactly.
//
// Replaces image_denoising_filter_tpu/ops/stencils.py:_normalize_kernel
// (launched by normalize). Bound on the H100: device memory, 36 bytes a
// pixel and one division per channel (0.022 ms at 1080p). Design: one
// thread per pixel, one float4 load, one float load and one float4 store,
// all coalesced. Division is IEEE (no fast math): x / x is exactly 1, and
// the output equals normalize_plain's. A grid-stride streaming form (four
// pixels a thread, every load before the first divide, a grid of the blocks
// the card holds at once) timed no faster on the H100
// (tools/torch_kernel_ab.py), so this one stays.
__global__ void __launch_bounds__(kNormThreads)
    normalize_kernel(const float4* __restrict__ wc, const float* __restrict__ nw,
                     float4* __restrict__ out, long long n, float4 sentinel) {
  const long long i = static_cast<long long>(blockIdx.x) * kNormThreads + threadIdx.x;
  if (i >= n) return;
  const float d = nw[i];
  const float4 v = wc[i];
  out[i] = d == 0.f ? sentinel : make_float4(v.x / d, v.y / d, v.z / d, v.w / d);
}

using BilStagedKernel = decltype(&bilateral_staged_kernel<false, false, false, false>);

template <bool GUIDED, bool BF16>
BilStagedKernel bilateral_staged_kernel_for(int uniform_alpha, int blue_bug) {
  return uniform_alpha ? (blue_bug ? bilateral_staged_kernel<GUIDED, BF16, true, false>
                                   : bilateral_staged_kernel<GUIDED, BF16, true, true>)
                       : (blue_bug ? bilateral_staged_kernel<GUIDED, BF16, false, false>
                                   : bilateral_staged_kernel<GUIDED, BF16, false, true>);
}

BilStagedKernel bilateral_staged_kernel_for(bool guided, int bf16_taps, int uniform_alpha,
                                            int blue_bug) {
  return guided ? (bf16_taps ? bilateral_staged_kernel_for<true, true>(uniform_alpha, blue_bug)
                             : bilateral_staged_kernel_for<true, false>(uniform_alpha, blue_bug))
                : (bf16_taps ? bilateral_staged_kernel_for<false, true>(uniform_alpha, blue_bug)
                             : bilateral_staged_kernel_for<false, false>(uniform_alpha, blue_bug));
}

using BilKernel = decltype(&bilateral_kernel<false, false, false>);

template <bool GUIDED>
BilKernel bilateral_kernel_for(int zero_border, int bf16_taps) {
  return zero_border ? (bf16_taps ? bilateral_kernel<GUIDED, true, true>
                                  : bilateral_kernel<GUIDED, true, false>)
                     : (bf16_taps ? bilateral_kernel<GUIDED, false, true>
                                  : bilateral_kernel<GUIDED, false, false>);
}

BilKernel bilateral_kernel_for(bool guided, int zero_border, int bf16_taps) {
  return guided ? bilateral_kernel_for<true>(zero_border, bf16_taps)
                : bilateral_kernel_for<false>(zero_border, bf16_taps);
}

using NlmKernel = decltype(&nlm_kernel<1, false, false>);

template <int P>
NlmKernel nlm_kernel_for(int zero_border, int bf16_taps) {
  return zero_border ? (bf16_taps ? nlm_kernel<P, true, true> : nlm_kernel<P, true, false>)
                     : (bf16_taps ? nlm_kernel<P, false, true> : nlm_kernel<P, false, false>);
}

// The kernel for patch radius p: the sliding body up to kNlmRegisterPatch,
// the staged body with the run-time radius above it; nullptr for p < 1.
NlmKernel nlm_kernel_for(int p, int zero_border, int bf16_taps) {
  static_assert(kNlmRegisterPatch == 4, "one case per unrolled patch radius");
  switch (p) {
    case 1: return nlm_kernel_for<1>(zero_border, bf16_taps);
    case 2: return nlm_kernel_for<2>(zero_border, bf16_taps);
    case 3: return nlm_kernel_for<3>(zero_border, bf16_taps);
    case 4: return nlm_kernel_for<4>(zero_border, bf16_taps);
    default:
      if (p <= kNlmRegisterPatch) return nullptr;
      return zero_border ? (bf16_taps ? nlm_wide_kernel<true, true> : nlm_wide_kernel<true, false>)
                         : (bf16_taps ? nlm_wide_kernel<false, true>
                                      : nlm_wide_kernel<false, false>);
  }
}

using HrwKernel = decltype(&nlm_hrw_kernel<false, false>);

HrwKernel nlm_hrw_kernel_for(int zero_border, int bf16_taps) {
  return zero_border ? (bf16_taps ? nlm_hrw_kernel<true, true> : nlm_hrw_kernel<true, false>)
                     : (bf16_taps ? nlm_hrw_kernel<false, true> : nlm_hrw_kernel<false, false>);
}

}  // namespace

// Device queries of both sources' launchers (fast.cu declares them).
namespace idf {

// The current device's opt-in shared memory a block, in bytes.
cudaError_t max_shared_bytes(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err;
}

// A kernel as compiled and its occupancy at `threads` a block and
// shared_bytes of dynamic shared memory: info[0] registers a thread, info[1]
// local (spill) bytes a thread, info[2] blocks a multiprocessor holds at
// once.
cudaError_t kernel_info(const void* kernel, int threads, int shared_bytes, int* info) {
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && shared_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, threads, shared_bytes);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  return err;
}

}  // namespace idf

extern "C" {

// runs: host array of n_runs (dy_start, n_rows, half_width) triples.
// guide == nullptr selects the plain bilateral; out_nw may be nullptr.
// bf16_taps selects the bf16 colour distance and bf16-rounded RGB values.
// tile: host array of kBilTileFields ints from ops/stencils.py:bilateral_tile:
// th output rows of kBilTileW columns (0: the direct-load instance, which
// takes no shared memory), the staged halo of hy rows and hx columns, the
// byte offsets of BilTile and the block's dynamic shared memory in bytes,
// which must fit the device. The halo must cover every run, and the regions
// (the weight source's pixels at 0, the value taps when guided, the alpha
// plane with bf16 taps unless alpha is uniform, the spatial terms, the
// channel ranges) must not overlap or overrun, else cudaErrorInvalidValue
// and no launch.
int idf_bilateral(const void* img, const void* guide, void* out_wc, void* out_nw, int h,
                  int w, const int* runs, int n_runs, float sp_coef, float col_coef,
                  int blue_bug, int zero_border, int uniform_alpha, int fuse_normalize,
                  int bf16_taps, const int* tile, void* stream) {
  const cudaError_t invalid = cudaErrorInvalidValue;
  if (n_runs < 0 || n_runs > kMaxRuns) return static_cast<int>(invalid);
  Runs table;
  table.n = n_runs;
  int hy = 0, hx = 0;
  for (int i = 0; i < n_runs; ++i) {
    const int dy0 = runs[3 * i], rows = runs[3 * i + 1], half = runs[3 * i + 2];
    if (rows < 0 || half < 0 || dy0 < -kMaxRuns || dy0 + rows > kMaxRuns + 1 || half > kMaxRuns)
      return static_cast<int>(invalid);
    table.dy0[i] = static_cast<short>(dy0);
    table.rows[i] = static_cast<short>(rows);
    table.hw[i] = static_cast<short>(half);
    if (rows > 0) hy = std::max(hy, std::max(-dy0, dy0 + rows - 1));
    hx = std::max(hx, half);
  }
  const BilTile geom{tile[0], tile[1], tile[2], tile[3], tile[4], tile[5], tile[6]};
  const int shared_bytes = tile[kBilTileFields - 1];
  const bool guided = guide != nullptr;
  const bool alpha_plane = bf16_taps && !uniform_alpha;
  if (geom.th < 0 || geom.th > kBilMaxTileH) return static_cast<int>(invalid);
  cudaError_t err = cudaSuccess;
  if (geom.th > 0) {
    if (geom.hy < hy || geom.hx < hx || geom.hy > kMaxRuns || geom.hx > kMaxRuns)
      return static_cast<int>(invalid);
    // The regions in order, each starting where the one before it may end.
    const int px = bf16_taps ? 8 : 16;
    const int n = (geom.th + 2 * geom.hy) * (kBilTileW + 2 * geom.hx);
    int end = px * n;
    if (guided) {
      if (geom.vals_at < end || geom.vals_at % px != 0) return static_cast<int>(invalid);
      end = geom.vals_at + px * n;
    }
    if (alpha_plane) {
      if (geom.alpha_at < end || geom.alpha_at % 4 != 0) return static_cast<int>(invalid);
      end = geom.alpha_at + 4 * n;
    }
    if (geom.sp_at < end || geom.sp_at % 4 != 0) return static_cast<int>(invalid);
    end = geom.sp_at + 4 * (2 * geom.hy + 1) * (2 * geom.hx + 1);
    if (geom.range_at < end || geom.range_at % 4 != 0) return static_cast<int>(invalid);
    end = geom.range_at + 24 * geom.th;
    if (shared_bytes < end) return static_cast<int>(invalid);
    int max_bytes = 0;
    err = idf::max_shared_bytes(&max_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (shared_bytes > max_bytes) return static_cast<int>(invalid);
  } else if (shared_bytes != 0) {
    return static_cast<int>(invalid);
  }
  if (h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* in = static_cast<const float4*>(img);
  const float4* gd = static_cast<const float4*>(guide);
  float4* o = static_cast<float4*>(out_wc);
  float* onw = static_cast<float*>(out_nw);
  if (geom.th == 0) {
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
    const BilKernel kernel = bilateral_kernel_for(guided, zero_border, bf16_taps);
    kernel<<<grid, block, 0, s>>>(in, gd, o, onw, h, w, table, sp_coef, col_coef, blue_bug,
                                  uniform_alpha, fuse_normalize);
    return static_cast<int>(cudaGetLastError());
  }
  const BilStagedKernel kernel = bilateral_staged_kernel_for(guided, bf16_taps, uniform_alpha,
                                                             blue_bug);
  if (shared_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((w + kBilTileW - 1) / kBilTileW, (h + geom.th - 1) / geom.th);
  kernel<<<grid, 32 * geom.th, shared_bytes, s>>>(in, gd, o, onw, h, w, table, sp_coef, col_coef,
                                                  zero_border, fuse_normalize, geom);
  return static_cast<int>(cudaGetLastError());
}

// The bilateral kernel of a form as compiled, and its occupancy: the staged
// kernel at th warps a block and shared_bytes, or with th == 0 the
// direct-load instance (kernel_info's).
int idf_bilateral_info(int guided, int bf16_taps, int uniform_alpha, int blue_bug,
                       int zero_border, int th, int shared_bytes, int* info) {
  if (th < 0 || th > kBilMaxTileH) return static_cast<int>(cudaErrorInvalidValue);
  if (th == 0)
    return static_cast<int>(idf::kernel_info(
        reinterpret_cast<const void*>(bilateral_kernel_for(guided, zero_border, bf16_taps)),
        kBlockX * kBlockY, 0, info));
  return static_cast<int>(idf::kernel_info(
      reinterpret_cast<const void*>(
          bilateral_staged_kernel_for(guided, bf16_taps, uniform_alpha, blue_bug)),
      32 * th, shared_bytes, info));
}

// cands: host array of n_cands (dy, dx) pairs; frames: (n_frames, h, w, 4);
// valid: device array of n_frames floats.
// bf16_taps selects the bf16 tap arithmetic (the turbo NLM).
// tile: host array of kNlmTileFields ints from ops/stencils.py:nlm_tile: th
// output rows of tw columns (the sliding body, p <= kNlmRegisterPatch: 33 -
// 2p rows, tw / kNlmSeg warps; the staged body: kNlmTileW columns); the
// staged window of win_h x win_w pixels, rows pitch pixels apart, at (oy, ox)
// from the tile's first output pixel; the byte offsets of NlmTile; the
// block's dynamic shared memory in bytes, which must fit the device. Every
// candidate's taps, and the self match's, must fall inside the window, else
// cudaErrorInvalidValue and no launch.
int idf_nlm(const void* tgt, const void* frames, const void* valid, void* out_wc,
            void* out_nw, int h, int w, int n_frames, int p, const int* cands,
            int n_cands, float ssd_coef, float log_m, float norm_seed, int zero_border,
            int uniform_alpha, int bf16_taps, const int* tile, void* stream) {
  const cudaError_t invalid = cudaErrorInvalidValue;
  const NlmKernel kernel = nlm_kernel_for(p, zero_border, bf16_taps);
  const NlmTile geom{tile[0], tile[1], tile[2], tile[3], tile[4],  tile[5],
                     tile[6], tile[7], tile[8], tile[9], tile[10], tile[11]};
  const int shared_bytes = tile[kNlmTileFields - 1];
  const bool sliding = p <= kNlmRegisterPatch;
  const int threads = sliding ? geom.tw / kNlmSeg * 32 : kNlmThreads;
  if (kernel == nullptr || n_cands < 0 || n_cands > kMaxCands || n_frames < 0 ||
      geom.win_h < 1 || geom.win_w < 1 || geom.pitch < geom.win_w ||
      (sliding ? geom.th != 33 - 2 * p || geom.tw < kNlmSeg || geom.tw % kNlmSeg != 0 ||
                     threads > kNlmSlideThreads
               : geom.th < 1 || geom.th > kNlmMaxTileH || geom.tw != kNlmTileW))
    return static_cast<int>(invalid);
  for (const int at : {geom.taps_at, geom.sums_at, geom.tgt_at, geom.e_at, geom.rows_at})
    if (at < 0 || at > shared_bytes) return static_cast<int>(invalid);
  const int e_h = geom.th + 2 * p - 1;
  const int e_w = geom.tw + 2 * p - 1;
  // e rows dy - p .. dy + th + p - 2 and columns likewise from the tile.
  const auto inside = [&](int dy, int dx) {
    return dy - p >= geom.oy && dy - p + e_h <= geom.oy + geom.win_h && dx - p >= geom.ox &&
           dx - p + e_w <= geom.ox + geom.win_w;
  };
  if (!inside(0, 0)) return static_cast<int>(invalid);
  Cands table;
  table.n = n_cands;
  for (int i = 0; i < n_cands; ++i) {
    const int dy = cands[2 * i];
    const int dx = cands[2 * i + 1];
    if (dy < -128 || dy > 127 || dx < -128 || dx > 127 || !inside(dy, dx))
      return static_cast<int>(invalid);
    table.dy[i] = static_cast<signed char>(dy);
    table.dx[i] = static_cast<signed char>(dx);
  }
  int max_bytes = 0;
  cudaError_t err = idf::max_shared_bytes(&max_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (shared_bytes > max_bytes) return static_cast<int>(invalid);
  if (h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (shared_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((w + geom.tw - 1) / geom.tw, (h + geom.th - 1) / geom.th);
  kernel<<<grid, threads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(tgt), static_cast<const float4*>(frames),
      static_cast<const float*>(valid), static_cast<float4*>(out_wc),
      static_cast<float*>(out_nw), h, w, n_frames, p, table, ssd_coef, log_m, norm_seed,
      uniform_alpha, geom);
  return static_cast<int>(cudaGetLastError());
}

// *bytes = the shared memory a block may opt into on the current device.
int idf_max_shared_bytes(int* bytes) { return static_cast<int>(idf::max_shared_bytes(bytes)); }

// The NLM kernel of a patch radius, border and tap form as compiled, and its
// occupancy at `threads` and shared_bytes a block (kernel_info's).
int idf_nlm_info(int p, int zero_border, int bf16_taps, int threads, int shared_bytes,
                 int* info) {
  const NlmKernel kernel = nlm_kernel_for(p, zero_border, bf16_taps);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      idf::kernel_info(reinterpret_cast<const void*>(kernel), threads, shared_bytes, info));
}

// The half-row NLM: the inputs and outputs of idf_nlm (patch radius 3, every
// dy even); stride_w multiplies every non-self candidate's weight.
// tile: host array of kHrwTileFields ints from ops/stencils.py:hrw_tile: th
// (even) output rows of kHrwTileW columns; the value window of win_h x win_w
// pixels at (oy, ox) from the tile's first output pixel (oy even); the
// half-row cell window of cell_h x cell_w; the byte offsets of HrwTile; the
// block's dynamic shared memory in bytes, which must fit the device. Every
// candidate's cells and value taps must fall inside the windows and the
// regions must not overlap, else cudaErrorInvalidValue and no launch.
int idf_nlm_hrw(const void* tgt, const void* frames, const void* valid, void* out_wc,
                void* out_nw, int h, int w, int n_frames, const int* cands, int n_cands,
                float ssd_coef, float stride_w, float norm_seed, int zero_border,
                int uniform_alpha, int bf16_taps, const int* tile, void* stream) {
  const cudaError_t invalid = cudaErrorInvalidValue;
  const HrwKernel kernel = nlm_hrw_kernel_for(zero_border, bf16_taps);
  const HrwTile geom{tile[0], tile[1], tile[2], tile[3], tile[4], tile[5],
                     tile[6], tile[7], tile[8], tile[9], tile[10]};
  const int shared_bytes = tile[kHrwTileFields - 1];
  const int half = geom.th / 2;
  if (n_cands < 0 || n_cands > kMaxCands || n_frames < 0 || geom.th < 2 || geom.th % 2 != 0 ||
      geom.th > kHrwMaxTileH || geom.oy % 2 != 0 || geom.win_h < geom.th ||
      geom.win_w < kHrwTileW || geom.cell_h < half + 4 || geom.cell_w < kHrwEW ||
      geom.cells_at % 16 != 0)
    return static_cast<int>(invalid);
  // The regions in order, each starting where the one before it may end.
  const int tap = bf16_taps ? 8 : 16;
  const int ends[] = {16 * geom.win_h * geom.win_w,
                      geom.cells_at + tap * geom.cell_h * geom.cell_w,
                      geom.e_at + 4 * (half + 4) * kHrwEW, geom.sums_at + 4 * (half + 2) * kHrwEW,
                      geom.w_at + 4 * (half + 2) * kHrwTileW};
  const int starts[] = {geom.cells_at, geom.e_at, geom.sums_at, geom.w_at, shared_bytes};
  for (int i = 0; i < 5; ++i)
    if (starts[i] < ends[i]) return static_cast<int>(invalid);
  Cands table;
  table.n = n_cands;
  for (int i = 0; i < n_cands; ++i) {
    const int dy = cands[2 * i];
    const int dx = cands[2 * i + 1];
    // value rows dy .. dy + th - 1 and columns dx .. dx + kHrwTileW - 1 from
    // the tile; cell rows (dy - oy)/2 .. + half + 3 and lanes dx - ox .. +
    // kHrwEW - 1 of the cell window.
    if (dy < -128 || dy > 127 || dx < -128 || dx > 127 || dy % 2 != 0 || dy < geom.oy ||
        dy - geom.oy + geom.th > geom.win_h || dx < geom.ox ||
        dx - geom.ox + kHrwTileW > geom.win_w || (dy - geom.oy) / 2 + half + 4 > geom.cell_h ||
        dx - geom.ox + kHrwEW > geom.cell_w)
      return static_cast<int>(invalid);
    table.dy[i] = static_cast<signed char>(dy);
    table.dx[i] = static_cast<signed char>(dx);
  }
  int max_bytes = 0;
  cudaError_t err = idf::max_shared_bytes(&max_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (shared_bytes > max_bytes) return static_cast<int>(invalid);
  if (h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (shared_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((w + kHrwTileW - 1) / kHrwTileW, (h + geom.th - 1) / geom.th);
  kernel<<<grid, kHrwThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(tgt), static_cast<const float4*>(frames),
      static_cast<const float*>(valid), static_cast<float4*>(out_wc),
      static_cast<float*>(out_nw), h, w, n_frames, table, ssd_coef, stride_w, norm_seed,
      uniform_alpha, geom);
  return static_cast<int>(cudaGetLastError());
}

// The half-row NLM kernel of a border and tap form as compiled, and its
// occupancy at shared_bytes a block (kernel_info's).
int idf_nlm_hrw_info(int zero_border, int bf16_taps, int shared_bytes, int* info) {
  return static_cast<int>(
      idf::kernel_info(reinterpret_cast<const void*>(nlm_hrw_kernel_for(zero_border, bf16_taps)),
                       kHrwThreads, shared_bytes, info));
}

int idf_normalize(const void* wc, const void* nw, void* out, long long n_pixels, float s_r,
                  float s_g, float s_b, float s_a, void* stream) {
  if (n_pixels <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_pixels + kNormThreads - 1) / kNormThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  normalize_kernel<<<static_cast<unsigned>(blocks), kNormThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(wc), static_cast<const float*>(nw),
      static_cast<float4*>(out), n_pixels, make_float4(s_r, s_g, s_b, s_a));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
