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

#include <type_traits>

namespace {

constexpr int kBlockX = 32;  // a warp spans 32 neighbouring pixels of a row
constexpr int kBlockY = 8;
constexpr int kMaxRuns = 128;
constexpr int kMaxCands = 1024;  // (2s)^2 candidates up to s = 16
// The NLM kernel's block, defined in ops/stencils.py and passed to nvcc as
// macros by ops/_build.py: kNlmThreads threads own an output tile of
// kNlmTileW columns and up to kNlmMaxTileH rows. For patch radii 1 to
// kNlmRegisterPatch each thread holds the target RGB of at most
// kNlmEPerThread squared-difference positions in registers; wider radii
// read the target from shared memory.
constexpr int kNlmThreads = IDF_NLM_THREADS;
constexpr int kNlmTileW = IDF_NLM_TILE_W;
constexpr int kNlmMaxTileH = IDF_NLM_MAX_TILE_H;
constexpr int kNlmRegisterPatch = IDF_NLM_REGISTER_PATCH;
constexpr int kNlmEPerThread = IDF_NLM_E_PER_THREAD;
static_assert((kNlmMaxTileH + 2 * kNlmRegisterPatch - 1) *
                      (kNlmTileW + 2 * kNlmRegisterPatch - 1) <=
                  kNlmThreads * kNlmEPerThread,
              "the e region of the largest tile must fit the threads' registers");
static_assert(kNlmMaxTileH * kNlmTileW % kNlmThreads == 0 && kNlmThreads % kNlmTileW == 0,
              "a thread owns whole output rows of one column");
constexpr int kNlmOutPerThread = kNlmMaxTileH * kNlmTileW / kNlmThreads;
constexpr int kNlmStrip = 4;  // patch row sums a thread makes in the row pass
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

// Bilateral over the truncation disk.
//
// Replaces image_denoising_filter_tpu/ops/stencils.py:_bilateral_kernel
// (launched by _bilateral_planar). Weight of tap (dy, dx):
//   exp2(sp_coef * (dy^2 + dx^2) - col_coef * ||c - t||^2)
// with log2(e) folded into both coefficients; c and t come from the guide
// when GUIDED, and the values from img. Alpha is accumulated with the
// RGB-derived weight.
//
// Bound on the H100: at the reference parameters the disk holds 499 taps, so
// a 1080p frame costs ~1.0 G taps, each one exp2, ~15 FP32 operations and one
// 16-byte load (two when guided) that hits L1. It is bound by instruction
// issue, not by device memory: the image is read from DRAM about once.
// Design: one thread per output pixel in 32x8 blocks, so a warp's tap load
// is 32 consecutive float4 (512 B) and a block's taps reuse the same L1
// lines; no shared-memory halo, so no radius can exceed the block's shared
// memory.
template <bool GUIDED, bool ZERO>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    bilateral_kernel(const float4* __restrict__ img, const float4* __restrict__ guide,
                     float4* __restrict__ out_wc, float* __restrict__ out_nw, int h,
                     int w, const Runs runs, float sp_coef, float col_coef, float blue_w,
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
      const float row_term = sp_coef * static_cast<float>(dy * dy);
      for (int dx = -hw; dx <= hw; ++dx) {
        const float4 g = col_tap<ZERO>(grow, ok, x + dx, w);
        const float dr = c.x - g.x;
        const float dg = c.y - g.y;
        const float db = c.z - g.z;
        // blue_w is 0 under blue_bug: the blue term then adds exactly 0.
        const float ssd = dr * dr + dg * dg + blue_w * (db * db);
        const float wgt =
            exp2f(row_term + sp_coef * static_cast<float>(dx * dx) - ssd * col_coef);
        const float4 v = GUIDED ? col_tap<ZERO>(vrow, ok, x + dx, w) : g;
        acc.x += v.x * wgt;
        acc.y += v.y * wgt;
        acc.z += v.z * wgt;
        acc.w += v.w * wgt;
        nw += wgt;
      }
    }
  }
  // sum(w * a) == a * sum(w) when alpha is one constant everywhere.
  if (uniform_alpha) acc.w = img[idx].w * nw;
  if (fuse_normalize) {
    // IEEE division (no fast math): x / x is exactly 1.
    acc.x /= nw;
    acc.y /= nw;
    acc.z /= nw;
    acc.w /= nw;
  }
  out_wc[idx] = acc;
  if (out_nw != nullptr) out_nw[idx] = nw;
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
struct alignas(8) Bf16x4 {
  __nv_bfloat16 x, y, z, w;
};

__device__ __forceinline__ Bf16x4 to_bf16x4(float4 v) {
  return {__float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y), __float2bfloat16_rn(v.z),
          __float2bfloat16_rn(0.f)};
}

__device__ __forceinline__ float sq_diff(float4 t, float4 n) {
  const float d0 = t.x - n.x;
  const float d1 = t.y - n.y;
  const float d2 = t.z - n.z;
  return d0 * d0 + d1 * d1 + d2 * d2;
}

__device__ __forceinline__ float sq_diff(Bf16x4 t, Bf16x4 n) {
  const __nv_bfloat16 d0 = __hsub_rn(t.x, n.x);
  const __nv_bfloat16 d1 = __hsub_rn(t.y, n.y);
  const __nv_bfloat16 d2 = __hsub_rn(t.z, n.z);
  const __nv_bfloat16 e = __hadd_rn(__hmul_rn(d0, d0), __hmul_rn(d1, d1));
  return __bfloat162float(__hadd_rn(e, __hmul_rn(d2, d2)));
}

template <bool BF16>
__device__ __forceinline__ float tap_sq_diff(float4 t, float4 n) {
  if constexpr (BF16) {
    return sq_diff(to_bf16x4(t), to_bf16x4(n));
  } else {
    return sq_diff(t, n);
  }
}

// A pixel as the squared difference reads it: float4, or its RGB in bf16.
template <bool BF16>
using NlmTap = typename std::conditional<BF16, Bf16x4, float4>::type;

template <bool BF16>
__device__ __forceinline__ NlmTap<BF16> nlm_tap(float4 v) {
  if constexpr (BF16) {
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
// included, is scaled by valid[f].
//
// Bound on the H100: chip_smoke.py's kernel_work counts 24 operations a
// candidate, pixel and frame with the box sums (e 8, two running sums 4,
// exponent and exp2 3, weighted colour 8, weight 1): at the reference
// parameters a 1080p frame is 196 x 2.07 M candidate-pixels, 9.8 GFLOP,
// 0.146 ms at 67 TFLOP/s. The kernel does more: each box pass adds 2p - 1
// terms a sum in the plain version's order, where running sums would add
// two, and e is computed over the tile's patch halo (1.5 positions an
// output at p = 3). What limits it is an estimate from a hand count, which
// no profiler reading backs: per tile and candidate at p = 3 it moves ~400
// shared-memory wavefronts of 128 bytes (e ~150, row pass ~90, lane pass and
// value taps ~160), at most one a cycle on each SM, against ~230 cycles of
// instruction issue, so shared-memory bandwidth before issue. Measured on
// an H100 80GB HBM3 (tools/torch_kernel_ab.py), a 1080p frame takes ~607
// cycles a tile and candidate on each SM at the 1980 MHz SM clock that
// nvidia-smi reads during the run. ptxas gives it 60-64 registers and no
// spills at p = 3, so 4 blocks (32 warps) a SM.
//
// Design: a block of kNlmThreads threads owns an output tile of th x
// kNlmTileW pixels (th from ops/stencils.py:nlm_tile, 16 where the window
// fits) and makes one pass over the frames. Per frame it stages the
// neighbour window, the tile plus the search and patch halo ((th + 2p - 1 +
// dy range) x (kNlmTileW + 2p - 1 + dx range) pixels), in shared memory,
// applying the border policy (index clamp, or a zero pixel) as it stages,
// and with bf16 taps also the window's RGB rounded to bf16. The target's e
// positions, the tile plus the patch halo, are loaded once a block. Per
// candidate, with two barriers:
//   1. e once per position of the (th + 2p - 1) x (kNlmTileW + 2p - 1)
//      region;
//   2. the row pass: each row sum adds 2p values of e, top to bottom;
//   3. the lane pass: each output adds 2p row sums left to right, then
//      exp2, one value tap from the window and five multiply-adds.
// The sums keep the plain version's order (ops/eager.py:_box_sum), so the
// SSD matches nlm_plain's up to the contraction of e's own multiply-adds.
//
// P > 0 is the patch radius, 1 to kNlmRegisterPatch: both box passes unroll
// into loads and adds with no loop or predicate, each thread keeps the
// target's taps for its kNlmEPerThread e positions in registers (every
// candidate computes the same positions), and a row-pass thread sums a strip
// of kNlmStrip row sums of one column from 2p + kNlmStrip - 1 loaded values.
// P == 0 takes the radius `patch` at run time, for radii above
// kNlmRegisterPatch: the target's taps are staged in shared memory, and the
// e positions, row sums and lane sums are loops. The shared-memory layout
// (byte offsets in `tile`) is nlm_tile's.
struct NlmTile {
  int th, oy, ox, win_h, win_w;
  // byte offsets: the window's bf16 RGB (the window itself with float32
  // taps), the target's taps (P == 0), e, the row sums
  int taps_at, tgt_at, e_at, rows_at;
};
// The ints of a tile as the launcher takes them: NlmTile's, then the bytes.
constexpr int kNlmTileFields = 10;

template <int P, bool ZERO, bool BF16>
__global__ void __launch_bounds__(kNlmThreads)
    nlm_kernel(const float4* __restrict__ tgt, const float4* __restrict__ frames,
               const float* __restrict__ valid, float4* __restrict__ out_wc,
               float* __restrict__ out_nw, int h, int w, int n_frames, int patch,
               const Cands cands, float ssd_coef, float log_m, float norm_seed,
               int uniform_alpha, const NlmTile tile) {
  using Tap = NlmTap<BF16>;
  constexpr bool kRegs = P > 0;
  constexpr int kBox = 2 * P;
  const int p = kRegs ? P : patch;
  const int box = kRegs ? kBox : 2 * patch;
  const int e_w = kNlmTileW + box - 1;
  const int th = tile.th;
  const int win_w = tile.win_w;
  extern __shared__ __align__(16) unsigned char nlm_smem[];
  const int n_win = tile.win_h * win_w;
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
  // off = (dy - dy_min) * win_w + dx - dx_min.
  const int dy_min = tile.oy + p;
  const int dx_min = tile.ox + p;
  const size_t plane = static_cast<size_t>(h) * w;

  // The target's e positions: e(r, c) pairs target pixel (y0 - p + r,
  // x0 - p + c) with the window's pixel r * win_w + c + off. With P > 0
  // this thread's positions t + q * kNlmThreads, in registers.
  Tap tv[kNlmEPerThread];
  int e_win[kNlmEPerThread];
  if constexpr (kRegs) {
#pragma unroll
    for (int q = 0; q < kNlmEPerThread; ++q) {
      const int pos = t + q * kNlmThreads;
      const int r = pos / e_w;
      const int c = pos - r * e_w;
      e_win[q] = r * win_w + c;
      bool ok;
      const float4* row = row_ptr<ZERO>(tgt, y0 - p + r, h, w, ok);
      tv[q] = nlm_tap<BF16>(pos < n_e ? col_tap<ZERO>(row, ok, x0 - p + c, w)
                                      : make_float4(0.f, 0.f, 0.f, 0.f));
    }
  } else {
    for (int pos = t; pos < n_e; pos += kNlmThreads) {
      const int r = pos / e_w;
      bool ok;
      const float4* row = row_ptr<ZERO>(tgt, y0 - p + r, h, w, ok);
      tgt_taps[pos] = nlm_tap<BF16>(col_tap<ZERO>(row, ok, x0 - p + pos - r * e_w, w));
    }
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
    o_win[q] = (orow + p) * win_w + ocol + p;
    total[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    total_nw[q] = 0.f;
  }
  const int n_strips = (th + kNlmStrip - 1) / kNlmStrip * e_w;

  for (int f = 0; f < n_frames; ++f) {
    const float4* nbr = frames + f * plane;
    __syncthreads();  // the previous frame's last window reads are done
    for (int i = t; i < n_win; i += kNlmThreads) {
      const int wr = i / win_w;
      bool ok;
      const float4* row = row_ptr<ZERO>(nbr, y0 + tile.oy + wr, h, w, ok);
      const float4 v = col_tap<ZERO>(row, ok, x0 + tile.ox + i - wr * win_w, w);
      win[i] = v;
      if constexpr (BF16) win_taps[i] = nlm_tap<true>(v);
    }
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
      const int off = (dy - dy_min) * win_w + dx - dx_min;
      // 1. e over the tile and its patch halo.
      if constexpr (kRegs) {
#pragma unroll
        for (int q = 0; q < kNlmEPerThread; ++q) {
          const int pos = t + q * kNlmThreads;
          if (pos < n_e) e_buf[pos] = sq_diff(tv[q], win_taps[e_win[q] + off]);
        }
      } else {
        for (int pos = t; pos < n_e; pos += kNlmThreads) {
          const int r = pos / e_w;
          e_buf[pos] = sq_diff(tgt_taps[pos], win_taps[r * win_w + pos - r * e_w + off]);
        }
      }
      __syncthreads();
      // 2. Row pass: rs(r, c) = e(r, c) + e(r + 1, c) + ... + e(r + 2p - 1,
      // c), added in that order.
      if constexpr (kRegs) {
        for (int task = t; task < n_strips; task += kNlmThreads) {
          const int strip = task / e_w;
          const int c = task - strip * e_w;
          const int r0 = strip * kNlmStrip;
          const int rows = min(kNlmStrip, th - r0);
          const float* ecol = e_buf + r0 * e_w + c;
          float ev[kNlmStrip + kBox - 1];
#pragma unroll
          for (int j = 0; j < kNlmStrip + kBox - 1; ++j)
            ev[j] = j < rows + kBox - 1 ? ecol[j * e_w] : 0.f;
#pragma unroll
          for (int i = 0; i < kNlmStrip; ++i) {
            float rs = ev[i];
#pragma unroll
            for (int j = 1; j < kBox; ++j) rs += ev[i + j];
            if (i < rows) row_buf[(r0 + i) * e_w + c] = rs;
          }
        }
      } else {
        // task = r * e_w + c indexes both e(r, c) and rs(r, c)
        for (int task = t; task < th * e_w; task += kNlmThreads) {
          float rs = e_buf[task];
          for (int j = 1; j < box; ++j) rs += e_buf[task + j * e_w];
          row_buf[task] = rs;
        }
      }
      __syncthreads();
      // 3. Lane pass, weight and value tap. The next candidate's e and row
      // sums are written only after the barriers that follow these reads.
      const float bias = (dy != 0 || dx != 0) ? log_m : 0.f;
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
__device__ __forceinline__ NlmTap<BF16> half_row_cell(const float4* __restrict__ img, int ci,
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
  using Tap = NlmTap<BF16>;
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

using NlmKernel = decltype(&nlm_kernel<1, false, false>);

template <int P>
NlmKernel nlm_kernel_for(int zero_border, int bf16_taps) {
  return zero_border ? (bf16_taps ? nlm_kernel<P, true, true> : nlm_kernel<P, true, false>)
                     : (bf16_taps ? nlm_kernel<P, false, true> : nlm_kernel<P, false, false>);
}

// The kernel for patch radius p: unrolled up to kNlmRegisterPatch, the
// run-time radius above it; nullptr for p < 1.
NlmKernel nlm_kernel_for(int p, int zero_border, int bf16_taps) {
  static_assert(kNlmRegisterPatch == 4, "one case per unrolled patch radius");
  switch (p) {
    case 1: return nlm_kernel_for<1>(zero_border, bf16_taps);
    case 2: return nlm_kernel_for<2>(zero_border, bf16_taps);
    case 3: return nlm_kernel_for<3>(zero_border, bf16_taps);
    case 4: return nlm_kernel_for<4>(zero_border, bf16_taps);
    default: return p > kNlmRegisterPatch ? nlm_kernel_for<0>(zero_border, bf16_taps) : nullptr;
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
int idf_bilateral(const void* img, const void* guide, void* out_wc, void* out_nw, int h,
                  int w, const int* runs, int n_runs, float sp_coef, float col_coef,
                  int blue_bug, int zero_border, int uniform_alpha, int fuse_normalize,
                  void* stream) {
  if (n_runs < 0 || n_runs > kMaxRuns) return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  Runs table;
  table.n = n_runs;
  for (int i = 0; i < n_runs; ++i) {
    table.dy0[i] = static_cast<short>(runs[3 * i]);
    table.rows[i] = static_cast<short>(runs[3 * i + 1]);
    table.hw[i] = static_cast<short>(runs[3 * i + 2]);
  }
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* in = static_cast<const float4*>(img);
  const float4* gd = static_cast<const float4*>(guide);
  float4* o = static_cast<float4*>(out_wc);
  float* onw = static_cast<float*>(out_nw);
  const float blue_w = blue_bug ? 0.f : 1.f;
  if (gd != nullptr && zero_border) {
    bilateral_kernel<true, true><<<grid, block, 0, s>>>(
        in, gd, o, onw, h, w, table, sp_coef, col_coef, blue_w, uniform_alpha, fuse_normalize);
  } else if (gd != nullptr) {
    bilateral_kernel<true, false><<<grid, block, 0, s>>>(
        in, gd, o, onw, h, w, table, sp_coef, col_coef, blue_w, uniform_alpha, fuse_normalize);
  } else if (zero_border) {
    bilateral_kernel<false, true><<<grid, block, 0, s>>>(
        in, gd, o, onw, h, w, table, sp_coef, col_coef, blue_w, uniform_alpha, fuse_normalize);
  } else {
    bilateral_kernel<false, false><<<grid, block, 0, s>>>(
        in, gd, o, onw, h, w, table, sp_coef, col_coef, blue_w, uniform_alpha, fuse_normalize);
  }
  return static_cast<int>(cudaGetLastError());
}

// cands: host array of n_cands (dy, dx) pairs; frames: (n_frames, h, w, 4);
// valid: device array of n_frames floats.
// bf16_taps selects the bf16 tap arithmetic (the turbo NLM).
// tile: host array of kNlmTileFields ints from ops/stencils.py:nlm_tile: th
// output rows of kNlmTileW columns; the staged window of win_h x win_w
// pixels at (oy, ox) from the tile's first output pixel; the byte offsets
// of NlmTile; the block's dynamic shared memory in bytes, which must fit
// the device. Every candidate's taps must fall inside the window, else
// cudaErrorInvalidValue and no launch.
int idf_nlm(const void* tgt, const void* frames, const void* valid, void* out_wc,
            void* out_nw, int h, int w, int n_frames, int p, const int* cands,
            int n_cands, float ssd_coef, float log_m, float norm_seed, int zero_border,
            int uniform_alpha, int bf16_taps, const int* tile, void* stream) {
  const cudaError_t invalid = cudaErrorInvalidValue;
  const NlmKernel kernel = nlm_kernel_for(p, zero_border, bf16_taps);
  const NlmTile geom{tile[0], tile[1], tile[2], tile[3], tile[4],
                     tile[5], tile[6], tile[7], tile[8]};
  const int shared_bytes = tile[kNlmTileFields - 1];
  if (kernel == nullptr || n_cands < 0 || n_cands > kMaxCands || n_frames < 0 ||
      geom.th < 1 || geom.th > kNlmMaxTileH || geom.win_h < 1 || geom.win_w < 1)
    return static_cast<int>(invalid);
  for (const int at : {geom.taps_at, geom.tgt_at, geom.e_at, geom.rows_at})
    if (at < 0 || at > shared_bytes) return static_cast<int>(invalid);
  const int e_h = geom.th + 2 * p - 1;
  const int e_w = kNlmTileW + 2 * p - 1;
  Cands table;
  table.n = n_cands;
  for (int i = 0; i < n_cands; ++i) {
    const int dy = cands[2 * i];
    const int dx = cands[2 * i + 1];
    // e rows dy - p .. dy + th + p - 2 and columns likewise from the tile.
    if (dy < -128 || dy > 127 || dx < -128 || dx > 127 || dy - p < geom.oy ||
        dy - p + e_h > geom.oy + geom.win_h || dx - p < geom.ox ||
        dx - p + e_w > geom.ox + geom.win_w)
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
  const dim3 grid((w + kNlmTileW - 1) / kNlmTileW, (h + geom.th - 1) / geom.th);
  kernel<<<grid, kNlmThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(tgt), static_cast<const float4*>(frames),
      static_cast<const float*>(valid), static_cast<float4*>(out_wc),
      static_cast<float*>(out_nw), h, w, n_frames, p, table, ssd_coef, log_m, norm_seed,
      uniform_alpha, geom);
  return static_cast<int>(cudaGetLastError());
}

// *bytes = the shared memory a block may opt into on the current device.
int idf_max_shared_bytes(int* bytes) { return static_cast<int>(idf::max_shared_bytes(bytes)); }

// The NLM kernel of a patch radius, border and tap form as compiled, and its
// occupancy at shared_bytes a block (kernel_info's).
int idf_nlm_info(int p, int zero_border, int bf16_taps, int shared_bytes, int* info) {
  const NlmKernel kernel = nlm_kernel_for(p, zero_border, bf16_taps);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      idf::kernel_info(reinterpret_cast<const void*>(kernel), kNlmThreads, shared_bytes, info));
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
