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

// Half-row cells of the half-row NLM's weight path: cell ih of an image is
// 0.5 * (row 2ih + row 2ih+1), the rows past the image given by the border
// policy (edge rows, or zero rows). With BF16, as the TPU kernel's bf16 pool
// matmul rounds them (stencils.py:727-742): bf16(0.5 * (bf16(a) + bf16(b))),
// the sum in float32. Writes cells ih in [-1, hc] of image blockIdx.z at row
// ih + 1 of its (hc + 2, w) plane: every cell before -1 equals cell -1, and
// every cell past hc equals cell hc, so the NLM kernel clamps its cell index
// into [-1, hc] under either border policy. Alpha is not pooled (zero).
template <bool ZERO, bool BF16>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    pool_rows2_kernel(const float4* __restrict__ src, float4* __restrict__ dst, int h, int w,
                      int hc) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || r >= hc + 2) return;
  const float4* img = src + static_cast<size_t>(blockIdx.z) * h * w;
  const int ih = r - 1;
  bool ok_a, ok_b;
  const float4 a = col_tap<ZERO>(row_ptr<ZERO>(img, 2 * ih, h, w, ok_a), ok_a, x, w);
  const float4 b = col_tap<ZERO>(row_ptr<ZERO>(img, 2 * ih + 1, h, w, ok_b), ok_b, x, w);
  float4 c;
  if constexpr (BF16) {
    c.x = bf16_round(__fmul_rn(0.5f, __fadd_rn(bf16_round(a.x), bf16_round(b.x))));
    c.y = bf16_round(__fmul_rn(0.5f, __fadd_rn(bf16_round(a.y), bf16_round(b.y))));
    c.z = bf16_round(__fmul_rn(0.5f, __fadd_rn(bf16_round(a.z), bf16_round(b.z))));
  } else {
    c.x = __fmul_rn(0.5f, __fadd_rn(a.x, b.x));
    c.y = __fmul_rn(0.5f, __fadd_rn(a.y, b.y));
    c.z = __fmul_rn(0.5f, __fadd_rn(a.z, b.z));
  }
  c.w = 0.f;
  dst[(static_cast<size_t>(blockIdx.z) * (hc + 2) + r) * w + x] = c;
}

// Frame-batched NLM accumulation with the weights at half row resolution
// (NlmParams.weights_halfres; search stride 2, patch radius 3).
//
// Replaces image_denoising_filter_tpu/ops/stencils.py:_nlm_hrw_kernel (the
// weights_halfres body of _nlm_planar_frames). For each candidate (dy, dx),
// dy even, the weight cells live on the half-row lattice: cell c of the
// target's and the neighbour's pooled planes (pool_rows2_kernel) give the
// RGB squared difference e(c, x') = |t(c, x') - n(c + dy/2, x' + dx)|^2,
// summed over the 3 cells c-1..c+1, then over the 6 lanes x-3..x+2, and
//   w(c) = exp2(ssd_coef * ssd(c)),  ssd_coef = -kappa log2(e) / h^2,
// kappa = 2. Pixel row y = 2i reads 0.25 w(i-1) + 0.75 w(i), row 2i+1
// 0.75 w(i) + 0.25 w(i+1) (the x2 bilinear row upsample); non-self
// candidates are multiplied by stride^2 (exact, a power of two). Value taps,
// the frame loop, the validity mask, the per-frame seed and uniform alpha
// are nlm_kernel's.
//
// BF16 (the turbo NLM): the pooled planes are bf16 values, e rounds as in
// nlm_kernel (tap_sq_diff<true>), and each weight cell is rounded to bf16
// before the upsample (the TPU kernel's wh.astype(bf16) ahead of its
// upsample matmul, stencils.py:786-788); the sums and the upsample are
// float32. Sums run in the plain version's order: per lane the three cells
// in order, then the lanes left to right.
//
// Bound on the H100: at the turbo parameters (49 candidates) a 1080p frame
// costs 49 x 2 M pixels x 24 squared differences, each two 16-byte loads
// that hit L1, and two exp2: bound by L1 load bandwidth and instruction
// issue, as nlm_kernel. Design: one thread per output pixel in 32x8 blocks;
// each thread computes the two weight cells its row reads, from 4 cell rows
// x 6 lanes of squared differences (24, where the full-resolution kernel
// evaluates 36 a candidate), so no shared memory and no synchronisation.
// Computing each cell once per block and sharing it through shared memory
// would cut that to about one squared difference a pixel, and is later work.
constexpr int kHrwLanes = 6;  // 2p lanes at patch radius 3

template <bool ZERO, bool BF16>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    nlm_hrw_kernel(const float4* __restrict__ tgt_h, const float4* __restrict__ frames_h,
                   const float4* __restrict__ frames, const float* __restrict__ valid,
                   float4* __restrict__ out_wc, float* __restrict__ out_nw, int h, int w,
                   int hc, int n_frames, const Cands cands, float ssd_coef, float stride_w,
                   float norm_seed, int uniform_alpha) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t idx = static_cast<size_t>(y) * w + x;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t hplane = static_cast<size_t>(hc + 2) * w;
  // The two cells row y reads, ca and ca + 1, and their upsample weights.
  const int ca = (y >> 1) - 1 + (y & 1);
  const float ua = (y & 1) ? 0.75f : 0.25f;
  const float ub = (y & 1) ? 0.25f : 0.75f;
  // Target cell rows ca - 1 .. ca + 2 (clamped into the stored [-1, hc]).
  const float4* trow[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) trow[r] = tgt_h + (min(max(ca - 1 + r, -1), hc) + 1) * w;
  float4 total = make_float4(0.f, 0.f, 0.f, 0.f);
  float total_nw = 0.f;
  for (int f = 0; f < n_frames; ++f) {
    const float4* nbr = frames + f * plane;
    const float4* nbr_h = frames_h + f * hplane;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float nw = norm_seed;
    for (int k = 0; k < cands.n; ++k) {
      const int dy = cands.dy[k];
      const int dx = cands.dx[k];
      const float4* nrow[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        nrow[r] = nbr_h + (min(max(ca - 1 + r + dy / 2, -1), hc) + 1) * w;
      float ssd_a = 0.f, ssd_b = 0.f;
#pragma unroll
      for (int j = 0; j < kHrwLanes; ++j) {
        const int xt = x + j - kHrwLanes / 2;
        float e[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          e[r] = tap_sq_diff<BF16>(col_tap<ZERO>(trow[r], true, xt, w),
                                   col_tap<ZERO>(nrow[r], true, xt + dx, w));
        ssd_a = __fadd_rn(ssd_a, __fadd_rn(__fadd_rn(e[0], e[1]), e[2]));
        ssd_b = __fadd_rn(ssd_b, __fadd_rn(__fadd_rn(e[1], e[2]), e[3]));
      }
      float wa = exp2f(ssd_a * ssd_coef);
      float wb = exp2f(ssd_b * ssd_coef);
      if constexpr (BF16) {
        wa = bf16_round(wa);
        wb = bf16_round(wb);
      }
      float wgt = __fadd_rn(__fmul_rn(ua, wa), __fmul_rn(ub, wb));
      if (dy != 0 || dx != 0) wgt *= stride_w;
      bool vok;
      const float4* vrow = row_ptr<ZERO>(nbr, y + dy, h, w, vok);
      const float4 v = col_tap<ZERO>(vrow, vok, x + dx, w);
      acc.x += v.x * wgt;
      acc.y += v.y * wgt;
      acc.z += v.z * wgt;
      acc.w += v.w * wgt;
      nw += wgt;
    }
    if (uniform_alpha) acc.w = nbr[idx].w * (nw - norm_seed);
    const float vf = valid[f];
    total.x += acc.x * vf;
    total.y += acc.y * vf;
    total.z += acc.z * vf;
    total.w += acc.w * vf;
    total_nw += nw * vf;
  }
  out_wc[idx] = total;
  out_nw[idx] = total_nw;
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

cudaError_t max_shared_bytes(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err;
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

}  // namespace

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
  cudaError_t err = max_shared_bytes(&max_bytes);
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
int idf_max_shared_bytes(int* bytes) { return static_cast<int>(max_shared_bytes(bytes)); }

// The NLM kernel of a patch radius, border and tap form as compiled, and its
// occupancy at shared_bytes a block: info[0] registers a thread, info[1]
// local (spill) bytes a thread, info[2] blocks a multiprocessor holds at
// once.
int idf_nlm_info(int p, int zero_border, int bf16_taps, int shared_bytes, int* info) {
  const NlmKernel kernel = nlm_kernel_for(p, zero_border, bf16_taps);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && shared_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, kNlmThreads,
                                                        shared_bytes);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

// The half-row NLM: the inputs and outputs of idf_nlm (patch radius 3, every
// dy even), and pooled, device scratch of (1 + n_frames) planes of (hc + 2,
// w) float4, hc = ceil(h / 2): the target's half-row cells, then each
// frame's. stride_w multiplies every non-self candidate's weight.
int idf_nlm_hrw(const void* tgt, const void* frames, const void* valid, void* pooled,
                void* out_wc, void* out_nw, int h, int w, int n_frames, const int* cands,
                int n_cands, float ssd_coef, float stride_w, float norm_seed, int zero_border,
                int uniform_alpha, int bf16_taps, void* stream) {
  if (n_cands < 0 || n_cands > kMaxCands || n_frames < 0 || n_frames > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  Cands table;
  table.n = n_cands;
  for (int i = 0; i < n_cands; ++i) {
    const int dy = cands[2 * i];
    const int dx = cands[2 * i + 1];
    if (dy < -128 || dy > 127 || dx < -128 || dx > 127 || dy % 2 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    table.dy[i] = static_cast<signed char>(dy);
    table.dx[i] = static_cast<signed char>(dx);
  }
  const int hc = (h + 1) / 2;
  const dim3 block(kBlockX, kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* t = static_cast<const float4*>(tgt);
  const float4* fr = static_cast<const float4*>(frames);
  float4* tgt_h = static_cast<float4*>(pooled);
  float4* frames_h = tgt_h + static_cast<size_t>(hc + 2) * w;
  const dim3 pool_grid((w + kBlockX - 1) / kBlockX, (hc + 2 + kBlockY - 1) / kBlockY);
  auto pool = zero_border ? (bf16_taps ? pool_rows2_kernel<true, true> : pool_rows2_kernel<true, false>)
                          : (bf16_taps ? pool_rows2_kernel<false, true> : pool_rows2_kernel<false, false>);
  pool<<<pool_grid, block, 0, s>>>(t, tgt_h, h, w, hc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_frames > 0) {
    pool<<<dim3(pool_grid.x, pool_grid.y, n_frames), block, 0, s>>>(fr, frames_h, h, w, hc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  auto kernel = zero_border ? (bf16_taps ? nlm_hrw_kernel<true, true> : nlm_hrw_kernel<true, false>)
                            : (bf16_taps ? nlm_hrw_kernel<false, true> : nlm_hrw_kernel<false, false>);
  kernel<<<grid, block, 0, s>>>(tgt_h, frames_h, fr, static_cast<const float*>(valid),
                                static_cast<float4*>(out_wc), static_cast<float*>(out_nw), h, w,
                                hc, n_frames, table, ssd_coef, stride_w, norm_seed, uniform_alpha);
  return static_cast<int>(cudaGetLastError());
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
