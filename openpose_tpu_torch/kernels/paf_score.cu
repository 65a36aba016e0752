// PAF kernels for NVIDIA Hopper (sm_90a): fused pair scoring, and the
// bicubic sampler of the unfused backend.
//
// 1. paf_score_kernel replaces the TPU kernel `paf_scores_fused`
// (openpose_tpu/ops/paf_pallas.py, kernel body `_paf_fused_kernel`).  For
// every frame n, limb pair p and peak combination (i, j) it computes what
// that kernel computes:
//
//   * line geometry: n_s = clip(floor(sqrt(5 * Linf(AB)) + 0.5), 5, 25)
//     samples at pixel clamp(floor(a + l * AB / n_s + 0.5)), l < n_s;
//   * the merged 8x-upsampled PAF x/y at each sample, evaluated directly as
//     4x4 Catmull-Rom taps of every scale's low-res map (tap source
//     coordinate src = coord / scale + (0.5 / scale - 0.5), the formula of
//     the TPU kernel), summed over scales and averaged after the projection
//     on the unit AB vector;
//   * score = mean of the projections above inter_threshold when more than
//     inter_min_above of the samples are above, else the close-keypoint
//     fallback (nms_threshold + 1e-6 when |AB| < sqrt(W * H) / 150), else -1;
//     -1 for |AB| <= 1e-6, i >= count_A or j >= count_B.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3, 700 W; times from
// chip_smoke.py).  At 8 frames x 26 pairs x 127 x 127
// lines (80.3 M samples, one scale of 46x82) the function moves 20 MB (the
// PAF planes, the peaks, 13.4 MB of scores: 6 us of device memory time) and
// needs 142 float operations per sample, 11.5 G in all: 0.171 ms at the
// card's 67 TFLOP/s.  Operations bound it.  The first design (one thread per
// (i, j), planes staged as two float planes) took 1.20-1.37 ms; this one
// takes 1.03 ms there (17% of the bound), 0.44 ms on the main path's own
// peaks (0.63 before) and 4.4 ms at 4 scales of 1312x736 (9.1-10.1 before).
// What sets its pace is not the arithmetic but the 16 taps of a sample: 128
// bytes of shared-memory reads, which alone cost 0.37 ms at the SMs' 128
// bytes a clock, about twice that with the bank conflicts of scattered
// lanes, beside some 200 instructions a sample, since -fmad=false forbids
// fused multiply-adds and the tap coordinates take two IEEE divisions.
// What the design does about it:
//
//   * planes are staged interleaved, one float2 (x, y) per pixel, so a tap
//     is one 8-byte load, and with a replicated border (1 before, 2 after)
//     so that the 4x4 window is 16 constant offsets from one address and no
//     tap index is clamped; the row stride is odd, so windows one row apart
//     start in different banks;
//   * kLineLanes (5) lanes share one (i, j) line and split its samples, so
//     loads made together lie along a line of the map instead of at 32
//     unrelated places, and a 25-sample line fills its lanes exactly; the
//     per-sample projections go back through warp shuffles and every lane
//     adds them in line order, the order of the plain version (a shuffle
//     moves a value, it does not reorder adds);
//   * lines are enumerated over the count_A x count_B block only, so no
//     lane waits on a peak slot that is empty; the -1 fill of the rest is
//     one coalesced pass;
//   * where scale is a power of two (8 at 368x656) coord / scale is the
//     exact product coord * (1 / scale);
//   * the shared-memory budget is what the device allows a block (227 KB)
//     instead of 96 KB.  Where the bordered planes of all scales do not fit
//     (242 KB at 4 scales of 1312x736) they are staged without borders and
//     the taps clamped (226 KB): a scale left in global memory is read
//     through an L1 that the staged ones have shrunk to almost nothing.
//     CTAs have 256 threads capped at 64 registers where several share an
//     SM and 512 where the planes leave room for one.  Staging is a plain
//     copy loop: with 33 KB per CTA at 368x656 four CTAs share an SM and
//     one CTA's staging overlaps the others' sampling, so asynchronous
//     copies had nothing left to hide (1.016-1.019 ms both ways; 4.31-4.34
//     against 4.40 ms at 4 scales, where one CTA has the SM);
//   * the kernel reads the net output in its own NHWC layout through strides
//     (a pair's x and y channels are neighbours there, one 8-byte piece per
//     pixel), so the wrapper makes no NCHW copy; per-scale pointers and
//     sizes are read from the kernel's parameter block, never copied into a
//     run-time-indexed local array.
//
// Tried and not kept (PERF.md has the times): tap weights tabulated per
// target column and row in shared memory; 4, 8, 16 and 32 lanes per line; a
// register cap for 5 or 6 CTAs per SM; staging by cp.async; and a
// row-interpolated table shared by a cluster of two CTAs through distributed
// shared memory.
//
// 2. sample_bicubic_kernel replaces the TPU kernel `sample_bicubic_pallas`
// (same file, kernel body `_make_kernel`, taps `_tap_weights_t`): the
// Catmull-Rom value of one pair's 8x-upsampled PAF x and y maps at integer
// target pixels (my, mx), with the tap source coordinate of that kernel,
// src = (coord + 0.5) / scale - 0.5.  The two formulas agree only in exact
// arithmetic, so each kernel keeps its TPU counterpart's.  It takes up to 8
// scales in one launch and returns their sum in scale order; with one scale
// it is the TPU kernel's function.
//
// What bounds it: 16 bytes of coordinates in and 8 bytes of values out per
// sample, 2.02 GB at the profile shape (8 x 26 pairs x 403,225 samples at
// 46x82): 0.603 ms at 3.35 TB/s, against 124 operations per sample (0.155
// ms).  Device-memory bytes bound it.  The first design (one CTA per 2048
// samples, each staging the pair's 30 KB anew) took 1.45 ms; this one takes
// 1.13 ms (53% of the bound).  Its samples there are scattered over the map,
// so what sets the pace is again the 16 tap reads with their bank conflicts.
// This design: a CTA of 512 threads stages once and walks over many
// 2048-sample tiles of its pair (the grid is sized to about four CTAs per
// SM); planes are interleaved and bordered as above; the planes are staged,
// all of them (without borders where they do not fit with) or none, where a
// CTA's samples read them at least once over, else they are read through
// the read-only cache (the line is in `sample_bicubic_launch`; at the
// people-capped path's 4 x 26 x 6400 samples and 4 scales: all staged 0.089
// ms, three of four 0.097 ms, none 0.129 ms); a thread loads the
// coordinates of its four samples before it works on any, 4 bytes each with
// a warp on 32 neighbouring samples (1.13 against 1.21 ms; 16-byte loads
// and stores, a thread on 4 neighbouring samples, took 1.12 ms but 0.096
// against 0.085 ms on the path's lines, where lanes 4 samples apart read
// more distinct taps); all scales of a pair block are one launch, so
// the sums over scales never travel through device memory (0.12 ms against
// 0.15-0.24 ms for four launches and the sums at 4 x 26 x 6400 samples).
// Any S works, with no padding; any coordinate value gives taps clamped to
// the map, so no read leaves it.
//
// Numerics: f32 throughout, built with -fmad=false so that every multiply
// and add rounds on its own, in the same order as the plain PyTorch versions
// (ops/paf.py paf_scores_multiscale_reference, sample_bicubic_reference and
// its in-order sum over scales); the two then agree bit for bit, and
// threshold decisions (proj > 0.05) cannot flip between them.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxScales = 8;
constexpr int kMaxSamples = 25;
constexpr int kMaxPeaks = 128;     // K <= 128
// Threads of a scoring CTA: kThreads where several CTAs share an SM, kThreadsWide
// where the staged planes leave room for one CTA only, so that one CTA still
// brings 16 warps.  The sampler's CTAs have kThreadsWide.
constexpr int kThreads = 256;
constexpr int kThreadsWide = 512;
constexpr size_t kWideAbove = 113 * 1024;   // half of what an SM can stage
constexpr int kMinCtas = 4;        // kThreads CTAs per SM: 64 registers each
constexpr int kLineLanes = 5;      // lanes that share one line
constexpr int kLinesPerWarp = 32 / kLineLanes;
constexpr int kRounds = (kMaxSamples + kLineLanes - 1) / kLineLanes;
constexpr int kRowsPerCta = 16;    // A peaks per CTA
constexpr unsigned kFullMask = 0xffffffffu;

// Row stride, in float2 pixels, of a staged plane of width w with `border`
// (0 or 1: 1 column before and 2 after), made odd.
__host__ __device__ inline int staged_stride(int w, int border) {
  return (w + 3 * border) | 1;
}

// float2 pixels of a staged plane.
__host__ __device__ inline size_t staged_pixels(int h, int w, int border) {
  return (size_t)(h + 3 * border) * staged_stride(w, border);
}

struct PafArgs {
  const float* src[kMaxScales];    // per scale [N, h, w, channels]
  int h[kMaxScales];
  int w[kMaxScales];
  float scale_h[kMaxScales];
  float scale_w[kMaxScales];
  float inv_h[kMaxScales];         // 1 / scale where that is exact, else 0
  float inv_w[kMaxScales];
  float off_h[kMaxScales];         // 0.5 / scale_h - 0.5
  float off_w[kMaxScales];
  int smem_off[kMaxScales];        // float2 offset of the staged plane, -1:
                                   // read from global memory
  int border;                      // staged planes carry the border
  int n_scales;
  int channels;
  const float* peaks;              // [N, parts, K + 1, 3]; count in [.., 0, 0]
  const int* pairs;                // [P, 2] part indices
  const int* map_idx;              // [P, 2] absolute PAF channels
  float* out;                      // [N, P, K, K]
  int parts;
  int n_pairs;
  int k;
  int th;
  int tw;
  float inter_threshold;
  float inter_min_above;
  float fallback_score;            // nms_threshold + 1e-6
  float close_thr;                 // sqrt(th * tw) / 150
  float inv_scales;
};

// Catmull-Rom taps and weights at one source coordinate (cubicSequentialData
// + cubicInterpolate of the reference): t1 = clamp(floor(src)), dx measured
// from the clamped t1.  The taps are clamp(t1 - 1), t1, t2 = clamp(t1 + 1),
// clamp(t2 + 1): in a bordered staged plane the four pixels from t1 on.
__device__ __forceinline__ void axis_taps(float src, int in_size, int& t1i,
                                          float wt[4]) {
  const float t1 = fminf(fmaxf(floorf(src), 0.0f), (float)(in_size - 1));
  const float d = src - t1;
  const float d2 = d * d;
  const float d3 = d2 * d;
  wt[0] = -0.5f * d3 + d2 - 0.5f * d;
  wt[1] = 1.5f * d3 - 2.5f * d2 + 1.0f;
  wt[2] = -1.5f * d3 + 2.0f * d2 + 0.5f * d;
  wt[3] = 0.5f * d3 - 0.5f * d2;
  t1i = (int)t1;
}

__device__ __forceinline__ void clamped_taps(int t1, int in_size, int t[4]) {
  t[0] = max(0, t1 - 1);
  t[1] = t1;
  t[2] = min(in_size - 1, t1 + 1);
  t[3] = min(in_size - 1, t[2] + 1);
}

// Source coordinate of a target coordinate in the fused TPU kernel
// (paf_pallas.py `_paf_fused_kernel`): coord / scale + (0.5 / scale - 0.5).
// `inv` is 1 / scale where scale is a power of two, else 0: the product is
// then the quotient, bit for bit, at a fraction of a division's cost.
__device__ __forceinline__ float fused_source(float coord, float scale,
                                              float inv, float off) {
  return (inv != 0.0f ? coord * inv : coord / scale) + off;
}

// ... and in the TPU sampler (paf_pallas.py `_tap_weights_t`, paf.py
// `_tap_matrix`): (coord + 0.5) / scale - 0.5.
__device__ __forceinline__ float half_pixel_source(int coord, float scale) {
  return ((float)coord + 0.5f) / scale - 0.5f;
}

// Copies one pair's x and y planes into a staged plane, interleaved.  With
// the border, staged (r, c) holds the map's pixel (clamp(r - 1),
// clamp(c - 1)); without, pixel (r, c).
template <int kT>
__device__ __forceinline__ void stage_planes(float2* dst, const float* gx,
                                             const float* gy, int h, int w,
                                             int row_stride, int pix_stride,
                                             int border) {
  const int stride = staged_stride(w, border);
  const int total = (h + 3 * border) * stride;
  for (int idx = threadIdx.x; idx < total; idx += kT) {
    const int r = idx / stride;
    const int c = idx - r * stride;
    const int y = min(max(r - border, 0), h - 1);
    const int x = min(max(c - border, 0), w - 1);
    const size_t at = (size_t)y * row_stride + (size_t)x * pix_stride;
    dst[idx] = make_float2(__ldg(gx + at), __ldg(gy + at));
  }
}

// One row of a window: the 4 column taps in order, for x and for y.
__device__ __forceinline__ void add_row(float2 q0, float2 q1, float2 q2,
                                        float2 q3, const float wx[4],
                                        float wy, float& vx, float& vy) {
  float ax = wx[0] * q0.x;
  ax = ax + wx[1] * q1.x;
  ax = ax + wx[2] * q2.x;
  ax = ax + wx[3] * q3.x;
  float ay = wx[0] * q0.y;
  ay = ay + wx[1] * q1.y;
  ay = ay + wx[2] * q2.y;
  ay = ay + wx[3] * q3.y;
  vx = vx + wy * ax;
  vy = vy + wy * ay;
}

// The x and y values of one 4x4 window of a bordered staged plane: for each
// of the 4 rows the sum of its 4 column taps in order, then the rows summed
// in order.
__device__ __forceinline__ void sample_bordered(const float2* plane,
                                                int stride, int t1y,
                                                const float wy[4], int t1x,
                                                const float wx[4], float& vx,
                                                float& vy) {
  const float2* p = plane + t1y * stride + t1x;
  vx = 0.0f;
  vy = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    add_row(p[0], p[1], p[2], p[3], wx, wy[r], vx, vy);
    p += stride;
  }
}

// The same from a staged plane without the border, taps clamped to the map.
__device__ __forceinline__ void sample_clamped(const float2* plane, int stride,
                                               int h, int w, int t1y,
                                               const float wy[4], int t1x,
                                               const float wx[4], float& vx,
                                               float& vy) {
  int ty[4], tx[4];
  clamped_taps(t1y, h, ty);
  clamped_taps(t1x, w, tx);
  vx = 0.0f;
  vy = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2* p = plane + ty[r] * stride;
    add_row(p[tx[0]], p[tx[1]], p[tx[2]], p[tx[3]], wx, wy[r], vx, vy);
  }
}

// The same from the maps in global memory.
__device__ __forceinline__ void sample_global(const float* gx, const float* gy,
                                              int h, int w, int row_stride,
                                              int pix_stride, int t1y,
                                              const float wy[4], int t1x,
                                              const float wx[4], float& vx,
                                              float& vy) {
  int ty[4], tx[4];
  clamped_taps(t1y, h, ty);
  clamped_taps(t1x, w, tx);
  vx = 0.0f;
  vy = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* px = gx + (size_t)ty[r] * row_stride;
    const float* py = gy + (size_t)ty[r] * row_stride;
    float2 q[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      q[c] = make_float2(__ldg(px + tx[c] * pix_stride),
                         __ldg(py + tx[c] * pix_stride));
    add_row(q[0], q[1], q[2], q[3], wx, wy[r], vx, vy);
  }
}

// One window of a staged plane, whichever layout it has.
__device__ __forceinline__ void sample_staged(const float2* plane, int border,
                                              int h, int w, int t1y,
                                              const float wy[4], int t1x,
                                              const float wx[4], float& vx,
                                              float& vy) {
  const int stride = staged_stride(w, border);
  if (border)
    sample_bordered(plane, stride, t1y, wy, t1x, wx, vx, vy);
  else
    sample_clamped(plane, stride, h, w, t1y, wy, t1x, wx, vx, vy);
}

template <int kT>
__global__ void __launch_bounds__(kT, kT == kThreads ? kMinCtas : 1)
paf_score_kernel(const PafArgs a) {
  constexpr int kLinesPerPass = kT / 32 * kLinesPerWarp;
  extern __shared__ float2 planes[];
  const int row0 = blockIdx.x * kRowsPerCta;
  const int p = blockIdx.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int k = a.k;
  const int rows = min(row0 + kRowsPerCta, k) - row0;
  float* out = a.out + (((size_t)n * a.n_pairs + p) * k + row0) * k;
  const int part_a = a.pairs[2 * p];
  const int part_b = a.pairs[2 * p + 1];
  const int cx = a.map_idx[2 * p];
  const int cy = a.map_idx[2 * p + 1];

  // Uniform over the CTA: table entries outside the peaks or the maps (the
  // wrapper does not check values, which would sync the host) score NaN.
  if (part_a < 0 || part_a >= a.parts || part_b < 0 || part_b >= a.parts ||
      cx < 0 || cx >= a.channels || cy < 0 || cy >= a.channels) {
    for (int idx = tid; idx < rows * k; idx += kT) out[idx] = nanf("");
    return;
  }
  const float* pk_a = a.peaks + ((size_t)n * a.parts + part_a) * (k + 1) * 3;
  const float* pk_b = a.peaks + ((size_t)n * a.parts + part_b) * (k + 1) * 3;
  // i is a valid A peak when (float)i < count, that is i < ceil(count)
  const int cnt_a = min(max((int)ceilf(pk_a[0]), 0), k);
  const int cnt_b = min(max((int)ceilf(pk_b[0]), 0), k);
  const int rows_valid = min(max(cnt_a - row0, 0), rows);

  // -1 for every entry outside the count_A x count_B block, one coalesced
  // pass; the lines inside it are scored below.
  for (int idx = tid; idx < rows * k; idx += kT) {
    const int i = idx / k;
    const int j = idx - i * k;
    if (i >= rows_valid || j >= cnt_b) out[idx] = -1.0f;
  }
  // Uniform over the CTA: no valid A row or no valid B column.
  if (rows_valid == 0 || cnt_b == 0) return;

  for (int s = 0; s < a.n_scales; ++s) {
    if (a.smem_off[s] < 0) continue;
    const float* base = a.src[s] + (size_t)n * a.h[s] * a.w[s] * a.channels;
    stage_planes<kT>(planes + a.smem_off[s], base + cx, base + cy, a.h[s],
                     a.w[s], a.w[s] * a.channels, a.channels, a.border);
  }
  __syncthreads();

  // lanes [slot * kLineLanes, (slot + 1) * kLineLanes) of a warp share one
  // line; the lanes left over (32 is no multiple of 5) carry zeros
  const int lane = tid % 32;
  const int slot = lane / kLineLanes;
  const int g = lane - slot * kLineLanes;
  const bool lane_used = slot < kLinesPerWarp;
  const int first_lane = lane_used ? slot * kLineLanes : lane;
  const int n_lines = rows_valid * cnt_b;
  // every warp makes the same number of passes, so that all its lanes meet
  // at the shuffles; a slot past the last line carries zeros
  for (int q0 = 0; q0 < n_lines; q0 += kLinesPerPass) {
    const int q = q0 + (tid / 32) * kLinesPerWarp + slot;
    const bool active = lane_used && q < n_lines;
    const int i = active ? q / cnt_b : 0;
    const int j = active ? q - i * cnt_b : 0;
    const float ax = pk_a[(1 + row0 + i) * 3];
    const float ay = pk_a[(1 + row0 + i) * 3 + 1];
    const float bx = pk_b[(1 + j) * 3];
    const float by = pk_b[(1 + j) * 3 + 1];
    const float vx = bx - ax;
    const float vy = by - ay;
    const float linf = fmaxf(fabsf(vx), fabsf(vy));
    const float ns = fminf(fmaxf(floorf(sqrtf(5.0f * linf) + 0.5f), 5.0f),
                           (float)kMaxSamples);
    const float norm = sqrtf(vx * vx + vy * vy);
    const bool has_line = active && norm > 1e-6f;
    const float ux = vx / norm;
    const float uy = vy / norm;
    const float stepx = vx / ns;
    const float stepy = vy / ns;

    // this lane's samples l = g, g + kLineLanes, ...: the projection where
    // it is above the threshold, else 0 (adding 0 changes no sum)
    float vals[kRounds];
    int above = 0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const float fl = (float)(g + r * kLineLanes);
      vals[r] = 0.0f;
      if (has_line && fl < ns) {
        const float mx = fminf(fmaxf(floorf(ax + fl * stepx + 0.5f), 0.0f),
                               (float)(a.tw - 1));
        const float my = fminf(fmaxf(floorf(ay + fl * stepy + 0.5f), 0.0f),
                               (float)(a.th - 1));
        float valx = 0.0f;
        float valy = 0.0f;
        for (int s = 0; s < a.n_scales; ++s) {
          int t1y, t1x;
          float wy[4], wx[4], sx, sy;
          axis_taps(fused_source(my, a.scale_h[s], a.inv_h[s], a.off_h[s]),
                    a.h[s], t1y, wy);
          axis_taps(fused_source(mx, a.scale_w[s], a.inv_w[s], a.off_w[s]),
                    a.w[s], t1x, wx);
          if (a.smem_off[s] >= 0) {
            sample_staged(planes + a.smem_off[s], a.border, a.h[s], a.w[s],
                          t1y, wy, t1x, wx, sx, sy);
          } else {
            const float* base =
                a.src[s] + (size_t)n * a.h[s] * a.w[s] * a.channels;
            sample_global(base + cx, base + cy, a.h[s], a.w[s],
                          a.w[s] * a.channels, a.channels, t1y, wy, t1x, wx,
                          sx, sy);
          }
          valx = valx + sx;
          valy = valy + sy;
        }
        const float proj = (ux * valx + uy * valy) * a.inv_scales;
        if (proj > a.inter_threshold) {
          vals[r] = proj;
          above += 1;
        }
      }
    }
    // the line's count (an integer: any order) and its sum in line order
    int count = 0;
#pragma unroll
    for (int t = 0; t < kLineLanes; ++t)
      count += __shfl_sync(kFullMask, above, first_lane + t);
    float ssum = 0.0f;
#pragma unroll
    for (int l = 0; l < kMaxSamples; ++l)
      ssum = ssum + __shfl_sync(kFullMask, vals[l / kLineLanes],
                                first_lane + l % kLineLanes);
    if (g == 0 && active) {
      const float cnt = (float)count;
      float score;
      if (!has_line)
        score = -1.0f;
      else if (cnt / ns > a.inter_min_above)
        score = ssum / fmaxf(cnt, 1.0f);
      else
        score = norm < a.close_thr ? a.fallback_score : -1.0f;
      out[(size_t)i * k + j] = score;
    }
  }
}

constexpr int kSamplesPerThread = 4;
constexpr int kTileSamples = kThreadsWide * kSamplesPerThread;   // 2048

struct SampleArgs {
  const float* low_xy[kMaxScales]; // per scale [N, P, 2, h, w], contiguous
  int h[kMaxScales];
  int w[kMaxScales];
  float scale_h[kMaxScales];
  float scale_w[kMaxScales];
  int smem_off[kMaxScales];        // float2 offset of the staged plane, -1:
                                   // read from global memory
  int border;                      // staged planes carry the border
  int n_scales;
  const int* my;                   // [N, P, S] target-grid rows
  const int* mx;                   // [N, P, S] target-grid columns
  float* vx;                       // [N, P, S]
  float* vy;
  int n_pairs;
  int s;
};

__global__ void __launch_bounds__(kThreadsWide)
sample_bicubic_kernel(const SampleArgs a) {
  extern __shared__ float2 planes[];
  const size_t np = (size_t)blockIdx.z * a.n_pairs + blockIdx.y;
  for (int s = 0; s < a.n_scales; ++s) {
    if (a.smem_off[s] < 0) continue;
    const size_t hw = (size_t)a.h[s] * a.w[s];
    const float* gx = a.low_xy[s] + np * 2 * hw;
    stage_planes<kThreadsWide>(planes + a.smem_off[s], gx, gx + hw, a.h[s],
                               a.w[s], a.w[s], 1, a.border);
  }
  __syncthreads();

  const size_t base = np * a.s;
  // this CTA's tiles of the pair's samples: blockIdx.x, + gridDim.x, ...
  for (int first = blockIdx.x * kTileSamples; first < a.s;
       first += gridDim.x * kTileSamples) {
    // the coordinates of this thread's samples first, all in flight at
    // once; a warp's lanes are on neighbouring samples, which on the
    // sampled backend's lines read neighbouring taps
    int cys[kSamplesPerThread], cxs[kSamplesPerThread];
#pragma unroll
    for (int k = 0; k < kSamplesPerThread; ++k) {
      const int i = first + k * kThreadsWide + threadIdx.x;
      cys[k] = i < a.s ? __ldg(a.my + base + i) : 0;
      cxs[k] = i < a.s ? __ldg(a.mx + base + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < kSamplesPerThread; ++k) {
      const int i = first + k * kThreadsWide + threadIdx.x;
      if (i >= a.s) break;
      const int cy = cys[k];
      const int cx = cxs[k];
      float valx = 0.0f;
      float valy = 0.0f;
      for (int s = 0; s < a.n_scales; ++s) {
        int t1y, t1x;
        float wy[4], wx[4], sx, sy;
        axis_taps(half_pixel_source(cy, a.scale_h[s]), a.h[s], t1y, wy);
        axis_taps(half_pixel_source(cx, a.scale_w[s]), a.w[s], t1x, wx);
        if (a.smem_off[s] >= 0) {
          sample_staged(planes + a.smem_off[s], a.border, a.h[s], a.w[s],
                        t1y, wy, t1x, wx, sx, sy);
        } else {
          const size_t hw = (size_t)a.h[s] * a.w[s];
          const float* gx = a.low_xy[s] + np * 2 * hw;
          sample_global(gx, gx + hw, a.h[s], a.w[s], a.w[s], 1, t1y, wy, t1x,
                        wx, sx, sy);
        }
        valx = valx + sx;
        valy = valy + sy;
      }
      a.vx[base + i] = valx;
      a.vy[base + i] = valy;
    }
  }
}

// What the device allows one block of dynamic shared memory (227 KB on the
// H100), capped by smem_limit when that is positive.
cudaError_t block_smem_limit(int device, long long smem_limit, size_t* bytes) {
  int value = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *bytes = (size_t)value;
  if (smem_limit > 0 && (size_t)smem_limit < *bytes)
    *bytes = (size_t)smem_limit;
  return err;
}

// 1 / scale where scale is a power of two (the reciprocal and every product
// with it are then exact), else 0.
float exact_reciprocal(float scale) {
  int exponent = 0;
  const bool power_of_two =
      scale > 0.0f && std::isfinite(scale) && std::frexp(scale, &exponent) == 0.5f;
  return power_of_two ? 1.0f / scale : 0.0f;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Gives every scale that fits `limit` bytes, in scale order, its offset in
// shared memory (else -1) and returns the float2 pixels used.
size_t place_planes(const int* hs, const int* ws, int n_scales, int border,
                    size_t limit, int* smem_off) {
  size_t pixels = 0;
  for (int s = 0; s < n_scales; ++s) {
    const size_t need = staged_pixels(hs[s], ws[s], border);
    if ((pixels + need) * sizeof(float2) <= limit) {
      smem_off[s] = (int)pixels;
      pixels += need;
    } else {
      smem_off[s] = -1;
    }
  }
  return pixels;
}

// Bordered planes where every scale fits `limit` bytes with its border,
// else planes without borders, which lets more scales in (4 scales of
// 1312x736: 242 KB with, 226 KB without).  Returns the float2 pixels used.
size_t place_planes_either(const int* hs, const int* ws, int n_scales,
                           size_t limit, int* smem_off, int* border) {
  *border = 1;
  size_t pixels = place_planes(hs, ws, n_scales, 1, limit, smem_off);
  for (int s = 0; s < n_scales; ++s) {
    if (smem_off[s] >= 0) continue;
    *border = 0;
    return place_planes(hs, ws, n_scales, 0, limit, smem_off);
  }
  return pixels;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// srcs/hs/ws/scale_h/scale_w are host arrays of n_scales entries; every
// other pointer is device memory.  The sources are contiguous [N, h, w, C].
// smem_limit caps the dynamic shared memory a block may use (0: what the
// device allows); a scale that does not fit is read from global memory.
extern "C" int paf_score_launch(
    const void* const* srcs, const int* hs, const int* ws,
    const double* scale_h, const double* scale_w, int n_scales,
    int channels, const void* peaks, const void* pairs,
    const void* map_idx, void* out, int n, int parts, int n_pairs, int k,
    int th, int tw, double inter_threshold, double inter_min_above,
    double nms_threshold, long long smem_limit, int device, void* stream) {
  if (n_scales < 1 || n_scales > kMaxScales || k < 1 || k > kMaxPeaks ||
      th < 1 || tw < 1 || n < 0 || n > 65535 || n_pairs < 0 ||
      n_pairs > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t limit = 0;
  err = block_smem_limit(device, smem_limit, &limit);
  if (err != cudaSuccess) return (int)err;

  PafArgs a;
  for (int s = 0; s < n_scales; ++s) {
    if (hs[s] < 1 || ws[s] < 1) return (int)cudaErrorInvalidValue;
    a.src[s] = static_cast<const float*>(srcs[s]);
    a.h[s] = hs[s];
    a.w[s] = ws[s];
    a.scale_h[s] = (float)scale_h[s];
    a.scale_w[s] = (float)scale_w[s];
    a.inv_h[s] = exact_reciprocal(a.scale_h[s]);
    a.inv_w[s] = exact_reciprocal(a.scale_w[s]);
    a.off_h[s] = (float)(0.5 / scale_h[s] - 0.5);
    a.off_w[s] = (float)(0.5 / scale_w[s] - 0.5);
  }
  // A scale left in global memory is read through an L1 that the staged
  // ones have shrunk to almost nothing, so borders go before a scale does.
  const size_t smem_bytes =
      place_planes_either(hs, ws, n_scales, limit, a.smem_off, &a.border) *
      sizeof(float2);
  a.n_scales = n_scales;
  a.channels = channels;
  a.peaks = static_cast<const float*>(peaks);
  a.pairs = static_cast<const int*>(pairs);
  a.map_idx = static_cast<const int*>(map_idx);
  a.out = static_cast<float*>(out);
  a.parts = parts;
  a.n_pairs = n_pairs;
  a.k = k;
  a.th = th;
  a.tw = tw;
  a.inter_threshold = (float)inter_threshold;
  a.inter_min_above = (float)inter_min_above;
  a.fallback_score = (float)(nms_threshold + 1e-6);
  a.close_thr = (float)(std::sqrt((double)tw * th) / 150.0);
  a.inv_scales = (float)(1.0 / n_scales);

  const bool wide = smem_bytes > kWideAbove;
  err = wide ? allow_smem(paf_score_kernel<kThreadsWide>, smem_bytes)
             : allow_smem(paf_score_kernel<kThreads>, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || n_pairs == 0) return (int)cudaSuccess;
  const dim3 grid((k + kRowsPerCta - 1) / kRowsPerCta, n_pairs, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide)
    paf_score_kernel<kThreadsWide><<<grid, kThreadsWide, smem_bytes, st>>>(a);
  else
    paf_score_kernel<kThreads><<<grid, kThreads, smem_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// Launches the sampler on `stream` and returns cudaGetLastError() (0 on
// success).  lows/hs/ws/scale_h/scale_w are host arrays of n_scales entries;
// every other pointer is device memory.  smem_limit as in paf_score_launch.
extern "C" int sample_bicubic_launch(
    const void* const* lows, const int* hs, const int* ws,
    const double* scale_h, const double* scale_w, int n_scales,
    const void* my, const void* mx, void* vx, void* vy, int n, int n_pairs,
    int s, long long smem_limit, int device, void* stream) {
  if (n_scales < 1 || n_scales > kMaxScales || n < 0 || n_pairs < 0 ||
      n_pairs > 65535 || n > 65535 || s < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t limit = 0;
  err = block_smem_limit(device, smem_limit, &limit);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  // CTAs per (frame, pair): enough to put about four CTAs on every SM, each
  // walking over its share of the pair's tiles
  const int tiles = (s + kTileSamples - 1) / kTileSamples;
  const long long pairs_total = (long long)n * n_pairs;
  int ctas = 1;
  if (pairs_total > 0)
    ctas = (int)((4LL * sms + pairs_total - 1) / pairs_total);
  if (ctas > tiles) ctas = tiles;
  if (ctas < 1) ctas = 1;
  const long long samples_per_cta = ((long long)s + ctas - 1) / ctas;

  SampleArgs a;
  long long plane_values = 0;
  for (int i = 0; i < n_scales; ++i) {
    if (hs[i] < 1 || ws[i] < 1) return (int)cudaErrorInvalidValue;
    a.low_xy[i] = static_cast<const float*>(lows[i]);
    a.h[i] = hs[i];
    a.w[i] = ws[i];
    a.scale_h[i] = (float)scale_h[i];
    a.scale_w[i] = (float)scale_w[i];
    a.smem_off[i] = -1;
    plane_values += 2LL * hs[i] * ws[i];
  }
  // Where the line lies.  Staging is all or nothing: shared memory is carved
  // out of the SM's L1, so staging some scales leaves the others to be read
  // through almost no cache.  All the planes are staged, without their
  // borders where they do not fit with, when a CTA's samples read them at
  // least once over: 32 tap values per sample and scale against 2 * h * w
  // values copied per scale.  Below that the copy costs more than it saves,
  // and where not every scale fits the block's limit nothing is staged:
  // the planes are then read through the read-only cache.
  const bool pays = 32LL * n_scales * samples_per_cta >= plane_values;
  size_t pixels = 0;
  a.border = 1;
  if (pays) {
    pixels = place_planes_either(hs, ws, n_scales, limit, a.smem_off,
                                 &a.border);
    for (int i = 0; i < n_scales; ++i) {
      if (a.smem_off[i] >= 0) continue;
      pixels = 0;
      for (int j = 0; j < n_scales; ++j) a.smem_off[j] = -1;
      break;
    }
  }
  a.n_scales = n_scales;
  a.my = static_cast<const int*>(my);
  a.mx = static_cast<const int*>(mx);
  a.vx = static_cast<float*>(vx);
  a.vy = static_cast<float*>(vy);
  a.n_pairs = n_pairs;
  a.s = s;
  const size_t smem_bytes = pixels * sizeof(float2);
  err = allow_smem(sample_bicubic_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || n_pairs == 0 || s == 0) return (int)cudaSuccess;
  const dim3 grid(ctas, n_pairs, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sample_bicubic_kernel<<<grid, kThreadsWide, smem_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* paf_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
