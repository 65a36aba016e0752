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
// The TPU kernel builds dense tap matrices to feed its matrix unit; here the
// taps are direct reads, the shape of the reference pafScoreKernel
// (bodyPartConnectorBase.cu).  One CTA covers one (frame, pair) and 16 rows
// of A peaks: 128 threads along j (K <= 128) by 4 along i.
//
// What bounds it on the card: each (i, j) reads up to 25 samples x 16 taps x
// 2 channels per scale, about 2.7e9 map reads at batch 8, K = 127, 26 pairs,
// against ~10 MB of low-res maps and 13 MB of scores in device memory.  The
// map reads, not device-memory bytes or flops, are the bound.  So the CTA
// stages the pair's x/y maps (30 KB at 368x656) in shared memory once and
// every tap read hits shared memory; scales beyond a 96 KB budget are read
// through the read-only cache instead.  A CTA whose rows are all past
// count_A writes -1 and exits before staging, the counterpart of the TPU
// kernel's per-row skip, so the cost follows the real peak counts.
//
// 2. sample_bicubic_kernel replaces the TPU kernel `sample_bicubic_pallas`
// (same file, kernel body `_make_kernel`, taps `_tap_weights_t`): the
// Catmull-Rom value of one pair's 8x-upsampled PAF x and y maps at integer
// target pixels (my, mx), with the tap source coordinate of that kernel,
// src = (coord + 0.5) / scale - 0.5.  The two formulas agree only in exact
// arithmetic, so each kernel keeps its TPU counterpart's.  The TPU kernel
// contracts dense [taps, 2048] weight matrices on its matrix unit; here one
// thread reads the 16 taps of a sample directly.  One CTA covers one
// (frame, pair) and 2048 samples (8 per thread, neighbouring threads on
// neighbouring samples).  What bounds it: 32 tap reads per sample against
// 16 bytes of coordinates in and 8 bytes of values out; at the profile shape
// (8 x 26 pairs x 403,225 samples) 2.7e9 tap reads and 2.0 GB of device
// memory traffic.  The pair's two planes are staged in shared memory when
// they fit the 96 KB budget (30 KB at 46x82), else read through the
// read-only cache.  Any S works, with no padding; any coordinate value is
// clamped to the map, so no read leaves it.
//
// Numerics: f32 throughout, built with -fmad=false so that every multiply
// and add rounds on its own, in the same order as the plain PyTorch versions
// (ops/paf.py paf_scores_multiscale_reference, sample_bicubic_reference);
// the two then agree bit for bit, and threshold decisions (proj > 0.05)
// cannot flip between them.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxScales = 8;
constexpr int kMaxSamples = 25;
constexpr int kLanes = 128;        // threads along j; K <= 128
constexpr int kRowThreads = 4;     // threads along i
constexpr int kRowsPerCta = 16;    // A peaks per CTA
constexpr size_t kSmemBudget = 96 * 1024;

struct PafArgs {
  const float* src[kMaxScales];    // per scale [N, C, h, w], contiguous
  int h[kMaxScales];
  int w[kMaxScales];
  float scale_h[kMaxScales];
  float scale_w[kMaxScales];
  float off_h[kMaxScales];         // 0.5 / scale_h - 0.5
  float off_w[kMaxScales];
  int smem_off[kMaxScales];        // float offset of the staged maps, -1: global
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
// + cubicInterpolate of the reference): t1 = clamp(floor(src)), the other
// taps clamped to the map, dx measured from the clamped t1.
__device__ __forceinline__ void cubic_taps(float src, int in_size, int t[4],
                                           float wt[4]) {
  const float t1 = fminf(fmaxf(floorf(src), 0.0f), (float)(in_size - 1));
  const float d = src - t1;
  const float d2 = d * d;
  const float d3 = d2 * d;
  wt[0] = -0.5f * d3 + d2 - 0.5f * d;
  wt[1] = 1.5f * d3 - 2.5f * d2 + 1.0f;
  wt[2] = -1.5f * d3 + 2.0f * d2 + 0.5f * d;
  wt[3] = 0.5f * d3 - 0.5f * d2;
  const int t1i = (int)t1;
  t[0] = max(0, t1i - 1);
  t[1] = t1i;
  t[2] = min(in_size - 1, t1i + 1);
  t[3] = min(in_size - 1, t[2] + 1);
}

// Source coordinate of a target coordinate in the fused TPU kernel
// (paf_pallas.py `_paf_fused_kernel`): coord / scale + (0.5 / scale - 0.5).
__device__ __forceinline__ float fused_source(float coord, float scale,
                                              float off) {
  return coord / scale + off;
}

// ... and in the TPU sampler (paf_pallas.py `_tap_weights_t`, paf.py
// `_tap_matrix`): (coord + 0.5) / scale - 0.5.
__device__ __forceinline__ float half_pixel_source(int coord, float scale) {
  return ((float)coord + 0.5f) / scale - 0.5f;
}

__device__ __forceinline__ float sample_map(const float* m, int w,
                                            const int ty[4], const float wy[4],
                                            const int tx[4], const float wx[4]) {
  float v = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* row = m + ty[r] * w;
    float acc = wx[0] * row[tx[0]];
    acc = acc + wx[1] * row[tx[1]];
    acc = acc + wx[2] * row[tx[2]];
    acc = acc + wx[3] * row[tx[3]];
    v = v + wy[r] * acc;
  }
  return v;
}

__device__ float pair_score(const PafArgs& a, const float* const* map_x,
                            const float* const* map_y, float ax, float ay,
                            float bx, float by) {
  const float vx = bx - ax;
  const float vy = by - ay;
  const float linf = fmaxf(fabsf(vx), fabsf(vy));
  const float ns = fminf(fmaxf(floorf(sqrtf(5.0f * linf) + 0.5f), 5.0f),
                         (float)kMaxSamples);
  const float norm = sqrtf(vx * vx + vy * vy);
  if (!(norm > 1e-6f)) return -1.0f;
  const float ux = vx / norm;
  const float uy = vy / norm;
  const float stepx = vx / ns;
  const float stepy = vy / ns;
  float cnt = 0.0f;
  float ssum = 0.0f;
  for (int l = 0; l < kMaxSamples; ++l) {
    const float fl = (float)l;
    if (!(fl < ns)) break;
    const float mx = fminf(fmaxf(floorf(ax + fl * stepx + 0.5f), 0.0f),
                           (float)(a.tw - 1));
    const float my = fminf(fmaxf(floorf(ay + fl * stepy + 0.5f), 0.0f),
                           (float)(a.th - 1));
    float valx = 0.0f;
    float valy = 0.0f;
    for (int s = 0; s < a.n_scales; ++s) {
      int ty[4], tx[4];
      float wy[4], wx[4];
      cubic_taps(fused_source(my, a.scale_h[s], a.off_h[s]), a.h[s], ty, wy);
      cubic_taps(fused_source(mx, a.scale_w[s], a.off_w[s]), a.w[s], tx, wx);
      valx = valx + sample_map(map_x[s], a.w[s], ty, wy, tx, wx);
      valy = valy + sample_map(map_y[s], a.w[s], ty, wy, tx, wx);
    }
    const float proj = (ux * valx + uy * valy) * a.inv_scales;
    if (proj > a.inter_threshold) {
      cnt = cnt + 1.0f;
      ssum = ssum + proj;
    }
  }
  const bool accepted = cnt / ns > a.inter_min_above;
  if (accepted) return ssum / fmaxf(cnt, 1.0f);
  return norm < a.close_thr ? a.fallback_score : -1.0f;
}

// This thread's entries of rows [row0, row_end) of one (frame, pair) block.
__device__ __forceinline__ void fill_rows(float* out, int row0, int row_end,
                                          int k, float value) {
  if (threadIdx.x >= k) return;
  for (int i = row0 + threadIdx.y; i < row_end; i += kRowThreads)
    out[(size_t)i * k + threadIdx.x] = value;
}

__global__ void __launch_bounds__(kLanes * kRowThreads)
paf_score_kernel(const PafArgs a) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * kRowsPerCta;
  const int p = blockIdx.y;
  const int n = blockIdx.z;
  const int j = threadIdx.x;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int k = a.k;
  const int row_end = min(row0 + kRowsPerCta, k);
  float* out = a.out + ((size_t)n * a.n_pairs + p) * k * k;
  const int part_a = a.pairs[2 * p];
  const int part_b = a.pairs[2 * p + 1];
  const int cx = a.map_idx[2 * p];
  const int cy = a.map_idx[2 * p + 1];

  // Uniform over the CTA: table entries outside the peaks or the maps (the
  // wrapper does not check values, which would sync the host) score NaN.
  if (part_a < 0 || part_a >= a.parts || part_b < 0 || part_b >= a.parts ||
      cx < 0 || cx >= a.channels || cy < 0 || cy >= a.channels) {
    fill_rows(out, row0, row_end, k, nanf(""));
    return;
  }
  const float* pk_a = a.peaks + ((size_t)n * a.parts + part_a) * (k + 1) * 3;
  const float* pk_b = a.peaks + ((size_t)n * a.parts + part_b) * (k + 1) * 3;
  const float cnt_a = pk_a[0];
  const float cnt_b = pk_b[0];

  // Uniform over the CTA: no valid A row or no valid B column.
  if (!((float)row0 < cnt_a) || !(0.0f < cnt_b)) {
    fill_rows(out, row0, row_end, k, -1.0f);
    return;
  }

  const float* map_x[kMaxScales];
  const float* map_y[kMaxScales];
  for (int s = 0; s < a.n_scales; ++s) {
    const size_t hw = (size_t)a.h[s] * a.w[s];
    const float* gx = a.src[s] + ((size_t)n * a.channels + cx) * hw;
    const float* gy = a.src[s] + ((size_t)n * a.channels + cy) * hw;
    if (a.smem_off[s] < 0) {
      map_x[s] = gx;
      map_y[s] = gy;
      continue;
    }
    float* sx = smem + a.smem_off[s];
    float* sy = sx + hw;
    for (size_t idx = tid; idx < hw; idx += kLanes * kRowThreads) {
      sx[idx] = __ldg(gx + idx);
      sy[idx] = __ldg(gy + idx);
    }
    map_x[s] = sx;
    map_y[s] = sy;
  }
  __syncthreads();

  if (j >= k) return;
  const bool col_ok = (float)j < cnt_b;
  const float bx = col_ok ? pk_b[(1 + j) * 3] : 0.0f;
  const float by = col_ok ? pk_b[(1 + j) * 3 + 1] : 0.0f;
  for (int i = row0 + threadIdx.y; i < row_end; i += kRowThreads) {
    float score = -1.0f;
    if (col_ok && (float)i < cnt_a)
      score = pair_score(a, map_x, map_y, pk_a[(1 + i) * 3],
                         pk_a[(1 + i) * 3 + 1], bx, by);
    out[(size_t)i * k + j] = score;
  }
}

constexpr int kSampleThreads = 256;
constexpr int kSamplesPerThread = 8;   // 2048 samples per CTA

struct SampleArgs {
  const float* low_xy;             // [N, P, 2, h, w], contiguous
  const int* my;                   // [N, P, S] target-grid rows
  const int* mx;                   // [N, P, S] target-grid columns
  float* vx;                       // [N, P, S]
  float* vy;
  int n_pairs;
  int h;
  int w;
  int s;
  float scale_h;
  float scale_w;
  bool staged;                     // the pair's planes in shared memory
};

__global__ void __launch_bounds__(kSampleThreads)
sample_bicubic_kernel(const SampleArgs a) {
  extern __shared__ float smem[];
  const size_t np = (size_t)blockIdx.z * a.n_pairs + blockIdx.y;
  const size_t hw = (size_t)a.h * a.w;
  const float* map_x = a.low_xy + np * 2 * hw;
  const float* map_y = map_x + hw;
  if (a.staged) {
    for (size_t idx = threadIdx.x; idx < 2 * hw; idx += kSampleThreads)
      smem[idx] = __ldg(map_x + idx);
    __syncthreads();
    map_x = smem;
    map_y = smem + hw;
  }
  const size_t base = np * a.s;
  const int first = blockIdx.x * kSampleThreads * kSamplesPerThread;
#pragma unroll
  for (int k = 0; k < kSamplesPerThread; ++k) {
    const int i = first + k * kSampleThreads + threadIdx.x;
    if (i >= a.s) break;
    int ty[4], tx[4];
    float wy[4], wx[4];
    cubic_taps(half_pixel_source(__ldg(a.my + base + i), a.scale_h), a.h, ty,
               wy);
    cubic_taps(half_pixel_source(__ldg(a.mx + base + i), a.scale_w), a.w, tx,
               wx);
    a.vx[base + i] = sample_map(map_x, a.w, ty, wy, tx, wx);
    a.vy[base + i] = sample_map(map_y, a.w, ty, wy, tx, wx);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// srcs/hs/ws/scale_h/scale_w are host arrays of n_scales entries; every
// other pointer is device memory.
extern "C" int paf_score_launch(
    const void* const* srcs, const int* hs, const int* ws,
    const double* scale_h, const double* scale_w, int n_scales,
    int channels, const void* peaks, const void* pairs, const void* map_idx,
    void* out, int n, int parts, int n_pairs, int k, int th, int tw,
    double inter_threshold, double inter_min_above, double nms_threshold,
    int device, void* stream) {
  if (n_scales < 1 || n_scales > kMaxScales || k < 1 || k > kLanes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  PafArgs a;
  size_t smem_floats = 0;
  for (int s = 0; s < n_scales; ++s) {
    a.src[s] = static_cast<const float*>(srcs[s]);
    a.h[s] = hs[s];
    a.w[s] = ws[s];
    a.scale_h[s] = (float)scale_h[s];
    a.scale_w[s] = (float)scale_w[s];
    a.off_h[s] = (float)(0.5 / scale_h[s] - 0.5);
    a.off_w[s] = (float)(0.5 / scale_w[s] - 0.5);
    const size_t need = 2 * (size_t)hs[s] * ws[s];
    if ((smem_floats + need) * sizeof(float) <= kSmemBudget) {
      a.smem_off[s] = (int)smem_floats;
      smem_floats += need;
    } else {
      a.smem_off[s] = -1;
    }
  }
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

  const size_t smem_bytes = smem_floats * sizeof(float);
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(paf_score_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (n == 0 || n_pairs == 0) return (int)cudaSuccess;
  const dim3 grid((k + kRowsPerCta - 1) / kRowsPerCta, n_pairs, n);
  const dim3 block(kLanes, kRowThreads);
  paf_score_kernel<<<grid, block, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Launches the sampler on `stream` and returns cudaGetLastError() (0 on
// success).  Every pointer is device memory.
extern "C" int sample_bicubic_launch(
    const void* low_xy, const void* my, const void* mx, void* vx, void* vy,
    int n, int n_pairs, int h, int w, int s, double scale_h, double scale_w,
    int device, void* stream) {
  if (n < 0 || n_pairs < 0 || n_pairs > 65535 || n > 65535 || h < 1 ||
      w < 1 || s < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  SampleArgs a;
  a.low_xy = static_cast<const float*>(low_xy);
  a.my = static_cast<const int*>(my);
  a.mx = static_cast<const int*>(mx);
  a.vx = static_cast<float*>(vx);
  a.vy = static_cast<float*>(vy);
  a.n_pairs = n_pairs;
  a.h = h;
  a.w = w;
  a.s = s;
  a.scale_h = (float)scale_h;
  a.scale_w = (float)scale_w;
  const size_t plane_bytes = 2 * (size_t)h * w * sizeof(float);
  a.staged = plane_bytes <= kSmemBudget;
  const size_t smem_bytes = a.staged ? plane_bytes : 0;
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(sample_bicubic_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  if (n == 0 || n_pairs == 0 || s == 0) return (int)cudaSuccess;
  const int per_cta = kSampleThreads * kSamplesPerThread;
  const dim3 grid((s + per_cta - 1) / per_cta, n_pairs, n);
  sample_bicubic_kernel<<<grid, kSampleThreads, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* paf_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
