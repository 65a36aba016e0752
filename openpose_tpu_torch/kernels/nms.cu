// Peak finding of the body decode for NVIDIA Hopper (sm_90a): the 3x3
// local maxima of the merged part maps, placed in row-major order and
// capped at K slots a part, with each kept peak's 7x7 refinement window.
//
// These kernels replace no TPU kernel: the JAX package's NMS
// (openpose_tpu/ops/nms.py) is plain jnp, which XLA fuses.  The port's plain
// version (ops/nms.py::plain) runs it as ~90 PyTorch operations a call: two
// boolean masks built from 8 shifted full-map compares each, two padded
// copies of the maps, a cumulative sum over every pixel and a scatter of
// every pixel's index.  That is ~130 times the time of one read of the maps.
//
// The arithmetic is the plain version's, bit for bit:
//
//   is_peak = v > thr && ((interior && v > all 8) || (inner && v >= all 8))
//     interior = 1 < x < W-2 && 1 < y < H-2
//     inner    = x == 1 || x == W-2 || y == 1 || y == H-2
//     a neighbour outside the map is thr; thr is the float32 threshold
//   slots: the peaks of a part in row-major order, the first K kept
//   window: max(heat, 0) over the 7x7 around a kept peak (clamp_min's
//     isnan(v) ? v : fmaxf(v, 0)), 0 outside the map, and its products with
//     each sample's x and y
//   x = sum(window * x) / (sum(window) > 0 ? sum(window) : 1) + offset_x
//
// The three 49-term sums stay PyTorch's own `sum(-1)` over [N, C, K, 49]
// tensors of the same values as the plain version's, so their order of
// addition is the same; nms_refine_kernel then does the divide and the
// offset, each rounded on its own (the library is built with -fmad=false).
//
// What bounds it on the card (NVIDIA H100 80GB HBM3, 700 W, 3.35 TB/s):
// bytes.  One read of the maps: BODY_25's [8, 368, 656, 25] float32 is 193
// MB, 0.058 ms; the peaks written are 100 KB.  What the design does about
// it:
//
//   * nms_mark_kernel streams the maps once as one flat array of float4s,
//     kUnroll loads in flight a thread, over as many threads as the card
//     holds.  A value at or below the threshold costs one comparison.  A
//     warp queues its values above it (about 1% of them for rendered
//     people) and tests them a lane a value against their 8 neighbours,
//     which the L1 and L2 hold, setting the value's bit in a per-row mask
//     of each channel.  Designs that staged tiles in shared memory, or
//     slid a 3x3 window along a row in registers, spent more instructions
//     a value than the bandwidth leaves (0.13-0.34 ms at batch 8; chiefly
//     where the compiler ran the neighbour test on every value's path);
//   * nms_place_kernel, a block a (frame, channel) plane: each row's count
//     from its mask words, an exclusive scan of the counts for each row's
//     first slot, then only the rows whose first slot lies below K are
//     visited (rendered people give a few such rows a plane), a warp a row
//     and a lane a mask word, the peaks ranked by x through popcounts; the
//     kept peaks' values and 7x7 windows are written from their pixels;
//   * nothing depends on the data but what the kernels write: no host
//     synchronisation, and every scratch tensor has the same shape on
//     every call, so a CUDA graph captures and replays the call.
//
// At BODY_25's batch 8 a call takes 0.118 ms replayed in a graph, 49% of
// its bound (PyTorch's amax over the same maps: 0.070 ms): the mark kernel
// 0.078, the mask memset 0.003, place 0.012, the three sums 0.024, refine
// 0.002; the plain version 7.6 ms.  At batch 1, 0.033 ms against a bound of
// 0.0072 (launches and the place kernel's latency).  Noise that fills
// every slot puts half the values above the threshold: 0.45 ms.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRadius = 3;                       // the 7x7 refinement window
constexpr int kSide = 2 * kRadius + 1;
constexpr int kWindow = kSide * kSide;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kUnroll = 8;             // loads in flight a thread

// Marks the value heat[f] = v, above the threshold, where it is a peak:
// the plain version's comparisons against its 8 neighbours, thr outside
// the map.  Out of line, so that the compiler keeps this rare path out of
// the loop that streams the maps (it would else run it for every value).
__device__ __noinline__ void mark_if_peak(const float* __restrict__ heat,
                                          long long f, float v, int h, int w,
                                          int channels, float thr,
                                          unsigned* __restrict__ masks) {
  const long long pixel = f / channels;
  const int c = (int)(f - pixel * channels);
  const long long rows = pixel / w;
  const int x = (int)(pixel - rows * w);
  const int n = (int)(rows / h), y = (int)(rows - (long long)n * h);
  bool gt = true, ge = true;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const bool inside = y + dy >= 0 && y + dy < h && x + dx >= 0 &&
                          x + dx < w;
      const float nb =
          inside ? __ldg(heat + f + ((long long)dy * w + dx) * channels) : thr;
      gt &= v > nb;
      ge &= v >= nb;
    }
  }
  const bool interior = 1 < x && x < w - 2 && 1 < y && y < h - 2;
  const bool inner = x == 1 || x == w - 2 || y == 1 || y == h - 2;
  if ((interior && gt) || (inner && ge)) {
    const int words = (w + 31) / 32;
    atomicOr(masks + (((long long)n * channels + c) * h + y) * words + (x >> 5),
             1u << (x & 31));
  }
}

// heat: [N, H, W, C] float32, 16-byte aligned, `total` floats; masks:
// [N, C, H, ceil(W / 32)] uint32, zero before the launch, bit x % 32 of
// word x / 32 set where (x, y) is a peak of the channel.  The threads
// stream the maps as one flat array of float4s, kUnroll loads in flight
// each, in a grid-stride loop.  A warp queues its values above the
// threshold (a ballot each) and then tests them in mark_if_peak, a lane a
// value, their neighbours read through the L1 and L2: rendered people put
// about 1% of the values above the threshold, a few a warp's step, so
// the maps are read at the pace of the loads; noise puts half of them
// there.
__global__ void __launch_bounds__(kThreads)
nms_mark_kernel(const float* __restrict__ heat, long long total, int h, int w,
                int channels, float thr, unsigned* __restrict__ masks) {
  constexpr int kPerLane = 4 * kUnroll;
  __shared__ int queues[kWarps][kPerLane * 32];
  int* queue = queues[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const float4* quads = reinterpret_cast<const float4*>(heat);
  const long long n_quads = total / 4;
  const long long step = (long long)gridDim.x * kThreads;
  // the warp's first float4 of a step; its lanes' follow it
  for (long long i0 = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31);
       i0 < n_quads; i0 += step * kUnroll) {
    float v[kPerLane];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + lane + u * step;
      const float4 q = i < n_quads ? __ldg(quads + i)
                                   : make_float4(thr, thr, thr, thr);
      v[4 * u] = q.x;
      v[4 * u + 1] = q.y;
      v[4 * u + 2] = q.z;
      v[4 * u + 3] = q.w;
    }
    // queue entry: the value's place k in v and the lane that holds it
    int queued = 0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const unsigned above = __ballot_sync(kAll, v[k] > thr);
      if (v[k] > thr)
        queue[queued + __popc(above & ((1u << lane) - 1u))] = k * 32 + lane;
      queued += __popc(above);
    }
    __syncwarp();
    for (int e = lane; e < queued; e += 32) {
      const int k = queue[e] / 32, from = queue[e] % 32;
      const long long f = 4 * (i0 + from + (long long)(k / 4) * step) + k % 4;
      mark_if_peak(heat, f, __ldg(heat + f), h, w, channels, thr, masks);
    }
    __syncwarp();
  }
  // the last total % 4 values
  const long long f = 4 * n_quads + (long long)blockIdx.x * kThreads +
                      threadIdx.x;
  if (f < total) {
    const float last = __ldg(heat + f);
    if (last > thr) mark_if_peak(heat, f, last, h, w, channels, thr, masks);
  }
}

// The exclusive prefix of each thread's value over the block, in thread
// order; `total` receives the sum.  Every thread of the block calls it.
__device__ int exclusive_scan(int value, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int sum = value;
  for (int d = 1; d < 32; d <<= 1) {
    const int other = __shfl_up_sync(kAll, sum, d);
    if (lane >= d) sum += other;
  }
  if (lane == 31) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
    for (int d = 1; d < kWarps; d <<= 1) {
      const int other = __shfl_up_sync(kAll, s, d);
      if (lane >= d) s += other;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return (warp > 0 ? warp_sums[warp - 1] : 0) + sum - value;
}

// One block of kThreads a (channel, frame) plane, grid (C, N).  masks:
// nms_mark_kernel's; peaks: [N, C, K+1, 3], row 0 (count, 0, 0), then
// (0, 0, value) for each kept slot and zeros past the count (x and y are
// nms_refine_kernel's); win, win_x, win_y: [N, C, K, 49], a kept slot's
// window of max(heat, 0) and its products with each sample's x and y (the
// slots past the count are not written).  Dynamic shared memory: H + 1 + K
// ints.
__global__ void __launch_bounds__(kThreads)
nms_place_kernel(const float* __restrict__ heat,
                 const unsigned* __restrict__ masks, int h, int w,
                 int channels, int k, float* __restrict__ peaks,
                 float* __restrict__ win, float* __restrict__ win_x,
                 float* __restrict__ win_y) {
  extern __shared__ int smem[];
  int* first = smem;               // [H + 1]: each row's first slot, total
  int* pixel = smem + h + 1;       // [K]: each slot's y * W + x
  __shared__ int warp_sums[kWarps];
  const int c = blockIdx.x, n = blockIdx.y;
  const long long plane = (long long)n * channels + c;
  const int words = (w + 31) / 32;
  const unsigned* plane_mask = masks + plane * h * words;

  // each row's peaks, from the plane's mask words, kUnroll loads in flight
  // a thread
  for (int i = threadIdx.x; i < h; i += kThreads) first[i] = 0;
  __syncthreads();
  for (int i0 = threadIdx.x; i0 < h * words; i0 += kUnroll * kThreads) {
    unsigned bits[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      bits[u] = i < h * words ? __ldg(plane_mask + i) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (bits[u])
        atomicAdd(first + (i0 + u * kThreads) / words, __popc(bits[u]));
  }
  __syncthreads();
  // each thread scans a contiguous stretch of rows
  const int per = (h + kThreads - 1) / kThreads;
  const int lo = min((int)threadIdx.x * per, h), hi = min(lo + per, h);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += first[i];
  int total = 0;
  int slot = exclusive_scan(sum, warp_sums, &total);
  for (int i = lo; i < hi; ++i) {
    const int count = first[i];
    first[i] = slot;
    slot += count;
  }
  if (threadIdx.x == 0) first[h] = total;
  __syncthreads();
  const int kept = min(total, k);

  // the rows with a slot below K, a warp a row: a lane a word of the row's
  // mask, the peaks ranked by x through the words' counts
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int y = warp; y < h; y += kWarps) {
    int next = first[y];
    if (next >= k || first[y + 1] == next) continue;
    const unsigned* row = plane_mask + (long long)y * words;
    for (int j0 = 0; j0 < words && next < k; j0 += 32) {
      const int j = j0 + lane;
      unsigned bits = j < words ? __ldg(row + j) : 0u;
      const int count = __popc(bits);
      int upto = count;                 // the inclusive sum over the lanes
      for (int d = 1; d < 32; d <<= 1) {
        const int other = __shfl_up_sync(kAll, upto, d);
        if (lane >= d) upto += other;
      }
      for (int s = next + upto - count; bits && s < k; ++s) {
        pixel[s] = y * w + j * 32 + __ffs(bits) - 1;
        bits &= bits - 1u;
      }
      next += __shfl_sync(kAll, upto, 31);
    }
  }
  __syncthreads();
  const float* frame = heat + (long long)n * h * w * channels;

  float* out = peaks + plane * (k + 1) * 3;
  for (int i = threadIdx.x; i < (k + 1) * 3; i += kThreads) {
    const int s = i / 3 - 1, col = i % 3;
    float v = 0.0f;
    if (s < 0 && col == 0)
      v = (float)kept;
    else if (s >= 0 && s < kept && col == 2)
      v = frame[(long long)pixel[s] * channels + c];
    out[i] = v;
  }
  // the kept slots' windows; the empty slots' are left as they are, since
  // nms_refine_kernel reads no sum past the count
  const long long base = plane * k * kWindow;
  for (int i = threadIdx.x; i < kept * kWindow; i += kThreads) {
    const int s = i / kWindow, j = i % kWindow;
    const int py = pixel[s] / w, px = pixel[s] % w;
    const int sy = py + j / kSide - kRadius, sx = px + j % kSide - kRadius;
    float wv = 0.0f;
    if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
      const float v = frame[((long long)sy * w + sx) * channels + c];
      wv = isnan(v) ? v : fmaxf(v, 0.0f);
    }
    win[base + i] = wv;
    win_x[base + i] = wv * (float)sx;
    win_y[base + i] = wv * (float)sy;
  }
}

// s, sx, sy: [N * C * K], the windows' sums; peaks as nms_place_kernel left
// them.  Each kept slot's x and y: the centroid plus the offset.
__global__ void nms_refine_kernel(const float* __restrict__ s,
                                  const float* __restrict__ sx,
                                  const float* __restrict__ sy,
                                  float* __restrict__ peaks, long long slots,
                                  int k, float off_x, float off_y) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= slots) return;
  const long long plane = i / k;
  const int slot = (int)(i - plane * k);
  float* out = peaks + plane * (k + 1) * 3;
  if (slot >= (int)out[0]) return;
  const float denom = s[i] > 0.0f ? s[i] : 1.0f;
  out[3 * (slot + 1)] = sx[i] / denom + off_x;
  out[3 * (slot + 1) + 1] = sy[i] / denom + off_y;
}

// What one block may hold of dynamic shared memory, opting in above 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int device) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Runs `launch` with `device` current, and makes the device that was
// current before it current again.
template <typename Launch>
int on_device(int device, Launch launch) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  err = launch();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// How many blocks of nms_mark_kernel the card holds at once (0 on an
// error): the grid that keeps every one of its threads streaming.
int resident_mark_blocks(int device) {
  static int blocks[kMaxDevices] = {0};
  if (device < 0 || device >= kMaxDevices) return 0;
  if (blocks[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, nms_mark_kernel, kThreads, 0) == cudaSuccess)
      blocks[device] = sms * per_sm;
  }
  return blocks[device];
}

cudaError_t launch_peaks(const float* heat, unsigned* masks, float* peaks,
                         float* win, float* win_x, float* win_y, int n,
                         int h, int w, int channels, int k, float thr,
                         int device, cudaStream_t stream) {
  const size_t place_smem = ((size_t)h + 1 + k) * sizeof(int);
  cudaError_t err = allow_smem(nms_place_kernel, place_smem, device);
  if (err != cudaSuccess) return err;
  const long long total = (long long)n * h * w * channels;
  if (total > 0) {
    const int full = resident_mark_blocks(device);
    if (full < 1) return cudaErrorInvalidDevice;
    err = cudaMemsetAsync(masks, 0,
                          (size_t)n * channels * h * ((w + 31) / 32) *
                              sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
    // no more blocks than have a step of kUnroll float4s a thread
    const long long steps = (total / 4 + kUnroll - 1) / kUnroll;
    const long long needed = (steps + kThreads - 1) / kThreads;
    const int blocks = (int)(needed < full ? (needed > 0 ? needed : 1) : full);
    nms_mark_kernel<<<blocks, kThreads, 0, stream>>>(heat, total, h, w,
                                                     channels, thr, masks);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  nms_place_kernel<<<dim3(channels, n), kThreads, place_smem, stream>>>(
      heat, masks, h, w, channels, k, peaks, win, win_x, win_y);
  return cudaGetLastError();
}

}  // namespace

// Launches a memset of masks, nms_mark_kernel and nms_place_kernel on
// `stream`: heat [n, h, w, channels] float32 (NHWC, contiguous, 16-byte
// aligned); masks [n, channels, h, ceil(w / 32)] int32 scratch; peaks
// [n, channels, k+1, 3] float32, written whole; win, win_x, win_y
// [n, channels, k, 49] float32, written for the kept slots.  threshold is
// rounded to float32 once.  Returns the CUDA error code (0 on success);
// cudaErrorInvalidValue for a negative size, a grid beyond the card's, a
// misaligned heat, or h + 1 + k ints beyond a block's shared memory.  The
// device that is current before the call is current after it.
extern "C" int nms_peaks_launch(const void* heat, void* masks, void* peaks,
                                void* win, void* win_x, void* win_y, int n,
                                int h, int w, int channels, int k,
                                double threshold, int device, void* stream) {
  if (n < 0 || h < 0 || w < 0 || channels < 0 || k < 0 || n > 65535 ||
      channels > 65535 || (long long)h * w > 0x7fffffffLL ||
      (long long)k * kWindow > 0x7fffffffLL ||
      reinterpret_cast<unsigned long long>(heat) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || channels == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    return launch_peaks(
        static_cast<const float*>(heat), static_cast<unsigned*>(masks),
        static_cast<float*>(peaks), static_cast<float*>(win),
        static_cast<float*>(win_x), static_cast<float*>(win_y), n, h, w,
        channels, k, (float)threshold, device,
        static_cast<cudaStream_t>(stream));
  });
}

// Launches nms_refine_kernel on `stream` over `slots` = n * channels * k
// sums (s, sx, sy float32) into peaks [n, channels, k+1, 3]; the offsets are
// rounded to float32 once.  Returns the CUDA error code (0 on success).
extern "C" int nms_refine_launch(const void* s, const void* sx,
                                 const void* sy, void* peaks,
                                 long long slots, int k, double offset_x,
                                 double offset_y, int device, void* stream) {
  if (slots < 0 || k < 0 || (k == 0 && slots != 0))
    return (int)cudaErrorInvalidValue;
  if (slots == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    const long long blocks = (slots + kThreads - 1) / kThreads;
    nms_refine_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(s), static_cast<const float*>(sx),
        static_cast<const float*>(sy), static_cast<float*>(peaks), slots, k,
        (float)offset_x, (float)offset_y);
    return cudaGetLastError();
  });
}
