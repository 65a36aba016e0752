// The epilogue of the CNN's bf16 convolutions for NVIDIA Hopper (sm_90a):
// the float32 bias, the rounding to bf16 and the activation in one pass over
// the convolution's NHWC output, in place.
//
// conv_epilogue_kernel replaces no TPU kernel: in the JAX package XLA fuses
// the bias and the activation into the convolution.  The port's convolution
// is cuDNN's, which cannot add a float32 bias to the float32 sum of bf16
// operands (models/graph.py's docstring), so the bias is added after it.
// Its plain version (ops/conv_epilogue.py::plain) runs that as PyTorch
// operations: the float32 bias add reads bf16 and writes float32 (6 bytes an
// element), the cast back 6, then ReLU 4 or PReLU 14 (the slope's cast, a
// compare, a product and a select: four launches).  This kernel reads each
// element once and writes it once: 4 bytes, one launch a convolution.
//
// The arithmetic is the plain version's, bit for bit:
//
//   y = bf16_rn(float(x) + bias[c])               the add in float32
//   ReLU:  isnan(y) ? y : bf16(fmaxf(y, 0))       clamp_min's, NaN kept
//   PReLU: y >= 0 ? y : bf16_rn(y * bf16_rn(slope[c]))
//   none:  y                                      the output convolutions
//
// Every product and sum rounds on its own (the library is built with
// -fmad=false); a value that is already bf16 converts to float and back
// exactly.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3, 700 W, 3.35 TB/s):
// bytes.  At conv1_2's 8 x 368 x 656 x 64 output it moves 494 MB, 0.147 ms;
// the operations (two or three an element) are far below the card's rate.
// It takes 0.175 ms there (84% of the bound), the plain sequence 0.96 ms;
// a batch-1 CPM stage's 46 x 82 x 96 PReLU output takes 2.3 us replayed in
// a CUDA graph, the plain sequence's six kernels 13 us.  What the design
// does about it:
//
//   * a block is (C / V) x P threads: threadIdx.x owns a fixed slice of V
//     channels, threadIdx.y a pixel, so a thread loads its bias and slope
//     slice once, into registers, and computes no channel index per
//     element; pixels follow one another in NHWC memory, so neighbouring
//     threads touch neighbouring addresses;
//   * V is 8 (16-byte loads and stores) where C % 8 == 0, every convolution
//     of the trunk and the CPM stages; 4, 2 or 1 for the output
//     convolutions' channel counts (BODY_25 26 and 52, COCO_18 19 and 38,
//     FACE_70 71, HAND_21 22);
//   * each thread has kUnroll loads in flight before it stores, and the grid
//     is capped at one full residency of the SMs, each block walking over
//     its share of the pixels; a small tensor (46 x 82 x 96 at batch 1)
//     takes as many blocks as it has pixel steps and finishes in a few us;
//   * in place: the convolution's output is read by nothing else, its
//     memory is not allocated twice, and where it still sits in the 50 MB
//     L2 (a CPM stage's tensors at batch 8 do) the next convolution reads
//     the result from there;
//   * under a trainer's autograd the PReLU's backward needs y, which the
//     output does not give back, so that instantiation (Keep) also writes
//     y to a second buffer: 6 bytes an element.  The ReLU's backward reads
//     the output, as F.relu's does, and needs nothing more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Act { kNone = 0, kRelu = 1, kPrelu = 2 };

constexpr int kThreads = 256;      // a block's threads, where C / V allows
constexpr int kMaxLanes = 1024;    // C / V: the threads of one pixel
constexpr int kUnroll = 4;         // loads in flight a thread
constexpr int kMaxDevices = 64;

// V bf16 values as one load: 16, 8, 4 or 2 bytes
template <int V> struct Raw;
template <> struct Raw<8> { using T = uint4; };
template <> struct Raw<4> { using T = uint2; };
template <> struct Raw<2> { using T = unsigned int; };
template <> struct Raw<1> { using T = unsigned short; };

template <int V>
union Pack {
  typename Raw<V>::T raw;
  unsigned short h[V];
};

__device__ __forceinline__ unsigned short biased(unsigned short bits,
                                                 float bias) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(
      __bfloat162float(__ushort_as_bfloat16(bits)) + bias));
}

template <int A>
__device__ __forceinline__ unsigned short activated(unsigned short bits,
                                                    float slope) {
  const float f = __bfloat162float(__ushort_as_bfloat16(bits));
  if (A == kRelu && !(f != f))
    return __bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(f, 0.0f)));
  if (A == kPrelu && !(f >= 0.0f))
    return __bfloat16_as_ushort(__float2bfloat16_rn(f * slope));
  return bits;
}

// x: [pixels, blockDim.x * V] bf16, overwritten; bias, slope: float32 [C]
// (slope read only for PReLU, rounded to bf16 here as `.to(bfloat16)` does);
// pre, where Keep: [pixels, C] bf16, written with the pre-activation (the
// biased, rounded sum) that the PReLU's backward reads
template <int V, int A, bool Keep>
__global__ void __launch_bounds__(kMaxLanes)
conv_epilogue_kernel(typename Raw<V>::T* __restrict__ x,
                     const float* __restrict__ bias,
                     const float* __restrict__ slope,
                     typename Raw<V>::T* __restrict__ pre, long long pixels) {
  const int c0 = threadIdx.x * V;
  float b[V], s[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    b[i] = __ldg(bias + c0 + i);
    s[i] = A == kPrelu
        ? __bfloat162float(__float2bfloat16_rn(__ldg(slope + c0 + i))) : 0.0f;
  }
  const long long lanes = blockDim.x;
  const long long rows = blockDim.y;
  const long long step = (long long)gridDim.x * rows * kUnroll;
  typename Raw<V>::T* base = x + threadIdx.x;
  typename Raw<V>::T* kept = Keep ? pre + threadIdx.x : nullptr;
  for (long long p0 = (long long)blockIdx.x * rows * kUnroll + threadIdx.y;
       p0 < pixels; p0 += step) {
    Pack<V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = p0 + u * rows;
      if (p < pixels) v[u].raw = base[p * lanes];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = p0 + u * rows;
      if (p >= pixels) continue;
      Pack<V> y;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        y.h[i] = biased(v[u].h[i], b[i]);
        v[u].h[i] = activated<A>(y.h[i], s[i]);
      }
      if (Keep) kept[p * lanes] = y.raw;
      base[p * lanes] = v[u].raw;
    }
  }
}

int sm_count(int device) {
  static int counts[kMaxDevices] = {0};
  if (device < 0 || device >= kMaxDevices) return 0;
  if (counts[device] == 0)
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount,
                           device);
  return counts[device];
}

template <int V>
cudaError_t launch(void* x, const float* bias, const float* slope, void* pre,
                   long long pixels, int channels, int act, int sms,
                   cudaStream_t stream) {
  using T = typename Raw<V>::T;
  const int lanes = channels / V;
  const int rows = lanes >= kThreads ? 1 : kThreads / lanes;
  const long long steps = (pixels + (long long)rows * kUnroll - 1) /
                          ((long long)rows * kUnroll);
  const long long resident = (long long)sms * (2048 / (lanes * rows));
  const int blocks = (int)(steps < resident ? steps : resident);
  const dim3 block(lanes, rows);
  auto* data = static_cast<T*>(x);
  auto* kept = static_cast<T*>(pre);
  if (act == kRelu)
    conv_epilogue_kernel<V, kRelu, false><<<blocks, block, 0, stream>>>(
        data, bias, slope, nullptr, pixels);
  else if (act == kPrelu && kept != nullptr)
    conv_epilogue_kernel<V, kPrelu, true><<<blocks, block, 0, stream>>>(
        data, bias, slope, kept, pixels);
  else if (act == kPrelu)
    conv_epilogue_kernel<V, kPrelu, false><<<blocks, block, 0, stream>>>(
        data, bias, slope, nullptr, pixels);
  else
    conv_epilogue_kernel<V, kNone, false><<<blocks, block, 0, stream>>>(
        data, bias, slope, nullptr, pixels);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` over x, `pixels` rows of `channels` contiguous bf16
// values (NHWC memory), in place, and returns cudaGetLastError() (0 on
// success).  act: 0 none, 1 ReLU, 2 PReLU (slope may be null otherwise).
// pre: null, or for PReLU a buffer of x's size that receives the
// pre-activation.  vec: the values a thread loads at once (8, 4, 2 or 1),
// dividing channels, with x and pre aligned to 2 * vec bytes and
// channels / vec at most 1024; anything else is cudaErrorInvalidValue.  The
// device that is current before the call is current after it.
extern "C" int conv_epilogue_launch(void* x, const void* bias,
                                    const void* slope, void* pre,
                                    long long pixels, int channels, int act,
                                    int vec, int device, void* stream) {
  const auto misaligned = [vec](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % (2 * vec) != 0;
  };
  if (pixels < 0 || channels < 1 || act < kNone || act > kPrelu ||
      (act == kPrelu && slope == nullptr) ||
      (pre != nullptr && act != kPrelu) ||
      (vec != 1 && vec != 2 && vec != 4 && vec != 8) || channels % vec != 0 ||
      channels / vec > kMaxLanes || misaligned(x) || misaligned(pre))
    return (int)cudaErrorInvalidValue;
  if (pixels == 0) return (int)cudaSuccess;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const int sms = sm_count(device);
  const auto* b = static_cast<const float*>(bias);
  const auto* s = static_cast<const float*>(slope);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sms < 1)
    err = cudaErrorInvalidDevice;
  else if (vec == 8)
    err = launch<8>(x, b, s, pre, pixels, channels, act, sms, st);
  else if (vec == 4)
    err = launch<4>(x, b, s, pre, pixels, channels, act, sms, st);
  else if (vec == 2)
    err = launch<2>(x, b, s, pre, pixels, channels, act, sms, st);
  else
    err = launch<1>(x, b, s, pre, pixels, channels, act, sms, st);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
