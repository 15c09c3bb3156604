// bn_act: eval-mode BatchNorm's fold, apply and activation in one pass, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's eval
// BatchNorm (yolo_continuous_tpu/nn/layers.py, _BNCore) with its activation
// into the convolution's consumers. The port's plain version
// (yolo_continuous_tpu_torch/kernels/bn_act.py::bn_act_plain) is about ten
// launches a call: seven per-channel kernels fold the running statistics
// (rsqrt, products, a difference, two casts), then x * inv and + shift run as
// two broadcast passes over the map (a stride-0 operand sends both to
// PyTorch's non-vectorised elementwise kernel), then the activation as a
// third pass.
//
// What bounds it on the H100: bytes. The work is a few operations an element
// (a silu's exp and division the most), against one read and one write of a
// bf16 map; a yolov7 request at 640 and batch 32 moves 11.2 GB through its
// 92 eval BatchNorms, 3.35 ms at 3.35 TB/s. One read and one write of the map
// is the whole design.
//
// The map is NCHW-contiguous, and each (n, c) plane has its own threads, so
// no element is divided to find its channel: a large plane a block-row
// (blockIdx.x), in chunks along blockIdx.y; small planes (a yolov7 @640
// request has them down to 20 x 20) a power-of-two group of a block's
// threads each, so that the block's threads all work. Each thread folds its
// channel itself from the four fp32 (C,) vectors (four cached loads and an
// rsqrt), so no cache of the fold can go stale when weights are reloaded.
// Threads stream the plane 16 bytes at a time, kVecs vectors in flight each;
// the elements before the plane's first 16-byte boundary and after its last
// are done one at a time.
//
// The arithmetic is the plain version's, rounded where it rounds, so the
// result is equal to it bit for bit:
//
//   inv = w * rsqrt(var + eps), shift = b - mean * inv      (fp32, torch's ops)
//   t = round(x * round(inv)), u = round(t + round(shift))  (round: to x's dtype)
//   y = round(act(u))                                       (act in fp32)
//
// Each product and sum is an explicit _rn intrinsic, so nothing contracts
// into a fused multiply-add that torch's separate kernels do not have. In
// bf16 and fp16 the product of two such values is exact in fp32, so it is
// rounded once, as torch's fp32 opmath rounds it. The activations are
// written as PyTorch's CUDA functors write them: silu u / (1 + expf(-u)),
// leaky u > 0 ? u : u * slope, hardswish u * min(max(u + 3, 0), 6) * (1/6),
// relu NaN-propagating max(u, 0).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreadsLog2 = 8;
constexpr int kThreads = 1 << kThreadsLog2;
constexpr int kVecs = 4;                 // 16-byte vectors in flight a thread

enum Act { kIdentity = 0, kSilu = 1, kRelu = 2, kLeaky = 3, kHardswish = 4 };

struct F32 {
  using Bits = float;
  static __device__ __forceinline__ float to_f(Bits b) { return b; }
  static __device__ __forceinline__ Bits from_f(float v) { return v; }
};

struct Bf16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float to_f(Bits b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ Bits from_f(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

struct F16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float to_f(Bits b) { return __half2float(__ushort_as_half(b)); }
  static __device__ __forceinline__ Bits from_f(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

template <class T>
__device__ __forceinline__ float round_to(float v) {
  return T::to_f(T::from_f(v));
}

struct Params {
  const float *w, *b, *mean, *var;
  float eps, slope;
};

// A channel's inv and shift, folded in fp32 as the plain version's torch ops
// do, each then rounded to x's dtype (the plain version's .to(x.dtype)).
struct Fold {
  float inv, shift;
};

template <class T>
__device__ __forceinline__ Fold fold(const Params& p, int c) {
  const float inv = __fmul_rn(__ldg(p.w + c), rsqrtf(__fadd_rn(__ldg(p.var + c), p.eps)));
  const float shift = __fsub_rn(__ldg(p.b + c), __fmul_rn(__ldg(p.mean + c), inv));
  return {round_to<T>(inv), round_to<T>(shift)};
}

template <int A>
__device__ __forceinline__ float activate(float u, float slope) {
  if constexpr (A == kSilu) {
    return __fdiv_rn(u, __fadd_rn(1.0f, expf(-u)));
  } else if constexpr (A == kRelu) {
    return isnan(u) ? u : fmaxf(u, 0.0f);
  } else if constexpr (A == kLeaky) {
    return u > 0.0f ? u : __fmul_rn(u, slope);
  } else if constexpr (A == kHardswish) {
    float m = __fadd_rn(u, 3.0f);
    m = m < 0.0f ? 0.0f : m;             // std::max(u + 3, 0)
    m = 6.0f < m ? 6.0f : m;             // std::min(., 6)
    return __fmul_rn(__fmul_rn(u, m), 1.0f / 6.0f);
  } else {
    return u;
  }
}

template <class T, int A>
__device__ __forceinline__ typename T::Bits bn_act1(typename T::Bits x, const Fold& f,
                                                    float slope) {
  const float t = round_to<T>(__fmul_rn(T::to_f(x), f.inv));
  const float u = round_to<T>(__fadd_rn(t, f.shift));
  return T::from_f(activate<A>(u, slope));
}

// One 16-byte vector of x, all of one channel.
template <class T, int A>
__device__ __forceinline__ uint4 bn_act_vec(uint4 in, const Fold& f, float slope) {
  using Bits = typename T::Bits;
  constexpr int V = 16 / sizeof(Bits);
  Bits v[V];
  memcpy(v, &in, 16);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = bn_act1<T, A>(v[j], f, slope);
  uint4 out;
  memcpy(&out, v, 16);
  return out;
}

// NCHW: 2^tpp_log2 threads a plane, blockDim / 2^tpp_log2 planes a block
// (blockIdx.x), each plane's threads streaming kVecs vectors each; a plane
// too large for one block (tpp_log2 = log2(kThreads)) in chunks along
// blockIdx.y.
template <class T, int A>
__global__ void __launch_bounds__(kThreads)
    bn_act_nchw(const typename T::Bits* __restrict__ x, typename T::Bits* __restrict__ y,
                Params p, long long planes, int channels, long long hw, int tpp_log2) {
  using Bits = typename T::Bits;
  constexpr int V = 16 / sizeof(Bits);
  const int tpp = 1 << tpp_log2;
  const int lane = threadIdx.x & (tpp - 1);
  const long long plane = (long long)blockIdx.x * (blockDim.x >> tpp_log2) +
                          (threadIdx.x >> tpp_log2);
  if (plane >= planes) return;
  const Fold f = fold<T>(p, int(plane % channels));
  const Bits* xp = x + plane * hw;
  Bits* yp = y + plane * hw;
  const uintptr_t ax = reinterpret_cast<uintptr_t>(xp), ay = reinterpret_cast<uintptr_t>(yp);
  // the elements before the first 16-byte boundary; where x and y lie apart
  // by other than a multiple of 16 bytes, the whole plane one at a time
  long long head = ((ax ^ ay) & 15) ? hw : (long long)(((16 - (ax & 15)) & 15) / sizeof(Bits));
  if (head > hw) head = hw;
  const long long nvec = (hw - head) / V;
  const uint4* xv = reinterpret_cast<const uint4*>(xp + head);
  uint4* yv = reinterpret_cast<uint4*>(yp + head);
  const long long v0 = (long long)blockIdx.y * tpp * kVecs + lane;
  uint4 in[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long v = v0 + (long long)k * tpp;
    if (v < nvec) in[k] = xv[v];
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long v = v0 + (long long)k * tpp;
    if (v < nvec) yv[v] = bn_act_vec<T, A>(in[k], f, p.slope);
  }
  if (blockIdx.y == 0) {
    for (long long i = lane; i < head; i += tpp) yp[i] = bn_act1<T, A>(xp[i], f, p.slope);
    for (long long i = head + nvec * V + lane; i < hw; i += tpp)
      yp[i] = bn_act1<T, A>(xp[i], f, p.slope);
  }
}

// The fewest threads (a power of two up to kThreads) that cover a plane's
// vectors kVecs each: small planes share a block instead of idling most of
// its threads.
template <class T, int A>
int launch(const void* x, void* y, const Params& p, long long n, int c, long long hw,
           cudaStream_t stream) {
  using Bits = typename T::Bits;
  constexpr int V = 16 / sizeof(Bits);
  const long long vecs = (hw + V - 1) / V;
  int tpp_log2 = 0;
  while ((1 << tpp_log2) < kThreads && (long long)(1 << tpp_log2) * kVecs < vecs) ++tpp_log2;
  const long long per_block = (long long)kThreads >> tpp_log2;
  const long long chunks = (vecs + (kThreads * kVecs) - 1) / (kThreads * kVecs);
  const long long planes = n * c;
  const dim3 grid(unsigned((planes + per_block - 1) / per_block),
                  unsigned(tpp_log2 == kThreadsLog2 && chunks > 1 ? chunks : 1));
  bn_act_nchw<T, A><<<grid, kThreads, 0, stream>>>(static_cast<const Bits*>(x),
                                                   static_cast<Bits*>(y), p, planes, c, hw,
                                                   tpp_log2);
  return int(cudaGetLastError());
}

template <class T>
int launch_act(const void* x, void* y, const Params& p, int act, long long n, int c,
               long long hw, cudaStream_t stream) {
  switch (act) {
    case kIdentity:
      return launch<T, kIdentity>(x, y, p, n, c, hw, stream);
    case kSilu:
      return launch<T, kSilu>(x, y, p, n, c, hw, stream);
    case kRelu:
      return launch<T, kRelu>(x, y, p, n, c, hw, stream);
    case kLeaky:
      return launch<T, kLeaky>(x, y, p, n, c, hw, stream);
    case kHardswish:
      return launch<T, kHardswish>(x, y, p, n, c, hw, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16; act: Act above (slope: leaky's); x and y
// (n, c, h, w) with hw = h * w, both NCHW-contiguous.
extern "C" int bn_act(const void* x, void* y, const float* w, const float* b, const float* mean,
                      const float* var, float eps, int act, float slope, int dtype,
                      long long n, int c, long long hw, cudaStream_t stream) {
  if (n * c * hw == 0) return 0;
  const Params p{w, b, mean, var, eps, slope};
  switch (dtype) {
    case 0:
      return launch_act<F32>(x, y, p, act, n, c, hw, stream);
    case 1:
      return launch_act<Bf16>(x, y, p, act, n, c, hw, stream);
    case 2:
      return launch_act<F16>(x, y, p, act, n, c, hw, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}
