// K1 and K2: class-aware greedy NMS keep-sets, for Hopper (sm_90a).
//
// Replace the TPU kernels of yolo_continuous_tpu/kernels/nms_pallas.py:
//   K1 nms_suppress       <- pallas_suppress (body _nms_kernel), K <= 1024
//   K2 nms_suppress_tiled <- pallas_suppress_tiled (body _hit_kernel), K > 1024
// Plain PyTorch version of both: yolo_continuous_tpu_torch/ops/nms.py
// (suppress_plain, the fixpoint of _fixpoint_suppress, and the sequential
// _greedy_suppress that it equals).
//
// Inputs per image, already score-sorted (top-K): boxes (K, 4) fp32 xyxy,
// classes (K,) int32, valid (K,) bool. Output keep (K,) bool: j is kept iff
// it is valid and no kept i < j of the same class has IoU(i, j) > thr, the
// torchvision per-class keep-set.
//
// IoU formula: the plain box_iou (ops/boxes.py, utils/bbox.py:62-72), with
// no epsilon, in the same order of rounded operations:
//   inter = max(min(x2i,x2j) - max(x1i,x1j), 0) * max(min(y2i,y2j) - max(y1i,y1j), 0)
//   iou   = inter / ((area_i + area_j) - inter)
// The TPU kernel adds 1e-9 to the denominator; either way a pair of
// zero-area boxes never suppresses (0/0 = NaN and NaN > thr is false here,
// 0/1e-9 = 0 there). The _rn intrinsics keep nvcc from contracting a
// multiply and an add into one FMA, which would round differently from the
// plain version and could flip a comparison that sits on the threshold.
//
// What bounds them on the H100: neither bytes nor flops. At the production
// K = 300 an image is 6.6 KB of input and 45k IoU pairs; the bound from
// either rate is well under a microsecond, so the launch latency (a few
// us) and the sequential greedy sweep are what a launch costs. At K = 4096
// x 16 images the IoU tests (13 fp32 operations a pair) bound K2 at 26 us.
//
// K1: one CTA per image replaces the TPU's vmap. It builds the suppression
// relation as a bitmask in shared memory, K rows of ceil(K/32) words (12 KB
// at K = 300, 128 KB at K = 1024 through dynamic shared memory), in parallel
// over all threads. Then one warp runs the K-step greedy sweep with the
// keep-mask in registers: lane l holds keep word l (K <= 1024 means at most
// 32 words), the owner of bit i broadcasts it with a shuffle, and every lane
// clears the bits that row i suppresses.
//
// K2 keeps the same relation in device memory instead, where the TPU kernel
// recomputed IoUs in every sweep of a fixpoint because VMEM cannot hold it:
// a scratch tensor (B, K, S) of uint32, S = ceil(K/32) rounded up to 4
// (16-byte rows), allocated by the wrapper: 32 MB at K = 4096 x 16 images,
// 128 MB at K = 8192 x 16, which L2 (50 MB) holds in part.
//   1. Mask, across all SMs: a grid over (column block, row block, image),
//      blocks of 32 rows x 256 columns left of the diagonal skipped. Each
//      thread computes one word: row i, 32 columns j, bit set where j > i,
//      same class and IoU > thr (the division only where the boxes meet).
//      The 8 threads of a row write 32 contiguous bytes; their column loops
//      are staggered so that the shared-memory reads of a warp hit distinct
//      banks.
//   2. Sweep, one CTA per image: the keep mask (K/32 words, seeded from
//      valid) in shared memory; the rows 32 at a time (a chunk, the rows
//      of keep word c). Only the diagonal word is sequential: one warp
//      resolves the chunk's 32 decisions with a chain of bit operations on
//      the 32 diagonal mask words; then every thread clears, for all kept
//      rows of the chunk, one word beyond the diagonal. Mask words at or
//      left of the diagonal are never read. The rows do not depend on the
//      decisions, so they come ahead with cp.async into a ring of 6 chunks
//      in shared memory, only the words the sweep will read.
// The two phases are two launches of one call; the greedy keep-set is
// exact, the same as K1's and the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaskThreads = 512;
constexpr size_t kStaticSmem = 48 * 1024;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ float intersection(float4 bi, float4 bj) {
  const float wx = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.0f);
  const float wy = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.0f);
  return __fmul_rn(wx, wy);
}

// IoU(i, j) > thr, the plain box_iou formula (see the note above)
__device__ __forceinline__ bool overlaps(float4 bi, float ai, float4 bj, float aj, float thr) {
  const float inter = intersection(bi, bj);
  const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(ai, aj), inter));
  return iou > thr;
}

__device__ void load_image(const float4* boxes, const int* classes, int k, float4* sbox,
                           float* sarea, int* scls) {
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float4 b = boxes[i];
    sbox[i] = b;
    sarea[i] = box_area(b);
    scls[i] = classes[i];
  }
}

__global__ void nms_suppress_kernel(const float4* __restrict__ boxes,
                                    const int* __restrict__ classes,
                                    const uint8_t* __restrict__ valid,
                                    uint8_t* __restrict__ keep, int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + k);
  int* scls = reinterpret_cast<int*>(sarea + k);
  uint32_t* mask = reinterpret_cast<uint32_t*>(scls + k);  // [k][words]

  const long long img = blockIdx.x;
  boxes += img * k;
  classes += img * k;
  valid += img * k;
  keep += img * k;

  load_image(boxes, classes, k, sbox, sarea, scls);
  __syncthreads();

  // mask[i][w] bit t: row i suppresses column j = 32 w + t (j > i, same class)
  for (int idx = threadIdx.x; idx < k * words; idx += blockDim.x) {
    const int i = idx / words;
    const int j0 = (idx % words) * 32;
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    const int ci = scls[i];
    uint32_t bits = 0;
    for (int t = 0; t < 32; ++t) {
      const int j = j0 + t;
      if (j > i && j < k && scls[j] == ci && overlaps(bi, ai, sbox[j], sarea[j], thr)) {
        bits |= 1u << t;
      }
    }
    mask[idx] = bits;
  }
  __syncthreads();

  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  uint32_t kw = 0;  // keep word `lane`: bits of columns 32 lane .. 32 lane + 31
  for (int t = 0; t < 32; ++t) {
    const int j = lane * 32 + t;
    if (j < k && valid[j]) kw |= 1u << t;
  }
  for (int i = 0; i < k; ++i) {
    const uint32_t owner = __shfl_sync(kFull, kw, i >> 5);
    if ((owner >> (i & 31)) & 1u) {  // i is kept: the same branch in every lane
      if (lane < words) kw &= ~mask[i * words + lane];
    }
  }
  for (int t = 0; t < 32; ++t) {
    const int j = lane * 32 + t;
    if (j < k) keep[j] = (kw >> t) & 1u;
  }
}

constexpr int kTileRows = 32;       // K2 mask: rows of a block
constexpr int kTileWords = 8;       // ... and words (256 columns), one thread each
constexpr int kTileThreads = kTileRows * kTileWords;
constexpr int kSweepThreads = 256;  // K2 sweep: one CTA per image
constexpr int kRing = 6;            // chunks of 32 mask rows in flight: 192 KB at K = 8192
constexpr int kTiledMaxK = 8192;    // 1 KB of keep words, a ring of 192 KB

// words of a mask row: ceil(k/32) rounded up to 16 bytes
__host__ __device__ __forceinline__ int mask_stride(int k) { return ((k + 31) / 32 + 3) / 4 * 4; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__global__ void __launch_bounds__(kTileThreads)
nms_tiled_mask_kernel(const float4* __restrict__ boxes, const int* __restrict__ classes,
                      uint32_t* __restrict__ mask, int k, float thr) {
  __shared__ float4 cbox[kTileWords * 32];
  __shared__ float carea[kTileWords * 32];
  __shared__ int ccls[kTileWords * 32];
  const int rb = blockIdx.y, cb = blockIdx.x;
  // the sweep reads row i from word i/32 on: skip blocks wholly left of it
  if ((cb + 1) * kTileWords <= rb) return;
  const int words = (k + 31) / 32;
  const long long img = blockIdx.z;
  boxes += img * k;
  classes += img * k;
  mask += img * k * mask_stride(k);

  const int j0 = cb * kTileWords * 32;
  for (int t = threadIdx.x; t < kTileWords * 32; t += blockDim.x) {
    if (j0 + t < k) {
      const float4 b = boxes[j0 + t];
      cbox[t] = b;
      carea[t] = box_area(b);
      ccls[t] = classes[j0 + t];
    }
  }
  __syncthreads();

  const int i = rb * kTileRows + threadIdx.x / kTileWords;
  const int wl = threadIdx.x % kTileWords;
  const int w = cb * kTileWords + wl;
  if (i >= k || w >= words) return;
  const float4 bi = boxes[i];
  const float ai = box_area(bi);
  const int ci = classes[i];
  // with thr >= 0 only boxes that meet can suppress: an intersection of 0
  // gives an IoU of 0, or NaN for two empty boxes, neither above thr; so
  // the division, the costly step, runs only for those
  const bool divide_all = !(thr >= 0.0f);
  uint32_t bits = 0;
  for (int s = 0; s < 32; ++s) {
    const int t = (s + wl) & 31;   // staggered: the 8 words of a row read distinct banks
    const int j = w * 32 + t;
    const int c = wl * 32 + t;
    if (j > i && j < k && ccls[c] == ci) {
      const float inter = intersection(bi, cbox[c]);
      if ((inter > 0.0f || divide_all) &&
          __fdiv_rn(inter, __fsub_rn(__fadd_rn(ai, carea[c]), inter)) > thr) {
        bits |= 1u << t;
      }
    }
  }
  mask[static_cast<long long>(i) * mask_stride(k) + w] = bits;
}

__global__ void __launch_bounds__(kSweepThreads)
nms_tiled_sweep_kernel(const uint8_t* __restrict__ valid, const uint32_t* __restrict__ mask,
                       uint8_t* __restrict__ keep, int k) {
  extern __shared__ __align__(16) uint32_t ring[];   // kRing chunks of 32 rows x stride words
  __shared__ uint32_t keepw[kTiledMaxK / 32];
  const int words = (k + 31) / 32;
  const int stride = mask_stride(k);
  const long long img = blockIdx.x;
  valid += img * k;
  keep += img * k;
  mask += img * k * stride;

  // rows 32 c .. 32 c + 31 of chunk c, from word c (the first the sweep
  // reads) rounded down to 16 bytes
  auto load = [&](int c) {
    if (c >= words) return;
    uint32_t* dst = ring + (c % kRing) * 32 * stride;
    const int v0 = c / 4, vecs = stride / 4 - v0;
    const int rows = min(32, k - 32 * c);
    for (int idx = threadIdx.x; idx < rows * vecs; idx += kSweepThreads) {
      const int r = idx / vecs, v = v0 + idx % vecs;
      cp_async16(dst + r * stride + 4 * v, mask + static_cast<long long>(32 * c + r) * stride + 4 * v);
    }
  };

  for (int wd = threadIdx.x; wd < words; wd += kSweepThreads) {
    uint32_t bits = 0;
    for (int t = 0; t < 32; ++t) {
      const int j = wd * 32 + t;
      if (j < k && valid[j]) bits |= 1u << t;
    }
    keepw[wd] = bits;
  }
  for (int c = 0; c < kRing - 1; ++c) {
    load(c);
    cp_async_commit();
  }

  for (int c = 0; c < words; ++c) {
    cp_async_wait<kRing - 2>();   // this thread's copies of chunk c have landed
    __syncthreads();              // everyone's have, and keep word c is final up to row 32 c
    const uint32_t* rows = ring + (c % kRing) * 32 * stride;
    // 1. keep word c decides the chunk's rows in order: only the diagonal
    // word carries a row's suppression of a later row of the same chunk.
    // One warp: the 32 diagonal words first, then a chain of bit operations.
    if (threadIdx.x < 32) {
      const int nrows = min(32, k - 32 * c);
      uint32_t diag[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) diag[r] = r < nrows ? rows[r * stride + c] : 0u;
      uint32_t word = keepw[c];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if (word & (1u << r)) word &= ~diag[r];
      }
      if (threadIdx.x == 0) keepw[c] = word;
    }
    __syncthreads();
    // 2. the chunk's kept rows clear what they suppress beyond the
    // diagonal, one word a thread: there the rows do not depend on each other
    const uint32_t kept = keepw[c];
    for (int wd = c + 1 + threadIdx.x; wd < words; wd += kSweepThreads) {
      uint32_t m = keepw[wd];
#pragma unroll 8
      for (int r = 0; r < 32; ++r) m &= ~(rows[r * stride + wd] & (0u - ((kept >> r) & 1u)));
      keepw[wd] = m;
    }
    load(c + kRing - 1);   // into the slot of chunk c - 1, done with since the barriers above
    cp_async_commit();
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += kSweepThreads) keep[j] = (keepw[j >> 5] >> (j & 31)) & 1u;
}

// above the 48 KB default a kernel must opt in to dynamic shared memory
template <typename Kernel>
cudaError_t prepare(Kernel* kernel, size_t smem) {
  if (smem <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

size_t image_bytes(int k) { return static_cast<size_t>(k) * (sizeof(float4) + 2 * sizeof(float)); }

}  // namespace

// boxes (batch, k, 4) fp32, classes (batch, k) int32, valid and keep (batch,
// k) one byte each, all contiguous on the device. Each returns the
// cudaError_t of its launch (0 when it was accepted).
extern "C" int nms_suppress(const void* boxes, const void* classes, const void* valid,
                            void* keep, int batch, int k, float thr, void* stream) {
  if (k > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || k == 0) return 0;
  const int words = (k + 31) / 32;
  const size_t smem = image_bytes(k) + static_cast<size_t>(k) * words * sizeof(uint32_t);
  cudaError_t err = prepare(nms_suppress_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_suppress_kernel<<<batch, kMaskThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(classes),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}

// K2 in two launches, which chip_smoke.py also times one by one. scratch
// holds batch * k * mask_stride(k) uint32 words (scratch_bytes is checked).
extern "C" int nms_tiled_mask(const void* boxes, const void* classes, const void* valid,
                              void* keep, void* scratch, long long scratch_bytes, int batch, int k,
                              float thr, void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (k > kTiledMaxK || batch > 65535 ||
      scratch_bytes < static_cast<long long>(batch) * k * mask_stride(k) * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = (k + 31) / 32;
  dim3 grid((words + kTileWords - 1) / kTileWords, (k + kTileRows - 1) / kTileRows, batch);
  nms_tiled_mask_kernel<<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(classes),
      static_cast<uint32_t*>(scratch), k, thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nms_tiled_sweep(const void* boxes, const void* classes, const void* valid,
                               void* keep, void* scratch, long long scratch_bytes, int batch, int k,
                               float thr, void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (k > kTiledMaxK || scratch_bytes < static_cast<long long>(batch) * k * mask_stride(k) * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kRing) * 32 * mask_stride(k) * sizeof(uint32_t);
  // the ring is dynamic shared memory beside the static keep words: opt in
  // whatever its size
  cudaError_t err = cudaFuncSetAttribute(nms_tiled_sweep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_tiled_sweep_kernel<<<batch, kSweepThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), static_cast<const uint32_t*>(scratch),
      static_cast<uint8_t*>(keep), k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nms_suppress_tiled(const void* boxes, const void* classes, const void* valid,
                                  void* keep, void* scratch, long long scratch_bytes, int batch,
                                  int k, float thr, void* stream) {
  const int err = nms_tiled_mask(boxes, classes, valid, keep, scratch, scratch_bytes, batch, k,
                                 thr, stream);
  if (err != 0) return err;
  return nms_tiled_sweep(boxes, classes, valid, keep, scratch, scratch_bytes, batch, k, thr, stream);
}
