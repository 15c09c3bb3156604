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
// us) and the sequential greedy sweep are what a launch costs.
//
// Design. One CTA per image replaces the TPU's vmap.
// K1 builds the suppression relation as a bitmask in shared memory, K rows
// of ceil(K/32) words (12 KB at K = 300, 128 KB at K = 1024 through dynamic
// shared memory), in parallel over all threads. Then one warp runs the K-step
// greedy sweep with the keep-mask in registers: lane l holds keep word l
// (K <= 1024 means at most 32 words), the owner of bit i broadcasts it with
// a shuffle, and every lane clears the bits that row i suppresses.
// K2 holds no K x K mask. It runs the fixpoint keep <- valid & ~hit(keep) on
// the device: each sweep recomputes IoUs on the fly, one thread per column j
// scanning the kept rows i < j until one suppresses it, and the warp ballots
// the hit bits into a word. keep and hit live in shared memory as bitmasks
// (512 B each at K = 4096); the CTA stops when keep is unchanged or after K
// sweeps, with no host round trip per sweep.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaskThreads = 512;
constexpr int kTiledThreads = 1024;
constexpr size_t kStaticSmem = 48 * 1024;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(i, j) > thr, the plain box_iou formula (see the note above)
__device__ __forceinline__ bool overlaps(float4 bi, float ai, float4 bj, float aj, float thr) {
  const float wx = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.0f);
  const float wy = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.0f);
  const float inter = __fmul_rn(wx, wy);
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

__global__ void nms_suppress_tiled_kernel(const float4* __restrict__ boxes,
                                          const int* __restrict__ classes,
                                          const uint8_t* __restrict__ valid,
                                          uint8_t* __restrict__ keep, int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + k);
  int* scls = reinterpret_cast<int*>(sarea + k);
  uint32_t* validw = reinterpret_cast<uint32_t*>(scls + k);
  uint32_t* keepw = validw + words;
  uint32_t* nextw = keepw + words;

  const long long img = blockIdx.x;
  boxes += img * k;
  classes += img * k;
  valid += img * k;
  keep += img * k;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  load_image(boxes, classes, k, sbox, sarea, scls);
  for (int wd = warp; wd < words; wd += nwarps) {
    const int j = wd * 32 + lane;
    const uint32_t bits = __ballot_sync(kFull, j < k && valid[j]);
    if (lane == 0) {
      validw[wd] = bits;
      keepw[wd] = bits;
    }
  }
  __syncthreads();

  for (int sweep = 0; sweep < k; ++sweep) {
    // next = valid & ~hit(keep), hit[j] = any kept i < j of j's class overlapping j
    for (int wd = warp; wd < words; wd += nwarps) {
      const int j = wd * 32 + lane;
      bool hit = false;
      if (j < k) {
        const float4 bj = sbox[j];
        const float aj = sarea[j];
        const int cj = scls[j];
        for (int i = 0; i < j && !hit; ++i) {
          if (((keepw[i >> 5] >> (i & 31)) & 1u) && scls[i] == cj) {
            hit = overlaps(sbox[i], sarea[i], bj, aj, thr);
          }
        }
      }
      const uint32_t hits = __ballot_sync(kFull, hit);
      if (lane == 0) nextw[wd] = validw[wd] & ~hits;
    }
    __syncthreads();
    int changed = 0;
    for (int wd = threadIdx.x; wd < words; wd += blockDim.x) changed |= nextw[wd] != keepw[wd];
    changed = __syncthreads_or(changed);
    for (int wd = threadIdx.x; wd < words; wd += blockDim.x) keepw[wd] = nextw[wd];
    __syncthreads();
    if (!changed) break;
  }

  for (int j = threadIdx.x; j < k; j += blockDim.x) keep[j] = (keepw[j >> 5] >> (j & 31)) & 1u;
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

extern "C" int nms_suppress_tiled(const void* boxes, const void* classes, const void* valid,
                                  void* keep, int batch, int k, float thr, void* stream) {
  if (batch == 0 || k == 0) return 0;
  const int words = (k + 31) / 32;
  const size_t smem = image_bytes(k) + 3 * static_cast<size_t>(words) * sizeof(uint32_t);
  cudaError_t err = prepare(nms_suppress_tiled_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_suppress_tiled_kernel<<<batch, kTiledThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(classes),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}
