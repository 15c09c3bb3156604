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
// This is the JAX package's XLA route (ops/boxes.py:75, ops/nms.py
// _fixpoint_suppress), the oracle its own tests hold the Pallas kernels to.
// The TPU kernels divide by union + 1e-9 (nms_pallas.py:43,114). That is a
// choice, and it can decide a pair differently: with normalized coordinates
// 1e-9 moves the IoU of small boxes by far more than an fp32 ulp (two 6 px
// boxes at 640 px, 2.276 px apart: an IoU just above 0.45 without it, just
// below with it; at thr 0.45 the XLA route and this kernel suppress the
// second box, the TPU kernels keep it; tests/test_torch_port_nms.py pins
// the pair). A pair of zero-area boxes never suppresses either way (0/0 =
// NaN and NaN > thr is false here, 0/1e-9 = 0 there). The _rn intrinsics
// keep nvcc from contracting a multiply and an add into one FMA, which
// would round differently from the plain version and could flip a
// comparison that sits on the threshold.
//
// What bounds them on the H100: neither bytes nor flops. At the production
// K = 300 an image is 6.6 KB of input and 45k IoU pairs; the bound from
// either rate is well under a microsecond, so the launch latency (a few
// us) and the sequential greedy sweep are what a launch costs. At K = 4096
// x 16 images the IoU tests (13 fp32 operations a pair) bound K2 at 26 us.
//
// K1: one thread-block cluster per image replaces the TPU's vmap; one
// launch (cudaLaunchKernelEx with a cluster dimension) for the batch.
//   1. Mask, across the cluster's CTAs (8; fewer when the batch's CTAs
//      would outnumber the SMs or a CTA would get no tile of the mask:
//      kernels/nms.py::cluster_size). Every CTA stages all K boxes, areas
//      and classes in its own shared memory. The upper triangle of the
//      relation comes in tiles of 32 rows x 32 columns (one mask word a
//      row), each tile 4 items of 8 rows, dealt to the cluster's warps in
//      turn. A warp builds an item with lane = column: a ballot a row, the
//      row's box a broadcast read ahead of the tests; no division per
//      element, and only the IoU division branches.
//      Once a first cluster barrier shows every CTA started, the rows'
//      words go straight into the leader CTA's shared memory (distributed
//      shared memory), a padded tile for every pair of row and column
//      words: 144 KB at K = 1024. A second barrier (arrive.release,
//      wait.acquire) follows; the other CTAs exit after it.
//   2. Sweep, in the leader, from its own shared memory: the rows 32 at a
//      time (a chunk, the rows of keep word c), as K2's sweep, by one warp
//      with the keep words in registers (lane l word l; K <= 1024 means at
//      most 32). The chunk's decisions are a fixpoint: the kept rows'
//      diagonal words ORed across the lanes (redux.sync), as many rounds as
//      the longest chain of suppression inside the chunk, plus one. Then
//      lane l clears, in its own word, what the kept rows suppress: their
//      32 words of column word l, read as 8 16-byte loads issued before the
//      chunk's keep word arrives. No barrier in the loop.
// valid comes in and keep goes out as 16-byte accesses over the aligned
// middle of each image's bytes, single bytes at the ends.
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
//      decisions, so they come ahead with cp.async into a ring of chunks in
//      shared memory, only the words the sweep will read: as many chunks,
//      at most 6, as fit in 227 KB beside the keep words (k2_ring), so that
//      a ring of two still fits at K = 28,544 (two chunks of 892-word rows,
//      223 KB, and 3.5 KB of keep words), where a 640 px plan's 25,200
//      candidates take 205 KB. Above kTiledMaxK a launch is refused.
// The two phases are two launches of one call; the greedy keep-set is
// exact, the same as K1's and the plain version's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kStaticSmem = 48 * 1024;
// K1 (kernels/nms.py copies these, a CPU test reads them here)
constexpr int kK1MaxK = 1024;
constexpr int kK1Threads = 512;              // 16 warps a CTA
constexpr int kMaxCluster = 8;               // CTAs an image: the portable cluster size
constexpr int kKeepWords = 36;               // 32 keep words, one zero word past them, 16-byte rows
constexpr int kParts = 4;                    // a 32 x 32 tile of the mask is 4 items of 8 rows
constexpr int kTileStride = 36;              // a tile's 32 row words, padded: the sweep's 16-byte
                                             // reads of a quarter warp then hit all 32 banks
constexpr size_t kSmemPerBlock = 227 * 1024;

// shared memory of a K1 CTA: boxes, areas and classes; the keep words; the
// leader's mask, a tile for every pair of row and column words (every CTA
// of a launch has the same size)
__host__ __device__ constexpr size_t k1_smem_bytes(int k) {
  return static_cast<size_t>(k) * (16 + 4 + 4) + 4 * kKeepWords +
         4 * kTileStride * static_cast<size_t>((k + 31) / 32) * ((k + 31) / 32);
}
static_assert(k1_smem_bytes(kK1MaxK) <= kSmemPerBlock, "K1's mask must fit in shared memory");

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ float intersection(float4 bi, float4 bj) {
  const float wx = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.0f);
  const float wy = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.0f);
  return __fmul_rn(wx, wy);
}

// IoU(i, j) > thr from their intersection, the plain box_iou formula (see
// the note above). With thr >= 0 only boxes that meet can suppress: an
// intersection of 0 gives an IoU of 0, or NaN for two empty boxes, neither
// above thr; so the division, the costly step, runs only for those unless
// divide_all (thr < 0 or NaN).
__device__ __forceinline__ bool iou_above(float inter, float ai, float aj, float thr,
                                          bool divide_all) {
  return (inter > 0.0f || divide_all) &&
         __fdiv_rn(inter, __fsub_rn(__fadd_rn(ai, aj), inter)) > thr;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// An image's k bytes (valid or keep) at p: the 16-byte aligned middle
// [head, tail) and, byte by byte, the ends [0, head) and [tail, k).
struct ByteSpan {
  int head, tail, k;
  __device__ ByteSpan(const void* p, int k_)
      : head(min(k_, static_cast<int>((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u))),
        tail(head + (k_ - head) / 16 * 16), k(k_) {}
  __device__ int vectors() const { return (tail - head) / 16; }
  __device__ int ends() const { return head + k - tail; }
  __device__ int end(int e) const { return e < head ? e : tail + e - head; }   // e < ends()
};

// 4 bytes -> 4 bits, bit q set where byte q is not 0
__device__ __forceinline__ uint32_t byte_bits(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

// 4 bits -> 4 bytes of 0 or 1
__device__ __forceinline__ uint32_t bit_bytes(uint32_t n) {
  return ((n & 15u) * 0x00204081u) & 0x01010101u;
}

// valid's bytes for the keep words, loaded while the boxes load: a vector
// of the aligned middle, or one byte of the ends, a thread
struct ValidBytes {
  uint4 q = {0u, 0u, 0u, 0u};   // 16 bytes, or one in q.x
  int at = -1;                  // the candidate of the first, or -1
  bool vector = false;

  ValidBytes() = default;
  __device__ ValidBytes(const uint8_t* valid, int k) {
    const ByteSpan span(valid, k);
    const int t = threadIdx.x;
    if (t < span.vectors()) {
      at = span.head + 16 * t;
      vector = true;
      q = *reinterpret_cast<const uint4*>(valid + at);
    } else if (t - span.vectors() < span.ends()) {
      at = span.end(t - span.vectors());
      q.x = valid[at];
    }
  }

  // into the keep words (zeroed, and a barrier since)
  __device__ void store(uint32_t* keepw) const {
    if (at < 0) return;
    const uint32_t bits = vector ? byte_bits(q.x) | byte_bits(q.y) << 4 | byte_bits(q.z) << 8 |
                                       byte_bits(q.w) << 12
                                 : static_cast<uint32_t>(q.x != 0u);
    if (bits == 0) return;
    const int s = at & 31;
    atomicOr(&keepw[at >> 5], bits << s);
    if (s > 16) atomicOr(&keepw[(at >> 5) + 1], bits >> (32 - s));
  }
};

// keep from the keep words, by all threads of the leader
__device__ void store_keep(uint8_t* keep, int k, const uint32_t* keepw) {
  const ByteSpan span(keep, k);
  for (int v = threadIdx.x; v < span.vectors(); v += kK1Threads) {
    const int i = span.head + 16 * v;
    const uint32_t bits = __funnelshift_r(keepw[i >> 5], keepw[(i >> 5) + 1], i & 31);
    *reinterpret_cast<uint4*>(keep + i) =
        make_uint4(bit_bytes(bits), bit_bytes(bits >> 4), bit_bytes(bits >> 8), bit_bytes(bits >> 12));
  }
  if (static_cast<int>(threadIdx.x) < span.ends()) {
    const int i = span.end(threadIdx.x);
    keep[i] = (keepw[i >> 5] >> (i & 31)) & 1u;
  }
}

// One warp, one item: rows 32 rb + 8 part .. + 7 of the tile (rb, w), lane
// = column 32 w + lane, a ballot a row; the rows' words go into the
// leader's tile. The row's box, area and class are read (the same address
// in every lane) before the tests, so that only the division branches.
__device__ __forceinline__ void mask_item(const float4* sbox, const float* sarea, const int* scls,
                                          uint32_t* lmask, int k, int words, int rb, int w,
                                          int part, float thr, bool divide_all) {
  constexpr int kRows = 32 / kParts;
  const int lane = threadIdx.x & 31;
  const int r0 = kRows * part, i0 = 32 * rb + r0;
  const int j = 32 * w + lane;
  const bool col = j < k;
  const float4 bj = col ? sbox[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float aj = col ? sarea[j] : 0.0f;
  const int cj = col ? scls[j] : 0;
  const int rows = min(kRows, k - i0);
  uint32_t mine = 0;   // the word of row 32 rb + lane, for lanes r0 .. r0 + rows - 1
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const int i = i0 + r;
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    const bool pair = col & (j > i) & (scls[i] == cj);
    const float inter = intersection(bi, bj);
    const bool hit = pair && iou_above(inter, ai, aj, thr, divide_all);
    const uint32_t bits = __ballot_sync(kFull, hit);
    if (lane == r0 + r) mine = bits;
  }
  if (lane >= r0 && lane - r0 < rows) lmask[(rb * words + w) * kTileStride + lane] = mine;
}

// One warp of the leader: the greedy sweep over the chunks of 32 rows. Lane
// l holds keep word l (kw, seeded from valid); rows that are not kept
// suppress nothing. The loads do not depend on the decisions, so they go
// out before the chunk's keep word arrives.
__device__ __forceinline__ void sweep(const uint32_t* mask, uint32_t* keepw, int words) {
  const int lane = threadIdx.x & 31;
  uint32_t kw = keepw[lane];
  for (int c = 0; c < words; ++c) {
    const uint32_t* tiles = mask + c * words * kTileStride;   // tile (c, w) at kTileStride w
    const uint32_t diag = tiles[c * kTileStride + lane];     // row 32 c + lane's diagonal word
    const bool right = lane > c && lane < words;            // lane's word is right of the diagonal
    const uint4* rows = reinterpret_cast<const uint4*>(tiles + (right ? lane : c) * kTileStride);
    uint4 rw[8];   // the chunk's 32 row words of column word `lane`
#pragma unroll
    for (int q = 0; q < 8; ++q) rw[q] = rows[q];
    const uint32_t word = __shfl_sync(kFull, kw, c);
    if (word == 0) continue;   // no row of the chunk is kept
    // the chunk's decisions as a fixpoint, the kept rows' diagonal words
    // ORed across the lanes: rounds as many as the longest chain of
    // suppression inside the chunk, plus one; it is the greedy keep-set
    uint32_t kept = word;
    for (;;) {
      const uint32_t next = word & ~__reduce_or_sync(kFull, (kept >> lane) & 1u ? diag : 0u);
      if (next == kept) break;
      kept = next;
    }
    if (right) {
      uint32_t hit[4] = {0u, 0u, 0u, 0u};   // four sums: a shallower chain
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (kept & (1u << (4 * q))) hit[0] |= rw[q].x;
        if (kept & (1u << (4 * q + 1))) hit[1] |= rw[q].y;
        if (kept & (1u << (4 * q + 2))) hit[2] |= rw[q].z;
        if (kept & (1u << (4 * q + 3))) hit[3] |= rw[q].w;
      }
      kw &= ~(hit[0] | hit[1] | hit[2] | hit[3]);
    } else if (lane == c) {
      kw = kept;
    }
  }
  keepw[lane] = kw;
}

__global__ void __launch_bounds__(kK1Threads)
nms_suppress_kernel(const float4* __restrict__ boxes, const int* __restrict__ classes,
                    const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int k,
                    int cluster_size, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  // the leader's mask, tiles [words][words][kTileStride] (row words of row
  // block, column word), a 16-byte multiple; then every CTA's
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem);
  float4* sbox = reinterpret_cast<float4*>(mask + words * words * kTileStride);
  float* sarea = reinterpret_cast<float*>(sbox + k);
  int* scls = reinterpret_cast<int*>(sarea + k);
  uint32_t* keepw = reinterpret_cast<uint32_t*>(scls + k);

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const long long img = blockIdx.x / cluster_size;
  boxes += img * k;
  classes += img * k;
  valid += img * k;
  keep += img * k;

  // the leader's shared memory may be written once every CTA of the
  // cluster has started: arrive now, wait before the first remote store
  cluster_arrive_relaxed();
  const ValidBytes vbytes = rank == 0 ? ValidBytes(valid, k) : ValidBytes();
  for (int i = threadIdx.x; i < k; i += kK1Threads) {
    const float4 b = boxes[i];
    sbox[i] = b;
    sarea[i] = box_area(b);
    scls[i] = classes[i];
  }
  if (rank == 0 && threadIdx.x < kKeepWords) keepw[threadIdx.x] = 0;
  __syncthreads();
  if (rank == 0) vbytes.store(keepw);
  cluster_wait_acquire();

  // items (tile, part): tiles (rb, w), rb <= w < words, row block by row
  // block, kParts items each, dealt to the cluster's warps in turn
  // (warp-major, so the CTAs share every row block)
  uint32_t* lmask = cluster.map_shared_rank(mask, 0);
  const bool divide_all = !(thr >= 0.0f);
  const int step = cluster_size * (kK1Threads / 32);
  int rb = 0, first = 0;   // first: the index of row block rb's first tile
  for (int item = (threadIdx.x >> 5) * cluster_size + rank;; item += step) {
    const int tile = item / kParts;
    while (rb < words && tile - first >= words - rb) {
      first += words - rb;
      ++rb;
    }
    if (rb >= words) break;
    mask_item(sbox, sarea, scls, lmask, k, words, rb, rb + tile - first, item % kParts, thr,
              divide_all);
  }
  cluster_arrive_release();
  cluster_wait_acquire();
  if (rank != 0) return;

  if (threadIdx.x < 32) sweep(mask, keepw, words);
  __syncthreads();
  store_keep(keep, k, keepw);
}

// K1's launch floor: nothing, launched as K1 is
__global__ void __launch_bounds__(kK1Threads)
nms_empty_kernel(const float4*, const int*, const uint8_t*, uint8_t*, int, int, float) {}

constexpr int kTileRows = 32;       // K2 mask: rows of a block
constexpr int kTileWords = 8;       // ... and words (256 columns), one thread each
constexpr int kTileThreads = kTileRows * kTileWords;
constexpr int kSweepThreads = 256;  // K2 sweep: one CTA per image
constexpr int kMaxRing = 6;         // chunks of 32 mask rows in flight, at most
constexpr int kTiledMaxK = 28544;   // the largest K whose ring of 2 chunks fits beside the keep words

// words of a mask row: ceil(k/32) rounded up to 16 bytes
__host__ __device__ constexpr int mask_stride(int k) { return ((k + 31) / 32 + 3) / 4 * 4; }

// K2 sweep's shared memory: a ring of `ring` chunks of 32 rows, then the
// keep words (one a mask word, so 16-byte aligned); all dynamic
__host__ __device__ constexpr size_t k2_sweep_smem(int k, int ring) {
  return static_cast<size_t>(ring) * 32 * mask_stride(k) * 4 + static_cast<size_t>(mask_stride(k)) * 4;
}

// the most chunks, at most kMaxRing, that fit; 0 where not even 2 do
__host__ __device__ constexpr int k2_ring(int k) {
  int ring = kMaxRing;
  while (ring >= 2 && k2_sweep_smem(k, ring) > kSmemPerBlock) --ring;
  return ring >= 2 ? ring : 0;
}
static_assert(k2_ring(kTiledMaxK) == 2 && k2_ring(kTiledMaxK + 1) == 0,
              "kTiledMaxK is the largest K whose ring of two chunks fits");
static_assert(k2_ring(8192) == kMaxRing && k2_ring(25200) == 2, "K2's rings at 8192 and 25200");

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

template <int kRing>
__global__ void __launch_bounds__(kSweepThreads)
nms_tiled_sweep_kernel(const uint8_t* __restrict__ valid, const uint32_t* __restrict__ mask,
                       uint8_t* __restrict__ keep, int k) {
  extern __shared__ __align__(16) uint32_t ring[];   // kRing chunks of 32 rows x stride words
  const int words = (k + 31) / 32;
  const int stride = mask_stride(k);
  uint32_t* keepw = ring + kRing * 32 * stride;      // then the keep words
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

using K1Kernel = void(const float4*, const int*, const uint8_t*, uint8_t*, int, int, float);

// K1's launch: batch clusters of cluster_size CTAs, each with K1's shared
// memory. Returns the cudaError_t; a refused cluster launch or shared-memory
// opt-in is returned as it is, and nothing else is tried.
int launch_k1(K1Kernel* kernel, const void* boxes, const void* classes, const void* valid,
              void* keep, int cluster_size, int batch, int k, float thr, void* stream) {
  if (k > kK1MaxK || cluster_size < 1 || cluster_size > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || k == 0) return 0;
  const size_t smem = k1_smem_bytes(k);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster_size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * cluster_size);
  cfg.blockDim = dim3(kK1Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float4*>(boxes),
                           static_cast<const int*>(classes), static_cast<const uint8_t*>(valid),
                           static_cast<uint8_t*>(keep), k, cluster_size, thr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes (batch, k, 4) fp32, classes (batch, k) int32, valid and keep (batch,
// k) one byte each, all contiguous on the device. Each returns the
// cudaError_t of its launch (0 when it was accepted).
extern "C" int nms_suppress(const void* boxes, const void* classes, const void* valid,
                            void* keep, int cluster_size, int batch, int k, float thr,
                            void* stream) {
  return launch_k1(nms_suppress_kernel, boxes, classes, valid, keep, cluster_size, batch, k, thr,
                   stream);
}

// An empty kernel launched as K1 is (grid, cluster, block, shared memory,
// parameters): chip_smoke.py times it as the floor under K1's time.
extern "C" int nms_launch_floor(const void* boxes, const void* classes, const void* valid,
                                void* keep, int cluster_size, int batch, int k, float thr,
                                void* stream) {
  return launch_k1(nms_empty_kernel, boxes, classes, valid, keep, cluster_size, batch, k, thr,
                   stream);
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

template <int kRing>
cudaError_t launch_sweep(const void* valid, const void* scratch, void* keep, int batch, int k,
                         void* stream) {
  const size_t smem = k2_sweep_smem(k, kRing);
  // opt in to the dynamic shared memory whatever its size
  cudaError_t err = cudaFuncSetAttribute(nms_tiled_sweep_kernel<kRing>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nms_tiled_sweep_kernel<kRing><<<batch, kSweepThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), static_cast<const uint32_t*>(scratch),
      static_cast<uint8_t*>(keep), k);
  return cudaGetLastError();
}

extern "C" int nms_tiled_sweep(const void* boxes, const void* classes, const void* valid,
                               void* keep, void* scratch, long long scratch_bytes, int batch, int k,
                               float thr, void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (k > kTiledMaxK || scratch_bytes < static_cast<long long>(batch) * k * mask_stride(k) * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (k2_ring(k)) {
    case 6: return static_cast<int>(launch_sweep<6>(valid, scratch, keep, batch, k, stream));
    case 5: return static_cast<int>(launch_sweep<5>(valid, scratch, keep, batch, k, stream));
    case 4: return static_cast<int>(launch_sweep<4>(valid, scratch, keep, batch, k, stream));
    case 3: return static_cast<int>(launch_sweep<3>(valid, scratch, keep, batch, k, stream));
    case 2: return static_cast<int>(launch_sweep<2>(valid, scratch, keep, batch, k, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int nms_suppress_tiled(const void* boxes, const void* classes, const void* valid,
                                  void* keep, void* scratch, long long scratch_bytes, int batch,
                                  int k, float thr, void* stream) {
  const int err = nms_tiled_mask(boxes, classes, valid, keep, scratch, scratch_bytes, batch, k,
                                 thr, stream);
  if (err != 0) return err;
  return nms_tiled_sweep(boxes, classes, valid, keep, scratch, scratch_bytes, batch, k, thr, stream);
}
