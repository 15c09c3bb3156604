// The TMA form shared by K3 (decode.cu, decode_levels_tma) and K4
// (bin_decode.cu, decode_levels_bin_tma): one launch per request over all
// head levels, for Hopper (sm_90a).
//
// What bounds both on the H100: bytes (each logit read once, each output
// written once, a few flops between). The strided forms beside them lost
// to instruction issue (two integer div/mod pairs and a branching
// __fdiv_rn sigmoid per element), to few bytes in flight (one scalar load
// per thread and turn), to row tiles that leave lanes idle on the small
// levels, and to three launches a request. This form:
//
// - Tiles pixels, not rows. A head map is the (bs, h, w, na, no) view of a
//   contiguous NCHW (bs, na * no, h, w) tensor, so output row p * na + a of
//   a level is flattened pixel p = y * w + x and anchor a: kP consecutive
//   pixels, across image rows, give one contiguous run of kP * na output
//   rows. A tile is (level, image, block of kP pixels).
// - Loads by TMA. One tensor map per level describes the map as 4-D
//   (h * w, no, na, bs), byte strides (4, 4 hw, 4 no hw, 4 na no hw); a box
//   of (kP, no, na, 1) brings every channel of a tile, as [na][no][kP]
//   floats, into a ring of stages in shared memory, each completed on an
//   mbarrier. One thread issues the loads; the next tiles' loads are in
//   flight while a tile is computed and stored. TMA zero-fills the pixels
//   past a level's end; they are never stored.
// - A persistent grid over the tiles of all levels and images, the level
//   with the most tiles first: one CTA of 32 warps an SM, so that the
//   sigmoids' dependent chains of many warps interleave, with as many stages
//   as fit in shared memory (4 for K3, 3 for K4 at 80 classes).
// - Computes without divisions: lanes run over the tile's pixels and the
//   warps over its (anchor, column) rows in turn, so anchor and column are
//   warp-uniform and come from loop counters. The sigmoid is
//   exact_math.cuh's sigmoid_rn, the box columns keep the strided forms' _rn
//   steps in their order, so the outputs are bit-equal to theirs. Results go
//   into an output buffer in output order; its row stride na * no_out is odd
//   at yolov7's widths (255), so lanes over pixels hit distinct banks.
// - Stores: the tile's rows are one contiguous run of the output. Its
//   16-byte aligned middle goes out by one bulk copy (shared -> global),
//   the at most 3 floats at each unaligned end by scalar stores. The output
//   buffer is double: a tile's store runs while the next tile is computed.
//
// A head map qualifies when its view is exactly that permutation, h * w is
// a multiple of 4 (TMA's 16-byte global strides) and its base is 16-byte
// aligned, for at most kMaxLevels levels; kernels/decode.py::form_for says
// so before the launch, and other maps take the strided forms.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_math.cuh"

namespace {

namespace decode_tma {

constexpr int kP = 32;                 // pixels per tile: one per lane
constexpr int kThreads = 1024;        // one CTA an SM: 32 warps hide the sigmoid's latency
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 4;          // P6 nets have 4
constexpr int kMaxAnchors = 8;
constexpr int kMaxStages = 4;
constexpr size_t kSmemPerBlock = 227 * 1024;
// the host's level table: per level pointer, h, w, na, row0 (ints) and the
// stride, then na (w, h) anchor pairs padded to kMaxAnchors (floats)
constexpr int kIntsPerLevel = 5;
constexpr int kFloatsPerLevel = 1 + 2 * kMaxAnchors;

struct Level {
  long long row0;       // first output row of the level
  int h, w, na;
  int tiles_per_image;  // blocks of kP pixels
  int first_tile;       // the level's first tile in the schedule
  float stride;
  float aw[kMaxAnchors], ah[kMaxAnchors];
};

struct Levels {
  Level l[kMaxLevels];    // in the caller's order of head maps
  int sched[kMaxLevels];  // the level of each schedule slot, most tiles first
  int n, tiles;           // levels; tiles of all levels and images
  int no, no_out;         // columns read and written per row
  long long out_bstride;  // floats between images of the output
  int stages;
  uint32_t stage_bytes;   // kP * no * max na floats, a multiple of 128 bytes
  int normalized;
  int nbin;               // K4's SigmoidBin constants
  float start, step;
};

struct Maps {
  CUtensorMap m[kMaxLevels];
};

struct Tile {
  int l, b, p0, np;       // level, image, first pixel, pixels in the map
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
                  "r"(c2), "r"(c3)
               : "memory");
}

__device__ __forceinline__ Tile tile_at(const Levels& lv, int t) {
  int slot = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < lv.n && t >= lv.l[lv.sched[i]].first_tile) slot = i;
  }
  const int l = lv.sched[slot];
  const Level& L = lv.l[l];
  const int rel = t - L.first_tile;
  const int b = rel / L.tiles_per_image;
  const int p0 = (rel - b * L.tiles_per_image) * kP;
  return Tile{l, b, p0, min(kP, L.h * L.w - p0)};
}

// tile t into the stage at dst, completing on bar (one thread)
__device__ __forceinline__ void load_tile(const Maps& maps, const Levels& lv, int t, uint32_t dst,
                                          uint32_t bar) {
  const Tile tl = tile_at(lv, t);
  mbar_expect_tx(bar, static_cast<uint32_t>(kP * lv.no * lv.l[tl.l].na) * sizeof(float));
  tma_load_4d(dst, &maps.m[tl.l], bar, tl.p0, 0, 0, tl.b);
}

// n_bytes of shared memory at src to dst (both 16-byte aligned, n_bytes a
// multiple of 16), by the bulk-copy engine
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t n_bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(n_bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// the issuing thread's bulk stores have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and have finished writing device memory
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Body::compute(lv, level, tile, in, ob, lane, warp) turns the staged
// [na][no][kP] logits `in` into the tile's output rows at ob[(p * na + a) *
// no_out + c], all threads together
template <class Body>
__global__ void __launch_bounds__(kThreads, 1)
decode_levels_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Levels lv,
                     float* __restrict__ out, uint32_t out_floats) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;   // TMA destinations: 128-byte aligned
  float* ring = reinterpret_cast<float*>(smem_raw + (base - raw));
  float* obufs = ring + lv.stages * (lv.stage_bytes / 4);   // two output runs
  const uint32_t full = base + lv.stages * lv.stage_bytes + 2 * out_floats * 4;   // stage s: full + 8 s
  if (threadIdx.x == 0) {
    for (int s = 0; s < lv.stages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < lv.stages; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < lv.tiles) load_tile(maps, lv, t, base + s * lv.stage_bytes, full + 8 * s);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x, k = 0; t < lv.tiles; t += gridDim.x, ++k) {
    const Tile tl = tile_at(lv, t);
    const Level& L = lv.l[tl.l];
    float* dst = out + tl.b * lv.out_bstride + (L.row0 + static_cast<long long>(tl.p0) * L.na) * lv.no_out;
    // the run's words before dst's next 16-byte boundary; staged from
    // ob[mis], so that its aligned middle starts at ob[mis + head], a
    // 16-byte boundary too
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
    const int head = (4 - mis) & 3;
    float* ob = obufs + (k & 1) * out_floats;
    mbar_wait(full + 8 * stage, phase);
    Body::compute(lv, L, tl, ring + stage * (lv.stage_bytes / 4), ob + mis, lane, warp);
    // this thread's writes of the stage and the run, ordered before TMA's
    // next load into the stage and the bulk store of the run
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0) bulk_wait_read();   // tile k - 1's store has read the run tile k + 1 overwrites
    __syncthreads();
    const int n = tl.np * L.na * lv.no_out;
    const int mid = n > head ? (n - head) & ~3 : 0;
    if (threadIdx.x == 0) {
      const int next = t + lv.stages * gridDim.x;
      if (next < lv.tiles) load_tile(maps, lv, next, base + stage * lv.stage_bytes, full + 8 * stage);
      if (mid > 0) bulk_store(dst + head, smem_u32(ob + mis + head), static_cast<uint32_t>(mid) * 4);
      bulk_commit();
    } else if (threadIdx.x >= kThreads - 8) {   // the at most 3 + 3 floats at the unaligned ends
      const int e = threadIdx.x - (kThreads - 8);
      const int j = e < 4 ? e : head + mid + e - 4;
      if ((e >= 4 || j < head) && j < n) dst[j] = ob[mis + j];
    }
    if (++stage == lv.stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  if (threadIdx.x == 0) bulk_wait();
}

int sm_count() {   // read once per device
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cached[dev] = 0;
  }
  return cached[dev];
}

// (h * w, no, na, bs) fp32, box (kP, no, na, 1), no swizzle; the pixels past
// h * w read as zeros (cuTensorMapEncodeTiled: libcuda, -lcuda)
bool encode_level(CUtensorMap* map, const void* ptr, int bs, int hw, int no, int na) {
  const cuuint64_t e = sizeof(float), p = hw, c = no, a = na;
  const cuuint64_t dims[4] = {p, c, a, static_cast<cuuint64_t>(bs)};
  const cuuint64_t strides[3] = {p * e, p * c * e, p * c * a * e};
  const cuuint32_t box[4] = {kP, static_cast<cuuint32_t>(no), static_cast<cuuint32_t>(na), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
                                dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// kernels/decode.py::tma_smem_bytes copies this sum at 2 stages, term for
// term, to choose the form before the launch
size_t smem_bytes(const Levels& lv, uint32_t out_floats, int stages) {
  return 128 + static_cast<size_t>(stages) * lv.stage_bytes + 2 * out_floats * 4 + 8 * stages;
}

// Checks the level table, encodes a tensor map per level and launches
// Body's kernel once for all levels. Returns a cudaError_t.
template <class Body>
int launch(int nl, const long long* ints, const float* floats, void* out, int bs, int no,
           int no_out, long long out_bstride, int normalized, int nbin, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (nl < 1 || nl > kMaxLevels || no < 1 || no > 256 || no_out < 1 || bs < 0 ||
      reinterpret_cast<uintptr_t>(out) % 4) {
    return invalid;
  }
  Levels lv = {};
  Maps maps = {};
  lv.n = nl;
  lv.no = no;
  lv.no_out = no_out;
  lv.out_bstride = out_bstride;
  lv.normalized = normalized;
  if (nbin > 0) {   // SigmoidBin(bin_count=nbin, vmin=0, vmax=4), rounded as bin_decode.cu's
    const double step = 4.0 / nbin;
    lv.nbin = nbin;
    lv.start = static_cast<float>(step / 2.0);
    lv.step = static_cast<float>(step);
  }
  int max_na = 1;
  for (int i = 0; i < nl; ++i) {
    const long long* in = ints + kIntsPerLevel * i;
    const float* fl = floats + kFloatsPerLevel * i;
    Level& L = lv.l[i];
    const long long h = in[1], w = in[2];
    L.na = static_cast<int>(in[3]);
    if (h < 0 || w < 0 || h * w > (1 << 30) || (h * w) % 4 || in[0] % 16 || L.na < 1 ||
        L.na > kMaxAnchors) {
      return invalid;
    }
    L.h = static_cast<int>(h);
    L.w = static_cast<int>(w);
    L.row0 = in[4];
    L.stride = fl[0];
    for (int a = 0; a < L.na; ++a) {
      L.aw[a] = fl[1 + 2 * a];
      L.ah[a] = fl[2 + 2 * a];
    }
    L.tiles_per_image = static_cast<int>((h * w + kP - 1) / kP);
    if (h * w > 0 && bs > 0 &&
        !encode_level(&maps.m[i], reinterpret_cast<const void*>(in[0]), bs, L.h * L.w, no, L.na)) {
      return invalid;
    }
    max_na = L.na > max_na ? L.na : max_na;
  }
  // schedule: the level with the most tiles first (stable)
  for (int i = 0; i < nl; ++i) lv.sched[i] = i;
  for (int i = 1; i < nl; ++i) {
    for (int j = i; j > 0 && lv.l[lv.sched[j]].tiles_per_image > lv.l[lv.sched[j - 1]].tiles_per_image; --j) {
      const int s = lv.sched[j];
      lv.sched[j] = lv.sched[j - 1];
      lv.sched[j - 1] = s;
    }
  }
  long long tiles = 0;
  for (int i = 0; i < nl; ++i) {
    Level& L = lv.l[lv.sched[i]];
    L.first_tile = static_cast<int>(tiles);
    tiles += static_cast<long long>(L.tiles_per_image) * bs;
    if (tiles > 0x7fffffff) return invalid;
  }
  if (tiles == 0) return 0;
  lv.tiles = static_cast<int>(tiles);

  // one CTA an SM, with as many stages as fit
  lv.stage_bytes = (static_cast<uint32_t>(kP * no * max_na * sizeof(float)) + 127u) & ~127u;
  const uint32_t out_floats = (static_cast<uint32_t>(kP * max_na * no_out) + 4u + 3u) & ~3u;
  lv.stages = 2;
  if (smem_bytes(lv, out_floats, 2) > kSmemPerBlock) return invalid;
  while (lv.stages < kMaxStages && smem_bytes(lv, out_floats, lv.stages + 1) <= kSmemPerBlock) {
    ++lv.stages;
  }
  const size_t smem = smem_bytes(lv, out_floats, lv.stages);
  auto kernel = decode_levels_kernel<Body>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int grid = lv.tiles < sms ? lv.tiles : sms;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps, lv, static_cast<float*>(out), out_floats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode_tma

}  // namespace
