// K3: fused grid/anchor decode of the head levels, for Hopper (sm_90a).
//
// Replaces the TPU kernel yolo_continuous_tpu/kernels/decode_pallas.py
// (decode_level_pallas, body _make_kernel). Plain PyTorch version of the
// same function: yolo_continuous_tpu_torch/ops/decode.py::decode_level.
//
// What it computes, per element of the raw head map pred (bs, h, w, na, no):
//   s = sigmoid(v)
//   c == 0: (2s - 0.5 + x) / w      c == 1: (2s - 0.5 + y) / h
//   c == 2: (2s)^2 * aw / w         c == 3: (2s)^2 * ah / h
//   c >= 4: s
// where aw, ah are the anchor in feature units (pixels / stride). In pixel
// mode (normalized == 0) the box columns are multiplied by the stride
// instead of divided by the feature size. Rows are written in the JAX
// package's (h, w, na) order (ops/decode.py:51) into out (bs, rows, no) at
// row offset row0, so all levels of a model land in one buffer with no
// concatenation copy.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (4 + 4 bytes) with a few flops, far below the card's flop/byte
// ratio; at yolov7 @640, bs 16 that is 2 x 137 MB, about 82 us at 3.35 TB/s.
//
// Two forms, chosen by the caller (kernels/decode.py::form_for) before the
// launch:
//
// decode_levels_tma, the main form: every level of a request in one launch,
// fed by TMA (decode_tma.cuh says how and when a head map qualifies).
//
// decode_level, the strided form, one launch per level, for any strides (a
// channels-last map, h * w not a multiple of 4, a misaligned base): the
// input is read through the strides it is given, so the permute costs no
// copy. One block takes a row of up to 32 cells (all anchors and columns)
// and transposes it through shared memory: it reads with w fastest
// (contiguous in NCHW) and writes one contiguous run of tile_x * na * no
// floats, so both sides are coalesced. Grid position and anchor come from
// the block and element index, as on the TPU.
#include <cuda_runtime.h>

#include "decode_tma.cuh"

namespace {

constexpr int kMaxAnchors = 8;
constexpr int kThreads = 256;

struct Anchors {
  float w[kMaxAnchors];  // anchor width / stride (feature units)
  float h[kMaxAnchors];
};

__global__ void decode_level_kernel(const float* __restrict__ pred, float* __restrict__ out,
                                    int h, int w, int na, int no, int tile_x,
                                    long long sb, long long sy, long long sx, long long sa,
                                    long long sc, long long out_bstride, long long row0,
                                    Anchors anc, int normalized, float stride) {
  extern __shared__ float tile[];  // [tile_x][na][no]
  const int x0 = blockIdx.x * tile_x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int nx = min(tile_x, w - x0);
  const int per_cell = na * no;
  const float* src = pred + b * sb + y * sy;
  const float fw = static_cast<float>(w);
  const float fh = static_cast<float>(h);

  // read with the cell index fastest: contiguous along w for an NCHW head
  for (int idx = threadIdx.x; idx < tile_x * per_cell; idx += blockDim.x) {
    const int xi = idx % tile_x;
    const int t = idx / tile_x;
    const int c = t % no;
    const int a = t / no;
    if (xi >= nx) continue;
    const int x = x0 + xi;
    const float v = src[x * sx + a * sa + c * sc];
    const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
    float r = s;
    if (c < 4) {
      const float t2 = __fmul_rn(s, 2.0f);
      float box;
      if (c < 2) {
        box = __fadd_rn(__fsub_rn(t2, 0.5f), static_cast<float>(c == 0 ? x : y));
      } else {
        box = __fmul_rn(__fmul_rn(t2, t2), c == 2 ? anc.w[a] : anc.h[a]);
      }
      if (normalized) {
        r = __fdiv_rn(box, (c & 1) ? fh : fw);
      } else {
        r = __fmul_rn(box, stride);
      }
    }
    tile[(xi * na + a) * no + c] = r;
  }
  __syncthreads();

  // the tile's rows are one contiguous run of the output
  float* dst = out + b * out_bstride + (row0 + (static_cast<long long>(y) * w + x0) * na) * no;
  const int n = nx * per_cell;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) dst[idx] = tile[idx];
}

// The TMA form's arithmetic on a staged tile: lane p is pixel t.p0 + p, the
// warps take the tile's (anchor, column) rows in turn
struct GridDecode {
  __device__ static void compute(const decode_tma::Levels& lv, const decode_tma::Level& L,
                                 const decode_tma::Tile& t, float* in, float* ob, int p,
                                 int warp) {
    using decode_tma::kP;
    const int pix = t.p0 + p;
    const int y = pix / L.w;
    const float gx = static_cast<float>(pix - y * L.w);
    const float gy = static_cast<float>(y);
    const float fw = static_cast<float>(L.w);
    const float fh = static_cast<float>(L.h);
    const int no = lv.no, na = L.na;
    for (int q = warp, a = 0, c = warp; q < na * no; q += decode_tma::kWarps, c += decode_tma::kWarps) {
      while (c >= no) {   // q = a * no + c
        c -= no;
        ++a;
      }
      const float s = sigmoid_rn(in[q * kP + p]);
      float r = s;
      if (c < 4) {   // as decode_level_kernel, step for step
        const float t2 = __fmul_rn(s, 2.0f);
        float box;
        if (c < 2) {
          box = __fadd_rn(__fsub_rn(t2, 0.5f), c == 0 ? gx : gy);
        } else {
          box = __fmul_rn(__fmul_rn(t2, t2), c == 2 ? L.aw[a] : L.ah[a]);
        }
        r = lv.normalized ? __fdiv_rn(box, (c & 1) ? fh : fw) : __fmul_rn(box, L.stride);
      }
      ob[(p * na + a) * no + c] = r;
    }
  }
};

}  // namespace

// pred: (bs, h, w, na, no) fp32, element strides sb, sy, sx, sa, sc.
// out: fp32 rows of no values, batch stride out_bstride, written from row0.
// anchors_wh: host array of na (w, h) pairs in feature units.
// Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int decode_level(const void* pred, void* out, int bs, int h, int w, int na, int no,
                            long long sb, long long sy, long long sx, long long sa, long long sc,
                            long long out_bstride, long long row0, const float* anchors_wh,
                            int normalized, float stride, void* stream) {
  if (na < 1 || na > kMaxAnchors || no < 5) return static_cast<int>(cudaErrorInvalidValue);
  if (bs == 0 || h == 0 || w == 0) return 0;
  Anchors anc;
  for (int a = 0; a < na; ++a) {
    anc.w[a] = anchors_wh[2 * a];
    anc.h[a] = anchors_wh[2 * a + 1];
  }
  // keep the tile within the 48 KB of static-limit shared memory
  int tile_x = 32;
  while (tile_x > 1 && static_cast<size_t>(tile_x) * na * no * sizeof(float) > 48 * 1024) tile_x /= 2;
  const size_t smem = static_cast<size_t>(tile_x) * na * no * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((w + tile_x - 1) / tile_x, h, bs);
  decode_level_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), static_cast<float*>(out), h, w, na, no, tile_x, sb, sy, sx,
      sa, sc, out_bstride, row0, anc, normalized, stride);
  return static_cast<int>(cudaGetLastError());
}

// The TMA form: all nl (<= 4) levels of pred in one launch. level_ints holds
// per level the map's base pointer, h, w, na and its first output row;
// level_floats per level the stride and 8 (w, h) anchor pairs in feature
// units (the first na used). Each map is the (bs, h, w, na, no) view of a
// contiguous (bs, na * no, h, w) fp32 tensor with h * w % 4 == 0 and a
// 16-byte aligned base (cudaErrorInvalidValue otherwise).
extern "C" int decode_levels_tma(int nl, const long long* level_ints, const float* level_floats,
                                 void* out, int bs, int no, long long out_bstride, int normalized,
                                 void* stream) {
  if (no < 5) return static_cast<int>(cudaErrorInvalidValue);
  return decode_tma::launch<GridDecode>(nl, level_ints, level_floats, out, bs, no, no,
                                        out_bstride, normalized, 0, stream);
}
