// K4: fused IBin (SigmoidBin) decode of the head levels, for Hopper (sm_90a).
//
// Replaces the TPU kernel yolo_continuous_tpu/kernels/bin_decode_pallas.py
// (decode_level_bin_pallas, body _make_kernel). Plain PyTorch version of the
// same function: yolo_continuous_tpu_torch/ops/decode.py::decode_level_bin.
//
// What it computes, per row (y, x, a) of the raw head map pred (bs, h, w, na,
// no), no = nc + 3 + 2 * L, L = nbin + 1, with s = sigmoid(v) of every column:
//   out 0: (2 s0 - 0.5 + x) * stride          out 1: (2 s1 - 0.5 + y) * stride
//   out 2: clip((2 s2 - 1) * step + start + step * argmax(s[3 .. 2 + nbin]), 0, 4) * aw
//   out 3: the same on the residual at 2 + L and the bins after it, * ah
//   out 4 .. 4 + nc: s[2 + 2L ..] (obj, cls)
// where (aw, ah) is the anchor in pixels, step = 4 / nbin, start = step / 2,
// and argmax takes the first maximum. In normalized mode the box columns are
// divided by (w * stride, h * stride). Rows are written in the JAX package's
// (h, w, na) order into out (bs, rows, 5 + nc) at row offset row0, so all
// levels land in one buffer with no concatenation copy.
//
// What bounds it on the H100: bytes. Each row reads no floats and writes
// 5 + nc (127 and 85 at 80 classes) with a few flops and two 21-way argmaxes;
// at yolov7-IBin @640, bs 16 that is about 342 MB, about 0.10 ms at 3.35 TB/s.
//
// Two forms, chosen by the caller (kernels/bin_decode.py::form_for) before
// the launch:
//
// decode_levels_bin_tma, the main form: every level of a request in one
// launch, fed by TMA (decode_tma.cuh says how and when a head map
// qualifies). The sigmoided bins stay in the staged input tile, per pixel
// and anchor; then one thread per (pixel, anchor, w|h) scans the 21 bins
// down its own pixel's column (lanes over pixels: no bank conflicts), and
// only the 5 + nc output columns are written.
//
// decode_level_bin, the strided form, one launch per level, for any
// strides: as K3's (csrc/decode.cu). One block takes a row of up to 32
// cells (16 at 3 x 127 columns, to stay under 48 KB) and stages their
// sigmoids in shared memory, read with w fastest (contiguous in NCHW). One
// thread per row and value then scans the bins into a small w/h array, so
// the 21-step scans do not stall the warps of the write; the write puts the
// tile's 5 + nc columns per row out as one contiguous run, so both sides are
// coalesced although input and output rows differ in width.
#include <cuda_runtime.h>

#include "decode_tma.cuh"

namespace {

constexpr int kMaxAnchors = 8;
constexpr int kThreads = 256;
constexpr int kTileX = 32;
constexpr size_t kStaticSmem = 48 * 1024;

struct Anchors {
  float w[kMaxAnchors];  // anchor width in input pixels
  float h[kMaxAnchors];
};

__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

// SigmoidBin decode of one value: residual at s[0], bins at s[ds .. nbin ds]
__device__ __forceinline__ float bin_value(const float* s, int ds, int nbin, float start,
                                           float step) {
  int best = 0;
  float top = s[ds];
  for (int j = 1; j < nbin; ++j) {
    const float v = s[(1 + j) * ds];
    if (v > top) {  // strict: the first maximum wins, as argmax
      top = v;
      best = j;
    }
  }
  const float reg = __fmul_rn(__fsub_rn(__fmul_rn(s[0], 2.0f), 1.0f), step);
  const float centre = __fadd_rn(start, __fmul_rn(step, static_cast<float>(best)));
  return fminf(fmaxf(__fadd_rn(reg, centre), 0.0f), 4.0f);
}

__global__ void decode_level_bin_kernel(const float* __restrict__ pred, float* __restrict__ out,
                                        int h, int w, int na, int no, int nbin, int tile_x,
                                        long long sb, long long sy, long long sx, long long sa,
                                        long long sc, long long out_bstride, long long row0,
                                        Anchors anc, int normalized, float stride, float start,
                                        float step) {
  extern __shared__ float tile[];  // [tile_x][na][no] sigmoids
  __shared__ float wh[kTileX * kMaxAnchors * 2];  // decoded w, h of each row
  const int x0 = blockIdx.x * tile_x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int nx = min(tile_x, w - x0);
  const int L = nbin + 1;
  const int no_out = no - 2 * L + 2;
  const float* src = pred + b * sb + y * sy;

  // read with the cell index fastest: contiguous along w for an NCHW head
  for (int idx = threadIdx.x; idx < tile_x * na * no; idx += blockDim.x) {
    const int xi = idx % tile_x;
    const int t = idx / tile_x;
    const int c = t % no;
    const int a = t / no;
    if (xi >= nx) continue;
    tile[(xi * na + a) * no + c] = sigmoid(src[(x0 + xi) * sx + a * sa + c * sc]);
  }
  __syncthreads();

  // the two bin scans of each row, one thread each, so no warp of the
  // write below waits on a scan
  for (int t = threadIdx.x; t < nx * na * 2; t += blockDim.x) {
    const int row = t >> 1;
    const float* s = tile + row * no + 2 + (t & 1) * L;
    wh[t] = __fmul_rn(bin_value(s, 1, nbin, start, step), (t & 1) ? anc.h[row % na] : anc.w[row % na]);
  }
  __syncthreads();

  const float sw = static_cast<float>(w) * stride;  // normalisers, exact for integer strides
  const float sh = static_cast<float>(h) * stride;
  float* dst = out + b * out_bstride + (row0 + (static_cast<long long>(y) * w + x0) * na) * no_out;
  const int n = nx * na * no_out;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int row = idx / no_out;
    const int c = idx % no_out;
    const float* s = tile + row * no;
    float r;
    if (c >= 4) {
      r = s[c + 2 * L - 2];
    } else {
      float box;
      if (c < 2) {
        const float g = static_cast<float>(c == 0 ? x0 + row / na : y);
        box = __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(s[c], 2.0f), 0.5f), g), stride);
      } else {
        box = wh[row * 2 + c - 2];
      }
      r = normalized ? __fdiv_rn(box, (c & 1) ? sh : sw) : box;
    }
    dst[idx] = r;
  }
}

// The TMA form's arithmetic on a staged tile: lane p is pixel t.p0 + p, the
// warps take the tile's (anchor, column) rows in turn: x and y are decoded,
// obj and cls written, the bins sigmoided in place; then a thread per
// (anchor, w|h) of its pixel scans them. Every step as in
// decode_level_bin_kernel.
struct BinDecode {
  __device__ static void compute(const decode_tma::Levels& lv, const decode_tma::Level& L,
                                 const decode_tma::Tile& t, float* in, float* ob, int p,
                                 int warp) {
    using decode_tma::kP;
    const int pix = t.p0 + p;
    const int y = pix / L.w;
    const float gx = static_cast<float>(pix - y * L.w);
    const float gy = static_cast<float>(y);
    const float sw = static_cast<float>(L.w) * L.stride;  // normalisers, as the strided form's
    const float sh = static_cast<float>(L.h) * L.stride;
    const int no = lv.no, no_out = lv.no_out, na = L.na, len = lv.nbin + 1;
    const int bins_end = 2 + 2 * len;   // x, y, then the w and h residuals and bins
    for (int q = warp, a = 0, c = warp; q < na * no; q += decode_tma::kWarps, c += decode_tma::kWarps) {
      while (c >= no) {   // q = a * no + c
        c -= no;
        ++a;
      }
      const float s = sigmoid_rn(in[q * kP + p]);
      float* dst = ob + (p * na + a) * no_out;
      if (c < 2) {
        const float box =
            __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(s, 2.0f), 0.5f), c == 0 ? gx : gy), L.stride);
        dst[c] = lv.normalized ? __fdiv_rn(box, c ? sh : sw) : box;
      } else if (c < bins_end) {
        in[q * kP + p] = s;
      } else {
        dst[c - bins_end + 4] = s;
      }
    }
    __syncthreads();
    for (int q = warp; q < 2 * na; q += decode_tma::kWarps) {
      const int a = q >> 1, k = q & 1;
      const float* s = in + (a * no + 2 + k * len) * kP + p;
      const float wh = __fmul_rn(bin_value(s, kP, lv.nbin, lv.start, lv.step), k ? L.ah[a] : L.aw[a]);
      ob[(p * na + a) * no_out + 2 + k] = lv.normalized ? __fdiv_rn(wh, k ? sh : sw) : wh;
    }
  }
};

}  // namespace

// pred: (bs, h, w, na, no) fp32, element strides sb, sy, sx, sa, sc.
// out: fp32 rows of no - 2 (nbin + 1) + 2 values, batch stride out_bstride,
// written from row0. anchors_wh: host array of na (w, h) pairs in pixels.
// Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int decode_level_bin(const void* pred, void* out, int bs, int h, int w, int na, int no,
                                long long sb, long long sy, long long sx, long long sa,
                                long long sc, long long out_bstride, long long row0,
                                const float* anchors_wh, int nbin, int normalized, float stride,
                                void* stream) {
  if (na < 1 || na > kMaxAnchors || nbin < 1 || no < 2 * (nbin + 1) + 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bs == 0 || h == 0 || w == 0) return 0;
  Anchors anc;
  for (int a = 0; a < na; ++a) {
    anc.w[a] = anchors_wh[2 * a];
    anc.h[a] = anchors_wh[2 * a + 1];
  }
  // keep the tile and the static w/h array within the 48 KB a block may
  // have without opting in to more (tile_x 16 at yolov7-IBin's 3 x 127)
  const size_t budget = kStaticSmem - kTileX * kMaxAnchors * 2 * sizeof(float);
  int tile_x = kTileX;
  while (tile_x > 1 && static_cast<size_t>(tile_x) * na * no * sizeof(float) > budget) tile_x /= 2;
  const size_t smem = static_cast<size_t>(tile_x) * na * no * sizeof(float);
  if (smem > budget) return static_cast<int>(cudaErrorInvalidValue);
  // SigmoidBin(bin_count=nbin, vmin=0, vmax=4) constants, rounded to fp32
  // as the plain version rounds them (ops/sigmoid_bin.py)
  const double step = 4.0 / nbin;
  const float start = static_cast<float>(step / 2.0);
  dim3 grid((w + tile_x - 1) / tile_x, h, bs);
  decode_level_bin_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), static_cast<float*>(out), h, w, na, no, nbin, tile_x, sb, sy,
      sx, sa, sc, out_bstride, row0, anc, normalized, stride, start, static_cast<float>(step));
  return static_cast<int>(cudaGetLastError());
}

// The TMA form: all nl (<= 4) levels of pred in one launch. level_ints holds
// per level the map's base pointer, h, w, na and its first output row;
// level_floats per level the stride and 8 (w, h) anchor pairs in pixels (the
// first na used). Each map is the (bs, h, w, na, no) view of a contiguous
// (bs, na * no, h, w) fp32 tensor with h * w % 4 == 0 and a 16-byte aligned
// base (cudaErrorInvalidValue otherwise).
extern "C" int decode_levels_bin_tma(int nl, const long long* level_ints, const float* level_floats,
                                     void* out, int bs, int no, long long out_bstride, int nbin,
                                     int normalized, void* stream) {
  if (nbin < 1 || no < 2 * (nbin + 1) + 3) return static_cast<int>(cudaErrorInvalidValue);
  return decode_tma::launch<BinDecode>(nl, level_ints, level_floats, out, bs, no,
                                       no - 2 * (nbin + 1) + 2, out_bstride, normalized, nbin,
                                       stream);
}
