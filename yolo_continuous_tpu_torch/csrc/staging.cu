// stage_letterbox: every staging canvas of a batch in one launch, for
// Hopper (sm_90a).
//
// Replaces the resize and letterbox of the host library native/staging.cpp
// (resize_bilinear and stage_one: a bilinear resize and a centred letterbox
// of fill 128, in a C++ thread pool), which the JAX package reaches through
// yolo_continuous_tpu/data/native_loader.py (stage_batch_native). It is no
// TPU kernel: JAX stages on the host. The decode stays on the host
// (kernels/staging.py: cv2 in a thread pool, libjpeg's pixels, copied up
// from pinned memory in one copy). Plain version of the same function:
// yolo_continuous_tpu_torch/kernels/staging.py::stage_letterbox_plain.
//
// It computes staging.cpp's resize_bilinear and stage_one exactly, in fp32,
// with every operation rounded on its own: the products and sums by
// __fmul_rn / __fadd_rn / __fsub_rn (no FMA contraction; the file is also
// built with -fmad=false), the scale by IEEE division (__fdiv_rn),
// std::lround by trunc and a compare (half away from zero, never the
// hardware's half to even). The geometry (r, nw, nh, ox, oy) is computed on
// the host in fp32, as stage_one does, and handed over in a table of one row
// a canvas; a row with nw = 0 is a canvas of fill alone (the zero tiles of a
// batch's unused mosaic slots).
//
// What bounds it on the H100: bytes. A canvas is S*S*3 bytes written once
// and its decoded RGB image read once (each source byte feeds up to four
// outputs through L1/L2); a 640 px batch of 64 JPEGs of 640 x 480 moves
// 59 MB in and 79 MB out, about 41 us at 3.35 TB/s. The design: one thread
// writes four consecutive bytes of a canvas as one 32-bit store, so a
// warp stores 128 contiguous bytes; grid (words / 256, canvases), so no
// 64-bit division. Fill bytes cost a compare. A simple kernel, right first.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGeoCols = 8;   // src offset, iw, ih, nw, nh, ox, oy, fill

// One output byte of a placed pixel: staging.cpp resize_bilinear, channel c.
__device__ __forceinline__ uint8_t bilinear(const uint8_t* __restrict__ img, int iw, int ih,
                                            float sx, float sy, int x, int y, int c) {
  const float fy = __fsub_rn(__fmul_rn(__fadd_rn(float(y), 0.5f), sy), 0.5f);
  const int y0 = int(floorf(fy));
  const float wy = __fsub_rn(fy, float(y0));
  const int y0c = min(max(y0, 0), ih - 1);
  const int y1c = min(max(y0 + 1, 0), ih - 1);
  const float fx = __fsub_rn(__fmul_rn(__fadd_rn(float(x), 0.5f), sx), 0.5f);
  const int x0 = int(floorf(fx));
  const float wx = __fsub_rn(fx, float(x0));
  const int x0c = min(max(x0, 0), iw - 1);
  const int x1c = min(max(x0 + 1, 0), iw - 1);
  const float v00 = img[(size_t(y0c) * iw + x0c) * 3 + c];
  const float v01 = img[(size_t(y0c) * iw + x1c) * 3 + c];
  const float v10 = img[(size_t(y1c) * iw + x0c) * 3 + c];
  const float v11 = img[(size_t(y1c) * iw + x1c) * 3 + c];
  const float ay = __fsub_rn(1.0f, wy), ax = __fsub_rn(1.0f, wx);
  // v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx, left to right
  float v = __fmul_rn(__fmul_rn(v00, ay), ax);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, ay), wx));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), ax));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
  const float t = truncf(v);   // v >= 0; v - t is exact
  return uint8_t(int(t) + (__fsub_rn(v, t) >= 0.5f ? 1 : 0));
}

__global__ void __launch_bounds__(kThreads)
stage_letterbox_kernel(const uint8_t* __restrict__ src, const long long* __restrict__ geo,
                       uint8_t* __restrict__ out, int size) {
  const long long* g = geo + size_t(blockIdx.y) * kGeoCols;
  const int iw = int(g[1]), ih = int(g[2]), nw = int(g[3]), nh = int(g[4]);
  const int ox = int(g[5]), oy = int(g[6]);
  const uint8_t fill = uint8_t(g[7]);
  const uint8_t* img = src + g[0];
  const int bytes = size * size * 3;
  const int b0 = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (b0 >= bytes) return;
  float sx = 0.f, sy = 0.f;
  if (nw > 0) {
    sx = __fdiv_rn(float(iw), float(nw));
    sy = __fdiv_rn(float(ih), float(nh));
  }
  uint8_t v[4];
  const int nb = min(4, bytes - b0);
  for (int k = 0; k < nb; ++k) {
    const int b = b0 + k;
    const int p = b / 3, c = b - 3 * p;
    const int y = p / size - oy, x = p % size - ox;
    v[k] = (y >= 0 && y < nh && x >= 0 && x < nw) ? bilinear(img, iw, ih, sx, sy, x, y, c)
                                                  : fill;
  }
  uint8_t* o = out + size_t(blockIdx.y) * bytes + b0;
  if (nb == 4 && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(o) =
        uint32_t(v[0]) | uint32_t(v[1]) << 8 | uint32_t(v[2]) << 16 | uint32_t(v[3]) << 24;
  } else {
    for (int k = 0; k < nb; ++k) o[k] = v[k];
  }
}

}  // namespace

// Writes n canvases (n, size, size, 3) u8 into out from the decoded RGB
// images at src, one row of geo (n, 8) int64 a canvas: {byte offset into
// src, iw, ih, nw, nh, ox, oy, fill}. One launch on stream.
extern "C" int stage_letterbox(const uint8_t* src, const long long* geo, uint8_t* out, int n,
                               int size, cudaStream_t stream) {
  if (n == 0) return 0;
  const int words = (size * size * 3 + 3) / 4;
  const dim3 grid((words + kThreads - 1) / kThreads, n);
  stage_letterbox_kernel<<<grid, kThreads, 0, stream>>>(src, geo, out, size);
  return int(cudaGetLastError());
}
