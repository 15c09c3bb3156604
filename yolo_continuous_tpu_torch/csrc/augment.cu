// warp_tiles: the train augmentation's warps, one launch a path, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel. JAX's augment_batch (yolo_continuous_tpu/ops/
// augment.py) warps every staging canvas with jax.image.scale_and_translate
// (linear, antialiased), which XLA computes as two dense weight matrices a
// warp and two matrix products; the port's plain version
// (yolo_continuous_tpu_torch/ops/augment.py: warp_canvas, then the LR flip or
// the mosaic's quadrant select, then random_hsv) copies that, in fp32. That
// form multiplies by matrices that are almost all zeros (the triangle filter
// covers about 2/scale inputs of an output) and, in the mosaic, warps four
// whole canvases to keep one quadrant of each.
//
// Here one thread computes one output pixel, all three channels, from the
// window of source pixels its filter covers:
//
// 1. The tile. Single path (q = 1 warp a sample): the sample's first canvas;
//    the LR flip after the paste mirrors the output x. Mosaic (q = 4): the
//    quadrant's canvas by the cut lines (top = y < cuty, left = x < cutx;
//    top-left 0, bottom-left 1, bottom-right 2, top-right 3); that tile's
//    flip before the resize mirrors the source x. Tiles are u8 canvases
//    reached through a (B, T) index, so a pool of staged canvases is read
//    where it lies (assembled tiles pass the identity index).
// 2. The resample: weight_matrix's filter for this output row and column
//    from the warp's own (k, t): kernel_scale = max(1/k, 1), the sample at
//    (o + 0.5)/k - t/k - 0.5, weights max(1 - |sample - i|/kernel_scale, 0)
//    over the inputs, divided by their sum (none where the sum is not above
//    1000 eps), none where the sample lies outside [-0.5, in - 0.5]. The
//    window has any width: its taps follow the warp's scale. The sum runs as
//    the plain version's two products do (rows, then columns) in fp32:
//    sum_w wx * (sum_h wy * (v - 128)), then + 128, so an output that no
//    window reaches reads exactly 128.
// 3. random_hsv's gain jitter (_hsv_planes, the gains u * g + 1,
//    _rgb_planes) in torch's order of operations, as torch on the card
//    rounds it: a division by a number as a product with its fp32 reciprocal
//    (1/30, 1/255), every other product, sum and quotient rounded on its own
//    (-fmad=false; the resample's sums are explicit fused multiply-adds).
// 4. The write: fp32 (B, S, S, 3) on 0..255, at the sample's batch row (the
//    mosaic's rows go straight into the batch's images).
//
// Every geometric value (the warps, the cut lines, the flips) and the HSV
// draws are read from device memory, so a captured launch warps by the draws
// of each replay.
//
// What bounds it on the H100: bytes. A 640 px batch of 32 mosaics writes
// 157 MB of fp32 and reads at most 4 x 32 u8 canvases of 1.2 MB; the single
// path as much again with one canvas a sample: about 0.15 ms at 3.35 TB/s for
// both. The work is about 4 taps an input pixel (a downscale reads each
// input about (2)^2 times) or about 4 an output pixel (an upscale): a few
// million multiply-adds a canvas; each weight costs two IEEE divisions (as
// weight_matrix divides), which is what the time goes to. The design: one
// thread a pixel, a block of 32 x 8 pixels, so a warp writes 384 contiguous
// bytes and its windows overlap in L1; each pixel's taps are exactly the
// inputs its filter can reach (no margin of zero taps), and its row weights
// are computed once into registers (up to kCache taps; a wider window, a
// scale under about 1/7, computes them again for each column: the same
// values, so no cap changes a result).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr float kFill = 128.0f;
constexpr float kGuard = 1000.0f * 0x1p-23f;   // 1000 * float32 eps, exact
constexpr int kCache = 16;                     // row taps kept in registers

// One axis of one output pixel: its sample position, kernel scale and the
// taps lo..hi that may carry weight (hi < lo: the output reads no input
// along this axis).
struct Axis {
  float s, ks;
  int lo, hi;
};

__device__ __forceinline__ float raw_weight(const Axis& a, int i) {
  const float x = __fdiv_rn(fabsf(__fsub_rn(a.s, float(i))), a.ks);
  return fmaxf(__fsub_rn(1.0f, x), 0.0f);
}

// weight_matrix's column for output o of a warp of scale k and translation
// t over an axis of n inputs, without the sum of its weights.
__device__ Axis axis_of(int o, float k, float t, int n) {
  Axis a;
  const float inv = __fdiv_rn(1.0f, k);
  a.ks = fmaxf(inv, 1.0f);
  a.s = __fsub_rn(__fsub_rn(__fmul_rn(__fadd_rn(float(o), 0.5f), inv), __fmul_rn(t, inv)), 0.5f);
  a.lo = 0;
  a.hi = -1;
  if (!(a.s >= -0.5f && a.s <= __fsub_rn(float(n), 0.5f))) return a;
  // A weight is not 0 only where fl(s - i) lies inside (-ks, ks): for an
  // integer i below floor(fl(s - ks)), s - i > ks + 1/2, so fl(s - i) >= ks
  // (likewise above ceil(fl(s + ks))). Clamped in fp32 first, so that a huge
  // ks converts to no int out of range.
  a.lo = int(fmaxf(floorf(__fsub_rn(a.s, a.ks)), 0.0f));
  a.hi = int(fminf(ceilf(__fadd_rn(a.s, a.ks)), float(n - 1)));
  return a;
}

// The sum of an axis's weights, in order of the taps.
__device__ __forceinline__ float total_of(const Axis& a) {
  float total = 0.0f;
  for (int i = a.lo; i <= a.hi; ++i) total = __fadd_rn(total, raw_weight(a, i));
  return total;
}

// weights / total, where total is above the guard; else no weight at all
__device__ __forceinline__ bool guarded(float total) { return fabsf(total) > kGuard; }

// c += w * (v - 128) for the three channels of one source pixel
__device__ __forceinline__ void tap(float w, const uint8_t* px, float& c0, float& c1, float& c2) {
  if (w == 0.0f) return;
  c0 = __fmaf_rn(w, __fsub_rn(float(px[0]), kFill), c0);
  c1 = __fmaf_rn(w, __fsub_rn(float(px[1]), kFill), c1);
  c2 = __fmaf_rn(w, __fsub_rn(float(px[2]), kFill), c2);
}

// sum_u wx(u) * sum_v wy(v) * (img[v, u] - 128), the plain version's order
// (rows, then columns). kCached: the row weights wy[0 .. ny) in registers;
// else computed again for each column from ay and its total ty.
template <bool kCached>
__device__ __forceinline__ void resample(const uint8_t* img, int in_w, bool mirror,
                                         const Axis& ay, const float (&wy)[kCache], float ty,
                                         const Axis& ax, float tx, float& a0, float& a1,
                                         float& a2) {
  const int ny = ay.hi - ay.lo + 1;
  const size_t row = size_t(in_w) * 3;
  for (int u = ax.lo; u <= ax.hi; ++u) {
    const float wx = __fdiv_rn(raw_weight(ax, u), tx);
    if (wx == 0.0f) continue;
    const uint8_t* col = img + size_t(ay.lo) * row + size_t(mirror ? in_w - 1 - u : u) * 3;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    if constexpr (kCached) {
#pragma unroll
      for (int j = 0; j < kCache; ++j) {
        if (j >= ny) break;
        tap(wy[j], col + j * row, c0, c1, c2);
      }
    } else {
      for (int j = 0; j < ny; ++j)
        tap(__fdiv_rn(raw_weight(ay, ay.lo + j), ty), col + j * row, c0, c1, c2);
    }
    a0 = __fmaf_rn(c0, wx, a0);
    a1 = __fmaf_rn(c1, wx, a1);
    a2 = __fmaf_rn(c2, wx, a2);
  }
}

// x modulo y > 0 as jnp.remainder gives it: fmod, then + y where the sign
// differs from the divisor's.
__device__ __forceinline__ float remainder_of(float x, float y) {
  const float m = fmodf(x, y);
  return (m != 0.0f && m < 0.0f) ? __fadd_rn(m, y) : m;
}

// random_hsv on one pixel (ops/augment.py: _hsv_planes, the gains, _rgb_planes).
__device__ void hsv_jitter(float& r, float& g, float& b, float gh, float gs, float gv) {
  const float mx = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float diff = __fsub_rn(mx, mn);
  const float safe = diff > 0.0f ? diff : 1.0f;
  float h;
  if (mx == r) {
    h = __fdiv_rn(__fsub_rn(g, b), safe);
  } else if (mx == g) {
    h = __fadd_rn(2.0f, __fdiv_rn(__fsub_rn(b, r), safe));
  } else {
    h = __fadd_rn(4.0f, __fdiv_rn(__fsub_rn(r, g), safe));
  }
  h = remainder_of(__fmul_rn(h, 30.0f), 180.0f);
  if (!(diff > 0.0f)) h = 0.0f;
  float s = mx > 0.0f ? __fmul_rn(__fdiv_rn(diff, mx), 255.0f) : 0.0f;
  float v = mx;
  h = remainder_of(__fmul_rn(h, gh), 180.0f);
  s = fminf(fmaxf(__fmul_rn(s, gs), 0.0f), 255.0f);
  v = fminf(fmaxf(__fmul_rn(v, gv), 0.0f), 255.0f);
  // _rgb_planes; torch on the card divides by a number as a product with its
  // fp32 reciprocal
  h = __fmul_rn(h, 1.0f / 30.0f);
  s = __fmul_rn(s, 1.0f / 255.0f);
  const float fl = floorf(h);
  const float i = remainder_of(fl, 6.0f);
  const float f = __fsub_rn(h, fl);
  const float p = __fmul_rn(v, __fsub_rn(1.0f, s));
  const float q = __fmul_rn(v, __fsub_rn(1.0f, __fmul_rn(s, f)));
  const float t = __fmul_rn(v, __fsub_rn(1.0f, __fmul_rn(s, __fsub_rn(1.0f, f))));
  // jnp.select over i == 0..5, default 0
  if (i == 0.0f) {
    r = v; g = t; b = p;
  } else if (i == 1.0f) {
    r = q; g = v; b = p;
  } else if (i == 2.0f) {
    r = p; g = v; b = t;
  } else if (i == 3.0f) {
    r = p; g = q; b = v;
  } else if (i == 4.0f) {
    r = t; g = p; b = v;
  } else if (i == 5.0f) {
    r = v; g = p; b = q;
  } else {
    r = 0.0f; g = 0.0f; b = 0.0f;
  }
}

struct Args {
  const uint8_t* src;       // (src_rows, in_h, in_w, 3) u8 canvases
  long long src_rows;
  const long long* idx;     // (batch, tiles) canvas rows
  int tiles;
  const long long* rows;    // (n,) batch rows of the samples
  const float* warps;       // (n, q, 4) ky, kx, ty, tx
  const uint8_t* flip;      // (n, q) bool
  const float* cut;         // (n, 2) cutx, cuty (q = 4)
  const float* hsv;         // (n, 3) the HSV draws, U(-1, 1)
  float hue, sat, val;      // the gains' magnitudes
  float* out;               // (batch, size, size, 3) fp32
  int n, q, batch, in_h, in_w, size;
};

__global__ void __launch_bounds__(kBlockX * kBlockY) warp_tiles_kernel(const Args a) {
  const int i = blockIdx.z;
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= a.size || y >= a.size) return;
  const long long row = a.rows[i];
  if (row < 0 || row >= a.batch) return;   // a row outside the batch is written nowhere
  int quad = 0, xs = x;
  bool mirror = false;
  if (a.q == 4) {
    const bool top = float(y) < a.cut[2 * i + 1], left = float(x) < a.cut[2 * i];
    quad = top ? (left ? 0 : 3) : (left ? 1 : 2);
    mirror = a.flip[4 * i + quad] != 0;
  } else if (a.flip[i] != 0) {
    xs = a.size - 1 - x;
  }
  const float* w = a.warps + 4 * (size_t(i) * a.q + quad);
  const long long tile = a.idx[row * a.tiles + quad];
  float r, g, b;
  if (tile < 0 || tile >= a.src_rows) {    // an index outside the canvases reads NaN
    r = g = b = __int_as_float(0x7fffffff);
  } else {
    const Axis ay = axis_of(y, w[0], w[2], a.in_h);
    const Axis ax = axis_of(xs, w[1], w[3], a.in_w);
    const uint8_t* img = a.src + tile * (long long)a.in_h * a.in_w * 3;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
    const int ny = ay.hi - ay.lo + 1;
    if (ny > 0 && ax.hi >= ax.lo) {
      const float tx = total_of(ax);
      float wy[kCache];
      if (ny <= kCache) {
        float ty = 0.0f;
#pragma unroll
        for (int j = 0; j < kCache; ++j) {
          if (j >= ny) break;
          wy[j] = raw_weight(ay, ay.lo + j);
          ty = __fadd_rn(ty, wy[j]);
        }
        if (guarded(ty) && guarded(tx)) {
#pragma unroll
          for (int j = 0; j < kCache; ++j) {
            if (j >= ny) break;
            wy[j] = __fdiv_rn(wy[j], ty);
          }
          resample<true>(img, a.in_w, mirror, ay, wy, ty, ax, tx, acc0, acc1, acc2);
        }
      } else {
        const float ty = total_of(ay);
        if (guarded(ty) && guarded(tx))
          resample<false>(img, a.in_w, mirror, ay, wy, ty, ax, tx, acc0, acc1, acc2);
      }
    }
    r = __fadd_rn(acc0, kFill);
    g = __fadd_rn(acc1, kFill);
    b = __fadd_rn(acc2, kFill);
  }
  const float* u = a.hsv + 3 * i;
  hsv_jitter(r, g, b, __fadd_rn(__fmul_rn(u[0], a.hue), 1.0f),
             __fadd_rn(__fmul_rn(u[1], a.sat), 1.0f), __fadd_rn(__fmul_rn(u[2], a.val), 1.0f));
  float* o = a.out + ((row * a.size + y) * a.size + x) * 3;
  o[0] = r;
  o[1] = g;
  o[2] = b;
}

}  // namespace

// Writes the n samples' images (size x size x 3 fp32) into rows `rows` of out
// (batch, size, size, 3); sample i's tile t is canvas idx[rows[i], t] of src. q = 1: one warp a sample, its flip
// mirroring the output; q = 4: a mosaic, four warps cut by `cut`, each flip
// mirroring its tile. One launch on stream.
extern "C" int warp_tiles(const uint8_t* src, long long src_rows, const long long* idx, int tiles,
                          const long long* rows, const float* warps, const uint8_t* flip,
                          const float* cut, const float* hsv, float hue, float sat, float val,
                          float* out, int n, int q, int batch, int in_h, int in_w, int size,
                          cudaStream_t stream) {
  if (n == 0 || size == 0) return 0;
  const Args a{src, src_rows, idx, tiles, rows, warps, flip, cut, hsv, hue, sat, val,
               out, n, q, batch, in_h, in_w, size};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((size + kBlockX - 1) / kBlockX, (size + kBlockY - 1) / kBlockY, n);
  warp_tiles_kernel<<<grid, block, 0, stream>>>(a);
  return int(cudaGetLastError());
}
