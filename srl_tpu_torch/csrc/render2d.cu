// MobileRobot sprite compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel srl_tpu/ops/pallas_render.py (_kernel, the body
// launched by pl.pallas_call in _render_batch). For every env and pixel it
// starts from the precomputed checker-and-walls background (packed RGB, one
// 32-bit word per pixel) and paints, in order: the yellow target disk
// (r 0.25) or the yellow line band, the red second target, the robot body
// box and its four wheel pads. It stores uint8 NHWC at channel offset 0
// with a channel stride of 3 (or 6 when the first-person view fills
// channels 3-5).
//
// What bounds it on this card: memory traffic. Each output pixel costs 3
// bytes written and about 15 float32 operations, far under the card's
// operation bound; the inputs (background, coordinate vectors, scene rows,
// 0.2 MB in all) are shared by every env and stay in L2.
// What the design does about it: one thread per 4 consecutive pixels of
// the flattened image, so that a warp reads 512 contiguous bytes of
// background (one 16-byte load per thread) and, with 3 channels, writes
// 384 contiguous bytes as three 32-bit stores per thread; the env's 8-float
// scene row is uniform across the block; nothing but the output touches
// device memory. The TPU kernel's 8-row blocks, VMEM residency and
// (row-block, env) grid order do not come across.
//
// Exactness: the compositor is integer selects over colours quantized on
// the host and float32 compares, so it equals the PyTorch twin
// (srl_tpu_torch/ops/render2d.py, render_mobile_robot_plain) bit for bit.
// The disk test is written out as the reference's XLA code rounds it:
// dy * dy rounded, then dx * dx fused into the sum, fmaf(dx, dx, dy2), with
// intrinsics so that nvcc cannot contract it another way.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see srl_tpu_torch/ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int PX = 4;  // pixels per thread
constexpr int SCENE = 8;

// Filled on the host by render2d.py (_kernel_consts) in this field order,
// as 32-bit words.
struct Consts {
  float target_r2;
  float line_half_w, line_cy, line_half_h;
  float half_l, half_w;
  float wheel_dx, wheel_hx, wheel_hy;
  uint32_t yellow, red, body, wheel;
};

__device__ __forceinline__ bool in_disk(float x, float y, float cx, float cy,
                                        float r2) {
  const float dx = x - cx;
  const float dy = y - cy;
  return __fmaf_rn(dx, dx, __fmul_rn(dy, dy)) <= r2;
}

__global__ void __launch_bounds__(THREADS)
render2d_kernel(const float* __restrict__ scene, const float* __restrict__ xs_row,
                const float* __restrict__ ys_col, const uint32_t* __restrict__ bg,
                int height, int width, const Consts c, uint8_t* __restrict__ out,
                int channels) {
  const int env = blockIdx.y;
  const int pixels = height * width;
  const int p0 = (blockIdx.x * THREADS + threadIdx.x) * PX;
  if (p0 >= pixels) return;

  const float* s = scene + (size_t)env * SCENE;
  const float rx = s[0], ry = s[1], t0x = s[2], t0y = s[3], t1x = s[4], t1y = s[5];
  const bool two = s[6] > 0.5f;
  const bool line = s[7] > 0.5f;

  uint32_t px[PX];
  const bool full = p0 + PX <= pixels;
  if (full && (pixels % PX) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(bg + p0);
    px[0] = v.x; px[1] = v.y; px[2] = v.z; px[3] = v.w;
  } else {
    for (int k = 0; k < PX; ++k) px[k] = p0 + k < pixels ? bg[p0 + k] : 0u;
  }

#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int p = p0 + k;
    if (p >= pixels) break;
    const int row = p / width;
    const float x = xs_row[p - row * width];
    const float y = ys_col[row];
    uint32_t color = px[k];
    bool yellow_hit;
    if (line)
      yellow_hit = fabsf(y - c.line_cy) <= c.line_half_h &&
                   fabsf(x - t0x) <= c.line_half_w;
    else
      yellow_hit = in_disk(x, y, t0x, t0y, c.target_r2);
    if (yellow_hit) color = c.yellow;
    if (two && !line && in_disk(x, y, t1x, t1y, c.target_r2)) color = c.red;
    const float ax = fabsf(x - rx);
    const float ay = fabsf(y - ry);
    if (ay <= c.half_w && ax <= c.half_l) color = c.body;
    if (fabsf(ay - c.half_w) <= c.wheel_hy && fabsf(ax - c.wheel_dx) <= c.wheel_hx)
      color = c.wheel;
    px[k] = color;
  }

  uint8_t* o = out + ((size_t)env * pixels + p0) * channels;
  if (channels == 3 && full && (pixels % PX) == 0) {
    // 4 pixels = 12 bytes = 3 aligned words (little endian, R first).
    uint32_t* w = reinterpret_cast<uint32_t*>(o);
    w[0] = (px[0] & 0xFFFFFFu) | (px[1] << 24);
    w[1] = ((px[1] >> 8) & 0xFFFFu) | (px[2] << 16);
    w[2] = ((px[2] >> 16) & 0xFFu) | (px[3] << 8);
  } else {
    for (int k = 0; k < PX && p0 + k < pixels; ++k) {
      uint8_t* q = o + (size_t)k * channels;
      q[0] = (uint8_t)(px[k] & 0xFFu);
      q[1] = (uint8_t)((px[k] >> 8) & 0xFFu);
      q[2] = (uint8_t)((px[k] >> 16) & 0xFFu);
    }
  }
}

}  // namespace

extern "C" int render2d_consts_words() { return sizeof(Consts) / 4; }

// scene   [n_env, 8] f32 (device)
// xs_row  [width] f32, ys_col [height] f32 (device)
// bg      [height, width] packed RGB u32 (device, 16-byte aligned)
// consts  host pointer to render2d_consts_words() 32-bit words
// out     [n_env, height, width, channels] uint8 (device); channels 0-2 written
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int render2d_launch(const float* scene, int n_env, const float* xs_row,
                               const float* ys_col, const uint32_t* bg, int height,
                               int width, const void* consts, uint8_t* out,
                               int channels, void* stream) {
  if (n_env < 1 || n_env > 65535 || height < 1 || width < 1 || channels < 3)
    return (int)cudaErrorInvalidValue;
  Consts c;
  memcpy(&c, consts, sizeof(Consts));
  const int pixels = height * width;
  const int groups = (pixels + PX - 1) / PX;
  dim3 grid((groups + THREADS - 1) / THREADS, n_env);
  render2d_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      scene, xs_row, ys_col, bg, height, width, c, out, channels);
  return (int)cudaGetLastError();
}
