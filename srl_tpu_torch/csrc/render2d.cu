// MobileRobot sprite compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel srl_tpu/ops/pallas_render.py (_kernel, the body
// launched by pl.pallas_call in _render_batch). For every env and pixel it
// starts from the precomputed checker-and-walls background and paints, in
// order: the yellow target disk (r 0.25) or the yellow line band, the red
// second target, the robot body box and its four wheel pads. It stores uint8
// NHWC at channel offset 0 with a channel stride of 3 (or 6 when the
// first-person view fills channels 3-5).
//
// What bounds it on this card: the bytes it writes. Each output pixel costs
// 3 bytes and about 15 float32 operations, far under the card's operation
// bound; the inputs (background, coordinate vectors, scene rows, 0.2 MB in
// all) are shared by every env and stay in L2.
// What the design does about it:
// - Each warp owns a span of 512 consecutive pixels of one env, 1,536 bytes
//   of output, and writes it as three 16-byte words per lane, consecutive
//   lanes on consecutive addresses, so every store fills whole 32-byte
//   sectors. A 224x224 image is 98 such spans, each 16-byte aligned. No
//   barrier spans more than one warp: the 4 warps of a block run apart.
// - Every load is issued before the first wait: the lane's three background
//   words, held as RGB bytes ([H, W, 3]) so that they are output words
//   already, the scene row as two 16-byte words, and the y of the span's
//   rows, found once per span and not per pixel.
// - Sprite culling per span: the span's rows are tested against each
//   sprite's row condition, the very sub-expression of the per-pixel test
//   (|y - cy| for the boxes and the band; dy * dy <= r * r for a disk, which
//   its fused sum can only exceed), so the culling changes no pixel. A span
//   that no sprite reaches stores its background words straight away.
// - Otherwise the warp stages its span in shared memory, each lane paints 16
//   consecutive pixels there (one division finds its row; per pixel only the
//   x tests of the sprites its row meets run), and the span leaves as
//   16-byte words.
// - The FPV layout (channel stride 6), a span whose output is not 16-byte
//   aligned and the bytes past the last whole word of a short span take
//   byte stores.
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

constexpr int WARP_PX = 512;                  // pixels per warp: 1,536 bytes out
constexpr int WORDS = WARP_PX * 3 / 16 / 32;  // 16-byte words per lane
constexpr int WARPS = 4;                      // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int PX = WARP_PX / 32;              // pixels painted per lane
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

// One env's sprites, from its scene row.
struct Sprites {
  float rx, ry, t0x, t0y, t1x, t1y;
  bool two, line;
};

// Which sprites a row at height y can reach: the y half of every per-pixel
// test below.
struct RowHits {
  bool yellow, red, body, wheel;
};

__device__ __forceinline__ RowHits row_hits(const Sprites& s, const Consts& c, float y) {
  const float dy0 = y - s.t0y, dy1 = y - s.t1y;
  const float ay = fabsf(y - s.ry);
  RowHits h;
  h.yellow = s.line ? fabsf(y - c.line_cy) <= c.line_half_h
                    : __fmul_rn(dy0, dy0) <= c.target_r2;
  h.red = s.two && !s.line && __fmul_rn(dy1, dy1) <= c.target_r2;
  h.body = ay <= c.half_w;
  h.wheel = fabsf(ay - c.half_w) <= c.wheel_hy;
  return h;
}

__device__ __forceinline__ bool in_disk(float x, float y, float cx, float cy, float r2) {
  const float dx = x - cx;
  const float dy = y - cy;
  return __fmaf_rn(dx, dx, __fmul_rn(dy, dy)) <= r2;
}

constexpr uint32_t NONE = 0xFFFFFFFFu;  // no sprite: a packed colour has byte 3 = 0

// The sprite colour at (x, y) of a row that meets the sprites h, or NONE.
__device__ __forceinline__ uint32_t paint(const Sprites& s, const Consts& c,
                                          const RowHits& h, float x, float y) {
  uint32_t color = NONE;
  if (h.yellow && (s.line ? fabsf(x - s.t0x) <= c.line_half_w
                          : in_disk(x, y, s.t0x, s.t0y, c.target_r2)))
    color = c.yellow;
  if (h.red && in_disk(x, y, s.t1x, s.t1y, c.target_r2)) color = c.red;
  const float ax = fabsf(x - s.rx);
  if (h.body && ax <= c.half_l) color = c.body;
  if (h.wheel && fabsf(ax - c.wheel_dx) <= c.wheel_hx) color = c.wheel;
  return color;
}

__global__ void __launch_bounds__(THREADS)
render2d_kernel(const float* __restrict__ scene, const float* __restrict__ xs_row,
                const float* __restrict__ ys_col, const uint8_t* __restrict__ bg_rgb,
                int height, int width, const Consts c, uint8_t* __restrict__ out,
                int channels) {
  __shared__ __align__(16) uint8_t stages[WARPS][WARP_PX * 3];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int env = blockIdx.y;
  const int pixels = height * width;
  const int p0 = (blockIdx.x * WARPS + warp) * WARP_PX;
  if (p0 >= pixels) return;  // no barrier below spans more than one warp
  const int n = min(WARP_PX, pixels - p0);
  const int n_bytes = 3 * n;
  const uint8_t* src = bg_rgb + (size_t)p0 * 3;
  uint8_t* dst = out + ((size_t)env * pixels + p0) * channels;
  const bool src_al = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const bool dst_al = channels == 3 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  // Word k of this lane: bytes [16 (lane + 32 k), +16) of the warp's span.
  auto whole = [&](int k) { return 16 * (lane + 32 * k) + 16 <= n_bytes; };

  // Every load is issued before the first wait: the background words, the
  // scene row and the y of the span's rows (found once, per warp).
  uint4 bg_word[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k)
    if (src_al && whole(k))
      bg_word[k] = reinterpret_cast<const uint4*>(src)[lane + 32 * k];
  const float4 s0 = reinterpret_cast<const float4*>(scene)[2 * env];
  const float4 s1 = reinterpret_cast<const float4*>(scene)[2 * env + 1];
  const Sprites s = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z > 0.5f, s1.w > 0.5f};
  const int r0 = p0 / width, c0 = p0 - r0 * width;
  const int r1 = (p0 + n - 1) / width;
  bool any = false;
  for (int r = r0 + lane; r <= r1; r += 32) {
    const RowHits h = row_hits(s, c, ys_col[r]);
    any |= h.yellow || h.red || h.body || h.wheel;
  }
  const bool busy = __any_sync(0xffffffffu, any);

  // A span that no sprite reaches: the background goes straight out.
  if (!busy && channels == 3) {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      const int b = 16 * (lane + 32 * k);
      if (src_al && dst_al && whole(k))
        reinterpret_cast<uint4*>(dst)[lane + 32 * k] = bg_word[k];
      else
        for (int i = b; i < min(b + 16, n_bytes); ++i) dst[i] = src[i];
    }
    return;
  }

  // Otherwise through shared memory: the background, the sprites, then out.
  uint8_t* stage = stages[warp];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int b = 16 * (lane + 32 * k);
    if (src_al && whole(k))
      reinterpret_cast<uint4*>(stage)[lane + 32 * k] = bg_word[k];
    else
      for (int i = b; i < min(b + 16, n_bytes); ++i) stage[i] = src[i];
  }
  __syncwarp();

  if (busy) {
    const int q0 = lane * PX;
    if (q0 < n) {
      const int j = c0 + q0;
      int r = r0 + j / width, col = j - (r - r0) * width;
      float y = ys_col[r];
      RowHits h = row_hits(s, c, y);
      for (int k = 0; k < PX && q0 + k < n; ++k) {
        if (col == width) {
          col = 0;
          y = ys_col[++r];
          h = row_hits(s, c, y);
        }
        if (h.yellow || h.red || h.body || h.wheel) {
          const uint32_t color = paint(s, c, h, xs_row[col], y);
          if (color != NONE) {
            uint8_t* q = stage + 3 * (q0 + k);
            q[0] = (uint8_t)(color & 0xFFu);
            q[1] = (uint8_t)((color >> 8) & 0xFFu);
            q[2] = (uint8_t)((color >> 16) & 0xFFu);
          }
        }
        ++col;
      }
    }
    __syncwarp();
  }

  if (channels == 3) {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      const int b = 16 * (lane + 32 * k);
      if (dst_al && whole(k))
        reinterpret_cast<uint4*>(dst)[lane + 32 * k] =
            reinterpret_cast<const uint4*>(stage)[lane + 32 * k];
      else
        for (int i = b; i < min(b + 16, n_bytes); ++i) dst[i] = stage[i];
    }
  } else {
    for (int q = lane; q < n; q += 32) {
      uint8_t* o = dst + (size_t)q * channels;
      o[0] = stage[3 * q];
      o[1] = stage[3 * q + 1];
      o[2] = stage[3 * q + 2];
    }
  }
}

}  // namespace

extern "C" int render2d_consts_words() { return sizeof(Consts) / 4; }

// scene   [n_env, 8] f32 (device)
// xs_row  [width] f32, ys_col [height] f32 (device)
// bg_rgb  [height, width, 3] uint8 background (device, 16-byte aligned)
// consts  host pointer to render2d_consts_words() 32-bit words
// out     [n_env, height, width, channels] uint8 (device); channels 0-2 written
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int render2d_launch(const float* scene, int n_env, const float* xs_row,
                               const float* ys_col, const uint8_t* bg_rgb, int height,
                               int width, const void* consts, uint8_t* out, int channels,
                               void* stream) {
  if (n_env < 1 || n_env > 65535 || height < 1 || width < 1 || channels < 3)
    return (int)cudaErrorInvalidValue;
  Consts c;
  memcpy(&c, consts, sizeof(Consts));
  const int pixels = height * width;
  dim3 grid((pixels + WARPS * WARP_PX - 1) / (WARPS * WARP_PX), n_env);
  render2d_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      scene, xs_row, ys_col, bg_rgb, height, width, c, out, channels);
  return (int)cudaGetLastError();
}
