// Ray-traced Kuka renderer for Hopper (sm_90a).
//
// Replaces the TPU kernel srl_tpu/ops/pallas_render3d.py (_make_kernel, the
// body launched by pl.pallas_call in _render_batch). For every env and every
// traced pixel it composites, by minimum depth, the camera-static background
// (sky, floor, table) with the per-env primitives: per button a base cylinder
// and a cap; 9 capsule bodies and 10 joint spheres along the arm; with
// distractors, 10 spheres and a ball. It then shades the winner once
// (Lambertian, 0.45 + 0.55 * n.L) and stores uint8 NHWC.
//
// What bounds it. The arm and the buttons cover a few percent of a frame:
// on the main path's scene (112x112, 256 envs) the culling rectangles keep
// about 0.35 primitives per pixel, against the 21 that every pixel traced
// without culling, and about a quarter of the 4x8-pixel sub-tiles hold any
// primitive. What is left is latency: the chains of each busy sub-tile (its
// loads, then per primitive a square root and an IEEE division, each a
// multi-instruction sequence through the 16-per-clock MUFU pipe), which
// gather in the few bands that hold the arm and the buttons, and the fixed
// work of every block (the background copy, the prologue, three barriers).
// On an H100 at 700 W (chip_smoke.py) that is about 10% of the byte bound.
//
// What the design does about it.
// - A block (4 warps) owns a band of 8 traced rows of one env, every view.
// - It first copies the band's background colours, shaded on the host as
//   the twin shades them (render3d.py, _background_rgb), to the output: one
//   straight run of 16-byte words when there is one view and no upsample.
//   No later step waits on that copy, and a pixel that no primitive wins
//   keeps it.
// - Prologue: one thread per (view, primitive) writes to shared memory the
//   primitive's per-env terms (cylinder offsets from the eye and the constant
//   of its quadratic; capsule ba, 1/|ba|^2, oa, oa.ba and the constant part
//   of cc; sphere offsets and constant) and one conservative pixel rectangle:
//   for a sphere, the exact interval of u/w (rows) and x/w (columns) over
//   its camera-space box, as in the reference's rows_overlap, with a slack
//   of one row and column and its near guard; a button cylinder takes the
//   sphere around its z extent, a capsule body the union of the rectangles
//   of its two joint spheres (each at least as wide as the body).
// - Each primitive marks, with shared-memory atomics, the 4x8-pixel
//   sub-tiles that its rectangle meets; one warp lists the sub-tiles with a
//   mark, and the block's warps take them in turn, a lane per pixel, tracing
//   only the marked primitives in the unculled order. A culled primitive
//   would have missed every pixel of the sub-tile, so the output is
//   bit-equal to the unculled launch (the ``cull`` argument, for checks).
// - Only sub-tiles with work read the ray and the background depth. The
//   per-pixel terms of the button cylinders (a = dx^2 + dy^2, 2 safe(a), the
//   two cap-plane hits and their xy points) come from planes precomputed per
//   view on the host with the twin's roundings (_button_planes), read only
//   where a cylinder is traced: a lane then needs no loop over envs, and
//   those terms equal the twin's bit for bit.
// - A warp skips a primitive's square root and division when none of its
//   rays meets the quadric; normals, with their divisions by the radius, are
//   computed only for a primitive that wins the depth test.
// - A pixel that a primitive wins is written straight to the output, with
//   the nearest upsample and the two-view interleave.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see srl_tpu_torch/ops/cuda_build.py). No fast
// math: IEEE sqrt and division keep silhouettes close to the PyTorch twin
// (srl_tpu_torch/ops/render3d.py, render_kuka_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e9f;
constexpr int MAX_SCENE = 128;
constexpr int MAX_VIEWS = 2;
constexpr int MAX_PRIMS = 64;
constexpr int MAX_WIDTH = 224;
constexpr int BAND = 8;                  // traced rows per block
constexpr int TILE_W = 4, TILE_H = 8;    // a warp's sub-tile: 4 columns, 8 rows
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int PRIM_FLOATS = 16;
constexpr int N_PLANES = 8;              // per-pixel button planes
constexpr int MAX_TILES = (BAND / TILE_H) * ((MAX_WIDTH + TILE_W - 1) / TILE_W);

// One camera. Filled on the host by render3d.py (_view_consts).
struct View {
  float eye[3];
  float fwd[3], right[3], up[3];
  float tan_h, tan_w;  // tan(fov / 2), tan(fov / 2) * width / height
};

// Scalars shared by every pixel. Filled on the host by render3d.py
// (_kernel_consts) in exactly this field order; every field is a float.
struct Consts {
  float light[3];
  float z_table, base_top, cap_top;
  float base_r, base_r2, cap_r, cap_r2;
  float link_r, link_r2, link_inv_r, last_r, last_r2, last_inv_r;
  float dist_r, dist_r2, dist_inv_r, ball_r, ball_r2, ball_inv_r;
  // bounding spheres of the base and cap cylinders: centre height, radius
  float base_zmid, base_bound, cap_zmid, cap_bound;
  // green, yellow cap, teal cap, orange, silver, distractor, ball
  float color[7][3];
  View view[MAX_VIEWS];
};

enum { GREEN = 0, YELLOW, TEAL, ORANGE, SILVER, DISTRACTOR, BALL };

// The winner so far: depth, normal, colour index (-1: the background).
struct Hit {
  float t, nx, ny, nz;
  int color;
};

__device__ __forceinline__ float safe(float d) {
  return fabsf(d) < 1e-8f ? 1e-8f : d;
}

__device__ __forceinline__ int to_row(float x, int n) {
  return (int)fminf(fmaxf(x, -1.0f), (float)n);
}

// The exact interval of a / w over a in [a_lo, a_hi], w in [w_lo, w_hi] > 0:
// the least of the four corner ratios has a_lo over the larger w when a_lo
// >= 0 and over the smaller one when not (rounded division is monotone, so
// the rounded values are the least and largest rounded ratios, too).
__device__ __forceinline__ void ratio_interval(float a_lo, float a_hi, float w_lo,
                                               float w_hi, float& lo, float& hi) {
  lo = a_lo / (a_lo >= 0.0f ? w_hi : w_lo);
  hi = a_hi / (a_hi >= 0.0f ? w_lo : w_hi);
}

// Rows and columns (inclusive, clamped to [-1, n]) whose pixel rays can meet
// the sphere (centre c, radius rad): the projection of its camera-space box,
// one row and column of slack; the whole image when the sphere reaches
// within 0.05 of the eye plane.
__device__ int4 cull_rect(const View& w, float cx, float cy, float cz, float rad,
                          int h, int wd) {
  const float wx = cx - w.eye[0], wy = cy - w.eye[1], wz = cz - w.eye[2];
  const float depth = wx * w.fwd[0] + wy * w.fwd[1] + wz * w.fwd[2];
  const float uc = wx * w.up[0] + wy * w.up[1] + wz * w.up[2];
  const float xc = wx * w.right[0] + wy * w.right[1] + wz * w.right[2];
  if (depth <= rad + 0.05f) return make_int4(0, h - 1, 0, wd - 1);
  const float w_lo = depth - rad, w_hi = depth + rad;
  float v0, v1, u0, u1;
  ratio_interval(uc - rad, uc + rad, w_lo * w.tan_h, w_hi * w.tan_h, v0, v1);
  ratio_interval(xc - rad, xc + rad, w_lo * w.tan_w, w_hi * w.tan_w, u0, u1);
  const float half_h = 0.5f * (float)h, half_w = 0.5f * (float)wd;
  return make_int4(to_row(ceilf((1.0f - v1) * half_h - 1.5f), h),
                   to_row(floorf((1.0f - v0) * half_h + 0.5f), h),
                   to_row(ceilf((u0 + 1.0f) * half_w - 1.5f), wd),
                   to_row(floorf((u1 + 1.0f) * half_w + 0.5f), wd));
}

// Prologue: primitive p of view v, its per-env terms into d[PRIM_FLOATS].
// Primitive order is the composite order: per button its base and cap, the
// capsule bodies, the joint spheres, the distractors and the ball. Returns
// whether the primitive's rectangle is that of one sphere, ``sph`` (centre,
// radius): a cylinder's bounding sphere or the sphere itself; a capsule
// body's is the union of its two joint spheres' rectangles.
__device__ bool setup_prim(const Consts& c, const float* sc, int v, int p, int n_buttons,
                           int n_pts, int n_distract, float* d, float4& sph) {
  const View& w = c.view[v];
  const float ex = w.eye[0], ey = w.eye[1], ez = w.eye[2];
  const int n_cyl = 2 * n_buttons, n_seg = n_pts - 1;
  int color;
  if (p < n_cyl) {
    // Vertical capped cylinder: ox, oy, c, centre xy, radius, r2, z range.
    const int i = p >> 1;
    const bool cap = p & 1;
    const float* btn = sc + 3 * n_pts + 2 * i;
    const float r2 = cap ? c.cap_r2 : c.base_r2;
    const float ox = ex - btn[0], oy = ey - btn[1];
    d[0] = ox;
    d[1] = oy;
    d[2] = ox * ox + oy * oy - r2;
    d[3] = btn[0];
    d[4] = btn[1];
    d[5] = cap ? c.cap_r : c.base_r;
    d[6] = r2;
    d[7] = cap ? c.base_top : c.z_table;
    d[8] = cap ? c.cap_top : c.base_top;
    sph = make_float4(btn[0], btn[1], cap ? c.cap_zmid : c.base_zmid,
                      cap ? c.cap_bound : c.base_bound);
    color = cap ? (i < 1 ? YELLOW : TEAL) : GREEN;
  } else if (p < n_cyl + n_seg) {
    // Capsule body from a to b: a, ba, oa, 1/|ba|^2, oa.ba, cc, 1/r. The
    // last body is the thinner gripper.
    const int i = p - n_cyl;
    const bool last = i == n_seg - 1;
    const float* pa = sc + 3 * i;
    const float ax = pa[0], ay = pa[1], az = pa[2];
    const float bax = pa[3] - ax, bay = pa[4] - ay, baz = pa[5] - az;
    const float inv_ba_len2 = 1.0f / (bax * bax + bay * bay + baz * baz + 1e-12f);
    const float oax = ex - ax, oay = ey - ay, oaz = ez - az;
    const float oa_dot_ba = oax * bax + oay * bay + oaz * baz;
    d[0] = ax;
    d[1] = ay;
    d[2] = az;
    d[3] = bax;
    d[4] = bay;
    d[5] = baz;
    d[6] = oax;
    d[7] = oay;
    d[8] = oaz;
    d[9] = inv_ba_len2;
    d[10] = oa_dot_ba;
    d[11] = oax * oax + oay * oay + oaz * oaz - oa_dot_ba * oa_dot_ba * inv_ba_len2 -
            (last ? c.last_r2 : c.link_r2);
    d[12] = last ? c.last_inv_r : c.link_inv_r;
    d[PRIM_FLOATS - 1] = __int_as_float(i % 2 == 0 ? ORANGE : SILVER);
    return false;
  } else {
    // Sphere: centre, oc, c, 1/r. Joint sphere i takes the colour of
    // segment max(i - 1, 0); the last joint sphere is the thinner gripper.
    const int i = p - n_cyl - n_seg;
    const float* s;
    float r, r2, inv_r;
    if (i < n_pts) {
      const bool last = i == n_pts - 1;
      s = sc + 3 * i;
      r = last ? c.last_r : c.link_r;
      r2 = last ? c.last_r2 : c.link_r2;
      inv_r = last ? c.last_inv_r : c.link_inv_r;
      color = (i > 0 ? i - 1 : 0) % 2 == 0 ? ORANGE : SILVER;
    } else {
      const bool ball = i == n_pts + n_distract;
      s = sc + 3 * n_pts + 2 * n_buttons + 3 * (i - n_pts);
      r = ball ? c.ball_r : c.dist_r;
      r2 = ball ? c.ball_r2 : c.dist_r2;
      inv_r = ball ? c.ball_inv_r : c.dist_inv_r;
      color = ball ? BALL : DISTRACTOR;
    }
    const float ocx = ex - s[0], ocy = ey - s[1], ocz = ez - s[2];
    d[0] = s[0];
    d[1] = s[1];
    d[2] = s[2];
    d[3] = ocx;
    d[4] = ocy;
    d[5] = ocz;
    d[6] = ocx * ocx + ocy * ocy + ocz * ocz - r2;
    d[7] = inv_r;
    sph = make_float4(s[0], s[1], s[2], r);
  }
  d[PRIM_FLOATS - 1] = __int_as_float(color);
  return true;
}

// Vertical capped cylinder (side wall + top disk). ``a`` and ``a2`` = 2
// safe(a) are per pixel; t_cap and (hx, hy) are the hit of the ray with the
// cap's plane and its xy point.
__device__ __forceinline__ void vcylinder(Hit& s, const float* d, float dx, float dy,
                                          float dz, float ez, float a, float a2,
                                          float t_cap, float hx, float hy) {
  const float ox = d[0], oy = d[1];
  const float bq = 2.0f * (ox * dx + oy * dy);
  const float disc = bq * bq - 4.0f * a * d[2];
  // The square root and division only where the side can be hit: a warp
  // none of whose rays meets the side skips them.
  float t_side = BIG;
  if (disc > 0.0f) {
    const float t = (-bq - sqrtf(disc)) / a2;
    const float z_at = ez + t * dz;
    if (t > 1e-4f && z_at >= d[7] && z_at <= d[8]) t_side = t;
  }

  const float px = hx - d[3];
  const float py = hy - d[4];
  t_cap = (px * px + py * py) <= d[6] ? t_cap : BIG;

  if (t_cap < t_side) {
    if (t_cap < s.t) {
      s.t = t_cap;
      s.nx = 0.0f;
      s.ny = 0.0f;
      s.nz = 1.0f;
      s.color = __float_as_int(d[PRIM_FLOATS - 1]);
    }
  } else if (t_side < s.t) {
    s.t = t_side;
    s.nx = (ox + t_side * dx) / d[5];
    s.ny = (oy + t_side * dy) / d[5];
    s.nz = 0.0f;
    s.color = __float_as_int(d[PRIM_FLOATS - 1]);
  }
}

// The cylindrical body of a capsule (its end spheres are the shared joint
// spheres).
__device__ __forceinline__ void capsule_body(Hit& s, const float* d, float ex, float ey,
                                             float ez, float dx, float dy, float dz) {
  const float bax = d[3], bay = d[4], baz = d[5];
  const float inv_ba_len2 = d[9], oa_dot_ba = d[10];
  const float d_dot_ba = dx * bax + dy * bay + dz * baz;
  const float aa = 1.0f - d_dot_ba * d_dot_ba * inv_ba_len2;
  const float bbq = 2.0f * ((dx * d[6] + dy * d[7] + dz * d[8]) -
                            d_dot_ba * oa_dot_ba * inv_ba_len2);
  const float disc = bbq * bbq - 4.0f * aa * d[11];
  if (!(disc > 0.0f)) return;
  const float t = (-bbq - sqrtf(disc)) / (2.0f * safe(aa));
  const float sp = (oa_dot_ba + t * d_dot_ba) * inv_ba_len2;
  if (!(t > 1e-4f && sp >= 0.0f && sp <= 1.0f) || !(t < s.t)) return;
  const float inv_r = d[12];
  s.t = t;
  s.nx = (ex + t * dx - (d[0] + sp * bax)) * inv_r;
  s.ny = (ey + t * dy - (d[1] + sp * bay)) * inv_r;
  s.nz = (ez + t * dz - (d[2] + sp * baz)) * inv_r;
  s.color = __float_as_int(d[PRIM_FLOATS - 1]);
}

__device__ __forceinline__ void sphere(Hit& s, const float* d, float ex, float ey,
                                       float ez, float dx, float dy, float dz) {
  const float bq = 2.0f * (dx * d[3] + dy * d[4] + dz * d[5]);
  const float disc = bq * bq - 4.0f * d[6];
  if (!(disc > 0.0f)) return;
  const float t = (-bq - sqrtf(disc)) * 0.5f;
  if (!(t > 1e-4f) || !(t < s.t)) return;
  const float inv_r = d[7];
  s.t = t;
  s.nx = (ex + t * dx - d[0]) * inv_r;
  s.ny = (ey + t * dy - d[1]) * inv_r;
  s.nz = (ez + t * dz - d[2]) * inv_r;
  s.color = __float_as_int(d[PRIM_FLOATS - 1]);
}

__device__ __forceinline__ uint32_t to_u8(float x) {
  return (uint32_t)(int)fminf(fmaxf(x, 0.0f), 255.0f);
}

constexpr uint32_t NONE = 0xFFFFFFFFu;  // no winner: a packed colour has byte 3 = 0

// Trace one pixel against the primitives in ``mask``: packed RGB (R in byte
// 0) of the winner, or NONE when the background stays in front.
__device__ uint32_t trace(const Consts& c, const View& w, const float (*prim)[PRIM_FLOATS],
                          uint64_t mask, uint64_t cyl_bits, uint64_t body_bits,
                          const float* rays, const float* bg, const float* planes, int P,
                          int p) {
  const float ex = w.eye[0], ey = w.eye[1], ez = w.eye[2];
  const float dx = rays[p], dy = rays[P + p], dz = rays[2 * P + p];
  Hit s = {bg[p], 0.0f, 0.0f, 0.0f, -1};

  uint64_t m = mask & cyl_bits;
  if (m) {
    const float a = planes[p], a2 = planes[P + p];
    const float t_base = planes[2 * P + p], hx_base = planes[3 * P + p],
                hy_base = planes[4 * P + p];
    const float t_top = planes[5 * P + p], hx_top = planes[6 * P + p],
                hy_top = planes[7 * P + p];
    do {
      const int k = __ffsll((long long)m) - 1;
      m &= m - 1;
      // Even k: a base, whose top is the base_top plane; odd k: a cap.
      if (k & 1)
        vcylinder(s, prim[k], dx, dy, dz, ez, a, a2, t_top, hx_top, hy_top);
      else
        vcylinder(s, prim[k], dx, dy, dz, ez, a, a2, t_base, hx_base, hy_base);
    } while (m);
  }
  for (m = mask & body_bits; m; m &= m - 1)
    capsule_body(s, prim[__ffsll((long long)m) - 1], ex, ey, ez, dx, dy, dz);
  for (m = mask & ~(cyl_bits | body_bits); m; m &= m - 1)
    sphere(s, prim[__ffsll((long long)m) - 1], ex, ey, ez, dx, dy, dz);

  if (s.color < 0) return NONE;
  // Deferred Lambertian shade of the winner; +0.5, clip, truncate.
  float lam = s.nx * c.light[0] + s.ny * c.light[1] + s.nz * c.light[2];
  lam = fminf(fmaxf(lam, 0.0f), 1.0f);
  const float sh = 0.45f + 0.55f * lam;
  const float* col = c.color[s.color];
  return to_u8(sh * col[0] * 255.0f + 0.5f) | (to_u8(sh * col[1] * 255.0f + 0.5f) << 8) |
         (to_u8(sh * col[2] * 255.0f + 0.5f) << 16);
}

// n bytes from src to dst by the block: 16-byte words when both are
// 16-byte aligned, consecutive threads on consecutive words.
__device__ __forceinline__ void copy_bytes(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ src, int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    done = n & ~15;
    for (int i = threadIdx.x; i < done / 16; i += THREADS)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
  for (int i = done + threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
}

__global__ void __launch_bounds__(THREADS)
render3d_kernel(const float* __restrict__ scene, int scene_stride,
                const float* __restrict__ rays, const float* __restrict__ bg,
                const uint8_t* __restrict__ bg_rgb, const float* __restrict__ planes,
                const __grid_constant__ Consts c, int n_buttons, int n_pts, int n_distract,
                int trace_h, int trace_w, int up, int n_views, int cull,
                uint8_t* __restrict__ out) {
  __shared__ float sc[MAX_SCENE];
  __shared__ __align__(16) float prim[MAX_VIEWS][MAX_PRIMS][PRIM_FLOATS];
  __shared__ int4 rect[MAX_VIEWS][MAX_PRIMS];
  __shared__ unsigned long long tile_mask[MAX_VIEWS * MAX_TILES];  // primitives per sub-tile
  __shared__ short work[MAX_VIEWS * MAX_TILES];  // the (view, sub-tile)s with a primitive
  __shared__ int n_work;

  const int env = blockIdx.y;
  const int row0 = blockIdx.x * BAND;
  const int rows = min(BAND, trace_h - row0);
  const int P = trace_h * trace_w;
  const int n_cyl = 2 * n_buttons, n_seg = n_pts - 1;
  const int n_prim = n_cyl + n_seg + n_pts + (n_distract > 0 ? n_distract + 1 : 0);
  const int tiles_x = (trace_w + TILE_W - 1) / TILE_W;
  const int n_tiles = tiles_x * ((rows + TILE_H - 1) / TILE_H);
  const uint64_t all = n_prim == 64 ? ~0ull : (1ull << n_prim) - 1;
  const int w_out = trace_w * up, ch = 3 * n_views;
  uint8_t* band_out = out + ((size_t)env * trace_h + row0) * up * w_out * ch;

  // The band's background colours go to the output first, and no later
  // step waits on them: a straight 16-byte copy when the layouts agree,
  // else per output pixel, with the upsample and the views interleaved.
  if (up == 1 && n_views == 1) {
    copy_bytes(band_out, bg_rgb + (size_t)row0 * trace_w * 3, 3 * rows * trace_w);
  } else {
    for (int q = threadIdx.x; q < rows * up * w_out; q += THREADS) {
      const int ro = q / w_out, co = q - ro * w_out;
      const size_t pix = (size_t)(row0 + ro / up) * trace_w + co / up;
      for (int v = 0; v < n_views; ++v)
        for (int k = 0; k < 3; ++k)
          band_out[(size_t)q * ch + 3 * v + k] = bg_rgb[((size_t)v * P + pix) * 3 + k];
    }
  }
  for (int k = threadIdx.x; k < scene_stride; k += THREADS)
    sc[k] = scene[(size_t)env * scene_stride + k];
  for (int i = threadIdx.x; i < n_views * n_tiles; i += THREADS) tile_mask[i] = cull ? 0 : all;
  __syncthreads();

  // Marks primitive p of view v in every sub-tile of the band that its
  // rectangle meets.
  auto mark = [&](int v, int p, int4 r) {
    if (r.y < row0 || r.x > row0 + rows - 1 || r.w < 0 || r.z > trace_w - 1) return;
    const int ty0 = (max(r.x, row0) - row0) / TILE_H, ty1 = min(r.y - row0, rows - 1) / TILE_H;
    const int tx0 = max(r.z, 0) / TILE_W, tx1 = min(r.w, trace_w - 1) / TILE_W;
    for (int ty = ty0; ty <= ty1; ++ty)
      for (int tx = tx0; tx <= tx1; ++tx)
        atomicOr(&tile_mask[v * n_tiles + ty * tiles_x + tx], 1ull << p);
  };
  for (int i = threadIdx.x; i < n_views * n_prim; i += THREADS) {
    const int v = i / n_prim, p = i - v * n_prim;
    float4 sph;
    if (setup_prim(c, sc, v, p, n_buttons, n_pts, n_distract, prim[v][p], sph)) {
      rect[v][p] = cull_rect(c.view[v], sph.x, sph.y, sph.z, sph.w, trace_h, trace_w);
      if (cull) mark(v, p, rect[v][p]);
    }
  }
  __syncthreads();
  // A capsule body lies in the convex hull of its two joint spheres (each at
  // least its radius), which the camera maps onto the hull of their images:
  // the union of their rectangles.
  for (int i = threadIdx.x; i < n_views * n_seg; i += THREADS) {
    const int v = i / n_seg, k = i - v * n_seg;
    const int4 a = rect[v][n_cyl + n_seg + k], b = rect[v][n_cyl + n_seg + k + 1];
    const int4 r = make_int4(min(a.x, b.x), max(a.y, b.y), min(a.z, b.z), max(a.w, b.w));
    rect[v][n_cyl + k] = r;
    if (cull) mark(v, n_cyl + k, r);
  }
  __syncthreads();

  // The work list: every (view, sub-tile) with a primitive, in order.
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < n_views * n_tiles; base += 32) {
      const int i = base + lane;
      const bool busy = i < n_views * n_tiles && tile_mask[i] != 0;
      const unsigned b = __ballot_sync(0xffffffffu, busy);
      if (busy) work[count + __popc(b & ((1u << lane) - 1))] = (short)i;
      count += __popc(b);
    }
    if (lane == 0) n_work = count;
  }
  __syncthreads();

  // Warps take the list's sub-tiles in turn: a lane per pixel traces the
  // sub-tile's primitives and writes the pixels a primitive wins.
  const uint64_t cyl_bits = (1ull << n_cyl) - 1;
  const uint64_t body_bits = ((1ull << n_seg) - 1) << n_cyl;
  for (int k = warp; k < n_work; k += WARPS) {
    const int i = work[k];
    const int v = i / n_tiles, tile = i - v * n_tiles;
    const int ty = tile / tiles_x;
    const int row = row0 + ty * TILE_H + lane / TILE_W;
    const int col = (tile - ty * tiles_x) * TILE_W + lane % TILE_W;
    const bool inside = row < row0 + rows && col < trace_w;
    const uint32_t rgb = trace(c, c.view[v], prim[v], tile_mask[i], cyl_bits, body_bits,
                               rays + (size_t)v * 3 * P, bg + (size_t)v * 7 * P,
                               planes + (size_t)v * N_PLANES * P, P,
                               inside ? row * trace_w + col : 0);
    if (!inside || rgb == NONE) continue;
    for (int a = 0; a < up; ++a)
      for (int b = 0; b < up; ++b) {
        uint8_t* o = band_out + ((size_t)((row - row0) * up + a) * w_out + col * up + b) * ch +
                     3 * v;
        o[0] = (uint8_t)(rgb & 0xFFu);
        o[1] = (uint8_t)((rgb >> 8) & 0xFFu);
        o[2] = (uint8_t)((rgb >> 16) & 0xFFu);
      }
  }
}

}  // namespace

extern "C" int render3d_consts_floats() { return sizeof(Consts) / sizeof(float); }

// scene   [n_env, scene_stride] f32 (device)
// rays    [n_views, 3, trace_h * trace_w] f32 (device)
// bg      [n_views, 7, trace_h * trace_w] f32 (device; plane 0, the depth, is read)
// bg_rgb  [n_views, trace_h * trace_w, 3] uint8 background colours (device)
// planes  [n_views, 8, trace_h * trace_w] f32 per-pixel button terms (device)
// consts  host pointer to render3d_consts_floats() floats
// cull    0 traces every primitive at every pixel (for checks), else culls
// out     [n_env, trace_h * up, trace_w * up, 3 * n_views] uint8 (device)
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int render3d_launch(const float* scene, int n_env, int scene_stride,
                               const float* rays, const float* bg, const uint8_t* bg_rgb,
                               const float* planes, const float* consts, int n_buttons,
                               int n_pts, int n_distract, int trace_h, int trace_w, int up,
                               int n_views, int cull, uint8_t* out, void* stream) {
  const int n_prim = 2 * n_buttons + 2 * n_pts - 1 + (n_distract > 0 ? n_distract + 1 : 0);
  if (scene_stride > MAX_SCENE || n_views > MAX_VIEWS || n_views < 1 || n_pts < 1 ||
      n_prim > MAX_PRIMS || trace_w > MAX_WIDTH || trace_h < 1 || trace_w < 1 || up < 1 ||
      n_env < 1 || n_env > 65535)
    return (int)cudaErrorInvalidValue;
  Consts c;
  const float* src = consts;
  float* dst = reinterpret_cast<float*>(&c);
  for (size_t k = 0; k < sizeof(Consts) / sizeof(float); ++k) dst[k] = src[k];
  dim3 grid((trace_h + BAND - 1) / BAND, n_env);
  render3d_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      scene, scene_stride, rays, bg, bg_rgb, planes, c, n_buttons, n_pts, n_distract,
      trace_h, trace_w, up, n_views, cull, out);
  return (int)cudaGetLastError();
}
