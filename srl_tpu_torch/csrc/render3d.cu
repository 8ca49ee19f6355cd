// Ray-traced Kuka renderer for Hopper (sm_90a).
//
// Replaces the TPU kernel srl_tpu/ops/pallas_render3d.py (_make_kernel, the
// body launched by pl.pallas_call in _render_batch). For every env and every
// traced pixel it composites, by minimum depth, the precomputed camera-static
// background (sky, floor, table: 7 planes of t, normal and albedo) with the
// per-env primitives: per button a base cylinder and a cap; 9 capsule bodies
// and 10 joint spheres along the arm; with distractors, 10 spheres and a
// ball. It then shades the winner once (Lambertian, 0.45 + 0.55 * n.L) and
// stores uint8 NHWC.
//
// What bounds it on this card: FP32 and SFU work. A pixel runs about 30
// quadratic intersections (each a square root and one or two IEEE
// divisions), while it reads 40 bytes of camera constants that every env
// shares (they stay in L2) and writes 3 bytes per output pixel.
// What the design does about it: one thread per traced pixel and no
// intermediate in device memory; the env's scene row (at most 67 floats)
// sits in shared memory, where every thread of the block reads the same
// word (a broadcast); the per-primitive scalar set-up is uniform across the
// block; the nearest upsample and the NHWC layout are fused into the store.
// The TPU kernel's 128-lane packed layout, VMEM scratch and row-interval
// culling do not come across: every primitive is traced for every pixel,
// so the work does not depend on the scene.
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
constexpr int THREADS = 256;

// Scalars shared by every pixel. Filled on the host by render3d.py
// (_kernel_consts) in exactly this field order; every field is a float.
struct Consts {
  float light[3];
  float z_table, base_top, cap_top;
  float base_r, base_r2, cap_r, cap_r2;
  float link_r2, link_inv_r, last_r2, last_inv_r;
  float dist_r2, dist_inv_r, ball_r2, ball_inv_r;
  // green, yellow cap, teal cap, orange, silver, distractor, ball
  float color[7][3];
  // per view: eye xyz, (base_top - eye_z), (cap_top - eye_z) in double
  // then rounded, as the reference computes them
  float view[MAX_VIEWS][5];
};

enum { GREEN = 0, YELLOW, TEAL, ORANGE, SILVER, DISTRACTOR, BALL };

struct Comp {
  float t, nx, ny, nz, r, g, b;
};

__device__ __forceinline__ void composite(Comp& s, float t, float nx, float ny,
                                          float nz, const float* col) {
  if (t < s.t) {
    s.t = t;
    s.nx = nx;
    s.ny = ny;
    s.nz = nz;
    s.r = col[0];
    s.g = col[1];
    s.b = col[2];
  }
}

__device__ __forceinline__ float safe(float d) {
  return fabsf(d) < 1e-8f ? 1e-8f : d;
}

// Vertical capped cylinder (side wall + top disk).
__device__ __forceinline__ void vcylinder(Comp& s, float ex, float ey, float ez,
                                          float dx, float dy, float dz,
                                          float cx, float cy, float radius,
                                          float r2, float z_lo, float z_hi,
                                          float cap_num, const float* col) {
  float ox = ex - cx;
  float oy = ey - cy;
  float a = dx * dx + dy * dy;
  float bq = 2.0f * (ox * dx + oy * dy);
  float c = ox * ox + oy * oy - r2;
  float disc = bq * bq - 4.0f * a * c;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t_side = (-bq - sq) / (2.0f * safe(a));
  float z_at = ez + t_side * dz;
  bool side_ok = disc > 0.0f && t_side > 1e-4f && z_at >= z_lo && z_at <= z_hi;
  t_side = side_ok ? t_side : BIG;

  float t_cap = cap_num / safe(dz);
  t_cap = t_cap > 1e-4f ? t_cap : BIG;
  float px = ex + t_cap * dx - cx;
  float py = ey + t_cap * dy - cy;
  t_cap = (px * px + py * py) <= r2 ? t_cap : BIG;

  if (t_cap < t_side) {
    composite(s, t_cap, 0.0f, 0.0f, 1.0f, col);
  } else {
    composite(s, t_side, (ox + t_side * dx) / radius, (oy + t_side * dy) / radius,
              0.0f, col);
  }
}

__device__ __forceinline__ void sphere(Comp& s, float ex, float ey, float ez,
                                       float dx, float dy, float dz, float sx,
                                       float sy, float sz, float r2, float inv_r,
                                       const float* col) {
  float ocx = ex - sx;
  float ocy = ey - sy;
  float ocz = ez - sz;
  float bq = 2.0f * (dx * ocx + dy * ocy + dz * ocz);
  float c = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  float disc = bq * bq - 4.0f * c;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t = (-bq - sq) * 0.5f;
  if (!(disc > 0.0f && t > 1e-4f)) return;  // t = BIG never wins
  composite(s, t, (ex + t * dx - sx) * inv_r, (ey + t * dy - sy) * inv_r,
            (ez + t * dz - sz) * inv_r, col);
}

// The cylindrical body of a capsule from a to b (its end spheres are the
// shared joint spheres).
__device__ __forceinline__ void capsule_body(Comp& s, float ex, float ey,
                                             float ez, float dx, float dy,
                                             float dz, const float* pa,
                                             const float* pb, float r2,
                                             float inv_r, const float* col) {
  float ax = pa[0], ay = pa[1], az = pa[2];
  float bax = pb[0] - ax, bay = pb[1] - ay, baz = pb[2] - az;
  float inv_ba_len2 = 1.0f / (bax * bax + bay * bay + baz * baz + 1e-12f);
  float oax = ex - ax, oay = ey - ay, oaz = ez - az;
  float d_dot_ba = dx * bax + dy * bay + dz * baz;
  float oa_dot_ba = oax * bax + oay * bay + oaz * baz;
  float aa = 1.0f - d_dot_ba * d_dot_ba * inv_ba_len2;
  float bbq = 2.0f * ((dx * oax + dy * oay + dz * oaz) -
                      d_dot_ba * oa_dot_ba * inv_ba_len2);
  float cc = oax * oax + oay * oay + oaz * oaz -
             oa_dot_ba * oa_dot_ba * inv_ba_len2 - r2;
  float disc = bbq * bbq - 4.0f * aa * cc;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t = (-bbq - sq) / (2.0f * safe(aa));
  float sp = (oa_dot_ba + t * d_dot_ba) * inv_ba_len2;
  if (!(disc > 0.0f && t > 1e-4f && sp >= 0.0f && sp <= 1.0f)) return;
  composite(s, t, (ex + t * dx - (ax + sp * bax)) * inv_r,
            (ey + t * dy - (ay + sp * bay)) * inv_r,
            (ez + t * dz - (az + sp * baz)) * inv_r, col);
}

__device__ __forceinline__ uint8_t to_u8(float x) {
  return (uint8_t)(int)fminf(fmaxf(x, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(THREADS)
render3d_kernel(const float* __restrict__ scene, int scene_stride,
                const float* __restrict__ rays, const float* __restrict__ bg,
                const Consts c, int n_buttons, int n_pts, int n_distract,
                int trace_h, int trace_w, int up, int n_views,
                uint8_t* __restrict__ out) {
  __shared__ float sc[MAX_SCENE];
  const int env = blockIdx.y;
  const int view = blockIdx.z;
  for (int k = threadIdx.x; k < scene_stride; k += blockDim.x)
    sc[k] = scene[(size_t)env * scene_stride + k];
  __syncthreads();

  const int P = trace_h * trace_w;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;

  const float* vr = rays + (size_t)view * 3 * P;
  const float dx = vr[p], dy = vr[P + p], dz = vr[2 * P + p];
  const float* vb = bg + (size_t)view * 7 * P;
  Comp s = {vb[p],         vb[P + p],     vb[2 * P + p], vb[3 * P + p],
            vb[4 * P + p], vb[5 * P + p], vb[6 * P + p]};
  const float* v = c.view[view];
  const float ex = v[0], ey = v[1], ez = v[2];

  // Buttons: base cylinder, then the cap ([yellow, teal][min(i, 1)]).
  const float* btn = sc + 3 * n_pts;
  for (int i = 0; i < n_buttons; ++i) {
    float bx = btn[2 * i], by = btn[2 * i + 1];
    vcylinder(s, ex, ey, ez, dx, dy, dz, bx, by, c.base_r, c.base_r2,
              c.z_table, c.base_top, v[3], c.color[GREEN]);
    vcylinder(s, ex, ey, ez, dx, dy, dz, bx, by, c.cap_r, c.cap_r2,
              c.base_top, c.cap_top, v[4], c.color[i < 1 ? YELLOW : TEAL]);
  }

  // Arm: capsule bodies, then one sphere per joint point. The last body and
  // the last sphere are the thinner gripper (r 0.035); joint sphere i takes
  // the colour of segment max(i - 1, 0).
  const int n_seg = n_pts - 1;
  for (int i = 0; i < n_seg; ++i) {
    bool last = i == n_seg - 1;
    capsule_body(s, ex, ey, ez, dx, dy, dz, sc + 3 * i, sc + 3 * i + 3,
                 last ? c.last_r2 : c.link_r2,
                 last ? c.last_inv_r : c.link_inv_r,
                 c.color[i % 2 == 0 ? ORANGE : SILVER]);
  }
  for (int i = 0; i < n_pts; ++i) {
    bool last = i == n_pts - 1;
    int seg = i > 0 ? i - 1 : 0;
    sphere(s, ex, ey, ez, dx, dy, dz, sc[3 * i], sc[3 * i + 1], sc[3 * i + 2],
           last ? c.last_r2 : c.link_r2, last ? c.last_inv_r : c.link_inv_r,
           c.color[seg % 2 == 0 ? ORANGE : SILVER]);
  }

  // Distractor spheres and the kicked ball.
  if (n_distract > 0) {
    const float* ds = btn + 2 * n_buttons;
    for (int i = 0; i < n_distract; ++i)
      sphere(s, ex, ey, ez, dx, dy, dz, ds[3 * i], ds[3 * i + 1], ds[3 * i + 2],
             c.dist_r2, c.dist_inv_r, c.color[DISTRACTOR]);
    const float* ball = ds + 3 * n_distract;
    sphere(s, ex, ey, ez, dx, dy, dz, ball[0], ball[1], ball[2], c.ball_r2,
           c.ball_inv_r, c.color[BALL]);
  }

  // Deferred Lambertian shade of the winner; +0.5, clip, truncate.
  float lam = s.nx * c.light[0] + s.ny * c.light[1] + s.nz * c.light[2];
  lam = fminf(fmaxf(lam, 0.0f), 1.0f);
  const float sh = 0.45f + 0.55f * lam;
  const uint8_t r8 = to_u8(sh * s.r * 255.0f + 0.5f);
  const uint8_t g8 = to_u8(sh * s.g * 255.0f + 0.5f);
  const uint8_t b8 = to_u8(sh * s.b * 255.0f + 0.5f);

  // NHWC store at channel offset 3 * view, with the up x up nearest
  // upsample fused.
  const int row = p / trace_w, col = p - (p / trace_w) * trace_w;
  const int w_out = trace_w * up, h_out = trace_h * up, ch = 3 * n_views;
  for (int i = 0; i < up; ++i) {
    size_t base = ((size_t)env * h_out + (size_t)row * up + i) * w_out;
    for (int j = 0; j < up; ++j) {
      uint8_t* o = out + (base + (size_t)col * up + j) * ch + 3 * view;
      o[0] = r8;
      o[1] = g8;
      o[2] = b8;
    }
  }
}

}  // namespace

extern "C" int render3d_consts_floats() { return sizeof(Consts) / sizeof(float); }

// scene  [n_env, scene_stride] f32 (device)
// rays   [n_views, 3, trace_h * trace_w] f32 (device)
// bg     [n_views, 7, trace_h * trace_w] f32 (device)
// consts host pointer to render3d_consts_floats() floats
// out    [n_env, trace_h * up, trace_w * up, 3 * n_views] uint8 (device)
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int render3d_launch(const float* scene, int n_env, int scene_stride,
                               const float* rays, const float* bg,
                               const float* consts, int n_buttons, int n_pts,
                               int n_distract, int trace_h, int trace_w, int up,
                               int n_views, uint8_t* out, void* stream) {
  if (scene_stride > MAX_SCENE || n_views > MAX_VIEWS || n_views < 1)
    return (int)cudaErrorInvalidValue;
  Consts c;
  const float* src = consts;
  float* dst = reinterpret_cast<float*>(&c);
  for (size_t k = 0; k < sizeof(Consts) / sizeof(float); ++k) dst[k] = src[k];
  const int P = trace_h * trace_w;
  dim3 grid((P + THREADS - 1) / THREADS, n_env, n_views);
  render3d_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      scene, scene_stride, rays, bg, c, n_buttons, n_pts, n_distract, trace_h,
      trace_w, up, n_views, out);
  return (int)cudaGetLastError();
}
