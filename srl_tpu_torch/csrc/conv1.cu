// conv1 of the Nature CNN for Hopper (sm_90a): the stem from camera frames
// to the first activations, and its weight gradient.
//
// Replaces no TPU kernel: the reference runs conv1 through XLA's
// convolution (srl_tpu/models/policies.py, _Conv1 and NatureCnnTorso). It
// replaces cuDNN's generic engine, which takes conv1 (3 input channels, so
// no tensor-core engine) and pads its input in a separate pass.
//
// conv1_fprop: out = act(conv(x / 255, w) + b), x NHWC [N, H, W, C] uint8
// (float32 also taken), w [32, C, k, k] and b [32] float32, out bf16 NHWC
// [N, Ho, Wo, 32]; k x k stride s with (k, s) = (8, 4), or (4, 2) for the
// 2x upsample folded into the weight. act is ReLU; with a mask (the bf16
// output of an earlier call) it is instead "keep where mask > 0", which is
// the adjoint of conv1_wgrad's product (the double backward).
// conv1_wgrad: dW = sum over pixels of patch(x)^T (g * [out > 0]) and db its
// column sums, float32 [32, C, k, k] and [32].
//
// Arithmetic, the same as the PyTorch code it replaces: each pixel becomes
// bf16(float(u8) / 255) (computed as float(u8) * (1 / 255), which rounds to
// the same bf16 for all 256 values; float input takes the IEEE division),
// the weight and bias are rounded to bf16, products are exact in float32 on
// the tensor cores (mma.sync m16n8k16), sums are float32, the bias is added
// in float32 and the result rounded once to bf16. The weight gradient is
// float32 with a fixed order of summation (per-block partials, then a
// second pass over them in block order): the same result on every call.
//
// What bounds it on this card: bytes. At 224x224x3 a frame is 150,528 bytes
// of uint8 in and 193,600 bytes of bf16 out, against 37 MFLOP (108 FLOP a
// byte, under the card's 295); the weight gradient also reads the output and
// its gradient. What the design does about it:
// - Persistent blocks walk over (frame, band of output rows) items. A band's
//   input rows are one contiguous byte range; they arrive by 16-byte cp.async
//   while the block computes the previous band, are converted once to bf16
//   in shared memory, and no float or bf16 copy of a frame reaches device
//   memory.
// - The [32, k*k*C] weight sits in shared memory as bf16 for the block's
//   life (12 KB at 8x8x3), read as B fragments.
// - A fragments are built from the bf16 band with 32-bit shared loads: a
//   patch's row is k*C contiguous values, and K runs (ky, kx, c). An m16 tile
//   takes 16 consecutive output pixels, fragment row g the pixel 2g and row
//   g + 8 the pixel 2g + 1, so the 8 addresses of a load at 8x8x3 fall in
//   distinct banks.
// - Each pixel's 32 channels leave as 16-byte stores after a transpose
//   within the quad of lanes that holds them: a warp's store covers whole
//   64-byte pixels.
// - Deep frame stacks: where a band and the weight of every channel do not
//   fit in shared memory, the channels go in the fewest passes that fit
//   (zeros past the last channel). The forward keeps its float32 sums in
//   shared memory from one pass to the next; the weight gradient gives each
//   pass blocks of its own.
// - The weight gradient stages g * [out > 0] per band in shared memory
//   (XOR-swizzled 16-byte chunks, read by ldmatrix.trans as A fragments of
//   channels x pixels), gathers patch values as B fragments, and keeps its
//   float32 sums in registers across every band of the block. The bias
//   gradient is summed while staging.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see srl_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int OC = 32;        // output channels
constexpr int MT = 2;         // m16 tiles a warp computes together (fprop)
constexpr int WG_NT = 3;      // n8 tiles (8 K indices each) a wgrad warp owns
constexpr int NBLK = 8 * WG_NT * WARPS;  // K indices a wgrad block covers: 192
constexpr int MAX_ROWS = 8;   // output rows of a band at most
constexpr int SMEM_TWO = 112 * 1024;  // two blocks an SM
constexpr int SMEM_ONE = 226 * 1024;  // one block an SM
constexpr float INV255 = 1.0f / 255.0f;

struct Geo {
  int n, h, w, c, ho, wo, k, s;
  int cg;      // channels of a pass: all c, or a group of them when c is large
  int passes;  // ceil(c / cg); channels past c in the last pass are zeros
  int kk;      // K of a pass = k * k * cg
  int kc;      // k * cg: one kernel row of a patch
  int rs;      // row stride of the bf16 band in elements: w * cg rounded up to 8
  int rows;    // output rows of a band
  int bands;   // bands of a frame
  int vec;     // one pass, and the band's bytes go by 16-byte cp.async
  long long items;
};

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Shared memory layout, in bytes from the start; every part 16-byte aligned.
struct Layout {
  int stage, xb, ws, koff, pbase, gs, bias, acc, total;
};

__host__ __device__ inline int in_rows(const Geo& g, int rows) { return (rows - 1) * g.s + g.k; }

__host__ __device__ inline Layout layout(const Geo& g, int elem, bool wgrad) {
  Layout l;
  const int nin = in_rows(g, g.rows);
  const int pix = round_up(g.rows * g.wo, 16);
  int at = 0;
  l.stage = at;
  at += g.vec ? round_up(nin * g.w * g.c * elem, 16) : 0;
  l.xb = at;
  at += round_up(nin * g.rs * 2, 16);
  l.ws = at;
  at += wgrad ? 0 : OC * (g.kk + 8) * 2;
  l.gs = at;
  at += wgrad ? pix * OC * 2 : 0;
  l.koff = at;
  at += round_up((wgrad ? g.kk : g.kk / 2) * 4, 16);
  l.pbase = at;
  at += pix * 4;
  l.bias = at;
  at += wgrad ? 0 : OC * 4;
  // The forward's float32 sums between passes, a warp's MT m16 tiles a slot.
  l.acc = at;
  at += wgrad || g.passes == 1 ? 0 : round_up(g.rows * g.wo, 16 * MT) * OC * 4;
  // The weight gradient's end-of-kernel reduction reuses the space.
  if (wgrad && at < OC * NBLK * 4) at = OC * NBLK * 4;
  if (wgrad && at < THREADS * 8 * 4) at = THREADS * 8 * 4;
  l.total = at;
  return l;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// float(byte k of v), exactly: the byte as the low mantissa bits of 2^23.
__device__ __forceinline__ float byte_f(uint32_t v, int k) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7540 | k)) - 8388608.0f;
}

__device__ __forceinline__ uint32_t two_px(uint32_t v, int k) {
  return pack_bf16(byte_f(v, k) * INV255, byte_f(v, k + 1) * INV255);
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(uint8_t u) {
  return __float2bfloat16_rn((float)u * INV255);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(float f) {
  return __float2bfloat16_rn(__fdiv_rn(f, 255.0f));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// An item is one band of one frame.
struct Item {
  long long frame;
  int oy0, rows, pixels, nin;
};

__device__ __forceinline__ Item item_of(const Geo& g, long long it) {
  Item i;
  i.frame = it / g.bands;
  i.oy0 = (int)(it % g.bands) * g.rows;
  i.rows = min(g.rows, g.ho - i.oy0);
  i.pixels = i.rows * g.wo;
  i.nin = in_rows(g, i.rows);
  return i;
}

template <typename T>
__device__ __forceinline__ const T* band_src(const T* x, const Geo& g, const Item& i) {
  return x + ((size_t)i.frame * g.h + (size_t)i.oy0 * g.s) * (size_t)g.w * g.c;
}

// Start the 16-byte copies of an item's input rows into the stage.
template <typename T>
__device__ __forceinline__ void stage_item(const T* x, const Geo& g, const Item& i,
                                           uint8_t* stage) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(band_src(x, g, i));
  const int chunks = i.nin * g.w * g.c * (int)sizeof(T) / 16;
  for (int q = threadIdx.x; q < chunks; q += THREADS) cp_async16(stage + 16 * q, src + 16 * q);
  cp_async_commit();
}

// The item's input rows, channels c0 .. c0 + cg of each pixel, as bf16 in xb:
// from the stage (vec), else straight from device memory.
template <typename T>
__device__ void fill_band(const T* x, const Geo& g, const Item& i, const uint8_t* stage,
                          __nv_bfloat16* xb, int c0) {
  const int wc = g.w * g.c;
  if (g.vec) {  // one pass and rs == wc, so the band is contiguous in xb too
    const int chunks = i.nin * wc * (int)sizeof(T) / 16;
    for (int q = threadIdx.x; q < chunks; q += THREADS) {
      const uint4 v = reinterpret_cast<const uint4*>(stage)[q];
      if constexpr (sizeof(T) == 1) {
        uint4 lo, hi;
        lo.x = two_px(v.x, 0), lo.y = two_px(v.x, 2), lo.z = two_px(v.y, 0), lo.w = two_px(v.y, 2);
        hi.x = two_px(v.z, 0), hi.y = two_px(v.z, 2), hi.z = two_px(v.w, 0), hi.w = two_px(v.w, 2);
        reinterpret_cast<uint4*>(xb)[2 * q] = lo;
        reinterpret_cast<uint4*>(xb)[2 * q + 1] = hi;
      } else {
        const float4 f = *reinterpret_cast<const float4*>(&v);
        uint2 o;
        o.x = pack_bf16(__fdiv_rn(f.x, 255.0f), __fdiv_rn(f.y, 255.0f));
        o.y = pack_bf16(__fdiv_rn(f.z, 255.0f), __fdiv_rn(f.w, 255.0f));
        reinterpret_cast<uint2*>(xb)[q] = o;
      }
    }
  } else {
    const T* src = band_src(x, g, i);
    const int wg = g.w * g.cg, n = i.nin * wg;
    for (int e = threadIdx.x; e < n; e += THREADS) {
      const int r = e / wg, rc = e - r * wg, px = rc / g.cg, ch = c0 + rc - px * g.cg;
      xb[r * g.rs + rc] =
          ch < g.c ? to_bf16(src[(size_t)r * wc + px * g.c + ch]) : __float2bfloat16_rn(0.f);
    }
  }
}

// Element offset in the band of pixel p's patch (band-relative pixel index).
__device__ __forceinline__ int pixel_base(const Geo& g, int p) {
  const int py = p / g.wo;
  return py * g.s * g.rs + (p - py * g.wo) * g.s * g.cg;
}
// Element offset of K index q within a patch.
__device__ __forceinline__ int k_offset(const Geo& g, int q) {
  const int ky = q / g.kc;
  return ky * g.rs + (q - ky * g.kc);
}

// Lane t of a quad holds, for one pixel, the bf16 pairs of channels
// 8j + 2t, 8j + 2t + 1 (j = 0..3); afterwards it holds channels 8t..8t+7.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t* r, int t) {
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int send = (t + i) & 3;
    const uint32_t mine = send == 0 ? r[0] : send == 1 ? r[1] : send == 2 ? r[2] : r[3];
    const int src = (threadIdx.x & 28) | ((t - i) & 3);
    v[i] = __shfl_sync(0xffffffffu, mine, src);
  }
  // v[i] came from lane (t - i) & 3: word w of the output is from lane w.
  uint32_t o[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int i = (t - w) & 3;
    o[w] = i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ uint32_t keep_positive(uint32_t v, uint32_t m) {
  const __nv_bfloat162 mb = *reinterpret_cast<const __nv_bfloat162*>(&m);
  const uint32_t lo = __low2float(mb) > 0.0f ? 0x0000FFFFu : 0u;
  const uint32_t hi = __high2float(mb) > 0.0f ? 0xFFFF0000u : 0u;
  return v & (lo | hi);
}

__device__ __forceinline__ uint4 keep_positive(uint4 v, uint4 m) {
  return make_uint4(keep_positive(v.x, m.x), keep_positive(v.y, m.y), keep_positive(v.z, m.z),
                    keep_positive(v.w, m.w));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    conv1_fprop_kernel(const T* __restrict__ x, Geo g, const float* __restrict__ weight,
                       const float* __restrict__ bias, const __nv_bfloat16* __restrict__ mask,
                       __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = layout(g, sizeof(T), false);
  uint8_t* stage = smem + L.stage;
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(smem + L.xb);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.ws);
  int* koff2 = reinterpret_cast<int*>(smem + L.koff);
  int* pbase = reinterpret_cast<int*>(smem + L.pbase);
  float* bs = reinterpret_cast<float*>(smem + L.bias);
  float* accs = reinterpret_cast<float*>(smem + L.acc);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int K = g.kk, kpad = K + 8;

  // The bf16 weight of channels c0 .. c0 + cg, K running (ky, kx, c).
  const auto load_weight = [&](int c0) {
    for (int e = tid; e < OC * K; e += THREADS) {
      const int o = e / K, q = e - o * K;
      const int ky = q / g.kc, r = q - ky * g.kc, kx = r / g.cg, c = c0 + r - kx * g.cg;
      const float v = c < g.c ? weight[((o * g.c + c) * g.k + ky) * g.k + kx] : 0.f;
      ws[o * kpad + q] = __float2bfloat16_rn(v);
    }
  };

  long long it = blockIdx.x;
  if (g.vec && it < g.items) stage_item(x, g, item_of(g, it), stage);
  if (g.passes == 1) load_weight(0);
  for (int m = tid; m < K / 2; m += THREADS) koff2[m] = k_offset(g, 2 * m);
  for (int p = tid; p < round_up(g.rows * g.wo, 16); p += THREADS)
    pbase[p] = p < g.rows * g.wo ? pixel_base(g, p) : 0;
  if (tid < OC) bs[tid] = bias ? bias[tid] : 0.0f;

  const uint32_t* xb32 = reinterpret_cast<const uint32_t*>(xb);
  const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);
  for (; it < g.items; it += gridDim.x) {
    const Item I = item_of(g, it);
    const int P = I.pixels, tiles = (P + 15) / 16, groups = (tiles + MT - 1) / MT;
    const size_t pix0 = ((size_t)I.frame * g.ho + I.oy0) * g.wo;
    for (int pass = 0; pass < g.passes; ++pass) {
      if (g.vec) cp_async_wait_all();
      __syncthreads();  // the stage has landed; xb and ws are free
      if (g.passes > 1) load_weight(pass * g.cg);
      fill_band(x, g, I, stage, xb, pass * g.cg);
      __syncthreads();  // xb and ws are ready; the stage is free
      if (g.vec && it + gridDim.x < g.items) stage_item(x, g, item_of(g, it + gridDim.x), stage);

      for (int grp = warp; grp < groups; grp += WARPS) {
        float acc[MT][4][4];
        float* slot = accs + grp * (MT * 16 * 32) + lane;  // 32 floats a lane, lane-minor
        int blo[MT], bhi[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int plo = (grp * MT + i) * 16 + 2 * gq;
          blo[i] = plo < P ? pbase[plo] : 0;
          bhi[i] = plo + 1 < P ? pbase[plo + 1] : 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] = pass ? slot[((i * 4 + j) * 4 + e) * 32] : 0.f;
        }
#pragma unroll 2
        for (int kc = 0; kc < K / 16; ++kc) {
          const int oa = koff2[8 * kc + t], ob = koff2[8 * kc + 4 + t];
          uint32_t b[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t* row = ws32 + (8 * j + gq) * (kpad / 2) + 8 * kc + t;
            b[j][0] = row[0];
            b[j][1] = row[4];
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const uint32_t a0 = xb32[(blo[i] + oa) >> 1], a1 = xb32[(bhi[i] + oa) >> 1];
            const uint32_t a2 = xb32[(blo[i] + ob) >> 1], a3 = xb32[(bhi[i] + ob) >> 1];
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a0, a1, a2, a3, b[j][0], b[j][1]);
          }
        }
        if (pass + 1 < g.passes) {  // keep the sums for the next pass
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) slot[((i * 4 + j) * 4 + e) * 32] = acc[i][j][e];
          continue;
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int plo = (grp * MT + i) * 16 + 2 * gq;
          uint32_t rlo[4], rhi[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b0 = bs[8 * j + 2 * t], b1 = bs[8 * j + 2 * t + 1];
            float v0 = acc[i][j][0] + b0, v1 = acc[i][j][1] + b1;
            float v2 = acc[i][j][2] + b0, v3 = acc[i][j][3] + b1;
            if (!mask) {
              v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f), v2 = fmaxf(v2, 0.f), v3 = fmaxf(v3, 0.f);
            }
            rlo[j] = pack_bf16(v0, v1);
            rhi[j] = pack_bf16(v2, v3);
          }
          uint4 lo = quad_transpose(rlo, t), hi = quad_transpose(rhi, t);
          const size_t olo = (pix0 + plo) * OC + 8 * t, ohi = olo + OC;
          if (mask) {
            if (plo < P) lo = keep_positive(lo, *reinterpret_cast<const uint4*>(mask + olo));
            if (plo + 1 < P) hi = keep_positive(hi, *reinterpret_cast<const uint4*>(mask + ohi));
          }
          if (plo < P) *reinterpret_cast<uint4*>(out + olo) = lo;
          if (plo + 1 < P) *reinterpret_cast<uint4*>(out + ohi) = hi;
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    conv1_wgrad_kernel(const T* __restrict__ x, Geo g, const __nv_bfloat16* __restrict__ act,
                       const __nv_bfloat16* __restrict__ gout, float* __restrict__ part_w,
                       float* __restrict__ part_b) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = layout(g, sizeof(T), true);
  uint8_t* stage = smem + L.stage;
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(smem + L.xb);
  uint8_t* gs = smem + L.gs;
  int* koffq = reinterpret_cast<int*>(smem + L.koff);
  int* pbase = reinterpret_cast<int*>(smem + L.pbase);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  // blockIdx.y: a pass (its channels) and a chunk of NBLK of the pass's K.
  const int chunks = (g.kk + NBLK - 1) / NBLK, c0 = (blockIdx.y / chunks) * g.cg;
  const int K = g.kk, q0 = (blockIdx.y % chunks) * NBLK, nk = min(NBLK, K - q0), ntiles = nk / 8;
  const int nch = (ntiles + WG_NT - 1) / WG_NT, groups = WARPS / nch;
  const int chunk = warp % nch, pg = warp / nch;
  const bool active = pg < groups;
  const bool bias_block = blockIdx.y == 0;

  long long it = blockIdx.x;
  if (g.vec && it < g.items) stage_item(x, g, item_of(g, it), stage);
  for (int q = tid; q < K; q += THREADS) koffq[q] = k_offset(g, q);
  for (int p = tid; p < round_up(g.rows * g.wo, 16); p += THREADS)
    pbase[p] = p < g.rows * g.wo ? pixel_base(g, p) : 0;
  __syncthreads();
  int ko[WG_NT];
#pragma unroll
  for (int j = 0; j < WG_NT; ++j) {
    const int nt = chunk * WG_NT + j;
    ko[j] = nt < ntiles ? koffq[q0 + 8 * nt + gq] : 0;
  }

  float acc[2][WG_NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < WG_NT; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  float db[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) db[e] = 0.f;

  const unsigned short* xb16 = reinterpret_cast<const unsigned short*>(xb);
  for (; it < g.items; it += gridDim.x) {
    const Item I = item_of(g, it);
    if (g.vec) cp_async_wait_all();
    __syncthreads();  // the stage has landed; xb and gs are free
    fill_band(x, g, I, stage, xb, c0);
    const int P = I.pixels, steps = (P + 15) / 16;
    const size_t e0 = ((size_t)I.frame * g.ho + I.oy0) * g.wo * OC;
    // g * [out > 0] in 16-byte chunks (8 channels); chunk c of pixel p at
    // slot c ^ ((p >> 1) & 3), so that ldmatrix's 8 rows hit distinct banks.
    for (int q = tid; q < steps * 16 * 4; q += THREADS) {
      const int p = q >> 2, c = q & 3;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (p < P) {
        v = keep_positive(__ldg(reinterpret_cast<const uint4*>(gout + e0) + q),
                          __ldg(reinterpret_cast<const uint4*>(act + e0) + q));
        if (bias_block) {
          const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w4[e]);
            db[2 * e] += __low2float(h);
            db[2 * e + 1] += __high2float(h);
          }
        }
      }
      *reinterpret_cast<uint4*>(gs + p * 64 + ((c ^ ((p >> 1) & 3)) << 4)) = v;
    }
    __syncthreads();  // xb and gs are ready; the stage is free
    if (g.vec && it + gridDim.x < g.items) stage_item(x, g, item_of(g, it + gridDim.x), stage);

    if (!active) continue;
    for (int ks = pg; ks < steps; ks += groups) {
      const int k0 = ks * 16;
      uint32_t a[2][4];
      {
        const int j = lane >> 3, p = k0 + (lane & 7) + ((j >> 1) << 3);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int c = 2 * m + (j & 1);
          ldmatrix_x4_trans(a[m], gs + p * 64 + ((c ^ ((p >> 1) & 3)) << 4));
        }
      }
      const int p0 = k0 + 2 * t;
      const int pb0 = p0 < P ? pbase[p0] : 0, pb1 = p0 + 1 < P ? pbase[p0 + 1] : 0;
      const int pb8 = p0 + 8 < P ? pbase[p0 + 8] : 0, pb9 = p0 + 9 < P ? pbase[p0 + 9] : 0;
#pragma unroll
      for (int j = 0; j < WG_NT; ++j) {
        if (chunk * WG_NT + j >= ntiles) break;
        const uint32_t b0 = (uint32_t)xb16[pb0 + ko[j]] | ((uint32_t)xb16[pb1 + ko[j]] << 16);
        const uint32_t b1 = (uint32_t)xb16[pb8 + ko[j]] | ((uint32_t)xb16[pb9 + ko[j]] << 16);
        mma_bf16(acc[0][j], a[0][0], a[0][1], a[0][2], a[0][3], b0, b1);
        mma_bf16(acc[1][j], a[1][0], a[1][1], a[1][2], a[1][3], b0, b1);
      }
    }
  }

  // This block's partial sums, the warps of one K chunk added in warp order.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < WG_NT; ++j) {
        const int nt = chunk * WG_NT + j;
        if (nt >= ntiles) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = 16 * m + gq + (e >> 1) * 8, q = 8 * nt + 2 * t + (e & 1);
          red[(pg * OC + o) * nk + q] = acc[m][j][e];
        }
      }
  }
  __syncthreads();
  const int kfull = g.k * g.k * g.c;
  for (int e = tid; e < OC * nk; e += THREADS) {
    float s = 0.f;
    for (int p = 0; p < groups; ++p) s += red[p * OC * nk + e];
    // The pass's K index (ky, kx, c) -> the whole weight's (ky, kx, c0 + c).
    const int o = e / nk, q = q0 + e - o * nk, kxy = q / g.cg, c = c0 + q - kxy * g.cg;
    if (c < g.c) part_w[((size_t)blockIdx.x * OC + o) * kfull + kxy * g.c + c] = s;
  }
  if (!bias_block) return;
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 8; ++e) red[tid * 8 + e] = db[e];
  __syncthreads();
  if (tid < OC) {
    float s = 0.f;
    for (int u = tid >> 3; u < THREADS; u += 4) s += red[u * 8 + (tid & 7)];
    part_b[(size_t)blockIdx.x * OC + tid] = s;
  }
}

// dW [32, C, k, k] and db [32]: the partials of every block, in block order.
__global__ void conv1_wgrad_reduce(const float* __restrict__ part_w,
                                   const float* __restrict__ part_b, int blocks, int K, int k,
                                   int c, float* __restrict__ dw, float* __restrict__ db) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < OC * K) {
    const int o = e / K, q = e - o * K;
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += part_w[((size_t)b * OC + o) * K + q];
    const int ky = q / (k * c), r = q - ky * k * c, kx = r / c, ci = r - kx * c;
    dw[((o * c + ci) * k + ky) * k + kx] = s;
  } else if (e < OC * K + OC) {
    const int o = e - OC * K;
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += part_b[(size_t)b * OC + o];
    db[o] = s;
  }
}

// The geometry of a call, or an error: all channels in one pass where the
// band and the weight fit in shared memory, else the fewest passes that fit;
// then the most rows a band.
int plan(Geo& g, const void* x, int elem, int n, int h, int w, int c, int k, int s, bool wgrad,
         int& smem) {
  if (n < 1 || c < 1 || !((k == 8 && s == 4) || (k == 4 && s == 2)) || h < k || w < k ||
      (long long)h * w * c * elem >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  g.n = n, g.h = h, g.w = w, g.c = c, g.k = k, g.s = s;
  g.ho = (h - k) / s + 1, g.wo = (w - k) / s + 1;
  for (int passes = 1; passes <= c; ++passes) {
    g.cg = (c + passes - 1) / passes;
    g.passes = (c + g.cg - 1) / g.cg;
    if (g.passes != passes) continue;  // the same split as a smaller count
    g.kk = k * k * g.cg, g.kc = k * g.cg;
    g.vec = passes == 1 && (w * c * elem) % 16 == 0 && (w * c) % 8 == 0 &&
            (uintptr_t)x % 16 == 0;
    g.rs = round_up(w * g.cg, 8);
    for (int budget : {SMEM_TWO, SMEM_ONE}) {
      for (int rows = g.ho < MAX_ROWS ? g.ho : MAX_ROWS; rows >= 1; --rows) {
        g.bands = (g.ho + rows - 1) / rows;
        g.rows = (g.ho + g.bands - 1) / g.bands;
        const int total = layout(g, elem, wgrad).total;
        if (total <= budget) {
          g.items = (long long)n * g.bands;
          smem = total;
          return 0;
        }
      }
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks the card holds at once of ``kernel`` at ``smem`` bytes, found once
// per device.
int resident(const void* kernel, int smem) {
  struct Entry {
    int dev;
    const void* kernel;
    int smem, blocks;
  };
  static std::mutex lock;
  static std::vector<Entry> known;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> hold(lock);
  for (const Entry& e : known)
    if (e.dev == dev && e.kernel == kernel && e.smem == smem) return e.blocks;
  int n = 0;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_ONE);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  known.push_back({dev, kernel, smem, sms * (n > 0 ? n : 1)});
  return known.back().blocks;
}

// A persistent grid: as many blocks as the card holds at once, at most one
// an item.
int blocks_for(const void* kernel, int smem, long long items) {
  const long long most = resident(kernel, smem);
  return (int)(items < most ? items : most);
}

template <typename T>
int fprop(const T* x, const Geo& g, int smem, const float* weight, const float* bias,
          const void* mask, void* out, cudaStream_t stream) {
  const int blocks = blocks_for((const void*)conv1_fprop_kernel<T>, smem, g.items);
  conv1_fprop_kernel<T><<<blocks, THREADS, smem, stream>>>(
      x, g, weight, bias, reinterpret_cast<const __nv_bfloat16*>(mask),
      reinterpret_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, h, w, c] uint8 (x_float 0) or float32 (1), NHWC, contiguous (device)
// weight [32, c, k, k] f32, bias [32] f32 or null (device)
// mask null, or bf16 [n, ho, wo, 32]: keep where mask > 0, no ReLU
// out bf16 [n, ho, wo, 32] (device, 16-byte aligned)
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int conv1_fprop_launch(const void* x, int x_float, int n, int h, int w, int c,
                                  int k, int s, const float* weight, const float* bias,
                                  const void* mask, void* out, void* stream) {
  Geo g;
  int smem = 0;
  const int elem = x_float ? 4 : 1;
  const int err = plan(g, x, elem, n, h, w, c, k, s, false, smem);
  if (err) return err;
  if ((uintptr_t)out % 16 || (uintptr_t)mask % 16) return (int)cudaErrorInvalidValue;
  if (x_float)
    return fprop(static_cast<const float*>(x), g, smem, weight, bias, mask, out,
                 (cudaStream_t)stream);
  return fprop(static_cast<const uint8_t*>(x), g, smem, weight, bias, mask, out,
               (cudaStream_t)stream);
}

// The blocks conv1_wgrad_launch will run (the rows of its partials), or a
// negative error.
extern "C" int conv1_wgrad_blocks(const void* x, int x_float, int n, int h, int w, int c,
                                  int k, int s) {
  Geo g;
  int smem = 0;
  const int err = plan(g, x, x_float ? 4 : 1, n, h, w, c, k, s, true, smem);
  if (err) return -err;
  return x_float ? blocks_for((const void*)conv1_wgrad_kernel<float>, smem, g.items)
                 : blocks_for((const void*)conv1_wgrad_kernel<uint8_t>, smem, g.items);
}

// act, gout bf16 [n, ho, wo, 32] (device, 16-byte aligned): the forward's
// output and its gradient
// part_w f32 [blocks, 32, k*k*c], part_b f32 [blocks, 32] (scratch)
// dw f32 [32, c, k, k], db f32 [32]
extern "C" int conv1_wgrad_launch(const void* x, int x_float, int n, int h, int w, int c, int k,
                                  int s, const void* act, const void* gout, float* part_w,
                                  float* part_b, int blocks, float* dw, float* db,
                                  void* stream) {
  Geo g;
  int smem = 0;
  const int err = plan(g, x, x_float ? 4 : 1, n, h, w, c, k, s, true, smem);
  if (err) return err;
  if ((uintptr_t)act % 16 || (uintptr_t)gout % 16 || blocks < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(blocks, g.passes * ((g.kk + NBLK - 1) / NBLK));
  const auto* a = reinterpret_cast<const __nv_bfloat16*>(act);
  const auto* go = reinterpret_cast<const __nv_bfloat16*>(gout);
  if (x_float) {
    resident((const void*)conv1_wgrad_kernel<float>, smem);
    conv1_wgrad_kernel<float><<<grid, THREADS, smem, st>>>(static_cast<const float*>(x), g, a,
                                                            go, part_w, part_b);
  } else {
    resident((const void*)conv1_wgrad_kernel<uint8_t>, smem);
    conv1_wgrad_kernel<uint8_t><<<grid, THREADS, smem, st>>>(static_cast<const uint8_t*>(x), g,
                                                              a, go, part_w, part_b);
  }
  const int launched = (int)cudaGetLastError();
  if (launched) return launched;
  const int outputs = OC * k * k * c + OC;
  conv1_wgrad_reduce<<<(outputs + 255) / 256, 256, 0, st>>>(part_w, part_b, blocks, k * k * c, k,
                                                             c, dw, db);
  return (int)cudaGetLastError();
}
