// D1: the bilinear sampling of a deformable 3x3 convolution (DCNv1),
// forward and backward, written for Hopper (sm_90a).
//
// Replaces the TPU-shaped op _bilinear_sample of
// db_text_minimal_tpu/models/deform.py:24-51, under DeformConv.__call__
// (:61-98): per tap, floor, four corner gathers of the NHWC input (each
// corner zero outside the image, its index clamped), a bilinear blend in
// f32, the sample cast to the compute dtype. The per-tap 1x1 products stay
// outside the kernels (torch.matmul, as the JAX package leaves them to XLA).
//
// Both kernels give one warp to each output pixel, which takes its 9 taps
// in turn and walks the channels, 4 a lane by one 16-byte (f32) or 8-byte
// (bf16) access when C % 4 == 0 and the pointers are 16-byte aligned, one
// a lane otherwise. So the four corner reads, the column write and the
// column-gradient read are coalesced along C; the pixel's 18 offsets are
// read by one 72-byte access and handed round by shuffles, and its
// position is divided out once (32-bit: the wrapper holds N*H*W and
// N*OH*OW under 2^31). The corners that the 9 taps of neighbouring pixels
// share come from L1/L2.
//
// deform_im2col (forward): x (N, H, W, C) f32 or bf16, offsets (N, OH, OW,
//   18) f32 as (dy, dx) per tap in row-major tap order; writes the columns
//   (9, N*OH*OW, C) in f32 or bf16. Coordinates as in JAX: (oy*stride +
//   ky - 1) + dy, floor, w = y - floor(y); the blend is
//   top = v00 (1-wx) + v01 wx, bot = v10 (1-wx) + v11 wx,
//   out = top (1-wy) + bot wy, every product and sum rounded on its own
//   (__fmul_rn / __fadd_rn: no FMA), so that the f32 columns equal the
//   plain PyTorch version's bit for bit and the bf16 ones its rounding.
//   The corner index is clamped into the image before the cast to int, so
//   huge or non-finite offsets never address outside x; an invalid corner
//   is not read at all.
// deform_col2im (backward): the column gradient g (9, P, C), f32 or bf16,
//   gives dx, by atomicAdd of g * (corner weight) into an f32 buffer (valid
//   corners only: with learned offsets any output may sample any input
//   pixel, so the input gradient is a scatter by nature), and doffsets
//   (N, OH, OW, 18) f32, a sum over C per (pixel, tap) reduced by warp
//   shuffles and written once: d/dy = sum g (bot - top), d/dx = sum
//   [g (1-wy) (v01 - v00) + g wy (v11 - v10)], invalid corners read as
//   zero. This is jax.grad through floor: one-sided at integer
//   coordinates, where wy = 0 and the difference is towards the next row.
//
// Bound: per (pixel, tap, channel) the forward does ~9 f32 operations and
// writes 2 or 4 bytes, and reads its 4 corners from cache; against the ~20
// operations a byte (67 TFLOP/s over 3.35 TB/s) at which arithmetic would
// bind, both kernels are bound by memory traffic: the columns written (the
// forward) or read (the backward) dominate, 9x the input's size.
//
// The extern "C" entries launch on the caller's stream, allocate nothing
// (the wrapper zeroes dx), and return cudaGetLastError() so that the Python
// wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCKS_PER_SM = 8;

// ---------------------------------------------------------- loads, stores

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ Vec<VEC> load(const __nv_bfloat16* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    r.v[0] = a.x;
    r.v[1] = a.y;
    r.v[2] = b.x;
    r.v[3] = b.y;
  } else {
    r.v[0] = __bfloat162float(*p);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Vec<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  } else {
    *p = r.v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const Vec<VEC>& r) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(r.v[0], r.v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(r.v[2], r.v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned int*>(&a);
    q.y = *reinterpret_cast<const unsigned int*>(&b);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
    *p = __float2bfloat16_rn(r.v[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void atomic_add(float* p, const Vec<VEC>& r) {
  if constexpr (VEC == 4) {
    // sm_90's vector atomic: one 16-byte red for the 4 channels
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(r.v[0], r.v[1], r.v[2], r.v[3]));
  } else {
    atomicAdd(p, r.v[0]);
  }
}

// ------------------------------------------------------------- one sample

// The four corners of one (pixel, tap) sample: each corner's row of the
// (N*H*W, C) input, whether it lies in the image, and the fractions.
struct Sample {
  int row[4];
  bool ok[4];
  float wy, wx;
};

// One output pixel: its image and position, and its 18 offsets, lane l
// holding offset l (l < 18), read by one coalesced 72-byte access.
struct Pixel {
  int n, oy, ox;
  float mine;
};

__device__ __forceinline__ Pixel pixel_at(const float* __restrict__ offsets,
                                          int p, int oh, int ow, int lane) {
  Pixel px;
  px.ox = p % ow;
  const int r = p / ow;
  px.oy = r % oh;
  px.n = r / oh;
  px.mine = lane < 18 ? __ldg(offsets + (long long)p * 18 + lane) : 0.0f;
  return px;
}

__device__ __forceinline__ Sample sample_at(const Pixel& px, int t, int h,
                                            int w, int stride) {
  const float dy = __shfl_sync(0xffffffffu, px.mine, 2 * t);
  const float dx = __shfl_sync(0xffffffffu, px.mine, 2 * t + 1);
  // (base + (k - 1)) is an exact integer in f32; + d is one rounding
  const float y = __fadd_rn((float)(px.oy * stride + t / 3 - 1), dy);
  const float x = __fadd_rn((float)(px.ox * stride + t % 3 - 1), dx);
  const float y0 = floorf(y);
  const float x0 = floorf(x);
  Sample s;
  s.wy = __fsub_rn(y, y0);
  s.wx = __fsub_rn(x, x0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float yy = __fadd_rn(y0, (float)(k >> 1));
    const float xx = __fadd_rn(x0, (float)(k & 1));
    s.ok[k] = yy >= 0.0f && yy < (float)h && xx >= 0.0f && xx < (float)w;
    // clamped before the cast: fmaxf takes 0 over a NaN
    const int yc = (int)fminf(fmaxf(yy, 0.0f), (float)(h - 1));
    const int xc = (int)fminf(fmaxf(xx, 0.0f), (float)(w - 1));
    s.row[k] = (px.n * h + yc) * w + xc;
  }
  return s;
}

template <int VEC, typename T>
__device__ __forceinline__ Vec<VEC> corner(const T* __restrict__ x,
                                           const Sample& s, int k, int c,
                                           int c0) {
  if (s.ok[k]) return load<VEC>(x + (long long)s.row[k] * c + c0);
  Vec<VEC> z;
#pragma unroll
  for (int i = 0; i < VEC; ++i) z.v[i] = 0.0f;
  return z;
}

__device__ __forceinline__ float blend(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

int grid_for(int pixels) {
  const long long want = ((long long)pixels + WARPS - 1) / WARPS;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  return (int)(want < cap ? want : cap);
}

// ---------------------------------------------------------------- kernels

// One (pixel, tap) of the forward: its column's C values.
template <int VEC, typename Tin, typename Tout>
__device__ __forceinline__ void im2col_tap(const Tin* __restrict__ x,
                                           const Sample& s,
                                           Tout* __restrict__ out, int c,
                                           int lane) {
  const float wy1 = __fsub_rn(1.0f, s.wy);
  const float wx1 = __fsub_rn(1.0f, s.wx);
  for (int c0 = lane * VEC; c0 < c; c0 += 32 * VEC) {
    const Vec<VEC> v00 = corner<VEC>(x, s, 0, c, c0);
    const Vec<VEC> v01 = corner<VEC>(x, s, 1, c, c0);
    const Vec<VEC> v10 = corner<VEC>(x, s, 2, c, c0);
    const Vec<VEC> v11 = corner<VEC>(x, s, 3, c, c0);
    Vec<VEC> r;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float top = blend(v00.v[i], wx1, v01.v[i], s.wx);
      const float bot = blend(v10.v[i], wx1, v11.v[i], s.wx);
      r.v[i] = blend(top, wy1, bot, s.wy);
    }
    store<VEC>(out + c0, r);
  }
}

// One (pixel, tap) of the backward: its corners' shares of dx by atomics;
// returns this lane's partial sums of d/dy and d/dx.
template <int VEC, typename Tin, typename Tg>
__device__ __forceinline__ float2 col2im_tap(const Tin* __restrict__ x,
                                             const Sample& s,
                                             const Tg* __restrict__ grad,
                                             float* __restrict__ dx, int c,
                                             int lane) {
  const float wy1 = __fsub_rn(1.0f, s.wy);
  const float wx1 = __fsub_rn(1.0f, s.wx);
  float sum_y = 0.0f, sum_x = 0.0f;
  for (int c0 = lane * VEC; c0 < c; c0 += 32 * VEC) {
    const Vec<VEC> g = load<VEC>(grad + c0);
    const Vec<VEC> v00 = corner<VEC>(x, s, 0, c, c0);
    const Vec<VEC> v01 = corner<VEC>(x, s, 1, c, c0);
    const Vec<VEC> v10 = corner<VEC>(x, s, 2, c, c0);
    const Vec<VEC> v11 = corner<VEC>(x, s, 3, c, c0);
    Vec<VEC> share[4];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float gt = __fmul_rn(g.v[i], wy1);
      const float gb = __fmul_rn(g.v[i], s.wy);
      const float top = blend(v00.v[i], wx1, v01.v[i], s.wx);
      const float bot = blend(v10.v[i], wx1, v11.v[i], s.wx);
      sum_y += g.v[i] * (bot - top);
      sum_x += gt * (v01.v[i] - v00.v[i]) + gb * (v11.v[i] - v10.v[i]);
      share[0].v[i] = __fmul_rn(gt, wx1);
      share[1].v[i] = __fmul_rn(gt, s.wx);
      share[2].v[i] = __fmul_rn(gb, wx1);
      share[3].v[i] = __fmul_rn(gb, s.wx);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (s.ok[k]) atomic_add<VEC>(dx + (long long)s.row[k] * c + c0,
                                   share[k]);
  }
  return make_float2(sum_y, sum_x);
}

// A warp a pixel, its 9 taps in turn.
template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(THREADS)
    deform_im2col_kernel(const Tin* __restrict__ x,
                         const float* __restrict__ offsets,
                         Tout* __restrict__ cols, int pixels, int h, int w,
                         int c, int oh, int ow, int stride) {
  const int lane = threadIdx.x & 31;
  for (int p = blockIdx.x * WARPS + (threadIdx.x >> 5); p < pixels;
       p += gridDim.x * WARPS) {
    const Pixel px = pixel_at(offsets, p, oh, ow, lane);
    for (int t = 0; t < 9; ++t)
      im2col_tap<VEC>(x, sample_at(px, t, h, w, stride),
                      cols + ((long long)t * pixels + p) * c, c, lane);
  }
}

template <typename Tin, typename Tg, int VEC>
__global__ void __launch_bounds__(THREADS)
    deform_col2im_kernel(const Tin* __restrict__ x,
                         const float* __restrict__ offsets,
                         const Tg* __restrict__ gcols, float* __restrict__ dx,
                         float* __restrict__ doffsets, int pixels, int h,
                         int w, int c, int oh, int ow, int stride) {
  const int lane = threadIdx.x & 31;
  for (int p = blockIdx.x * WARPS + (threadIdx.x >> 5); p < pixels;
       p += gridDim.x * WARPS) {
    const Pixel px = pixel_at(offsets, p, oh, ow, lane);
    for (int t = 0; t < 9; ++t) {
      float2 sum = col2im_tap<VEC>(x, sample_at(px, t, h, w, stride),
                                   gcols + ((long long)t * pixels + p) * c,
                                   dx, c, lane);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        sum.x += __shfl_xor_sync(0xffffffffu, sum.x, m);
        sum.y += __shfl_xor_sync(0xffffffffu, sum.y, m);
      }
      if (lane == 0)
        reinterpret_cast<float2*>(doffsets)[(long long)p * 9 + t] = sum;
    }
  }
}

template <typename Tin, typename Tout>
void launch_im2col(const void* x, const float* offsets, void* cols,
                   int pixels, int h, int w, int c, int oh, int ow,
                   int stride, int vec, cudaStream_t stream) {
  const int blocks = grid_for(pixels);
  const Tin* xi = static_cast<const Tin*>(x);
  Tout* co = static_cast<Tout*>(cols);
  if (vec == 4)
    deform_im2col_kernel<Tin, Tout, 4><<<blocks, THREADS, 0, stream>>>(
        xi, offsets, co, pixels, h, w, c, oh, ow, stride);
  else
    deform_im2col_kernel<Tin, Tout, 1><<<blocks, THREADS, 0, stream>>>(
        xi, offsets, co, pixels, h, w, c, oh, ow, stride);
}

template <typename Tin, typename Tg>
void launch_col2im(const void* x, const float* offsets, const void* gcols,
                   float* dx, float* doffsets, int pixels, int h, int w,
                   int c, int oh, int ow, int stride, int vec,
                   cudaStream_t stream) {
  const int blocks = grid_for(pixels);
  const Tin* xi = static_cast<const Tin*>(x);
  const Tg* g = static_cast<const Tg*>(gcols);
  if (vec == 4)
    deform_col2im_kernel<Tin, Tg, 4><<<blocks, THREADS, 0, stream>>>(
        xi, offsets, g, dx, doffsets, pixels, h, w, c, oh, ow, stride);
  else
    deform_col2im_kernel<Tin, Tg, 1><<<blocks, THREADS, 0, stream>>>(
        xi, offsets, g, dx, doffsets, pixels, h, w, c, oh, ow, stride);
}

}  // namespace

extern "C" {

// x (n, h, w, c): bf16 when x_bf16, else f32; offsets (n, oh, ow, 18) f32;
// cols (9, n*oh*ow, c): bf16 when cols_bf16, else f32. vec is 4 (c % 4 == 0
// and every pointer 16-byte aligned; the wrapper checks) or 1.
int deform_im2col(const void* x, int x_bf16, const float* offsets,
                  void* cols, int cols_bf16, int n, int h, int w, int c,
                  int oh, int ow, int stride, int vec, cudaStream_t stream) {
  const int pixels = n * oh * ow;
  if (pixels == 0 || c == 0) return (int)cudaGetLastError();
  if (x_bf16) {
    if (cols_bf16)
      launch_im2col<__nv_bfloat16, __nv_bfloat16>(
          x, offsets, cols, pixels, h, w, c, oh, ow, stride, vec, stream);
    else
      launch_im2col<__nv_bfloat16, float>(x, offsets, cols, pixels, h, w, c,
                                          oh, ow, stride, vec, stream);
  } else {
    if (cols_bf16)
      launch_im2col<float, __nv_bfloat16>(x, offsets, cols, pixels, h, w, c,
                                          oh, ow, stride, vec, stream);
    else
      launch_im2col<float, float>(x, offsets, cols, pixels, h, w, c, oh, ow,
                                  stride, vec, stream);
  }
  return (int)cudaGetLastError();
}

// x and offsets as deform_im2col's; gcols (9, n*oh*ow, c): bf16 when
// g_bf16, else f32; dx (n, h, w, c) f32, zeroed by the caller; doffsets
// (n, oh, ow, 18) f32, every element written.
int deform_col2im(const void* x, int x_bf16, const float* offsets,
                  const void* gcols, int g_bf16, float* dx, float* doffsets,
                  int n, int h, int w, int c, int oh, int ow, int stride,
                  int vec, cudaStream_t stream) {
  const int pixels = n * oh * ow;
  if (pixels == 0) return (int)cudaGetLastError();
  if (x_bf16) {
    if (g_bf16)
      launch_col2im<__nv_bfloat16, __nv_bfloat16>(
          x, offsets, gcols, dx, doffsets, pixels, h, w, c, oh, ow, stride,
          vec, stream);
    else
      launch_col2im<__nv_bfloat16, float>(x, offsets, gcols, dx, doffsets,
                                          pixels, h, w, c, oh, ow, stride,
                                          vec, stream);
  } else {
    if (g_bf16)
      launch_col2im<float, __nv_bfloat16>(x, offsets, gcols, dx, doffsets,
                                          pixels, h, w, c, oh, ow, stride,
                                          vec, stream);
    else
      launch_col2im<float, float>(x, offsets, gcols, dx, doffsets, pixels, h,
                                  w, c, oh, ow, stride, vec, stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
