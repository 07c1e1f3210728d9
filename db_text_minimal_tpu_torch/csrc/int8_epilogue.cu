// P1: the epilogue of an int8 convolution, written for Hopper (sm_90a).
//
// Replaces the TPU kernel _epi_kernel / epilogue of
// benchmarks/int8_conv_probe.py:103-122, the hand-written form of the chain
// that the JAX int8 forward leaves to XLA's fusion
// (db_text_minimal_tpu/models/quant_infer.py:243). Per output channel c of
// the int32 accumulators of an int8 x int8 convolution:
//
//   y = acc * scale[c] + bias[c]            (f32 product, then f32 add)
//   y = max(y, 0)                           (when relu)
//   f32 form:  out = y
//   int8 form: out = clip(rint(y * inv_out_scale), -127, 127)
//
// The int8 form writes the next convolution's int8 input directly (its
// static activation scale's reciprocal is inv_out_scale), so the f32 map is
// never written. Rounding matches the plain version and jnp bit for bit:
// __fmul_rn / __fadd_rn keep nvcc from contracting to an FMA, rintf rounds
// half to even as torch.round and jnp.round do, and the reciprocal is
// multiplied, never divided by, as the JAX code does.
//
// Bound: per element it reads 4 B of int32 and writes 4 B (f32) or 1 B
// (int8), and does 4-6 operations: under 1 operation a byte, against the ~20
// a byte (67 TFLOP/s over 3.35 TB/s) at which arithmetic would bind. So it
// is bound by memory traffic, and the design aims at full-width
// transactions: a thread takes 4 consecutive channels of one position, one
// 16-byte int4 load, its 4 scales and biases as float4 through the
// read-only cache (C <= 512 floats stay in L1), and one float4 or char4
// store; neighbouring threads touch neighbouring 16 bytes. A grid-stride
// loop over M*C/4 groups with a few blocks per SM keeps the loads in flight.
//
// The extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so that the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ float affine(int acc, float scale, float bias,
                                        bool relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return relu ? fmaxf(y, 0.0f) : y;
}

__device__ __forceinline__ signed char requant(float y, float inv) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.0f), 127.0f);
  return static_cast<signed char>(__float2int_rn(r));
}

template <bool RELU, bool QUANT>
__global__ void __launch_bounds__(THREADS)
    epilogue(const int4* __restrict__ acc, const float4* __restrict__ scale,
             const float4* __restrict__ bias,
             const float* __restrict__ inv_out_scale, void* __restrict__ out,
             long long n4, int c4) {
  const float inv = QUANT ? __ldg(inv_out_scale) : 0.0f;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += stride) {
    const int4 a = __ldcs(acc + i);   // read once: stream past the caches
    const int g = (int)(i % c4);
    const float4 s = __ldg(scale + g);
    const float4 b = __ldg(bias + g);
    const float y0 = affine(a.x, s.x, b.x, RELU);
    const float y1 = affine(a.y, s.y, b.y, RELU);
    const float y2 = affine(a.z, s.z, b.z, RELU);
    const float y3 = affine(a.w, s.w, b.w, RELU);
    if (QUANT) {
      char4 q;
      q.x = requant(y0, inv);
      q.y = requant(y1, inv);
      q.z = requant(y2, inv);
      q.w = requant(y3, inv);
      static_cast<char4*>(out)[i] = q;
    } else {
      static_cast<float4*>(out)[i] = make_float4(y0, y1, y2, y3);
    }
  }
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

}  // namespace

extern "C" {

// acc (M, C) int32, scale and bias (C,) f32, out (M, C): int8 when
// inv_out_scale (a device f32 scalar) is given, else f32. C % 4 == 0 and
// every pointer 16-byte aligned (the wrapper checks both).
int int8_epilogue(const int32_t* acc, const float* scale, const float* bias,
                  const float* inv_out_scale, void* out, long long m, int c,
                  int relu, cudaStream_t stream) {
  const long long n4 = m * (long long)(c / 4);
  if (n4 == 0) return (int)cudaGetLastError();
  const long long want = (n4 + THREADS - 1) / THREADS;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  const int blocks = (int)(want < cap ? want : cap);
  const int4* a = reinterpret_cast<const int4*>(acc);
  const float4* s = reinterpret_cast<const float4*>(scale);
  const float4* b = reinterpret_cast<const float4*>(bias);
  const int c4 = c / 4;
  if (inv_out_scale != nullptr) {
    if (relu)
      epilogue<true, true><<<blocks, THREADS, 0, stream>>>(
          a, s, b, inv_out_scale, out, n4, c4);
    else
      epilogue<false, true><<<blocks, THREADS, 0, stream>>>(
          a, s, b, inv_out_scale, out, n4, c4);
  } else {
    if (relu)
      epilogue<true, false><<<blocks, THREADS, 0, stream>>>(
          a, s, b, nullptr, out, n4, c4);
    else
      epilogue<false, false><<<blocks, THREADS, 0, stream>>>(
          a, s, b, nullptr, out, n4, c4);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
