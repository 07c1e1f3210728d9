// Loading K10's 26.2 MB map (16x640x640 f32) into the shared memory of 132
// blocks of 1024 threads, four ways: bulk copies (cp.async.bulk on an
// mbarrier) issued by one thread or by 32 lanes, in pieces of 8 or 32 KB;
// 16-byte loads and shared stores; and cp.async of 16 bytes. Each after a
// 256 MB read-write pass over a buffer (the L2 left full of dirty lines,
// as chip_smoke.py's flush leaves it) and with no flush (the map still in
// L2); it prints the mean event time and the slowest block's time from
// its start to its last value in shared memory, over 10 runs.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o load_probe demo/k10_phases/load_probe.cu && ./load_probe
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
constexpr int T = 1024;
constexpr long long N = 16LL * 640 * 640;
__device__ unsigned long long g_t[132 * 2];
__device__ __forceinline__ unsigned long long now() { unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
__device__ __forceinline__ uint32_t sa(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
__global__ void flush(int* b, long long n) { long long i = blockIdx.x * 1024LL + threadIdx.x; if (i < n) b[i] += 1; }
template <int V>
__global__ void __launch_bounds__(T, 1) load(const float* x, float* sink, int piece) {
  extern __shared__ __align__(128) unsigned char sm[];
  unsigned long long* bar = (unsigned long long*)sm;
  float* d = (float*)(sm + 128);
  unsigned long long t0 = now();
  long long words = N / 4, per = words / gridDim.x, extra = words % gridDim.x, b = blockIdx.x;
  long long own = per + (b < extra), start = b * per + (b < extra ? b : extra);
  const float* src = x + 4 * start;
  int len = 4 * (int)own;
  if (V == 0 || V == 1) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(sa(bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(sa(bar)), "r"(4u * len) : "memory");
    }
    __syncthreads();
    int pieces = (len + piece / 4 - 1) / (piece / 4);
    if (V == 0 ? threadIdx.x == 32 : (threadIdx.x >= 32 && threadIdx.x < 64)) {
      int l0 = V == 0 ? 0 : threadIdx.x - 32, step = V == 0 ? 1 : 32;
      for (int p = l0; p < pieces; p += step) {
        int at = p * (piece / 4), end = min(len, at + piece / 4);
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                     :: "r"(sa(d + at)), "l"(src + at), "r"(4u * (end - at)), "r"(sa(bar)) : "memory");
      }
    }
    uint32_t done;
    do { asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; selp.u32 %0, 1, 0, p; }" : "=r"(done) : "r"(sa(bar)) : "memory"); } while (!done);
  } else if (V == 2) {
    const float4* s4 = (const float4*)src; float4* d4 = (float4*)d;
    int w = len / 4, i = threadIdx.x;
    for (; i + 3 * T < w; i += 4 * T) {
      float4 a = s4[i], bb = s4[i + T], c = s4[i + 2 * T], e = s4[i + 3 * T];
      d4[i] = a; d4[i + T] = bb; d4[i + 2 * T] = c; d4[i + 3 * T] = e;
    }
    for (; i < w; i += T) d4[i] = s4[i];
    __syncthreads();
  } else {
    int w = len / 4;
    for (int i = threadIdx.x; i < w; i += T)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(sa(d + 4 * i)), "l"(src + 4 * i) : "memory");
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  }
  if (threadIdx.x == 0) { g_t[blockIdx.x] = now() - t0; }
  if (d[threadIdx.x] == 12345.f) sink[0] = 1;
}
int main() {
  float* x; int* fb; float* sink;
  cudaMalloc(&x, N * 4); cudaMalloc(&fb, 256 << 20); cudaMalloc(&sink, 64);
  cudaMemset(x, 0, N * 4); cudaMemset(fb, 0, 256 << 20);
  int smem = 232448 - 1024;
  const char* names[] = {"bulk, one thread", "bulk, 32 lanes", "ld.global.v4 -> st.shared", "cp.async 16 B"};
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int dirty = 1; dirty >= 0; --dirty)
  for (int v = 0; v < 4; ++v)
  for (int piece : {8192, 32768}) {
    if (v >= 2 && piece != 8192) continue;
    void (*k)(const float*, float*, int) = v == 0 ? load<0> : v == 1 ? load<1> : v == 2 ? load<2> : load<3>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    float ms_sum = 0; double tmax = 0; int reps = 10;
    for (int r = 0; r < reps + 2; ++r) {
      if (dirty) flush<<<(64 << 20) / 1024, 1024>>>(fb, 64 << 20);
      else cudaMemcpy(sink, fb + (r % 2) * (1 << 20), 4, cudaMemcpyDeviceToDevice);  // no flush
      cudaEventRecord(e0); k<<<132, T, smem>>>(x, sink, piece); cudaEventRecord(e1);
      cudaError_t err = cudaDeviceSynchronize(); if (err) { printf("err %d\n", (int)err); return 1; }
      unsigned long long h[132]; cudaMemcpyFromSymbol(h, g_t, sizeof(h));
      float ms; cudaEventElapsedTime(&ms, e0, e1);
      if (r >= 2) {
        unsigned long long mx = 0; for (int b = 0; b < 132; ++b) mx = h[b] > mx ? h[b] : mx;
        ms_sum += ms; tmax += mx / 1e3;
      }
    }
    printf("%s flush, %-28s piece %5d: event %.4f ms, slowest block %.2f us\n", dirty ? "dirty" : "no", names[v], piece, ms_sum / reps, tmax / reps);
  }
  return 0;
}
