// K10: OHEM's top-k sum with a dynamic k, for Hopper (sm_90a).
//
// Replaces the TPU-shaped op db_text_minimal_tpu/losses.py:40-67
// `_topk_sum`: the sum of the k largest entries of a non-negative f32 map,
// k a 0-d f32 tensor on the device. The JAX function bisects 34 times for
// the k-th largest value, a compare over the whole map and a count each
// round (laid out for XLA on the TPU: no sort, no dynamic shape); the port
// ran each round as ~9 device operations, ~320 a train step. Here:
//
//   1. k10_hist, three passes: a radix select of the kk-th largest value
//      v, kk the least integer c with float32(c) >= k. Non-negative f32
//      values order as their bits; `key_of` maps any float to a uint32 of
//      the same order (-0 as +0). Each pass histograms one digit (11, 11
//      and 10 bits, high first) of the keys whose higher digits are the
//      ones chosen so far, privatised in shared memory; the last block to
//      finish (a ticket) picks the digit's bucket and the rank left within
//      it. The first pass also takes the largest key, for the bracket.
//   2. k10_sum: each block replays the 34 bisection rounds in one thread:
//      count(values > mid) >= k holds exactly when count >= kk, that is
//      when mid < v (every round keeps lo when kk <= 0, none when kk > n),
//      so lo comes out bit-equal to the bisection's. Then
//      sum(values * [values > lo]) in f64 and count(values > lo); the
//      last block writes sum + lo * (k - count), taken in f64 and rounded
//      to f32 once, and lo.
//   3. k10_grad (the backward): g * [values > lo].
//
// Bound by bytes: one read of the map (4 B a pixel) is the least; this
// design reads it four times (the later passes mostly from L2, the map of
// a batch of 16 at 640x640 being 26 MB) plus a memset and five launches.
// Ties at v are what the clamped BCE gives by the thousand, hence the
// exact replay rather than an approximate threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_BINS = 2048;
constexpr int PASSES = 3;
// the digits, high first: bits 31..21, 20..10, 9..0
__host__ __device__ constexpr int shift_of(int pass) {
  return pass == 0 ? 21 : (pass == 1 ? 10 : 0);
}
__host__ __device__ constexpr int digit_bits(int pass) {
  return pass == 2 ? 10 : 11;
}
__host__ __device__ constexpr int bins_of(int pass) {
  return 1 << digit_bits(pass);
}

// The state of one call, zeroed by the wrapper before the first launch.
struct State {
  unsigned int hist[PASSES][MAX_BINS];
  unsigned int ticket[PASSES + 1];
  unsigned int max_key;
  unsigned int prefix;      // the digits chosen so far
  unsigned int rank;        // the rank (from 1, largest first) left in it
  int mode;                 // 0 select v; 1 keep lo every round; 2 none
  double sum;
  unsigned long long count;
};

__device__ __forceinline__ unsigned int key_of(float x) {
  unsigned int u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned int key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// kk: the least integer c >= 0 with float32(c) >= k; mode 1 when it is 0,
// mode 2 when it exceeds n (or k is NaN)
__device__ void target_rank(float k, long long n, State* st) {
  if (k <= 0.0f) {
    st->mode = 1;
    return;
  }
  if (!(k <= __ll2float_rn(n))) {
    st->mode = 2;
    return;
  }
  long long c = (long long)ceilf(k);
  while (c > 0 && __ll2float_rn(c - 1) >= k) --c;
  st->mode = 0;
  st->rank = (unsigned int)c;
}

// The 32 lanes of warp 0 pick the bucket of the rank-th largest key from
// the block's copy of the histogram: each lane sums 1/32 of the bins, high
// bins first, a scan over the lanes finds the lane, and it walks its bins.
// The bucket's digit joins the prefix, and the rank becomes the rank left
// within the bucket.
__device__ void pick_bucket(const unsigned int* h, int pass, State* st) {
  const int bins = bins_of(pass);
  const int lane = threadIdx.x;
  const int per = bins / 32;
  const int top = bins - 1 - lane * per;  // this lane's bins, downwards
  unsigned int own = 0;
  for (int i = 0; i < per; ++i) own += h[top - i];
  unsigned int incl = own;
  for (int d = 1; d < 32; d <<= 1) {
    unsigned int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  unsigned int above = incl - own;
  const unsigned int rank = st->rank;
  if (!(above < rank && rank <= incl)) return;
  for (int i = 0; i < per; ++i) {
    unsigned int c = h[top - i];
    if (rank <= above + c) {
      unsigned int digit = (unsigned int)(top - i);
      st->prefix = pass ? (st->prefix << digit_bits(pass)) | digit : digit;
      st->rank = rank - above;
      return;
    }
    above += c;
  }
}

__device__ __forceinline__ bool last_block(unsigned int* ticket) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  return is_last;
}

__global__ void __launch_bounds__(THREADS)
k10_hist(const float* __restrict__ x, long long n, int vec,
         const float* __restrict__ k, State* st, int pass) {
  __shared__ unsigned int h[MAX_BINS];
  __shared__ unsigned int block_max;
  if (pass > 0 && *(volatile int*)&st->mode != 0) return;
  const int shift = shift_of(pass);
  const int bins = bins_of(pass);
  const unsigned int prefix = pass ? *(volatile unsigned int*)&st->prefix
                                   : 0u;
  for (int i = threadIdx.x; i < bins; i += THREADS) h[i] = 0;
  if (threadIdx.x == 0) block_max = 0;
  __syncthreads();

  unsigned int mx = 0;
  const int lane = threadIdx.x & 31;
  auto add = [&](float v) {
    unsigned int key = key_of(v);
    mx = max(mx, key);
    // pass 0 takes every key, later passes those under the chosen prefix;
    // the lanes of a warp that hit one bin add to it once (a map holds
    // long runs of equal and of near values)
    bool take = pass == 0
                || (key >> (shift + digit_bits(pass))) == prefix;
    // in the later passes most warps hold no key under the prefix
    const unsigned int active = __activemask();
    if (pass > 0 && !__any_sync(active, take)) return;
    unsigned int bin = take ? (key >> shift) & (bins - 1) : 0xffffffffu;
    unsigned int peers = __match_any_sync(active, bin);
    if (take && lane == __ffs(peers) - 1)
      atomicAdd(&h[bin], (unsigned int)__popc(peers));
  };
  long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long step = (long long)gridDim.x * THREADS;
  long long n4 = vec ? n / 4 : 0;
  for (long long i = tid; i < n4; i += step) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    add(v.x);
    add(v.y);
    add(v.z);
    add(v.w);
  }
  for (long long i = n4 * 4 + tid; i < n; i += step) add(x[i]);
  if (pass == 0) {
    for (int d = 16; d > 0; d >>= 1)
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    if ((threadIdx.x & 31) == 0) atomicMax(&block_max, mx);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += THREADS)
    if (h[i]) atomicAdd(&st->hist[pass][i], h[i]);
  if (pass == 0 && threadIdx.x == 0) atomicMax(&st->max_key, block_max);

  if (!last_block(&st->ticket[pass])) return;
  // the last block: the digit's bucket and the rank left in it
  volatile unsigned int* g = st->hist[pass];
  for (int i = threadIdx.x; i < bins; i += THREADS) h[i] = g[i];
  if (pass == 0 && threadIdx.x == 0) target_rank(*k, n, st);
  __syncthreads();
  if (*(volatile int*)&st->mode == 0 && threadIdx.x < 32)
    pick_bucket(h, pass, st);
}

__global__ void __launch_bounds__(THREADS)
k10_sum(const float* __restrict__ x, long long n, int vec,
        const float* __restrict__ k, State* st, int iters,
        float* __restrict__ out, float* __restrict__ lo_out) {
  __shared__ float s_lo;
  __shared__ double s_sum[THREADS / 32];
  __shared__ unsigned long long s_cnt[THREADS / 32];
  if (threadIdx.x == 0) {
    // torch.clamp(max, min=1), then 34 rounds of mid = 0.5 * (lo + hi)
    float hi = fmaxf(value_of(*(volatile unsigned int*)&st->max_key), 1.0f);
    float lo = -hi;
    int mode = *(volatile int*)&st->mode;
    float v = value_of(*(volatile unsigned int*)&st->prefix);
    for (int i = 0; i < iters; ++i) {
      float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      bool keep = mode == 1 || (mode == 0 && mid < v);
      if (keep) lo = mid; else hi = mid;
    }
    s_lo = lo;
  }
  __syncthreads();
  const float lo = s_lo;
  double sum = 0.0;
  unsigned long long cnt = 0;
  auto add = [&](float v) {
    if (v > lo) {
      sum += (double)v;
      ++cnt;
    }
  };
  long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long step = (long long)gridDim.x * THREADS;
  long long n4 = vec ? n / 4 : 0;
  for (long long i = tid; i < n4; i += step) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    add(v.x);
    add(v.y);
    add(v.z);
    add(v.w);
  }
  for (long long i = n4 * 4 + tid; i < n; i += step) add(x[i]);
  for (int d = 16; d > 0; d >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, d);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
  }
  int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    s_sum[warp] = sum;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      sum += s_sum[w];
      cnt += s_cnt[w];
    }
    atomicAdd(&st->sum, sum);
    atomicAdd(&st->count, cnt);
  }
  if (!last_block(&st->ticket[PASSES])) return;
  if (threadIdx.x == 0) {
    // (values * above).sum() + lo * (k - cnt) in f64, rounded once: the
    // two terms cancel where many values tie at lo, and f32 terms would
    // leave an error of their own ulp
    double total = *(volatile double*)&st->sum;
    double count = (double)*(volatile unsigned long long*)&st->count;
    *out = (float)(total + (double)lo * ((double)*k - count));
    *lo_out = lo;
  }
}

__global__ void __launch_bounds__(THREADS)
k10_grad(const float* __restrict__ x, long long n,
         const float* __restrict__ lo_ptr, const float* __restrict__ g_ptr,
         float* __restrict__ dx) {
  const float lo = *lo_ptr, g = *g_ptr;
  long long step = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += step)
    dx[i] = g * (x[i] > lo ? 1.0f : 0.0f);
}

}  // namespace

extern "C" {

long long ohem_state_bytes() { return (long long)sizeof(State); }

// values: n contiguous f32 on the device; k, out, lo_out: device scalars;
// state: ohem_state_bytes() of device memory zeroed on `stream`.
int ohem_topk_sum(const float* values, long long n, int vec, const float* k,
                  void* state, int blocks, int iters, float* out,
                  float* lo_out, cudaStream_t stream) {
  State* st = static_cast<State*>(state);
  for (int pass = 0; pass < PASSES; ++pass) {
    k10_hist<<<blocks, THREADS, 0, stream>>>(values, n, vec, k, st, pass);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  k10_sum<<<blocks, THREADS, 0, stream>>>(values, n, vec, k, st, iters, out,
                                          lo_out);
  return (int)cudaGetLastError();
}

int ohem_topk_grad(const float* values, long long n, const float* lo,
                   const float* g, float* dx, int blocks,
                   cudaStream_t stream) {
  k10_grad<<<blocks, THREADS, 0, stream>>>(values, n, lo, g, dx);
  return (int)cudaGetLastError();
}

}  // extern "C"
