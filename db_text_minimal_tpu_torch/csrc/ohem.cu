// K10: OHEM's top-k sum with a dynamic k, for Hopper (sm_90a).
//
// Replaces the TPU-shaped op db_text_minimal_tpu/losses.py:40-67
// `_topk_sum`: the sum of the k largest entries of a non-negative f32 map,
// k a 0-d f32 tensor on the device. The JAX function bisects 34 times for
// the k-th largest value, a compare over the whole map and a count each
// round (laid out for XLA on the TPU: no sort, no dynamic shape); the port
// ran each round as ~9 device operations, ~320 a train step.
//
// Bound by bytes: one read of the map, 4 B a pixel (0.0078 ms for the
// 26.2 MB map of a batch of 16 at 640x640 at 3.35 TB/s). The card's 132
// SMs hold 227 KB of shared memory each, 30 MB in all, so the map is read
// from device memory once, into shared memory, and every later sweep runs
// there. k10_select is one cooperative launch, one persistent block of
// 1024 threads an SM, and no memset:
//
//   0. Each block's slice of the map (a contiguous run of 16-byte words)
//      goes to shared memory in chunks, a chunk by bulk copies
//      (cp.async.bulk) that complete on its own mbarrier, issued in order
//      by one thread; what does not fit (a batch over about 18 at 640x640)
//      is re-read from device memory in every sweep, and the unaligned
//      head and the ragged tail (< 4 values each) by scalar loads.
//      Meanwhile the grid zeroes the call's state (merged bins, maximum,
//      ticket); a grid barrier before the first merge.
//   1. Three digit passes, a radix select of the kk-th largest value v,
//      kk the least integer c with float32(c) >= k. Non-negative f32
//      values order as their bits; `key_of` maps any float to a uint32 of
//      the same order (-0 as +0). Pass p histograms one digit (11, 11 and
//      10 bits, high first) of the keys whose higher digits are the ones
//      chosen so far; a thread adds a (bin, count) pair to the block's
//      shared histogram where its bin changes. Pass 0 sweeps each chunk as
//      it lands (a thread the RUN consecutive values of its run, RUN odd
//      so a warp's loads hit 32 banks) and takes the largest key. Pass 1
//      first moves the values at or above the pass-0 bucket, in order, to
//      the front of the block's shared memory (a scan a chunk: the list);
//      passes 1 and 2 then read only the list. The block's nonzero bins
//      go to the merged bins by atomics; after a grid barrier every block
//      reads the merged bins and picks the bucket and the rank left in it
//      itself (`pick_bucket`, the same on every block).
//   2. Thread 0 of each block replays the 34 bisection rounds: count(values
//      > mid) >= k holds exactly when count >= kk, that is when mid < v
//      (every round keeps lo when kk <= 0, none when kk > n), so lo comes
//      out bit-equal to the bisection's. Then sum(values * [values > lo])
//      in f64 and count(values > lo), over the list when no value left out
//      of it exceeds lo (else over the slice again); each block writes its
//      pair, and the last block (a ticket) adds them in block order and
//      writes sum + lo * (k - count), taken in f64 and rounded to f32 once,
//      and lo. The result does not depend on the blocks' timing.
//   3. k10_grad (the backward): g * [values > lo], a grid-stride pass.
//
// On an H100 (demo/k10_phases) the copy of a 26.2 MB map ends 13-17 us in
// after the cold measurement's dirty 256 MB L2 flush, any way it is
// loaded; the four grid barriers with their merges and picks take ~9 us,
// the list ~5 us: ~0.04 ms in one device operation. Ties at v are what
// the clamped BCE gives by the thousand, hence the exact replay rather
// than an approximate threshold.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int GRAD_THREADS = 512;
constexpr int MAX_BINS = 2048;
constexpr int PASSES = 3;
constexpr int MAX_GRID = 1024;
// A thread takes RUN consecutive values of each chunk of CHUNK: RUN odd,
// so the 32 lanes' loads hit 32 banks; a chunk is staged by bulk copies
// of at most PIECE bytes each, completing on the chunk's mbarrier.
constexpr int RUN = 11;
constexpr int CHUNK = RUN * THREADS;
constexpr int MAX_CHUNKS = 6;
constexpr int PIECE = 8192;
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

// The state of one call in device memory. The wrapper allocates it
// uninitialised; the kernel zeroes the words up to `part_sum` itself.
struct State {
  unsigned int hist[PASSES][MAX_BINS];  // the merged block histograms
  unsigned int max_key;
  unsigned int ticket;
  double part_sum[MAX_GRID];            // each block's sum and count above
  unsigned long long part_cnt[MAX_GRID];  // lo, written before its ticket
};
constexpr int ZEROED_WORDS = PASSES * MAX_BINS + 2;

// A block's own copy of the select, at the start of its dynamic shared
// memory; the staged values follow at DATA_OFFSET.
struct Shared {
  unsigned int h[MAX_BINS];
  unsigned long long bar[MAX_CHUNKS];
  double wsum[WARPS];
  unsigned long long wcnt[WARPS];
  unsigned int wtot[WARPS];
  unsigned int ktot[2][WARPS];
  unsigned int max_key;
  unsigned int prefix;      // the digits chosen so far
  unsigned int rank;        // the rank (from 1, largest first) left in it
  int mode;                 // 0 select v; 1 keep lo every round; 2 none
  float lo;
  int last;
};
constexpr int DATA_OFFSET = (sizeof(Shared) + 127) / 128 * 128;

// What a block sweeps: its slice of the 16-byte-aligned body, staged4
// words of it in shared memory and stream4 more read from device memory;
// block 0 also takes the head and the tail.
struct Slice {
  const float* x;
  long long n;
  int head;                 // values before the aligned body
  long long tail0;          // the first value after it
  const float4* body;       // x + head
  long long start4;         // this block's first word of the body
  int staged4;
  long long stream4;
};

// x + 0 is +0 for -0 and x otherwise (NaN stays NaN); then the sign bit
// flips a positive value's top bit and all of a negative value's bits
__device__ __forceinline__ unsigned int key_of(float x) {
  const unsigned int u = __float_as_uint(__fadd_rn(x, 0.0f));
  return u ^ ((unsigned int)((int)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned int key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_stage(const unsigned long long* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
  } while (!done);
}

// kk: the least integer c >= 0 with float32(c) >= k; mode 1 when it is 0,
// mode 2 when it exceeds n (or k is NaN)
__device__ void target_rank(float k, long long n, Shared* sh) {
  if (k <= 0.0f) {
    sh->mode = 1;
    return;
  }
  if (!(k <= __ll2float_rn(n))) {
    sh->mode = 2;
    return;
  }
  long long c = (long long)ceilf(k);
  while (c > 0 && __ll2float_rn(c - 1) >= k) --c;
  sh->mode = 0;
  sh->rank = (unsigned int)c;
}

// The block's exclusive prefix sum of x in thread order, and its total,
// by warp shuffles and sh->wtot (two __syncthreads).
__device__ __forceinline__ unsigned int block_scan(unsigned int x,
                                                   Shared* sh,
                                                   unsigned int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  unsigned int* wtot = sh->wtot;
  unsigned int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    unsigned int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned int w = wtot[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      unsigned int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    wtot[lane] = w;
  }
  __syncthreads();
  total = wtot[WARPS - 1];
  return incl - x + (warp ? wtot[warp - 1] : 0u);
}

// The block picks the bucket of the rank-th largest key from the merged
// bins in device memory: thread t holds bins_of(PASS) / THREADS bins,
// high bins first, a scan over the threads finds the thread whose bins
// hold the rank, and it walks them. The bucket's digit joins the prefix,
// and the rank becomes the rank left within the bucket.
template <int PASS>
__device__ void pick_bucket(const unsigned int* merged, Shared* sh) {
  constexpr int per = bins_of(PASS) / THREADS;
  const int top = bins_of(PASS) - 1 - (int)threadIdx.x * per;
  unsigned int c[per], own = 0, total;
#pragma unroll
  for (int i = 0; i < per; ++i) own += c[i] = __ldcg(&merged[top - i]);
  const unsigned int rank = sh->rank;
  unsigned int above = block_scan(own, sh, total);
  if (above < rank && rank <= above + own) {
#pragma unroll
    for (int i = 0; i < per; ++i) {
      if (rank <= above + c[i]) {
        const unsigned int digit = (unsigned int)(top - i);
        sh->prefix = PASS ? (sh->prefix << digit_bits(PASS)) | digit
                          : digit;
        sh->rank = rank - above;
        break;
      }
      above += c[i];
    }
  }
  __syncthreads();
}

// A thread's staged values, to one(v): of each chunk (waited for when
// `wait`), the RUN consecutive ones from RUN * thread on, all loaded
// before the first is used.
template <typename F>
__device__ __forceinline__ void sweep_staged(const float* data, int len,
                                             const unsigned long long* bar,
                                             bool wait, F&& one) {
  for (int c = 0; c * CHUNK < len; ++c) {
    if (wait) wait_stage(bar + c);
    const int at = c * CHUNK + (int)threadIdx.x * RUN;
    if (at + RUN <= len) {
      float v[RUN];
#pragma unroll
      for (int j = 0; j < RUN; ++j) v[j] = data[at + j];
#pragma unroll
      for (int j = 0; j < RUN; ++j) one(v[j]);
    } else {
      for (int i = at; i < len; ++i) one(data[i]);
    }
  }
}

// A thread's entries of the block's list of len, to one(v): a contiguous
// run of an odd count (a warp's loads hit 32 banks).
template <typename F>
__device__ __forceinline__ void sweep_list(const float* list, int len,
                                           F&& one) {
  const int run = ((len + THREADS - 1) / THREADS) | 1;
  const int end = min((int)threadIdx.x * run + run, len);
  for (int i = (int)threadIdx.x * run; i < end; ++i) one(list[i]);
}

// What the block reads from device memory in every sweep, to one(v): the
// words past its shared memory by a block stride, and on block 0's thread
// 0 the head and the tail.
template <typename F>
__device__ __forceinline__ void sweep_rest(const Slice& sl, F&& one) {
  const float4* rest = sl.body + sl.start4 + sl.staged4;
  for (long long i = threadIdx.x; i < sl.stream4; i += THREADS) {
    float4 v = rest[i];
    one(v.x);
    one(v.y);
    one(v.z);
    one(v.w);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int i = 0; i < sl.head; ++i) one(sl.x[i]);
    for (long long i = sl.tail0; i < sl.n; ++i) one(sl.x[i]);
  }
}

// Pass 1's sweep: the staged values that may lie in the pass-0 bucket or
// above it (all but those below its least value va; a NaN stays) move, in
// their order, to the front of the staged values; returns their count. A
// chunk is read whole into registers before its barrier, and its values
// go to places before the next chunk. Each warp writes its count to
// sh->ktot[c & 1] and, after the one barrier, sums the counts before it.
__device__ int build_list(float* data, int len, float va, Shared* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  int base = 0;
  for (int c = 0; c * CHUNK < len; ++c) {
    const int at = c * CHUNK + (int)threadIdx.x * RUN;
    float v[RUN];
    unsigned int keep = 0, kept = 0;
    if (at + RUN <= len) {
#pragma unroll
      for (int j = 0; j < RUN; ++j) v[j] = data[at + j];
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j) v[j] = at + j < len ? data[at + j] : va;
    }
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const bool k = !(v[j] < va) && at + j < len;
      keep |= (unsigned int)k << j;
      kept += k;
    }
    // the kept values of the lower lanes by a shuffle scan, of the lower
    // warps by a sum over the counts they left in sh->ktot
    unsigned int incl = kept;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      unsigned int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    unsigned int* ktot = sh->ktot[c & 1];
    if (lane == 31) ktot[warp] = incl;
    __syncthreads();
    const unsigned int w = ktot[lane];
    int pos = base + (int)(incl - kept + __reduce_add_sync(
                                              0xffffffffu,
                                              lane < warp ? w : 0u));
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (keep >> j & 1) data[pos++] = v[j];
    base += (int)__reduce_add_sync(0xffffffffu, w);
  }
  __syncthreads();
  return base;
}

// One digit pass: the block's histogram of the digit of the keys under
// the prefix, a (bin, count) pair added where a thread's bin changes;
// pass 0 over the staged values as they land, passes 1 and 2 over the
// list; then the values read from device memory. Merged into
// st->hist[PASS]; a grid barrier; then the block picks the bucket from
// the merged bins.
template <int PASS>
__device__ void digit_pass(const Slice& sl, const float* data, int list_len,
                           float kv, Shared* sh, State* st,
                           cg::grid_group& grid) {
  constexpr int shift = shift_of(PASS);
  constexpr int bins = bins_of(PASS);
  constexpr int high = shift + digit_bits(PASS);  // 32 on pass 0
  unsigned int* h = sh->h;
  for (int i = threadIdx.x; i < bins; i += THREADS) h[i] = 0;
  __syncthreads();
  const unsigned int prefix = sh->prefix;
  unsigned int cur = 0, cnt = 0, mx = 0;
  auto one = [&](float v) {
    const unsigned int key = key_of(v);
    if (PASS == 0) mx = max(mx, key);
    const bool take = PASS == 0 || (key >> (high & 31)) == prefix;
    const unsigned int bin = (key >> shift) & (bins - 1);
    if (take && bin != cur) {
      if (cnt) atomicAdd(&h[cur], cnt);
      cur = bin;
      cnt = 0;
    }
    cnt += take;
  };
  if (PASS == 0)
    sweep_staged(data, 4 * sl.staged4, sh->bar, true, one);
  else
    sweep_list(data, list_len, one);
  sweep_rest(sl, one);
  if (cnt) atomicAdd(&h[cur], cnt);
  if (PASS == 0) {
    for (int d = 16; d > 0; d >>= 1)
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    if ((threadIdx.x & 31) == 0) atomicMax(&sh->max_key, mx);
    if (threadIdx.x == 0) target_rank(kv, sl.n, sh);
  }
  __syncthreads();
  // the zeroed state seen by every block before the first merge
  if (PASS == 0) grid.sync();
  for (int i = threadIdx.x; i < bins; i += THREADS)
    if (h[i]) atomicAdd(&st->hist[PASS][i], h[i]);
  if (PASS == 0 && threadIdx.x == 0) atomicMax(&st->max_key, sh->max_key);
  grid.sync();
  if (PASS == 0 && threadIdx.x == 0) sh->max_key = __ldcg(&st->max_key);
  if (sh->mode == 0) pick_bucket<PASS>(st->hist[PASS], sh);
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
k10_select(const float* __restrict__ x, long long n, int head,
           const float* __restrict__ k, State* __restrict__ st, int cap4,
           int iters, float* __restrict__ out, float* __restrict__ lo_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  Shared* sh = reinterpret_cast<Shared*>(smem);
  float* data = reinterpret_cast<float*>(smem + DATA_OFFSET);
  cg::grid_group grid = cg::this_grid();

  // this block's slice: the body's words split evenly over the grid
  Slice sl;
  sl.x = x;
  sl.n = n;
  sl.head = head;
  sl.body = reinterpret_cast<const float4*>(x + head);
  const long long words = (n - head) / 4;
  sl.tail0 = head + 4 * words;
  const long long per = words / gridDim.x, extra = words % gridDim.x;
  const long long b = blockIdx.x;
  const long long own = per + (b < extra);
  sl.start4 = b * per + min(b, extra);
  sl.staged4 = (int)min(own, (long long)cap4);
  sl.stream4 = own - sl.staged4;

  // 0. the copies into shared memory (one mbarrier a chunk, a chunk in
  // pieces of PIECE bytes, issued in order by one thread of warp 1: the
  // first chunk at once, the rest after the block's barrier, as the other
  // threads sweep what has landed) and the state zeroed meanwhile
  const int len = 4 * sl.staged4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const float* src = reinterpret_cast<const float*>(sl.body + sl.start4);
  auto issue = [&](int c) {
    const int end = min(len, (c + 1) * CHUNK);
    const uint32_t bar = smem_addr(&sh->bar[c]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(4u * (end - c * CHUNK)) : "memory");
    for (int at = c * CHUNK; at < end; at += PIECE / 4)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes [%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(data + at)), "l"(src + at),
             "r"(4u * (min(end, at + PIECE / 4) - at)), "r"(bar)
          : "memory");
  };
  if (threadIdx.x == 32) {
    for (int c = 0; c * CHUNK < len; ++c)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&sh->bar[c])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (len) issue(0);
  }
  // k is read now and used after the first sweep
  const float kv = threadIdx.x == 0 ? *k : 0.0f;
  if (threadIdx.x == 0) {
    sh->prefix = 0;
    sh->max_key = 0;
  }
  unsigned int* zeroed = reinterpret_cast<unsigned int*>(st);
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < ZEROED_WORDS;
       i += gridDim.x * THREADS)
    zeroed[i] = 0;
  __syncthreads();
  if (threadIdx.x == 32)
    for (int c = 1; c * CHUNK < len; ++c) issue(c);

  // 1. the digit passes; passes 1 and 2 (only where v is selected) over
  // the list of the staged values at or above the pass-0 bucket
  digit_pass<0>(sl, data, 0, kv, sh, st, grid);
  const int mode = sh->mode;
  const unsigned int kmin0 = sh->prefix << 21;
  int list_len = 0;
  if (mode == 0) {
    list_len = build_list(data, len, value_of(kmin0), sh);
    digit_pass<1>(sl, data, list_len, kv, sh, st, grid);
    digit_pass<2>(sl, data, list_len, kv, sh, st, grid);
  }

  // 2. the replay: torch.clamp(max, min=1), then the rounds of
  // mid = 0.5 * (lo + hi)
  if (threadIdx.x == 0) {
    float hi = fmaxf(value_of(sh->max_key), 1.0f);
    float lo = -hi;
    const float v = value_of(sh->prefix);
    for (int i = 0; i < iters; ++i) {
      float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      bool keep = mode == 1 || (mode == 0 && mid < v);
      if (keep) lo = mid; else hi = mid;
    }
    sh->lo = lo;
  }
  __syncthreads();
  const float lo = sh->lo;
  // The sum over the list when every value left out of it is at most lo
  // (the largest of them, the value just below the pass-0 bucket, is);
  // over the staged values where no list was made; else over the slice
  // in device memory again (the list took the staged values' place). A
  // bound that is a NaN's pattern stands for the infinity of its sign.
  float below = value_of(kmin0 - 1u);
  if (below != below) below = kmin0 - 1u >= 0x80000000u ? INFINITY : -INFINITY;
  const bool complete = kmin0 == 0u || !(lo < below);
  double sum = 0.0;
  unsigned long long cnt = 0;
  auto one = [&](float v) {
    if (v > lo) {
      sum += (double)v;
      ++cnt;
    }
  };
  if (mode != 0) {
    sweep_staged(data, len, sh->bar, false, one);
  } else if (complete) {
    sweep_list(data, list_len, one);
  } else {
    const float4* mine = sl.body + sl.start4;
    for (int i = threadIdx.x; i < sl.staged4; i += THREADS) {
      const float4 v = mine[i];
      one(v.x);
      one(v.y);
      one(v.z);
      one(v.w);
    }
  }
  sweep_rest(sl, one);
  for (int d = 16; d > 0; d >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, d);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
  }
  if (lane == 0) {
    sh->wsum[warp] = sum;
    sh->wcnt[warp] = cnt;
  }
  __syncthreads();
  if (warp == 0) {
    sum = sh->wsum[lane];
    cnt = sh->wcnt[lane];
    for (int d = 16; d > 0; d >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, d);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
    }
  }
  if (threadIdx.x == 0) {
    st->part_sum[blockIdx.x] = sum;
    st->part_cnt[blockIdx.x] = cnt;
    __threadfence();
    sh->last = atomicAdd(&st->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh->last || warp != 0) return;
  // the last block: the blocks' pairs in block order, then
  // (values * above).sum() + lo * (k - cnt) in f64, rounded once: the two
  // terms cancel where many values tie at lo, and f32 terms would leave an
  // error of their own ulp
  sum = 0.0;
  cnt = 0;
  for (int i = lane; i < (int)gridDim.x; i += 32) {
    sum += __ldcg(&st->part_sum[i]);
    cnt += __ldcg(&st->part_cnt[i]);
  }
  for (int d = 16; d > 0; d >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, d);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
  }
  if (lane == 0) {
    *out = (float)(sum + (double)lo * ((double)*k - (double)cnt));
    *lo_out = lo;
  }
}

__global__ void __launch_bounds__(GRAD_THREADS)
k10_grad(const float* __restrict__ x, long long n,
         const float* __restrict__ lo_ptr, const float* __restrict__ g_ptr,
         float* __restrict__ dx) {
  const float lo = *lo_ptr, g = *g_ptr;
  long long step = (long long)gridDim.x * GRAD_THREADS;
  for (long long i = (long long)blockIdx.x * GRAD_THREADS + threadIdx.x;
       i < n; i += step)
    dx[i] = g * (x[i] > lo ? 1.0f : 0.0f);
}

}  // namespace

extern "C" {

long long ohem_state_bytes() { return (long long)sizeof(State); }

// values: n contiguous f32 on the current device; k, out, lo_out: device
// scalars; state: ohem_state_bytes() of device memory, any contents. One
// cooperative launch of one block an SM (as many as fit) with all the
// shared memory a block may have; a grid that cannot be co-resident
// comes back as the launch's error.
int ohem_topk_sum(const float* values, long long n, const float* k,
                  void* state, int iters, float* out, float* lo_out,
                  cudaStream_t stream) {
  int dev, sms, optin, per_sm;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, k10_select);
  if (err != cudaSuccess) return (int)err;
  const int smem = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(
      k10_select, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k10_select,
                                                        THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = min(per_sm * sms, MAX_GRID);
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(values) & 15;
  int head = mis ? (int)((16 - mis) / 4) : 0;
  if (head > n) head = (int)n;
  int cap4 = min((smem - DATA_OFFSET) / 16, MAX_CHUNKS * CHUNK / 4);
  State* st = static_cast<State*>(state);
  void* args[] = {&values, &n, &head, &k, &st, &cap4, &iters, &out,
                  &lo_out};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(k10_select),
                                    dim3(grid), dim3(THREADS), args,
                                    (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int ohem_topk_grad(const float* values, long long n, const float* lo,
                   const float* g, float* dx, int blocks,
                   cudaStream_t stream) {
  k10_grad<<<blocks, GRAD_THREADS, 0, stream>>>(values, n, lo, g, dx);
  return (int)cudaGetLastError();
}

}  // extern "C"
