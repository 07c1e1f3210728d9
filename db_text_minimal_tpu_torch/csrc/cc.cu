// Connected components and per-component statistics for the device rect
// and polygon postprocess, written for Hopper (sm_90a).
//
// Port of the TPU postprocess in db_text_minimal_tpu/ops/pallas/cc.py. The
// TPU version is laid out for a machine without fast gathers: min-label
// propagation by segmented scans in a capped while-loop, and scatters into
// K + 1 fixed slots. A GPU gathers and does atomics cheaply, so every
// kernel here is rewritten around that:
//
//   K3 cc_label      <- connected_components (cc.py:63-111)
//   K4 cc_compact    <- _compact_slots (cc.py:114-144)
//   K5 cc_rot_boxes  <- component_rotated_boxes + _rect_corners (cc.py:181-320)
//   K6 cc_hole_route <- _hole_stats (cc.py:383-444), after K3/K4 on the
//                       4-connected background
//   K7 cc_bbox_stats, cc_pack_bits <- _device_poly_stats_single
//                       (cc.py:447-492), with K3, K4 and K6 around them
//   K8 cc_bbox_stats <- component_boxes (cc.py:147-178), under fast_boxes
//                       (cc.py:506-521)
//
// Every pass reads each input pixel once or a few times and does a handful
// of integer or float operations on it, so all of them are bound by memory
// traffic (and, for K5, by atomics into a few hot slot addresses), not by
// arithmetic. Each design note below says what the kernel does about that.
//
// Each extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so that the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- K3 ------
// Connected components by runs. Replaces connected_components
// (db_text_minimal_tpu/ops/pallas/cc.py:63-111): the label of a foreground
// pixel is the linear index, within its image, of its component's minimum
// pixel; background is -1. K4 relies on label == index at roots.
//
// Bound: 1 B of mask in and 4 B of label out per pixel, 0.0049 ms at
// 8x640x640 at the H100's 3.35 TB/s. A pixel costs a few bit operations, so
// bytes and latency bound the kernel, not arithmetic.
//
// The design before this one gave each pixel of a 32x32 tile a thread that
// made 2 (4-connected) or 4 (8-connected) unions through a find on volatile
// shared memory with no path compression, each ending in an atomicMin that
// retried under contention; every pixel then walked to its root again, and
// every tile-border pixel made one more union in device memory. A full tile
// (the 4-connected background, a giant served component) built long parent
// chains that all of its 1024 threads walked. What this design does instead:
//
// - k3_local: a tile of TH = 32 rows by TW = 128 columns per block, a warp
//   a row. Four ballots give the row's foreground as four words; run starts
//   are fg & ~(fg << 1), carried across words, and each pixel finds its run
//   start with __clz on the starts at or left of it: no union inside a row.
//   Only run starts enter the union-find. Rows y-1 and y are joined once per
//   touching pair of runs (join_events), so a full tile costs 31 unions in
//   place of about 8,000, and a warp's events are spread over its lanes
//   (for_each_event), so a lane makes about (events / 32) unions. Two
//   blocks fit an SM (at most 32 registers a thread). After a
//   __syncthreads() the run starts find their roots and store them over
//   their parents (with no union in flight, such a store undoes no hook),
//   and each pixel takes its run start's root.
// - k3_merge: per tile, one warp for the top border (rows y0-1 and y0) and
//   one for the left border (columns x0-1 and x0), the same rules once per
//   touching pair of run pieces, spread over the lanes, so a border costs a
//   union per run, not per pixel. The finds in device memory halve paths
//   with atomicMin: a parent is only ever lowered, so no concurrent hook is
//   undone.
// - k3_flatten: no union is in flight any more; each pixel walks its short
//   path to the root with plain loads, 4 pixels a thread with 16-byte loads
//   and stores where the image is aligned, and writes only the labels that
//   changed.
//
// A union hooks the larger root under the smaller, so every root is its
// component's minimum index whatever order the threads run in, and the
// result equals the plain version bit for bit. Three launches on the
// caller's stream, no allocation, no host synchronisation.

constexpr int TW = 128, TH = 32, NW = TW / 32;

// Word j of a row of NW words, shifted so that bit c holds bit c - 1
// (shl1) or bit c + 1 (shr1) of the row; bits past the row are 0.
__device__ __forceinline__ unsigned shl1(const unsigned* x, int j) {
  return (x[j] << 1) | (j > 0 ? x[j - 1] >> 31 : 0u);
}
__device__ __forceinline__ unsigned shr1(const unsigned* x, int j) {
  return (x[j] >> 1) | (j + 1 < NW ? x[j + 1] << 31 : 0u);
}

// Bit c of a row of NW words, and the highest set bit at or below c (-1 if
// none): the run start of a foreground pixel c when x holds the starts.
// Unrolled over the words so that the row stays in registers.
__device__ __forceinline__ bool bit_at(const unsigned* x, int c) {
  unsigned w = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    if (k == (c >> 5)) w = x[k];
  return (w >> (c & 31)) & 1u;
}
__device__ __forceinline__ int last_at_or_before(const unsigned* x, int c) {
  int at = -1;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int top = c - 32 * k;   // bits 0..top of word k count
    const unsigned m = top >= 31 ? x[k]
                       : top >= 0 ? x[k] & (0xffffffffu >> (31 - top))
                                  : 0u;
    if (m) at = 32 * k + 31 - __clz(m);
  }
  return at;
}

// Where the runs of a lower line b meet those of the line a above it, once
// per touching pair of runs: `up` at the first pixel of each overlap; with
// 8-connectivity also `ul` at a lower run's first pixel where an upper run
// ends just before it, and `ur` at a lower run's last pixel where an upper
// run starts just after it (neither pair overlaps, so none is taken twice).
// *_l and *_r are the lines shifted so that bit c holds pixel c - 1 and
// c + 1. For a tile's rows the lines are rows; for its left border they are
// the columns x0 and x0 - 1, bit c for row y0 + c.
struct JoinEvents {
  unsigned up, ul, ur;
};
__device__ __forceinline__ JoinEvents join_events(unsigned b, unsigned b_l,
                                                  unsigned b_r, unsigned a,
                                                  unsigned a_l, unsigned a_r) {
  return {b & a & ~(b_l & a_l), b & ~b_l & ~a & a_l, b & ~b_r & ~a & a_r};
}

// Position of set bit n (from 0, n < popc(w)) of w, by halving.
__device__ __forceinline__ int nth_set_bit(unsigned w, int n) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int low = __popc(w & ((1u << half) - 1u));
    if (n >= low) {
      n -= low;
      w >>= half;
      pos += half;
    }
  }
  return pos;
}

// Calls f(e, bit) once for every set bit of the warp-uniform words ev[NE],
// the warp's events spread over its lanes (event k to lane k % 32), so a
// lane makes about (events / 32) unions however they fall in the words.
template <int NE, typename F>
__device__ __forceinline__ void for_each_event(const unsigned (&ev)[NE],
                                               int lane, F f) {
  int total = 0;
#pragma unroll
  for (int e = 0; e < NE; ++e) total += __popc(ev[e]);
  for (int k = lane; k < total; k += 32) {
    int rest = k, which = -1;
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int n = __popc(ev[e]);
      if (which < 0 && rest < n) {
        which = e;
        word = ev[e];
      } else if (which < 0) {
        rest -= n;
      }
    }
    f(which, nth_set_bit(word, rest));
  }
}

// Union-find over parent indices, each at or below its child's. find_root
// only reads, for phases with no union in flight; find_halving points each
// node it passes at its grandparent with atomicMin, for phases with unions.
__device__ __forceinline__ int find_root(const int* parent, int x) {
  const volatile int* p = parent;
  int up = p[x];
  while (up != x) {
    x = up;
    up = p[x];
  }
  return x;
}
__device__ __forceinline__ int find_halving(int* parent, int x) {
  const volatile int* p = parent;
  int up = p[x];
  while (up != x) {
    const int next = p[up];
    if (next != up) atomicMin(&parent[x], next);
    x = up;
    up = next;
  }
  return x;
}

// Works on shared or device memory (generic addressing). When the hook
// finds b already hooked (old != b), atomicMin may have replaced b's parent
// old by a, so the loop goes on to join a with old.
__device__ __forceinline__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_halving(parent, a);
    b = find_halving(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&parent[b], a);
    if (old == b) return;
    b = old;
  }
}

// The join events of a lower line b and the line a above it as 3 * NW
// words: up, then ul, then ur (both 0 when 4-connected). Event word `which`
// joins pixel c = 32 * (which % NW) + bit with pixel c + dc(which) above.
__device__ __forceinline__ void line_events(const unsigned* b,
                                            const unsigned* a, bool eight,
                                            unsigned (&ev)[3 * NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const JoinEvents e = join_events(b[j], shl1(b, j), shr1(b, j), a[j],
                                     shl1(a, j), shr1(a, j));
    ev[j] = e.up;
    ev[NW + j] = eight ? e.ul : 0u;
    ev[2 * NW + j] = eight ? e.ur : 0u;
  }
}
__device__ __forceinline__ int dc(int which, int nw) {
  return which < nw ? 0 : which < 2 * nw ? -1 : 1;
}

__global__ void __launch_bounds__(TH * 32, 2)
k3_local(const uint8_t* __restrict__ mask, int* __restrict__ labels, int H,
         int W, int conn) {
  __shared__ int parent[TH * TW];
  __shared__ unsigned rows[TH][NW];
  const int lane = threadIdx.x & 31, ly = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TW, y = blockIdx.y * TH + ly;
  const size_t base = (size_t)blockIdx.z * H * W;
  const int row0 = ly * TW;
  // every lane takes part in the ballots; pixels past the edge count as 0
  unsigned fg[NW], st[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int x = x0 + 32 * j + lane;
    fg[j] = __ballot_sync(FULL, y < H && x < W &&
                                    mask[base + (size_t)y * W + x] != 0);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    st[j] = fg[j] & ~shl1(fg, j);
    if (lane == 0) rows[ly][j] = fg[j];
    const int i = row0 + 32 * j + lane;
    if ((st[j] >> lane) & 1u) parent[i] = i;
  }
  __syncthreads();

  unsigned ev[3 * NW] = {}, ust[NW] = {};
  if (ly > 0) {
    unsigned up[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) up[j] = rows[ly - 1][j];
#pragma unroll
    for (int j = 0; j < NW; ++j) ust[j] = up[j] & ~shl1(up, j);
    line_events(fg, up, conn == 8, ev);
  }
  // every row pair at once (joining the rows in a binary tree of strips,
  // with the trees flattened between steps, measured slower)
  for_each_event(ev, lane, [&](int which, int bit) {
    const int c = 32 * (which % NW) + bit;
    unite(parent, row0 + last_at_or_before(st, c),
          row0 - TW + last_at_or_before(ust, c + dc(which, NW)));
  });
  __syncthreads();
  // the run starts' roots, stored over their parents: no union is in flight
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int i = row0 + 32 * j + lane;
    if ((st[j] >> lane) & 1u) parent[i] = find_root(parent, i);
  }
  __syncthreads();

  // a lane writes 4 neighbouring pixels, as one 16-byte store where aligned
  if (y < H) {
    const int c0 = 4 * lane, x = x0 + c0;
    int out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i;
      out[i] = -1;
      if (bit_at(fg, c)) {
        const int r = parent[row0 + last_at_or_before(st, c)];
        out[i] = (blockIdx.y * TH + r / TW) * W + x0 + r % TW;
      }
    }
    int* dst = labels + base + (size_t)y * W + x;
    if ((W & 3) == 0 && x + 3 < W) {
      *reinterpret_cast<int4*>(dst) = make_int4(out[0], out[1], out[2],
                                                out[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (x + i < W) dst[i] = out[i];
    }
  }
}

// Warp 0 joins the tile's top row y0 with the row above over the tile's
// columns [x0, x1), and, 8-connected, its corner pixels with the pixels
// x0 - 1 and x1 of the row above (no rule of the row words covers those).
// Warp 1 joins the tile's left column x0 with column x0 - 1 over its rows;
// the diagonal pairs that leave the tile's rows are corners of a top border.
__global__ void __launch_bounds__(64)
k3_merge(const uint8_t* __restrict__ mask, int* labels, int H, int W,
         int conn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t base = (size_t)blockIdx.z * H * W;
  const uint8_t* m = mask + base;
  int* L = labels + base;
  const bool eight = conn == 8;
  if (warp == 0 && y0 > 0) {
    const int x1 = min(x0 + TW, W);
    const int lo0 = y0 * W, hi0 = lo0 - W;
    unsigned lo[NW], hi[NW], ev[3 * NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int x = x0 + 32 * j + lane;
      lo[j] = __ballot_sync(FULL, x < x1 && m[lo0 + x] != 0);
      hi[j] = __ballot_sync(FULL, x < x1 && m[hi0 + x] != 0);
    }
    line_events(lo, hi, eight, ev);
    if (eight && lane == 31 && x0 > 0 && m[lo0 + x0] && m[hi0 + x0 - 1])
      unite(L, lo0 + x0, hi0 + x0 - 1);
    if (eight && lane == 30 && x1 < W && m[lo0 + x1 - 1] && m[hi0 + x1])
      unite(L, lo0 + x1 - 1, hi0 + x1);
    for_each_event(ev, lane, [&](int which, int bit) {
      const int p = lo0 + x0 + 32 * (which % NW) + bit;
      unite(L, p, p - W + dc(which, NW));
    });
  } else if (warp == 1 && x0 > 0) {
    const int y = y0 + lane;
    const bool in = y < H;
    const unsigned r = __ballot_sync(FULL, in && m[y * W + x0] != 0);
    const unsigned l = __ballot_sync(FULL, in && m[y * W + x0 - 1] != 0);
    const JoinEvents e = join_events(r, r << 1, r >> 1, l, l << 1, l >> 1);
    const unsigned ev[3] = {e.up, eight ? e.ul : 0u, eight ? e.ur : 0u};
    for_each_event(ev, lane, [&](int which, int bit) {
      const int p = (y0 + bit) * W + x0;
      unite(L, p, p - 1 + dc(which, 1) * W);
    });
  }
}

// The root of v (background -1 stays) from its parent u = L[v], once no
// union is in flight. Plain loads: a thread's four first hops overlap.
__device__ __forceinline__ int walk(const int* L, int v, int u) {
  if (v < 0) return v;
  while (u != v) {
    v = u;
    u = L[v];
  }
  return v;
}

__global__ void k3_flatten(int* labels, int HW) {
  int* L = labels + (size_t)blockIdx.y * HW;
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (p >= HW) return;   // no warp collective in this kernel
  if ((HW & 3) == 0) {
    const int4 v = *reinterpret_cast<const int4*>(L + p);
    const int4 u = make_int4(v.x < 0 ? v.x : L[v.x], v.y < 0 ? v.y : L[v.y],
                             v.z < 0 ? v.z : L[v.z], v.w < 0 ? v.w : L[v.w]);
    const int4 r = make_int4(walk(L, v.x, u.x), walk(L, v.y, u.y),
                             walk(L, v.z, u.z), walk(L, v.w, u.w));
    if (r.x != v.x || r.y != v.y || r.z != v.z || r.w != v.w)
      *reinterpret_cast<int4*>(L + p) = r;
  } else {
    for (int i = 0; i < 4 && p + i < HW; ++i) {
      const int v = L[p + i];
      const int r = walk(L, v, v < 0 ? v : L[v]);
      if (r != v) L[p + i] = r;
    }
  }
}

// ---------------------------------------------------------------- K4 ------
// Slot of a pixel = min(rank of its root among all roots in raster order, K).
// Design: the rank is an exclusive count of roots, done with warp ballots
// (32 pixels per instruction) inside 1024-pixel chunks, one scan of the
// per-chunk counts per image, and a gather of the root's rank through the
// label. This equals the TPU version's segment-min + searchsorted
// (cc.py:135-142) and reads each label twice.

constexpr int CHUNK = 1024;

__global__ void k4_count(const int* __restrict__ labels, int HW,
                         int* chunk_counts, int nchunk) {
  __shared__ int warp_tot[CHUNK / 32];
  const int p = blockIdx.x * CHUNK + threadIdx.x;
  const size_t base = (size_t)blockIdx.y * HW;
  const bool root = p < HW && labels[base + p] == p;
  const unsigned b = __ballot_sync(FULL, root);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = __popc(b);
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = warp_tot[threadIdx.x];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (threadIdx.x == 0) chunk_counts[blockIdx.y * nchunk + blockIdx.x] = v;
  }
}

// One block of 1024 threads per image: exclusive scan of the chunk counts in
// place, then valid_root[k] = k < number of roots.
__global__ void k4_scan(int* chunk_counts, int nchunk, int K,
                        uint8_t* valid_root) {
  __shared__ int warp_sum[32];
  __shared__ int total;
  int* c = chunk_counts + blockIdx.x * nchunk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (nchunk + blockDim.x - 1) / blockDim.x;
  const int lo = min(t * per, nchunk), hi = min(lo + per, nchunk);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += c[i];
  int incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? warp_sum[lane] : 0;
    int wincl = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, wincl, o);
      if (lane >= o) wincl += v;
    }
    warp_sum[lane] = wincl - w;
    if (lane == 31) total = wincl;
  }
  __syncthreads();
  int run = warp_sum[warp] + incl - own;
  for (int i = lo; i < hi; ++i) {
    const int v = c[i];
    c[i] = run;
    run += v;
  }
  uint8_t* vr = valid_root + (size_t)blockIdx.x * K;
  for (int k = t; k < K; k += blockDim.x) vr[k] = k < total;
}

__global__ void k4_rank(const int* __restrict__ labels, int HW,
                        const int* __restrict__ chunk_offsets, int nchunk,
                        int* rank_at) {
  __shared__ int warp_tot[CHUNK / 32];
  const int p = blockIdx.x * CHUNK + threadIdx.x;
  const size_t base = (size_t)blockIdx.y * HW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool root = p < HW && labels[base + p] == p;
  const unsigned b = __ballot_sync(FULL, root);
  if (lane == 0) warp_tot[warp] = __popc(b);
  __syncthreads();
  if (root) {
    int r = chunk_offsets[blockIdx.y * nchunk + blockIdx.x] +
            __popc(b & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) r += warp_tot[w];
    rank_at[base + p] = r;
  }
}

__global__ void k4_assign(const int* __restrict__ labels,
                          const int* __restrict__ rank_at, int HW, int K,
                          int* keyed) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const size_t base = (size_t)blockIdx.y * HW;
  const int lab = labels[base + p];
  keyed[base + p] = lab >= 0 ? min(rank_at[base + lab], K) : K;
}

// ---------------------------------------------------------------- K5 ------
// Per-slot moments and a coarse-to-fine angle search over projected
// extents. Design: the bound is memory traffic plus atomics into the few
// addresses of a large component. Each thread walks RUN consecutive pixels
// and keeps running sums / minima / maxima in registers while the slot stays
// the same, flushing on a slot change; at the end a warp whose 32 threads
// all hold the same slot reduces by shuffles and one lane does the atomics.
// A large component therefore costs about one atomic per 512 pixels per
// value instead of one per pixel. Float minima and maxima go through an
// order-preserving int encoding (CUDA has no float atomicMin). Sums that
// depend on atomic order are taken exactly (int64 coordinate sums) or in
// f64 (prob and second moments), so the f32 results they are rounded to
// hardly ever change from run to run. Products and sums that feed the
// angle choice use __fmul_rn/__fadd_rn so that the compiler does not fuse
// them: the plain PyTorch version computes the same roundings, and the two
// pick the same candidate angle.

constexpr int RUN = 16;
constexpr int MAXA = 16;
constexpr float BIG = 1e9f;

__device__ __forceinline__ int f2o(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float o2f(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// True when all 32 lanes hold the same non-negative slot.
__device__ __forceinline__ bool warp_uniform(int cur) {
  const int lead = __shfl_sync(FULL, cur, 0);
  return __all_sync(FULL, cur == lead) && lead >= 0;
}

__global__ void k5_moments1(const int* __restrict__ keyed,
                            const float* __restrict__ prob, int HW, int W,
                            int K, int* cnt, double* psum,
                            unsigned long long* sx, unsigned long long* sy) {
  const size_t base = (size_t)blockIdx.y * HW;
  const size_t sbase = (size_t)blockIdx.y * K;
  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * RUN;
  int cur = -1, c = 0;
  double ps = 0.0;
  unsigned long long ax = 0, ay = 0;
  for (int j = 0; j < RUN; ++j) {
    const int p = p0 + j;
    if (p >= HW) break;
    const int s = keyed[base + p];
    if (s >= K) continue;
    if (s != cur) {
      if (cur >= 0) {
        atomicAdd(&cnt[sbase + cur], c);
        atomicAdd(&psum[sbase + cur], ps);
        atomicAdd(&sx[sbase + cur], ax);
        atomicAdd(&sy[sbase + cur], ay);
      }
      cur = s; c = 0; ps = 0.0; ax = 0; ay = 0;
    }
    c += 1;
    ps += (double)prob[base + p];
    ax += (unsigned long long)(p % W);
    ay += (unsigned long long)(p / W);
  }
  if (warp_uniform(cur)) {
    c = warp_sum(c); ps = warp_sum(ps); ax = warp_sum(ax); ay = warp_sum(ay);
    if ((threadIdx.x & 31) != 0) cur = -1;
  }
  if (cur >= 0) {
    atomicAdd(&cnt[sbase + cur], c);
    atomicAdd(&psum[sbase + cur], ps);
    atomicAdd(&sx[sbase + cur], ax);
    atomicAdd(&sy[sbase + cur], ay);
  }
}

__global__ void k5_center(const int* __restrict__ cnt,
                          const unsigned long long* __restrict__ sx,
                          const unsigned long long* __restrict__ sy, int K,
                          int NK, float* cx, float* cy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NK) return;
  const double n = (double)max(cnt[i], 1);
  cx[i] = (float)((double)sx[i] / n);
  cy[i] = (float)((double)sy[i] / n);
}

__global__ void k5_moments2(const int* __restrict__ keyed, int HW, int W,
                            int K, const float* __restrict__ cx,
                            const float* __restrict__ cy, double* sxx,
                            double* syy, double* sxy) {
  const size_t base = (size_t)blockIdx.y * HW;
  const size_t sbase = (size_t)blockIdx.y * K;
  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * RUN;
  int cur = -1;
  float mx = 0.f, my = 0.f;
  double axx = 0.0, ayy = 0.0, axy = 0.0;
  for (int j = 0; j < RUN; ++j) {
    const int p = p0 + j;
    if (p >= HW) break;
    const int s = keyed[base + p];
    if (s >= K) continue;
    if (s != cur) {
      if (cur >= 0) {
        atomicAdd(&sxx[sbase + cur], axx);
        atomicAdd(&syy[sbase + cur], ayy);
        atomicAdd(&sxy[sbase + cur], axy);
      }
      cur = s; axx = 0.0; ayy = 0.0; axy = 0.0;
      mx = cx[sbase + s]; my = cy[sbase + s];
    }
    const float dx = __fsub_rn((float)(p % W), mx);
    const float dy = __fsub_rn((float)(p / W), my);
    axx += (double)__fmul_rn(dx, dx);
    ayy += (double)__fmul_rn(dy, dy);
    axy += (double)__fmul_rn(dx, dy);
  }
  if (warp_uniform(cur)) {
    axx = warp_sum(axx); ayy = warp_sum(ayy); axy = warp_sum(axy);
    if ((threadIdx.x & 31) != 0) cur = -1;
  }
  if (cur >= 0) {
    atomicAdd(&sxx[sbase + cur], axx);
    atomicAdd(&syy[sbase + cur], ayy);
    atomicAdd(&sxy[sbase + cur], axy);
  }
}

__global__ void k5_theta(const double* __restrict__ sxx,
                         const double* __restrict__ syy,
                         const double* __restrict__ sxy, int NK,
                         float* theta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NK) return;
  const float xx = (float)sxx[i], yy = (float)syy[i], xy = (float)sxy[i];
  theta[i] = 0.5f * atan2f(2.0f * xy, __fsub_rn(xx, yy));
}

// Candidate angles theta + off[a] of one stage: their cos/sin table and the
// reset extent accumulators (umin, umax, vmin, vmax as ordered ints).
__global__ void k5_prepare(const float* __restrict__ theta,
                           const float* __restrict__ off, int A, int NK,
                           float* cs, int* ext) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NK) return;
  const float t = theta[i];
  for (int a = 0; a < A; ++a) {
    const float ang = __fadd_rn(t, off[a]);
    cs[((size_t)i * A + a) * 2] = cosf(ang);
    cs[((size_t)i * A + a) * 2 + 1] = sinf(ang);
    int* e = ext + ((size_t)i * A + a) * 4;
    e[0] = f2o(BIG);
    e[1] = f2o(-BIG);
    e[2] = f2o(BIG);
    e[3] = f2o(-BIG);
  }
}

__device__ __forceinline__ void flush_ext(int* e, int A, const float* umin,
                                          const float* umax,
                                          const float* vmin,
                                          const float* vmax) {
#pragma unroll
  for (int a = 0; a < MAXA; ++a) {
    if (a < A) {
      atomicMin(&e[a * 4 + 0], f2o(umin[a]));
      atomicMax(&e[a * 4 + 1], f2o(umax[a]));
      atomicMin(&e[a * 4 + 2], f2o(vmin[a]));
      atomicMax(&e[a * 4 + 3], f2o(vmax[a]));
    }
  }
}

__global__ void k5_extent(const int* __restrict__ keyed, int HW, int W, int K,
                          int A, const float* __restrict__ cx,
                          const float* __restrict__ cy,
                          const float* __restrict__ cs, int* ext) {
  const size_t base = (size_t)blockIdx.y * HW;
  const size_t sbase = (size_t)blockIdx.y * K;
  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * RUN;
  float umin[MAXA], umax[MAXA], vmin[MAXA], vmax[MAXA], c[MAXA], s[MAXA];
  int cur = -1;
  float mx = 0.f, my = 0.f;
  for (int j = 0; j < RUN; ++j) {
    const int p = p0 + j;
    if (p >= HW) break;
    const int sl = keyed[base + p];
    if (sl >= K) continue;
    if (sl != cur) {
      if (cur >= 0)
        flush_ext(ext + (sbase + cur) * A * 4, A, umin, umax, vmin, vmax);
      cur = sl;
      mx = cx[sbase + sl];
      my = cy[sbase + sl];
      const float* t = cs + (sbase + sl) * A * 2;
#pragma unroll
      for (int a = 0; a < MAXA; ++a) {
        if (a < A) {
          c[a] = t[2 * a];
          s[a] = t[2 * a + 1];
          umin[a] = BIG; umax[a] = -BIG; vmin[a] = BIG; vmax[a] = -BIG;
        }
      }
    }
    const float dx = __fsub_rn((float)(p % W), mx);
    const float dy = __fsub_rn((float)(p / W), my);
#pragma unroll
    for (int a = 0; a < MAXA; ++a) {
      if (a < A) {
        const float u = __fadd_rn(__fmul_rn(dx, c[a]), __fmul_rn(dy, s[a]));
        const float v = __fadd_rn(__fmul_rn(-dx, s[a]), __fmul_rn(dy, c[a]));
        umin[a] = fminf(umin[a], u);
        umax[a] = fmaxf(umax[a], u);
        vmin[a] = fminf(vmin[a], v);
        vmax[a] = fmaxf(vmax[a], v);
      }
    }
  }
  if (warp_uniform(cur)) {
#pragma unroll
    for (int a = 0; a < MAXA; ++a) {
      if (a < A) {
        umin[a] = warp_min(umin[a]);
        umax[a] = warp_max(umax[a]);
        vmin[a] = warp_min(vmin[a]);
        vmax[a] = warp_max(vmax[a]);
      }
    }
    if ((threadIdx.x & 31) != 0) cur = -1;
  }
  if (cur >= 0)
    flush_ext(ext + (sbase + cur) * A * 4, A, umin, umax, vmin, vmax);
}

// Tightest candidate (first minimum, as jnp.argmin) becomes the new angle.
__global__ void k5_pick(const int* __restrict__ ext,
                        const float* __restrict__ off, int A, int NK,
                        float* theta, float* best_ext) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NK) return;
  int best = 0;
  float best_area = 0.f;
  for (int a = 0; a < A; ++a) {
    const int* e = ext + ((size_t)i * A + a) * 4;
    const float area = __fmul_rn(__fsub_rn(o2f(e[1]), o2f(e[0])),
                                 __fsub_rn(o2f(e[3]), o2f(e[2])));
    if (a == 0 || area < best_area) {
      best_area = area;
      best = a;
    }
  }
  theta[i] = __fadd_rn(theta[i], off[best]);
  const int* e = ext + ((size_t)i * A + best) * 4;
  for (int j = 0; j < 4; ++j) best_ext[(size_t)i * 4 + j] = o2f(e[j]);
}

__global__ void k5_finish(const float* __restrict__ theta,
                          const float* __restrict__ best_ext,
                          const float* __restrict__ cx,
                          const float* __restrict__ cy,
                          const int* __restrict__ cnt,
                          const double* __restrict__ psum,
                          const uint8_t* __restrict__ valid_root,
                          const float* __restrict__ hole_sum,
                          const float* __restrict__ hole_cnt, int NK,
                          float* corners, float* sides, float* scores,
                          uint8_t* valid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NK) return;
  const float ang = theta[i];
  const float c = cosf(ang), s = sinf(ang);
  const float umin = best_ext[i * 4], umax = best_ext[i * 4 + 1];
  const float vmin = best_ext[i * 4 + 2], vmax = best_ext[i * 4 + 3];
  const float uc = __fadd_rn(umin, umax) / 2.0f;
  const float vc = __fadd_rn(vmin, vmax) / 2.0f;
  const float ctr_x = __fsub_rn(__fadd_rn(cx[i], __fmul_rn(uc, c)),
                                __fmul_rn(vc, s));
  const float ctr_y = __fadd_rn(__fadd_rn(cy[i], __fmul_rn(uc, s)),
                                __fmul_rn(vc, c));
  const float w = __fsub_rn(umax, umin), h = __fsub_rn(vmax, vmin);
  const float hw = w / 2.0f, hh = h / 2.0f;
  const float us[4] = {-hw, hw, hw, -hw};
  const float vs[4] = {-hh, -hh, hh, hh};
  for (int k = 0; k < 4; ++k) {
    corners[(size_t)i * 8 + 2 * k] =
        __fsub_rn(__fadd_rn(ctr_x, __fmul_rn(us[k], c)), __fmul_rn(vs[k], s));
    corners[(size_t)i * 8 + 2 * k + 1] =
        __fadd_rn(__fadd_rn(ctr_y, __fmul_rn(us[k], s)), __fmul_rn(vs[k], c));
  }
  sides[(size_t)i * 2] = w;
  sides[(size_t)i * 2 + 1] = h;
  // score over the component and the holes it encloses (K6)
  const float n = (float)cnt[i];
  const bool ok = valid_root[i] && n > 0.f;
  valid[i] = ok;
  const float denom = __fadd_rn(n, hole_cnt[i]);
  scores[i] = ok && denom > 0.f
                  ? __fadd_rn((float)psum[i], hole_sum[i]) / fmaxf(denom, 1.0f)
                  : 0.f;
}

// ---------------------------------------------------------------- K6 ------
// Holes = background components (4-connected, from K3/K4) that touch no
// image border; each routes its prob sum and pixel count to the enclosing
// foreground slot, the MIN fg slot among its pixels' 8-neighbours (a
// component nested in the hole has a later root, so a larger slot). Slot K
// is a real bucket here exactly as in the TPU version (fg pixels and
// overflow bg components share it). Design: bound by reading the three
// per-pixel maps; border and enclosing updates are skipped when they would
// not change the stored value, so the large outside background costs reads,
// not atomics; the hole sums use per-thread runs like K5.

__global__ void k6_scan(const uint8_t* __restrict__ mask,
                        const int* __restrict__ fg_keyed,
                        const int* __restrict__ bg_keyed, int H, int W, int K,
                        int* border, int* enclosing) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t base = (size_t)blockIdx.z * H * W;
  const size_t sbase = (size_t)blockIdx.z * (K + 1);
  const int p = y * W + x;
  const int key = bg_keyed[base + p];
  if (x == 0 || y == 0 || x == W - 1 || y == H - 1) {
    if (border[sbase + key] == 0) atomicMax(&border[sbase + key], 1);
  }
  if (mask[base + p]) return;
  int nb = K;
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = x + dx;
      if ((dx == 0 && dy == 0) || xx < 0 || xx >= W) continue;
      nb = min(nb, fg_keyed[base + yy * W + xx]);
    }
  }
  if (nb < K && enclosing[sbase + key] > nb)
    atomicMin(&enclosing[sbase + key], nb);
}

__global__ void k6_target(const int* __restrict__ border, int* enclosing,
                          int K, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int e = enclosing[i];
  enclosing[i] = (e < K && border[i] == 0) ? e : K;
}

__global__ void k6_accumulate(const uint8_t* __restrict__ mask,
                              const int* __restrict__ bg_keyed,
                              const int* __restrict__ target,
                              const float* __restrict__ prob, int HW, int K,
                              double* hole_sum, int* hole_cnt) {
  const size_t base = (size_t)blockIdx.y * HW;
  const size_t tbase = (size_t)blockIdx.y * (K + 1);
  const size_t sbase = (size_t)blockIdx.y * K;
  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * RUN;
  int cur = -1, c = 0;
  double ps = 0.0;
  for (int j = 0; j < RUN; ++j) {
    const int p = p0 + j;
    if (p >= HW) break;
    if (mask[base + p]) continue;
    const int t = target[tbase + bg_keyed[base + p]];
    if (t >= K) continue;
    if (t != cur) {
      if (cur >= 0) {
        atomicAdd(&hole_sum[sbase + cur], ps);
        atomicAdd(&hole_cnt[sbase + cur], c);
      }
      cur = t; c = 0; ps = 0.0;
    }
    c += 1;
    ps += (double)prob[base + p];
  }
  if (cur >= 0) {
    atomicAdd(&hole_sum[sbase + cur], ps);
    atomicAdd(&hole_cnt[sbase + cur], c);
  }
}

// ------------------------------------------------------------- K7, K8 -----
// The device half of the polygon postprocess (_device_poly_stats_single,
// cc.py:447-492) and the stats of the axis-aligned fast boxes
// (component_boxes, cc.py:147-178): per slot the pixel count, the prob sum
// and the integer bbox, and the MSB-first bit-pack of the binary map that
// the host traces contours on. Design: k7_stats reads the slot map and prob
// once, 8 B a pixel, which bounds it; the TPU version's six scatters into
// K + 1 slots become one pass in which each thread keeps a run of RUN
// pixels' count, sum and extremes in registers while the slot stays the
// same, and a warp whose lanes share one slot reduces by shuffles before a
// single lane does the atomics, as in K5. Coordinates are ints, so their
// minima and maxima are plain integer atomics, and the sum is f64 as in K5
// and K6. k7_pack writes one byte from eight mask bytes per thread, bound by
// reading the mask; a row is padded with zero bits to a whole byte.

__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ int warp_max_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Empty slots keep the TPU version's fill: count 0, sum 0, bbox [W, H, -1, -1].
__global__ void k7_init(int NK, int W, int H, int* cnt, double* psum,
                        int* bbox) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NK) return;
  cnt[i] = 0;
  psum[i] = 0.0;
  bbox[(size_t)i * 4] = W;
  bbox[(size_t)i * 4 + 1] = H;
  bbox[(size_t)i * 4 + 2] = -1;
  bbox[(size_t)i * 4 + 3] = -1;
}

__device__ __forceinline__ void flush_bbox(size_t at, int c, double ps, int x0,
                                           int y0, int x1, int y1, int* cnt,
                                           double* psum, int* bbox) {
  atomicAdd(&cnt[at], c);
  atomicAdd(&psum[at], ps);
  int* b = bbox + at * 4;
  atomicMin(&b[0], x0);
  atomicMin(&b[1], y0);
  atomicMax(&b[2], x1);
  atomicMax(&b[3], y1);
}

__global__ void k7_stats(const int* __restrict__ keyed,
                         const float* __restrict__ prob, int HW, int W, int K,
                         int* cnt, double* psum, int* bbox) {
  const size_t base = (size_t)blockIdx.y * HW;
  const size_t sbase = (size_t)blockIdx.y * K;
  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * RUN;
  int cur = -1, c = 0, x0 = 0, y0 = 0, x1 = -1, y1 = -1;
  double ps = 0.0;
  for (int j = 0; j < RUN; ++j) {
    const int p = p0 + j;
    if (p >= HW) break;
    const int s = keyed[base + p];
    if (s >= K) continue;
    const int x = p % W, y = p / W;
    if (s != cur) {
      if (cur >= 0) flush_bbox(sbase + cur, c, ps, x0, y0, x1, y1, cnt, psum,
                               bbox);
      cur = s; c = 0; ps = 0.0; x0 = x1 = x; y0 = y1 = y;
    }
    c += 1;
    ps += (double)prob[base + p];
    x0 = min(x0, x); x1 = max(x1, x);
    y0 = min(y0, y); y1 = max(y1, y);
  }
  if (warp_uniform(cur)) {
    c = warp_sum(c); ps = warp_sum(ps);
    x0 = warp_min_i(x0); y0 = warp_min_i(y0);
    x1 = warp_max_i(x1); y1 = warp_max_i(y1);
    if ((threadIdx.x & 31) != 0) cur = -1;
  }
  if (cur >= 0)
    flush_bbox(sbase + cur, c, ps, x0, y0, x1, y1, cnt, psum, bbox);
}

// One packed byte per thread: pixels 8b..8b+7 of a row, the first in the
// most significant bit (np.unpackbits' order), pixels past W as 0.
__global__ void k7_pack(const uint8_t* __restrict__ mask, uint8_t* packed,
                        int W, int W8, long total) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long row = i / W8;
  const int x0 = (int)(i % W8) * 8;
  const uint8_t* m = mask + row * W;
  unsigned v = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int x = x0 + b;
    v = (v << 1) | (x < W && m[x] ? 1u : 0u);
  }
  packed[i] = (uint8_t)v;
}

inline int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" {

// K3: labels (N,H,W) int32 from mask (N,H,W) uint8; conn is 4 or 8.
int cc_label(const uint8_t* mask, int* labels, int N, int H, int W, int conn,
             cudaStream_t stream) {
  const dim3 tiles(cdiv(W, TW), cdiv(H, TH), N);
  k3_local<<<tiles, TH * 32, 0, stream>>>(mask, labels, H, W, conn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3_merge<<<tiles, 64, 0, stream>>>(mask, labels, H, W, conn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int HW = H * W;
  k3_flatten<<<dim3(cdiv(HW, 4 * 256), N), 256, 0, stream>>>(labels, HW);
  return (int)cudaGetLastError();
}

// K4: keyed (N,HW) int32 and valid_root (N,K) uint8 from labels (N,HW).
// Scratch: chunk (N, ceil(HW/1024)) int32, rank_at (N,HW) int32.
int cc_compact(const int* labels, int* keyed, uint8_t* valid_root, int* chunk,
               int* rank_at, int N, int HW, int K, cudaStream_t stream) {
  const int nchunk = cdiv(HW, CHUNK);
  const dim3 grid(nchunk, N);
  k4_count<<<grid, CHUNK, 0, stream>>>(labels, HW, chunk, nchunk);
  k4_scan<<<N, 1024, 0, stream>>>(chunk, nchunk, K, valid_root);
  k4_rank<<<grid, CHUNK, 0, stream>>>(labels, HW, chunk, nchunk, rank_at);
  k4_assign<<<dim3(cdiv(HW, 256), N), 256, 0, stream>>>(labels, rank_at, HW,
                                                         K, keyed);
  return (int)cudaGetLastError();
}

// K6: hole_sum (N,K) f64 and hole_cnt (N,K) int32, both zeroed by the
// caller, from the fg mask, fg and bg slot maps and prob. Scratch: border
// (N,K+1) int32 zeroed, enclosing (N,K+1) int32 filled with K.
int cc_hole_route(const uint8_t* mask, const int* fg_keyed,
                  const int* bg_keyed, const float* prob, int* border,
                  int* enclosing, double* hole_sum, int* hole_cnt, int N,
                  int H, int W, int K, cudaStream_t stream) {
  const dim3 blk(32, 8);
  const dim3 grid(cdiv(W, 32), cdiv(H, 8), N);
  k6_scan<<<grid, blk, 0, stream>>>(mask, fg_keyed, bg_keyed, H, W, K, border,
                                    enclosing);
  const int total = N * (K + 1);
  k6_target<<<cdiv(total, 256), 256, 0, stream>>>(border, enclosing, K,
                                                  total);
  const int HW = H * W;
  k6_accumulate<<<dim3(cdiv(HW, 256 * RUN), N), 256, 0, stream>>>(
      mask, bg_keyed, enclosing, prob, HW, K, hole_sum, hole_cnt);
  return (int)cudaGetLastError();
}

// K5. offsets holds every stage's candidate offsets back to back
// (stage_sizes[s] of them for stage s). Scratch, zeroed by the caller: cnt
// (N,K) int32, psum/sxx/syy/sxy (N,K) f64, sx/sy (N,K) int64. Scratch, no
// init: cx, cy, theta (N,K) f32, cs (N,K,maxA,2) f32, ext (N,K,maxA,4)
// int32, best_ext (N,K,4) f32. hole_sum/hole_cnt (N,K) f32 from K6.
int cc_rot_boxes(const float* prob, const int* keyed,
                 const uint8_t* valid_root, const float* hole_sum,
                 const float* hole_cnt, const float* offsets,
                 const int* stage_sizes, int n_stages, int* cnt, double* psum,
                 unsigned long long* sx, unsigned long long* sy, double* sxx,
                 double* syy, double* sxy, float* cx, float* cy, float* theta,
                 float* cs, int* ext, float* best_ext, float* corners,
                 float* sides, float* scores, uint8_t* valid, int N, int H,
                 int W, int K, cudaStream_t stream) {
  for (int s = 0; s < n_stages; ++s)
    if (stage_sizes[s] < 1 || stage_sizes[s] > MAXA)
      return (int)cudaErrorInvalidValue;
  const int HW = H * W, NK = N * K;
  const dim3 pgrid(cdiv(HW, 256 * RUN), N);
  const int sblocks = cdiv(NK, 256);
  k5_moments1<<<pgrid, 256, 0, stream>>>(keyed, prob, HW, W, K, cnt, psum, sx,
                                         sy);
  k5_center<<<sblocks, 256, 0, stream>>>(cnt, sx, sy, K, NK, cx, cy);
  k5_moments2<<<pgrid, 256, 0, stream>>>(keyed, HW, W, K, cx, cy, sxx, syy,
                                         sxy);
  k5_theta<<<sblocks, 256, 0, stream>>>(sxx, syy, sxy, NK, theta);
  const float* off = offsets;
  for (int s = 0; s < n_stages; ++s) {
    const int A = stage_sizes[s];
    k5_prepare<<<sblocks, 256, 0, stream>>>(theta, off, A, NK, cs, ext);
    k5_extent<<<pgrid, 256, 0, stream>>>(keyed, HW, W, K, A, cx, cy, cs, ext);
    k5_pick<<<sblocks, 256, 0, stream>>>(ext, off, A, NK, theta, best_ext);
    off += A;
  }
  k5_finish<<<sblocks, 256, 0, stream>>>(theta, best_ext, cx, cy, cnt, psum,
                                         valid_root, hole_sum, hole_cnt, NK,
                                         corners, sides, scores, valid);
  return (int)cudaGetLastError();
}

// K7/K8 stats: cnt (N,K) int32, psum (N,K) f64 and bbox (N,K,4) int32
// [xmin, ymin, xmax, ymax] per slot of keyed (N,HW) over prob (N,HW); all
// three are filled here (no init by the caller).
int cc_bbox_stats(const int* keyed, const float* prob, int* cnt, double* psum,
                  int* bbox, int N, int H, int W, int K, cudaStream_t stream) {
  const int HW = H * W, NK = N * K;
  k7_init<<<cdiv(NK, 256), 256, 0, stream>>>(NK, W, H, cnt, psum, bbox);
  k7_stats<<<dim3(cdiv(HW, 256 * RUN), N), 256, 0, stream>>>(
      keyed, prob, HW, W, K, cnt, psum, bbox);
  return (int)cudaGetLastError();
}

// K7 bit-pack: packed (N,H,ceil(W/8)) uint8 from mask (N,H,W) uint8.
int cc_pack_bits(const uint8_t* mask, uint8_t* packed, int N, int H, int W,
                 cudaStream_t stream) {
  const int W8 = (W + 7) / 8;
  const long total = (long)N * H * W8;
  k7_pack<<<cdiv(total, 256), 256, 0, stream>>>(mask, packed, W, W8, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
