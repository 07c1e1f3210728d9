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
//   K7 cc_poly_stats, cc_pack_bits <- _device_poly_stats_single
//                       (cc.py:447-492), with K3, K4 and K6 around them;
//                       cc_bbox_stats, the same stats without the scores
//   K8 cc_bbox_stats <- component_boxes (cc.py:147-178), under fast_boxes
//                       (cc.py:506-521)
//
// Every pass reads each input pixel once or a few times and does a handful
// of integer or float operations on it, so all of them are bound by memory
// traffic (and by atomics into the few addresses of a large component), not
// by arithmetic. Each design note below says what the kernel does about
// that.
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
// Slot of a pixel = min(rank of its root among the image's roots in raster
// order, K); background K. Replaces _compact_slots
// (db_text_minimal_tpu/ops/pallas/cc.py:114-144), whose segment-min and
// searchsorted become a scan and a gather.
//
// Bound: 4 B of label in and 4 B of slot out per pixel, 0.0078 ms at
// 8x640x640 at the H100's 3.35 TB/s; a pixel costs a compare and a popc.
//
// K3's labels make the gather cheap: a pixel p is a root iff labels[p] == p,
// and every foreground label is a root. So a root's clamped rank is written
// in place into keyed[root], and every pixel then reads keyed[labels[p]]:
// no rank map, and min(min(r, K), K) = min(r, K). Two launches after one
// memset of the scratch:
//
// - k4_rank: a single-pass scan with decoupled look-back (Merrill and
//   Garland, 2016). A block of 1024 threads takes a tile of 16384 pixels,
//   16 a thread in four coalesced 16-byte loads (where the image is
//   aligned), so that the tiles of 8 maps of 640x640 all fit the card at
//   once; ballots and __popc count the roots of a warp, a warp scans the
//   128 (chunk, warp) counts. The
//   tile's index comes from a per-image ticket, not from blockIdx, so every
//   tile it waits on belongs to a block that is already running. The tile
//   publishes its count, then warp 0 reads its predecessors' status words
//   32 at a time back to the nearest inclusive prefix and publishes its
//   own; flag and count share one 64-bit word, so one store publishes both.
//   Roots then write their clamped rank into keyed; the image's last tile
//   writes valid_root[k] = k < the number of roots.
// - k4_assign: keyed[p] = labels[p] >= 0 ? keyed[labels[p]] : K, 4 pixels
//   a thread. A root reads and writes its own, unchanged value, and no
//   other pixel's slot is ever read, so the in-place gather has no race.

constexpr int K4_THREADS = 1024, K4_CHUNKS = 4;
constexpr int K4_CHUNK = 4 * K4_THREADS, K4_TILE = K4_CHUNKS * K4_CHUNK;
// a status word: the flag in the top two bits, the count in the low 32
constexpr unsigned long long K4_AGGREGATE = 1ull << 62,
                             K4_INCLUSIVE = 2ull << 62;

__device__ __forceinline__ unsigned long long k4_load(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}
__device__ __forceinline__ void k4_store(unsigned long long* p,
                                         unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// The sum of the counts of tiles [0, tile) of one image (status holds its
// words), read by warp 0 of the tile's block.
__device__ int k4_look_back(const unsigned long long* status, int tile) {
  const int lane = threadIdx.x & 31;
  int prefix = 0;
  for (int top = tile - 1;; top -= 32) {
    const int t = top - lane;
    // below tile 0 reads as an inclusive prefix of 0, so the walk ends
    unsigned long long s = t >= 0 ? k4_load(status + t) : K4_INCLUSIVE;
    while (__any_sync(FULL, (s >> 62) == 0))
      if ((s >> 62) == 0) s = k4_load(status + t);
    // the nearest inclusive prefix and every count after it
    const unsigned inclusive = __ballot_sync(FULL, (s >> 62) == 2);
    const int first = inclusive ? __ffs(inclusive) - 1 : 32;
    int v = lane <= first ? (int)(unsigned)s : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    prefix += v;
    if (inclusive) return prefix;
  }
}

// A tile is K4_CHUNKS chunks of 4 pixels a thread, so that each load
// instruction of a warp reads 512 neighbouring bytes; in raster order the
// (chunk, warp) pairs come chunk by chunk.
__global__ void __launch_bounds__(K4_THREADS)
k4_rank(const int* __restrict__ labels, int HW, int K, int ntiles, bool vec,
        unsigned long long* status, unsigned* tickets, int* keyed,
        uint8_t* valid_root) {
  __shared__ int warp_count[K4_CHUNKS * 32];
  __shared__ int tile_s, prefix_s, roots_s;
  const int n = blockIdx.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    tile_s = (int)atomicAdd(&tickets[n], 1u);
    roots_s = -1;
  }
  __syncthreads();
  const int tile = tile_s;
  const int* lab_base = labels + (size_t)n * HW;
  int* keyed_base = keyed + (size_t)n * HW;
  int lab[K4_CHUNKS][4];
#pragma unroll
  for (int c = 0; c < K4_CHUNKS; ++c) {
    const int p0 = tile * K4_TILE + c * K4_CHUNK + 4 * t;
    if (vec && p0 + 3 < HW) {
      const int4 v = *reinterpret_cast<const int4*>(lab_base + p0);
      lab[c][0] = v.x; lab[c][1] = v.y; lab[c][2] = v.z; lab[c][3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        lab[c][j] = p0 + j < HW ? lab_base[p0 + j] : -1;
    }
  }
  // ranks within the warp: lane l's pixels come after lanes 0..l-1's
  const unsigned below = (1u << lane) - 1u;
  int before[K4_CHUNKS];
#pragma unroll
  for (int c = 0; c < K4_CHUNKS; ++c) {
    const int p0 = tile * K4_TILE + c * K4_CHUNK + 4 * t;
    int count = 0;
    before[c] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned b = __ballot_sync(FULL, lab[c][j] == p0 + j);
      before[c] += __popc(b & below);
      count += __popc(b);
    }
    if (lane == 0) warp_count[c * 32 + warp] = count;
  }
  __syncthreads();
  if (warp == 0) {
    // lane l scans entries 4l .. 4l + 3 of the (chunk, warp) counts
    int e[4], sum = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = warp_count[4 * lane + i];
      sum += e[i];
    }
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - sum;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      warp_count[4 * lane + i] = run;
      run += e[i];
    }
    const int total = __shfl_sync(FULL, incl, 31);
    unsigned long long* st = status + (size_t)n * ntiles;
    if (lane == 0)
      k4_store(st + tile, (tile == 0 ? K4_INCLUSIVE : K4_AGGREGATE) |
                              (unsigned)total);
    const int prefix = tile == 0 ? 0 : k4_look_back(st, tile);
    if (lane == 0) {
      if (tile > 0)
        k4_store(st + tile, K4_INCLUSIVE | (unsigned)(prefix + total));
      prefix_s = prefix;
      if (tile == ntiles - 1) roots_s = prefix + total;
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < K4_CHUNKS; ++c) {
    const int p0 = tile * K4_TILE + c * K4_CHUNK + 4 * t;
    int rank = prefix_s + warp_count[c * 32 + warp] + before[c];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (lab[c][j] == p0 + j) keyed_base[p0 + j] = min(rank++, K);
  }
  if (roots_s >= 0) {   // the image's last tile
    uint8_t* vr = valid_root + (size_t)n * K;
    for (int k = t; k < K; k += K4_THREADS) vr[k] = k < roots_s;
  }
}

__global__ void k4_assign(const int* __restrict__ labels, int HW, int K,
                          bool vec, int* keyed) {
  const int p0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (p0 >= HW) return;
  const size_t base = (size_t)blockIdx.y * HW;
  int* slots = keyed + base;
  if (vec && p0 + 3 < HW) {
    int4 v = *reinterpret_cast<const int4*>(labels + base + p0);
    v.x = v.x >= 0 ? slots[v.x] : K;
    v.y = v.y >= 0 ? slots[v.y] : K;
    v.z = v.z >= 0 ? slots[v.z] : K;
    v.w = v.w >= 0 ? slots[v.w] : K;
    *reinterpret_cast<int4*>(slots + p0) = v;
  } else {
    for (int j = 0; j < 4 && p0 + j < HW; ++j) {
      const int lab = labels[base + p0 + j];
      slots[p0 + j] = lab >= 0 ? slots[lab] : K;
    }
  }
}

// ---------------------------------------------------------------- K5 ------
// Oriented min-rects of the slots. Replaces component_rotated_boxes with
// _rect_corners (db_text_minimal_tpu/ops/pallas/cc.py:181-320): per slot the
// pixel count, prob sum and centre, the PCA angle from the second moments, a
// coarse-to-fine search for the candidate angle whose rotated extents give
// the least area (13 candidates over +-45 degrees, then three stages of 5),
// the rectangle's corners and sides, and the mean prob over the component
// and the holes K6 routed to it.
//
// Bound: 8 B a pixel in (slot and prob) and 54 B a slot out, 0.0080 ms at
// 8x640x640 and K = 1000 at the H100's 3.35 TB/s; a pixel costs a dozen
// operations, so bytes bound it.
//
// Row extremes are exact. Within one row y of a slot, dx = fl(x - cx) is
// non-decreasing in x, fl(dx * c) is monotone in dx, and fl(a + b) is
// non-decreasing in a for a fixed b; so u = fl(fl(dx c) + fl(dy s)) and
// v = fl(fl(-dx s) + fl(dy c)) are monotone in x within the row, after
// rounding too. Every extent (umin, umax, vmin, vmax) at every candidate is
// therefore reached at the slot's leftmost or rightmost pixel of some row,
// and the extents over those two pixels of each row equal the extents over
// all of its pixels bit for bit. A slot needs at most 2 H points, whatever
// its pixel count.
//
// The design before this one ran, for each of the four stages, a pass over
// every pixel that projected it at each candidate and flushed 4 A atomics
// (52 in the coarse stage) into its slot's few words on every change of
// slot, from 96 floats of candidate state in registers: six passes over the
// slot map, 17 launches, 7 fills and a copy of the offsets from pageable
// host memory per call. Its extent passes took 0.69 of its 0.81 ms on an
// H100 at 8x640x640. What this design does instead:
//
// - k5_moments1, over the pixels: count, f64 prob sum, exact int64
//   coordinate sums and the slot's first and last row, from runs of RUN
//   pixels kept in registers and flushed on a change of slot; a warp whose
//   lanes hold one slot reduces by shuffles before one lane's atomics.
// - k5_rows, over the slots: the centre, and the row entries [ymin, ymax]
//   of the slot set to (W, -1), so the table (N, K, H) costs the sum of
//   the heights in writes, not N K H, and needs no host synchronisation.
// - k5_moments2, over the pixels: the f64 second moments as before, and
//   each run's leftmost and rightmost x by atomicMin/atomicMax into its
//   (slot, row) entry, flushed on a change of slot or row; at the end the
//   lanes of a warp that hold one (slot, row) reduce first
//   (__match_any_sync, __reduce_min_sync), so a row of a large component
//   takes about one atomic pair per warp that crosses it.
// - k5_search, over the slots: a warp runs all four stages of one slot on
//   its row extremes, with no pass over the pixels, no atomics and no
//   per-candidate tables in device memory. Lane (a, g) projects candidate a over rows
//   g, g + G, ... (G = 32 / A); the G lanes of a candidate combine by
//   shuffles; a butterfly over (area, a) gives the first minimum, as
//   jnp.argmin picks it; the finish writes corners, sides, score and valid.
//   A slot of more than K5_TALL rows (a spiral, a served map's one giant
//   component) takes its block's eight warps, which combine each stage's
//   extents through shared memory between two barriers. A slot's row
//   extremes are read into shared memory once and serve all four stages.
//   A slot without a pixel (most of the K) skips the search: every area
//   ties, so the first candidate of each stage wins.
//
// Five operations on the caller's stream (a memset of the accumulators and
// four kernels), no allocation, no host synchronisation; the candidate
// offsets travel by value in the search's parameters. Sums taken in atomic
// order are exact (int64) or f64, and the products and sums that choose the
// angle use __fmul_rn/__fadd_rn so that the compiler fuses none of them:
// the plain PyTorch version computes the same roundings and picks the same
// angles.

constexpr int RUN = 16;
constexpr float BIG = 1e9f;
constexpr int K5_MAX_STAGES = 8, K5_MAX_OFFSETS = 64;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ int warp_max_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// True when all 32 lanes hold the same non-negative slot.
__device__ __forceinline__ bool warp_uniform(int cur) {
  const int lead = __shfl_sync(FULL, cur, 0);
  return __all_sync(FULL, cur == lead) && lead >= 0;
}

// The candidate offsets of every stage, back to back.
struct K5Stages {
  int n;
  int size[K5_MAX_STAGES];
  float off[K5_MAX_OFFSETS];
};

// Per-slot scratch, (N, K) each but the row table (N, K, H). The sums,
// counts and row bounds are zeroed by the memset; the bounds are kept as
// ylo = max(H - y) and yhi = max(y + 1), so 0 means no pixel.
struct K5Slots {
  int2* rows;                    // per row: leftmost and rightmost x
  double *psum, *sxx, *syy, *sxy;
  unsigned long long *sx, *sy;
  int *cnt, *ylo, *yhi;
  float *cx, *cy;
};

__host__ __device__ inline size_t k5_zeroed_bytes(size_t NK) {
  return NK * (6 * 8 + 3 * 4);
}

inline K5Slots k5_slots(void* scratch, int N, int H, int K) {
  const size_t NK = (size_t)N * K;
  K5Slots t;
  t.rows = static_cast<int2*>(scratch);
  double* d = reinterpret_cast<double*>(t.rows + NK * H);
  t.psum = d;
  t.sxx = d + NK;
  t.syy = d + 2 * NK;
  t.sxy = d + 3 * NK;
  t.sx = reinterpret_cast<unsigned long long*>(d + 4 * NK);
  t.sy = reinterpret_cast<unsigned long long*>(d + 5 * NK);
  int* i = reinterpret_cast<int*>(d + 6 * NK);
  t.cnt = i;
  t.ylo = i + NK;
  t.yhi = i + 2 * NK;
  t.cx = reinterpret_cast<float*>(i + 3 * NK);
  t.cy = t.cx + NK;
  return t;
}

__device__ __forceinline__ void flush_moments1(const K5Slots& t, size_t at,
                                               int H, int c, double ps,
                                               unsigned long long ax,
                                               unsigned long long ay, int y0,
                                               int y1) {
  atomicAdd(&t.cnt[at], c);
  atomicAdd(&t.psum[at], ps);
  atomicAdd(&t.sx[at], ax);
  atomicAdd(&t.sy[at], ay);
  atomicMax(&t.ylo[at], H - y0);
  atomicMax(&t.yhi[at], y1 + 1);
}

__global__ void k5_moments1(const int* __restrict__ keyed,
                            const float* __restrict__ prob, int H, int W,
                            int K, const __grid_constant__ K5Slots t) {
  const int HW = H * W;
  const size_t base = (size_t)blockIdx.y * HW;
  const size_t sbase = (size_t)blockIdx.y * K;
  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * RUN;
  int cur = -1, c = 0, y0 = 0, y1 = 0;
  double ps = 0.0;
  unsigned long long ax = 0, ay = 0;
  int x = p0 % W, y = p0 / W;
  for (int j = 0; j < RUN; ++j, ++x) {
    if (x == W) {
      x = 0;
      ++y;
    }
    const int p = p0 + j;
    if (p >= HW) break;
    const int s = keyed[base + p];
    if ((unsigned)s >= (unsigned)K) continue;
    if (s != cur) {
      if (cur >= 0) flush_moments1(t, sbase + cur, H, c, ps, ax, ay, y0, y1);
      cur = s; c = 0; ps = 0.0; ax = 0; ay = 0; y0 = y;
    }
    c += 1;
    ps += (double)prob[base + p];
    ax += (unsigned long long)x;
    ay += (unsigned long long)y;
    y1 = y;
  }
  // every lane reaches the collectives, those past the image too
  if (warp_uniform(cur)) {
    c = warp_sum(c); ps = warp_sum(ps); ax = warp_sum(ax); ay = warp_sum(ay);
    y0 = warp_min_i(y0); y1 = warp_max_i(y1);
    if ((threadIdx.x & 31) != 0) cur = -1;
  }
  if (cur >= 0) flush_moments1(t, sbase + cur, H, c, ps, ax, ay, y0, y1);
}

// A warp per slot: its centre (as the plain version rounds it), and its
// row entries [ymin, ymax] set to (W, -1), an empty row.
__global__ void k5_rows(int H, int W, int NK,
                        const __grid_constant__ K5Slots t) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= NK) return;   // no warp collective in this kernel
  const int n = t.cnt[i];
  if (lane == 0) {
    const double d = (double)max(n, 1);
    t.cx[i] = (float)((double)t.sx[i] / d);
    t.cy[i] = (float)((double)t.sy[i] / d);
  }
  if (n == 0) return;
  int2* r = t.rows + (size_t)i * H;
  const int end = t.yhi[i];
  for (int y = H - t.ylo[i] + lane; y < end; y += 32) r[y] = make_int2(W, -1);
}

__device__ __forceinline__ void flush_row(const K5Slots& t, size_t at, int H,
                                          int y, int x0, int x1) {
  int* e = reinterpret_cast<int*>(t.rows + at * H + y);
  atomicMin(&e[0], x0);
  atomicMax(&e[1], x1);
}

__device__ __forceinline__ void flush_moments2(const K5Slots& t, size_t at,
                                               double axx, double ayy,
                                               double axy) {
  atomicAdd(&t.sxx[at], axx);
  atomicAdd(&t.syy[at], ayy);
  atomicAdd(&t.sxy[at], axy);
}

__global__ void k5_moments2(const int* __restrict__ keyed, int H, int W,
                            int K, const __grid_constant__ K5Slots t) {
  const int HW = H * W;
  const size_t base = (size_t)blockIdx.y * HW;
  const size_t sbase = (size_t)blockIdx.y * K;
  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * RUN;
  int cur = -1, row = 0, x0 = 0, x1 = 0;
  float mx = 0.f, my = 0.f;
  double axx = 0.0, ayy = 0.0, axy = 0.0;
  int x = p0 % W, y = p0 / W;
  for (int j = 0; j < RUN; ++j, ++x) {
    if (x == W) {
      x = 0;
      ++y;
    }
    const int p = p0 + j;
    if (p >= HW) break;
    const int s = keyed[base + p];
    if ((unsigned)s >= (unsigned)K) continue;
    if (s != cur || y != row) {
      if (cur >= 0) flush_row(t, sbase + cur, H, row, x0, x1);
      if (s != cur) {
        if (cur >= 0) flush_moments2(t, sbase + cur, axx, ayy, axy);
        cur = s; axx = 0.0; ayy = 0.0; axy = 0.0;
        mx = t.cx[sbase + s]; my = t.cy[sbase + s];
      }
      row = y;
      x0 = x;
    }
    x1 = x;
    const float dx = __fsub_rn((float)x, mx);
    const float dy = __fsub_rn((float)y, my);
    axx += (double)__fmul_rn(dx, dx);
    ayy += (double)__fmul_rn(dy, dy);
    axy += (double)__fmul_rn(dx, dy);
  }
  // every lane reaches the collectives, those past the image too: the
  // lanes that end in one (slot, row) take its extremes together
  const unsigned same = __match_any_sync(FULL, cur >= 0 ? cur * H + row : -1);
  x0 = __reduce_min_sync(same, x0);
  x1 = __reduce_max_sync(same, x1);
  if (cur >= 0 && (threadIdx.x & 31) == __ffs(same) - 1)
    flush_row(t, sbase + cur, H, row, x0, x1);
  if (warp_uniform(cur)) {
    axx = warp_sum(axx); ayy = warp_sum(ayy); axy = warp_sum(axy);
    if ((threadIdx.x & 31) != 0) cur = -1;
  }
  if (cur >= 0) flush_moments2(t, sbase + cur, axx, ayy, axy);
}

constexpr int K5_WARPS = 8;   // slots a block of k5_search
// A slot of more rows than this takes the whole block, not one warp.
constexpr int K5_TALL = 64;
// Rows of a tall slot's span that the block stages in shared memory.
constexpr int K5_STAGED = 1024;
static_assert(K5_WARPS * K5_TALL <= K5_STAGED, "a warp's rows must fit");

__device__ __forceinline__ int k5_height(const K5Slots& t, size_t i, int H) {
  return t.cnt[i] > 0 ? t.yhi[i] - (H - t.ylo[i]) : 0;
}

// The four stages and the finish of slot i, by one warp (BLOCK false) or
// by the block's K5_WARPS warps together (BLOCK true: every thread of the
// block calls it, and part holds each warp's extents between barriers).
// The slot's row extremes are read once into shared memory (cache: the
// warp's K5_TALL entries, or the block's K5_STAGED), and the four stages
// read them from there.
template <bool BLOCK>
__device__ __forceinline__ void k5_slot(
    size_t i, int H, const K5Stages& st, const K5Slots& t,
    const uint8_t* __restrict__ valid_root,
    const float* __restrict__ hole_sum, const float* __restrict__ hole_cnt,
    float* __restrict__ corners, float* __restrict__ sides,
    float* __restrict__ scores, uint8_t* __restrict__ valid,
    float (*part)[32][4], int2* cache) {
  const int lane = threadIdx.x & 31;
  const int warp = BLOCK ? threadIdx.x >> 5 : 0;
  const int warps = BLOCK ? K5_WARPS : 1;
  const int n = t.cnt[i];
  const float mx = t.cx[i], my = t.cy[i];
  const float xx = (float)t.sxx[i], yy = (float)t.syy[i];
  const float xy = (float)t.sxy[i];
  float theta = 0.5f * atan2f(2.0f * xy, __fsub_rn(xx, yy));
  const int y0 = n > 0 ? H - t.ylo[i] : 0;
  const int y1 = n > 0 ? t.yhi[i] - 1 : -1;
  const int2* rows = t.rows + i * H;
  const int span = min(y1 - y0 + 1, BLOCK ? K5_STAGED : K5_TALL);
  for (int q = BLOCK ? threadIdx.x : lane; q < span;
       q += BLOCK ? K5_WARPS * 32 : 32)
    cache[q] = rows[y0 + q];
  if (BLOCK)
    __syncthreads();
  else
    __syncwarp();
  float umin = BIG, umax = -BIG, vmin = BIG, vmax = -BIG;
  for (int stage = 0, first = 0; stage < st.n; first += st.size[stage++]) {
    if (n == 0) {   // no pixel: every area ties, so the first candidate wins
      theta = __fadd_rn(theta, st.off[first]);
      continue;
    }
    const int A = st.size[stage], G = 32 / A;
    const int a = lane % A, g = lane / A;
    const float off = st.off[first + a];
    const float ang = __fadd_rn(theta, off);
    const float c = cosf(ang), s = sinf(ang);
    float u0 = BIG, u1 = -BIG, v0 = BIG, v1 = -BIG;
    // rows y0 + q, y0 + q + Q, ... for part q = warp G + g of Q = warps G
#pragma unroll 4
    for (int y = y0 + warp * G + g; g < G && y <= y1; y += warps * G) {
      const int2 r = y - y0 < span ? cache[y - y0] : rows[y];
      if (r.x > r.y) continue;   // a row of the slot's span without a pixel
      const float dy = __fsub_rn((float)y, my);
      const float dys = __fmul_rn(dy, s), dyc = __fmul_rn(dy, c);
      const float dl = __fsub_rn((float)r.x, mx);
      const float dr = __fsub_rn((float)r.y, mx);
      const float ul = __fadd_rn(__fmul_rn(dl, c), dys);
      const float ur = __fadd_rn(__fmul_rn(dr, c), dys);
      const float vl = __fadd_rn(__fmul_rn(-dl, s), dyc);
      const float vr = __fadd_rn(__fmul_rn(-dr, s), dyc);
      u0 = fminf(u0, fminf(ul, ur));
      u1 = fmaxf(u1, fmaxf(ul, ur));
      v0 = fminf(v0, fminf(vl, vr));
      v1 = fmaxf(v1, fmaxf(vl, vr));
    }
    // lane a < A takes in the partial extents of lanes a + A j, j < G
    const float p0 = u0, p1 = u1, p2 = v0, p3 = v1;
    for (int j = 1; j < G; ++j) {
      const int src = (lane + A * j) & 31;
      u0 = fminf(u0, __shfl_sync(FULL, p0, src));
      u1 = fmaxf(u1, __shfl_sync(FULL, p1, src));
      v0 = fminf(v0, __shfl_sync(FULL, p2, src));
      v1 = fmaxf(v1, __shfl_sync(FULL, p3, src));
    }
    if (BLOCK) {   // and the same lane of the other warps
      if (lane < A) {
        part[warp][lane][0] = u0;
        part[warp][lane][1] = u1;
        part[warp][lane][2] = v0;
        part[warp][lane][3] = v1;
      }
      __syncthreads();
      if (lane < A) {
        for (int w = 0; w < K5_WARPS; ++w) {
          u0 = fminf(u0, part[w][lane][0]);
          u1 = fmaxf(u1, part[w][lane][1]);
          v0 = fminf(v0, part[w][lane][2]);
          v1 = fmaxf(v1, part[w][lane][3]);
        }
      }
      __syncthreads();
    }
    // the first candidate of least area, on every lane
    float area = __int_as_float(0x7f800000);
    int best = 32;
    if (lane < A) {
      area = __fmul_rn(__fsub_rn(u1, u0), __fsub_rn(v1, v0));
      best = lane;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float oa = __shfl_xor_sync(FULL, area, o);
      const int ob = __shfl_xor_sync(FULL, best, o);
      if (oa < area || (oa == area && ob < best)) {
        area = oa;
        best = ob;
      }
    }
    theta = __fadd_rn(theta, __shfl_sync(FULL, off, best));
    umin = __shfl_sync(FULL, u0, best);
    umax = __shfl_sync(FULL, u1, best);
    vmin = __shfl_sync(FULL, v0, best);
    vmax = __shfl_sync(FULL, v1, best);
  }
  if (lane != 0 || warp != 0) return;
  const float c = cosf(theta), s = sinf(theta);
  const float uc = __fadd_rn(umin, umax) / 2.0f;
  const float vc = __fadd_rn(vmin, vmax) / 2.0f;
  const float ctr_x = __fsub_rn(__fadd_rn(mx, __fmul_rn(uc, c)),
                                __fmul_rn(vc, s));
  const float ctr_y = __fadd_rn(__fadd_rn(my, __fmul_rn(uc, s)),
                                __fmul_rn(vc, c));
  const float w = __fsub_rn(umax, umin), h = __fsub_rn(vmax, vmin);
  const float hw = w / 2.0f, hh = h / 2.0f;
  const float us[4] = {-hw, hw, hw, -hw};
  const float vs[4] = {-hh, -hh, hh, hh};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    corners[i * 8 + 2 * q] =
        __fsub_rn(__fadd_rn(ctr_x, __fmul_rn(us[q], c)), __fmul_rn(vs[q], s));
    corners[i * 8 + 2 * q + 1] =
        __fadd_rn(__fadd_rn(ctr_y, __fmul_rn(us[q], s)), __fmul_rn(vs[q], c));
  }
  sides[i * 2] = w;
  sides[i * 2 + 1] = h;
  // score over the component and the holes it encloses (K6)
  const float nf = (float)n;
  const bool ok = valid_root[i] && nf > 0.f;
  valid[i] = ok;
  const float denom = __fadd_rn(nf, hole_cnt[i]);
  scores[i] = ok && denom > 0.f
                  ? __fadd_rn((float)t.psum[i], hole_sum[i]) /
                        fmaxf(denom, 1.0f)
                  : 0.f;
}

// A block takes K5_WARPS slots: a warp each for those of at most K5_TALL
// rows, then, after a barrier, the whole block for each taller one in turn
// (each warp marks its slot tall or not in shared memory first, so that
// the block reads its slots' heights from device memory once).
__global__ void __launch_bounds__(K5_WARPS * 32)
k5_search(const uint8_t* __restrict__ valid_root,
          const float* __restrict__ hole_sum,
          const float* __restrict__ hole_cnt, int H, int K,
          const __grid_constant__ K5Stages st,
          const __grid_constant__ K5Slots t, float* __restrict__ corners,
          float* __restrict__ sides, float* __restrict__ scores,
          uint8_t* __restrict__ valid) {
  __shared__ float part[K5_WARPS][32][4];
  __shared__ int2 cache[K5_STAGED];
  __shared__ bool tall[K5_WARPS];
  const int slots = min(K5_WARPS, K - (int)blockIdx.x * K5_WARPS);
  const size_t first = (size_t)blockIdx.y * K + blockIdx.x * K5_WARPS;
  const int warp = threadIdx.x >> 5;
  const bool own_tall =
      warp < slots && k5_height(t, first + warp, H) > K5_TALL;
  if ((threadIdx.x & 31) == 0) tall[warp] = own_tall;
  if (warp < slots && !own_tall)
    k5_slot<false>(first + warp, H, st, t, valid_root, hole_sum, hole_cnt,
                   corners, sides, scores, valid, nullptr,
                   cache + warp * K5_TALL);
  __syncthreads();
  for (int w = 0; w < slots; ++w)   // the same branch on every thread
    if (tall[w])
      k5_slot<true>(first + w, H, st, t, valid_root, hole_sum, hole_cnt,
                    corners, sides, scores, valid, part, cache);
}

// ---------------------------------------------------------------- K6 ------
// Holes = background components (4-connected, from K3/K4) that touch no
// image border; each routes its prob sum and pixel count to the enclosing
// foreground slot, the MIN fg slot among its pixels' 8-neighbours (a
// component nested in the hole has a later root, so a larger slot). Bg slot
// K is a real bucket exactly as in the TPU version: overflow bg components
// share it and route to their common enclosing slot. Replaces _hole_stats
// (db_text_minimal_tpu/ops/pallas/cc.py:383-444).
//
// Bound: 1 B of mask and 4 B of each slot map in per pixel, 4 B of prob per
// hole pixel, 8 B a slot out: 0.0092 ms at 8x640x640 and K = 1000 at the
// H100's 3.35 TB/s. A pixel costs a few compares, so bytes bound it.
//
// Two passes over the pixels. Each thread loads all its pixels before it
// uses any, keeps a run while the slot stays the same, and a warp whose
// lanes with a run share one slot reduces it to one lane before any atomic.
// One memset zeroes the scratch that both passes accumulate into:
//
// - k6_scan: a tile of 32 columns by 32 rows, a block of 32x8 threads, each
//   thread a strip of 4 rows of one column. It stages the tile's fg slots
//   with a 1-pixel halo in shared memory (34x34 words for 1024 pixels) and
//   takes each bg pixel's 8-neighbour min from column minima there. Per bg
//   slot it keeps {border touched, K - enclosing}: 0 stands for "none
//   yet", so the memset is the fill. A slot is updated only where that
//   would change the stored value, so the large outside background costs
//   reads, not atomics.
// - k6_accumulate: 8 pixels a thread in two groups of 4 neighbours (4-byte
//   mask and 16-byte slot loads). Each bg pixel's target is taken from that
//   table as the pixel is read (enclosing where it is a slot and the
//   component touches no border, else none), so the target step needs no
//   launch of its own. Hole pixels add prob (f64) and 1 to their target's
//   sums. The last block of each image, by a counter in the scratch,
//   converts the image's sums to the f32 outputs, so there are no fills
//   and casts around the kernels.
//
// One pass that sums prob per bg slot and routes the K + 1 slot sums in
// each image's last block is slower on the H100 (0.033-0.036 ms against
// 0.028-0.029 on 8x640x640): it reads prob at every bg pixel, its per-slot
// atomics meet on the outside background and slot K, and the route runs
// serially after every other block.

constexpr int K6_TX = 32, K6_TY = 8, K6_STRIP = 4, K6_TH = K6_TY * K6_STRIP;

// The scratch of cc_hole_route, one buffer zeroed by one memset.
struct K6Scratch {
  double* sum;       // (N, K) hole prob sums
  int2* table;       // (N, K + 1) per bg slot {border touched, K - enclosing}
  int* cnt;          // (N, K) hole pixel counts
  unsigned* done;    // (N) blocks of the image through k6_accumulate
};

size_t k6_scratch_bytes(int N, int K) {
  const size_t NK = (size_t)N * K;
  return NK * sizeof(double) + (NK + N) * sizeof(int2) + NK * sizeof(int) +
         N * sizeof(unsigned);
}

K6Scratch k6_scratch(void* base, int N, int K) {
  const size_t NK = (size_t)N * K;
  K6Scratch s;
  s.sum = static_cast<double*>(base);
  s.table = reinterpret_cast<int2*>(s.sum + NK);
  s.cnt = reinterpret_cast<int*>(s.table + NK + N);
  s.done = reinterpret_cast<unsigned*>(s.cnt + NK);
  return s;
}

// The slot that every lane with a run (cur >= 0) holds; -1 where those
// lanes differ or no lane has a run.
__device__ __forceinline__ int k6_common(int cur) {
  const int lo = __reduce_min_sync(FULL, cur >= 0 ? cur : 0x7fffffff);
  const int hi = __reduce_max_sync(FULL, cur);
  return lo == hi ? lo : -1;
}

__device__ __forceinline__ void k6_enclose(int2* tab, int slot, int best,
                                           int K) {
  if (slot >= 0 && best < K && tab[slot].y < K - best)
    atomicMax(&tab[slot].y, K - best);
}

__global__ void __launch_bounds__(K6_TX * K6_TY)
k6_scan(const uint8_t* __restrict__ mask, const int* __restrict__ fg_keyed,
        const int* __restrict__ bg_keyed, int H, int W, int K, int2* table) {
  __shared__ int halo[K6_TH + 2][K6_TX + 2];
  const int x0 = blockIdx.x * K6_TX, y0 = blockIdx.y * K6_TH;
  const size_t base = (size_t)blockIdx.z * H * W;
  int2* tab = table + (size_t)blockIdx.z * (K + 1);
  const int tx = threadIdx.x, x = x0 + tx, r0 = threadIdx.y * K6_STRIP;
  // the strip's own pixels first, so that their loads overlap the halo's;
  // a pixel past the image reads as foreground off the border
  bool bg[K6_STRIP];
  int key[K6_STRIP];
#pragma unroll
  for (int j = 0; j < K6_STRIP; ++j) {
    const int y = y0 + r0 + j;
    const bool in = x < W && y < H;
    const size_t p = base + (size_t)y * W + x;
    bg[j] = in && !mask[p];
    key[j] = in ? bg_keyed[p] : 0;
  }
  for (int i = threadIdx.y * K6_TX + tx; i < (K6_TH + 2) * (K6_TX + 2);
       i += K6_TX * K6_TY) {
    const int hy = i / (K6_TX + 2), hx = i - hy * (K6_TX + 2);
    const int y = y0 + hy - 1, xx = x0 + hx - 1;
    halo[hy][hx] = y >= 0 && y < H && xx >= 0 && xx < W
                       ? fg_keyed[base + (size_t)y * W + xx]
                       : K;
  }
  __syncthreads();
  // rows r0 - 1 .. r0 + K6_STRIP of the column and its two neighbours: the
  // min over all three columns, and over the two side columns only
  int m3[K6_STRIP + 2], side[K6_STRIP + 2];
#pragma unroll
  for (int i = 0; i < K6_STRIP + 2; ++i) {
    const int* row = halo[r0 + i];
    side[i] = min(row[tx], row[tx + 2]);
    m3[i] = min(side[i], row[tx + 1]);
  }
  int cur = -1, best = K;
#pragma unroll
  for (int j = 0; j < K6_STRIP; ++j) {
    const int y = y0 + r0 + j;
    if (x < W && y < H && (x == 0 || y == 0 || x == W - 1 || y == H - 1) &&
        tab[key[j]].x == 0)
      atomicExch(&tab[key[j]].x, 1);
    if (!bg[j]) continue;
    if (key[j] != cur) {
      k6_enclose(tab, cur, best, K);
      cur = key[j];
      best = K;
    }
    best = min(best, min(min(m3[j], m3[j + 2]), side[j + 1]));
  }
  const int common = k6_common(cur);
  if (common >= 0) {
    best = __reduce_min_sync(FULL, cur >= 0 ? best : K);
    cur = (threadIdx.x & 31) == 0 ? common : -1;
  }
  k6_enclose(tab, cur, best, K);
}

// k6_accumulate: K6_GROUPS groups of 4 neighbouring pixels a thread, each
// one 4-byte mask load and one 16-byte slot load where the image is
// aligned; a warp's group covers 128 neighbouring pixels.
constexpr int K6_THREADS = 256, K6_GROUPS = 2;
constexpr int K6_BLOCK_PX = 4 * K6_GROUPS * K6_THREADS;

__global__ void __launch_bounds__(K6_THREADS)
k6_accumulate(const uint8_t* __restrict__ mask,
              const int* __restrict__ bg_keyed,
              const float* __restrict__ prob,
              const int2* __restrict__ table, int HW, int K, bool vec,
              K6Scratch s, float* hole_sum, float* hole_cnt) {
  __shared__ bool last;
  const size_t base = (size_t)blockIdx.y * HW;
  const size_t sbase = (size_t)blockIdx.y * K;
  const int2* tab = table + (size_t)blockIdx.y * (K + 1);
  const int t = threadIdx.x;
  // every pixel's target (K for foreground, past the image, and bg
  // components that are not holes), all loads issued before any is used
  int target[4 * K6_GROUPS];
#pragma unroll
  for (int g = 0; g < K6_GROUPS; ++g) {
    const int p0 = blockIdx.x * K6_BLOCK_PX + (g * K6_THREADS + t) * 4;
    unsigned m = 0;   // byte j: pixel p0 + j is foreground or past the image
    int keys[4];
    if (vec && p0 + 3 < HW) {
      m = *reinterpret_cast<const unsigned*>(mask + base + p0);
      const int4 v = *reinterpret_cast<const int4*>(bg_keyed + base + p0);
      keys[0] = v.x; keys[1] = v.y; keys[2] = v.z; keys[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = p0 + j < HW;
        m |= (in ? mask[base + p0 + j] : 1u) << (8 * j);
        keys[j] = in ? bg_keyed[base + p0 + j] : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int2 e = make_int2(1, 0);
      if (((m >> (8 * j)) & 0xff) == 0) e = tab[keys[j]];
      target[4 * g + j] = e.y > 0 && e.x == 0 ? K - e.y : K;
    }
  }
  int cur = -1, c = 0;
  double ps = 0.0;
#pragma unroll
  for (int i = 0; i < 4 * K6_GROUPS; ++i) {
    if (target[i] >= K) continue;
    const int p = blockIdx.x * K6_BLOCK_PX + ((i / 4) * K6_THREADS + t) * 4 +
                  i % 4;
    if (target[i] != cur) {
      if (cur >= 0) {
        atomicAdd(&s.sum[sbase + cur], ps);
        atomicAdd(&s.cnt[sbase + cur], c);
      }
      cur = target[i];
      c = 0;
      ps = 0.0;
    }
    c += 1;
    ps += (double)prob[base + p];
  }
  const int common = k6_common(cur);
  if (common >= 0) {
    c = warp_sum(c);
    ps = warp_sum(ps);
    cur = (t & 31) == 0 ? common : -1;
  }
  if (cur >= 0) {
    atomicAdd(&s.sum[sbase + cur], ps);
    atomicAdd(&s.cnt[sbase + cur], c);
  }
  // the image's last block to finish writes its f32 outputs
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(&s.done[blockIdx.y], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = t; k < K; k += K6_THREADS) {
    hole_sum[sbase + k] = (float)__ldcg(&s.sum[sbase + k]);
    hole_cnt[sbase + k] = (float)__ldcg(&s.cnt[sbase + k]);
  }
}

// ------------------------------------------------------------- K7, K8 -----
// The device half of the polygon postprocess (_device_poly_stats_single,
// cc.py:447-492) and the stats of the axis-aligned fast boxes
// (component_boxes, cc.py:147-178): per slot the pixel count, the prob sum
// and the integer bbox, with the polygon path's hole-filled score and valid
// flag folded in, and the MSB-first bit-pack of the binary map that the
// host traces contours on.
//
// k7_stats reads the slot map and prob once, 8 B a pixel, which bounds it
// (0.0079 ms at 8x640x640 at 3.35 TB/s). The design before this one gave
// each thread a run of 16 pixels (a warp's lanes 64 B apart on every
// load), loaded prob only after the slot, paid a % and a / by W a pixel,
// flushed every lane of a warp whose lanes differed, and needed a kernel
// that filled the outputs with [W, H, -1, -1] before the pass. What this
// design does instead:
//
// - K7_GROUPS groups of 4 neighbouring pixels a thread, one 16-byte load of
//   slots and one of prob each where every image is 16-byte aligned (lane i
//   reads the i-th 16-byte chunk of its warp's span), every load made
//   before any value is used; a scalar path serves the tail and unaligned inputs. One
//   division a group, then x steps and wraps to the next row.
// - A thread keeps its current run's count, f64 sum and extremes in
//   registers; the extremes are kept as maxima of W - x, H - y, x + 1 and
//   y + 1, so 0 means "no pixel", a lane without a run adds nothing to a
//   reduction, and one memset zeroes every accumulator (no fill kernel).
// - The slot that every lane with a run holds is reduced across the warp by
//   shuffles, and the slot that every warp of the block shares in shared
//   memory, so a large component costs one set of atomics a block. Where a
//   warp's lanes end on different slots, each slot's lanes reduce to one
//   flush (__match_any_sync): on scenes of many small components the
//   flushes of single lanes, six atomics each on a few hot lines, are what
//   the pass costs beyond its bytes.
// - k7_epilogue, a thread a slot, decodes the extremes (an empty slot gives
//   [W, H, -1, -1] by itself) and writes the outputs: count, sum and bbox
//   for bbox_stats; for poly_stats the bbox, the score
//   (f32(sum) + hole_sum) / max(f32(count) + hole_cnt, 1) (0 where the
//   denominator is 0) with round-to-nearest adds and division, as the
//   plain version rounds them, and valid = valid_root && count > 0. Writing
//   them from each image's last block (a fence and a counter in every
//   block) was slower on the H100: 0.0151 against 0.0134 ms on 8x640x640
//   kernel scenes, 0.0166 against 0.0139 in the poly_stats form.
//
// k7_pack_words: where W % 8 == 0 every row starts on a packed byte, so the
// batch is one stream of bytes: a thread loads 16 mask bytes with one
// 16-byte load, turns each into 0 or 1 (__vsetne4), and gathers each 8 of
// them into a byte with one 64-bit multiply; one 2-byte store.
// k7_pack_rows, for other widths: one packed byte a thread from 8 byte
// loads; a row is padded with zero bits to a whole byte. Both are bound by
// reading the mask.

constexpr int K7_THREADS = 256, K7_WARPS = K7_THREADS / 32, K7_GROUPS = 4;
constexpr int K7_BLOCK_PX = 4 * K7_GROUPS * K7_THREADS;

// The per-slot accumulators of k7_stats, one buffer zeroed by one memset.
struct K7Scratch {
  int4* ext;        // (N, K) maxima of W - x, H - y, x + 1, y + 1
  double* psum;     // (N, K)
  int* cnt;         // (N, K)
};

size_t k7_scratch_bytes(int N, int K) {
  return (size_t)N * K * (sizeof(int4) + sizeof(double) + sizeof(int));
}

K7Scratch k7_scratch(void* base, int N, int K) {
  const size_t NK = (size_t)N * K;
  K7Scratch s;
  s.ext = static_cast<int4*>(base);
  s.psum = reinterpret_cast<double*>(s.ext + NK);
  s.cnt = reinterpret_cast<int*>(s.psum + NK);
  return s;
}

// The outputs: cnt, psum and bbox for bbox_stats (POLY false); bbox,
// scores and valid from valid_root, hole_sum and hole_cnt for poly_stats.
struct K7Out {
  int* cnt;
  double* psum;
  int4* bbox;
  const uint8_t* valid_root;
  const float *hole_sum, *hole_cnt;
  float* scores;
  uint8_t* valid;
};

// One slot's count, sum and encoded extremes.
struct K7Acc {
  int c;
  double ps;
  int4 e;
};

__device__ __forceinline__ void k7_flush(const K7Scratch& s, size_t at,
                                         const K7Acc& a) {
  atomicAdd(&s.cnt[at], a.c);
  atomicAdd(&s.psum[at], a.ps);
  int* e = &s.ext[at].x;
  atomicMax(e, a.e.x);
  atomicMax(e + 1, a.e.y);
  atomicMax(e + 2, a.e.z);
  atomicMax(e + 3, a.e.w);
}

// The sum of the counts and sums and the max of the extremes over the
// lanes of `peers`, every one of which calls it with the same mask.
__device__ __forceinline__ K7Acc k7_reduce(unsigned peers, K7Acc a) {
  a.c = __reduce_add_sync(peers, a.c);
  if (peers == FULL) {
    a.ps = warp_sum(a.ps);
  } else {
    double ps = 0.0;
    for (unsigned m = peers; m; m &= m - 1)
      ps += __shfl_sync(peers, a.ps, __ffs(m) - 1);
    a.ps = ps;
  }
  a.e = make_int4(__reduce_max_sync(peers, a.e.x),
                  __reduce_max_sync(peers, a.e.y),
                  __reduce_max_sync(peers, a.e.z),
                  __reduce_max_sync(peers, a.e.w));
  return a;
}

__global__ void __launch_bounds__(K7_THREADS)
k7_stats(const int* __restrict__ keyed, const float* __restrict__ prob,
         int H, int W, int K, bool vec, K7Scratch s) {
  __shared__ int wslot[K7_WARPS];
  __shared__ K7Acc wacc[K7_WARPS];
  const int HW = H * W;
  const size_t base = (size_t)blockIdx.y * HW;
  const size_t sbase = (size_t)blockIdx.y * K;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // every pixel's slot and prob, every load made before any value is used;
  // a pixel past the image reads as slot K
  int key[4 * K7_GROUPS];
  float pr[4 * K7_GROUPS];
#pragma unroll
  for (int g = 0; g < K7_GROUPS; ++g) {
    const int p0 = blockIdx.x * K7_BLOCK_PX + (g * K7_THREADS + t) * 4;
    if (vec && p0 + 3 < HW) {
      const int4 k4 = __ldg(reinterpret_cast<const int4*>(keyed + base + p0));
      const float4 f4 =
          __ldg(reinterpret_cast<const float4*>(prob + base + p0));
      key[4 * g] = k4.x; key[4 * g + 1] = k4.y;
      key[4 * g + 2] = k4.z; key[4 * g + 3] = k4.w;
      pr[4 * g] = f4.x; pr[4 * g + 1] = f4.y;
      pr[4 * g + 2] = f4.z; pr[4 * g + 3] = f4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = p0 + j < HW;
        key[4 * g + j] = in ? keyed[base + p0 + j] : K;
        pr[4 * g + j] = in ? prob[base + p0 + j] : 0.f;
      }
    }
  }
  int cur = -1;
  K7Acc a = {0, 0.0, make_int4(0, 0, 0, 0)};
#pragma unroll
  for (int g = 0; g < K7_GROUPS; ++g) {
    const int p0 = blockIdx.x * K7_BLOCK_PX + (g * K7_THREADS + t) * 4;
    if (p0 >= HW) continue;
    int y = p0 / W, x = p0 - y * W;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int slot = key[4 * g + j];
      if ((unsigned)slot < (unsigned)K) {
        if (slot != cur) {
          if (cur >= 0) k7_flush(s, sbase + cur, a);
          cur = slot;
          a = {0, 0.0, make_int4(0, 0, 0, 0)};
        }
        a.c += 1;
        a.ps += (double)pr[4 * g + j];
        a.e = make_int4(max(a.e.x, W - x), max(a.e.y, H - y),
                        max(a.e.z, x + 1), max(a.e.w, y + 1));
      }
      if (++x == W) {
        x = 0;
        ++y;
      }
    }
  }
  // the warp's common slot into shared memory; where the lanes end on
  // different slots, one flush for each slot's lanes
  const int common = k6_common(cur);
  const unsigned peers = __match_any_sync(FULL, cur);
  if (common >= 0) {
    a = k7_reduce(FULL, a);
  } else if (cur >= 0) {
    a = k7_reduce(peers, a);
    if (lane == __ffs(peers) - 1) k7_flush(s, sbase + cur, a);
  }
  if (lane == 0) {
    wslot[warp] = common;
    wacc[warp] = a;
  }
  __syncthreads();
  // the block's common slot, one set of atomics; or each warp's own
  if (warp == 0) {
    const int slot = lane < K7_WARPS ? wslot[lane] : -1;
    K7Acc b = {0, 0.0, make_int4(0, 0, 0, 0)};
    if (slot >= 0) b = wacc[lane];
    const int shared_slot = k6_common(slot);
    if (shared_slot >= 0) {
      b = k7_reduce(FULL, b);
      if (lane == 0) k7_flush(s, sbase + shared_slot, b);
    } else if (slot >= 0) {
      k7_flush(s, sbase + slot, b);
    }
  }
}

// One thread a slot: decode the extremes (an empty slot gives [W, H, -1,
// -1] by itself) and write the outputs of either form.
template <bool POLY>
__global__ void k7_epilogue(int NK, int H, int W, K7Scratch s, K7Out out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NK) return;
  const int4 e = s.ext[i];
  const int n = s.cnt[i];
  const double sum = s.psum[i];
  out.bbox[i] = make_int4(W - e.x, H - e.y, e.z - 1, e.w - 1);
  if (POLY) {
    const float denom = __fadd_rn(__int2float_rn(n), out.hole_cnt[i]);
    const float num = __fadd_rn(__double2float_rn(sum), out.hole_sum[i]);
    out.scores[i] = denom > 0.f ? __fdiv_rn(num, fmaxf(denom, 1.f)) : 0.f;
    out.valid[i] = out.valid_root[i] && n > 0;
  } else {
    out.cnt[i] = n;
    out.psum[i] = sum;
  }
}

// Eight 0/1 bytes (lo holds the first four) to one byte, the first in the
// most significant bit: byte j of v is bit 8j, and the product's top byte
// collects bit 8j + 9k at 63 - j where j + k = 7, with no carries into it.
__device__ __forceinline__ unsigned k7_gather8(unsigned lo, unsigned hi) {
  const unsigned long long v = lo | (unsigned long long)hi << 32;
  return (unsigned)((v * 0x8040201008040201ull) >> 56);
}

// W % 8 == 0: mask bytes 16i..16i+15 of the batch -> packed bytes 2i, 2i+1
// (one byte for the last thread where total % 16 == 8).
__global__ void k7_pack_words(const uint8_t* __restrict__ mask,
                              uint8_t* packed, long total, bool vec) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long b0 = i * 16;
  if (b0 >= total) return;
  const bool whole = b0 + 16 <= total;
  unsigned w[4];
  if (vec && whole) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(mask + b0));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long b = b0 + 4 * k + j;
        w[k] |= (b < total ? (unsigned)mask[b] : 0u) << (8 * j);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = __vsetne4(w[k], 0u);
  const unsigned lo = k7_gather8(w[0], w[1]);
  if (whole)
    *reinterpret_cast<uint16_t*>(packed + 2 * i) =
        (uint16_t)(lo | k7_gather8(w[2], w[3]) << 8);
  else
    packed[2 * i] = (uint8_t)lo;
}

// Other widths: one packed byte a thread, pixels 8b..8b+7 of a row, pixels
// past W as 0.
__global__ void k7_pack_rows(const uint8_t* __restrict__ mask,
                             uint8_t* packed, int W, int W8, long total) {
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

// K4's tiles of an image; an image with no pixel still has one, which
// writes its valid_root
inline int k4_tiles(int HW) { return HW > 0 ? cdiv(HW, K4_TILE) : 1; }

// K7 stats in either form: a memset of the accumulators and two kernels.
template <bool POLY>
int k7_run(const int* keyed, const float* prob, void* scratch,
           const K7Out& out, int N, int H, int W, int K,
           cudaStream_t stream) {
  if (N == 0 || K == 0) return 0;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, k7_scratch_bytes(N, K), stream);
  if (err != cudaSuccess) return (int)err;
  const int HW = H * W;
  const K7Scratch s = k7_scratch(scratch, N, K);
  if (HW > 0) {
    // 16-byte loads where every image starts on a 16-byte boundary
    const bool vec = HW % 4 == 0 && (reinterpret_cast<uintptr_t>(keyed) |
                                     reinterpret_cast<uintptr_t>(prob)) %
                                            16 == 0;
    k7_stats<<<dim3(cdiv(HW, K7_BLOCK_PX), N), K7_THREADS, 0, stream>>>(
        keyed, prob, H, W, K, vec, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int NK = N * K;
  k7_epilogue<POLY><<<cdiv(NK, 256), 256, 0, stream>>>(NK, H, W, s, out);
  return (int)cudaGetLastError();
}

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

// K4: keyed (N,HW) int32 and valid_root (N,K) 0/1 bytes (a bool tensor's
// storage) from labels (N,HW) int32 (K3's). scratch:
// cc_compact_scratch_bytes(N, HW) bytes, no init by the caller.
size_t cc_compact_scratch_bytes(int N, int HW) {
  const size_t tiles = (size_t)N * k4_tiles(HW);
  return tiles * sizeof(unsigned long long) + N * sizeof(unsigned);
}

int cc_compact(const int* labels, int* keyed, uint8_t* valid_root,
               void* scratch, int N, int HW, int K, cudaStream_t stream) {
  if (N == 0) return 0;
  const int ntiles = k4_tiles(HW);
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* tickets = reinterpret_cast<unsigned*>(status + (size_t)N * ntiles);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, cc_compact_scratch_bytes(N, HW), stream);
  if (err != cudaSuccess) return (int)err;
  // 16-byte loads where every image starts on a 16-byte boundary
  const bool vec = HW % 4 == 0 && (reinterpret_cast<uintptr_t>(labels) |
                                   reinterpret_cast<uintptr_t>(keyed)) %
                                          16 == 0;
  k4_rank<<<dim3(ntiles, N), K4_THREADS, 0, stream>>>(
      labels, HW, K, ntiles, vec, status, tickets, keyed, valid_root);
  err = cudaGetLastError();
  if (err != cudaSuccess || HW == 0) return (int)err;
  k4_assign<<<dim3(cdiv(HW, 4 * 256), N), 256, 0, stream>>>(labels, HW, K,
                                                             vec, keyed);
  return (int)cudaGetLastError();
}

// K6: hole_sum and hole_cnt (N,K) f32 from the fg mask (N,H,W) uint8, the
// fg and bg slot maps (N,H*W) int32 (K4's, on the 8-connected foreground
// and the 4-connected background) and prob (N,H,W) f32. scratch:
// cc_hole_route_scratch_bytes(N, K) bytes, no init by the caller.
size_t cc_hole_route_scratch_bytes(int N, int K) {
  return k6_scratch_bytes(N, K);
}

int cc_hole_route(const uint8_t* mask, const int* fg_keyed,
                  const int* bg_keyed, const float* prob, void* scratch,
                  float* hole_sum, float* hole_cnt, int N, int H, int W,
                  int K, cudaStream_t stream) {
  if (N == 0 || K == 0) return 0;
  const size_t out_bytes = (size_t)N * K * sizeof(float);
  cudaError_t err;
  if (H == 0 || W == 0) {   // no pixel, so no hole
    err = cudaMemsetAsync(hole_sum, 0, out_bytes, stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(hole_cnt, 0, out_bytes, stream);
    return (int)err;
  }
  const K6Scratch s = k6_scratch(scratch, N, K);
  err = cudaMemsetAsync(scratch, 0, k6_scratch_bytes(N, K), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 blk(K6_TX, K6_TY), grid(cdiv(W, K6_TX), cdiv(H, K6_TH), N);
  k6_scan<<<grid, blk, 0, stream>>>(mask, fg_keyed, bg_keyed, H, W, K,
                                    s.table);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 4-byte mask and 16-byte slot loads where every image is aligned
  const int HW = H * W;
  const bool vec = HW % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(bg_keyed) % 16 == 0;
  k6_accumulate<<<dim3(cdiv(HW, K6_BLOCK_PX), N), K6_THREADS, 0, stream>>>(
      mask, bg_keyed, prob, s.table, HW, K, vec, s, hole_sum, hole_cnt);
  return (int)cudaGetLastError();
}

// K5: corners (N,K,4,2), sides (N,K,2), scores (N,K) f32 and valid (N,K)
// 0/1 bytes (a bool tensor's storage) from prob (N,H,W) f32, keyed (N,HW) int32, valid_root (N,K) uint8
// and hole_sum/hole_cnt (N,K) f32 (K6). offsets holds every stage's
// candidate offsets back to back, stage_sizes[s] of them for stage s, in
// host memory: they go to the card in the search's launch parameters.
// scratch: cc_rot_boxes_scratch_bytes(N, H, K) bytes, no init by the caller.
size_t cc_rot_boxes_scratch_bytes(int N, int H, int K) {
  const size_t NK = (size_t)N * K;
  return NK * H * sizeof(int2) + k5_zeroed_bytes(NK) + NK * 2 * sizeof(float);
}

int cc_rot_boxes(const float* prob, const int* keyed,
                 const uint8_t* valid_root, const float* hole_sum,
                 const float* hole_cnt, const float* offsets,
                 const int* stage_sizes, int n_stages, void* scratch,
                 float* corners, float* sides, float* scores, uint8_t* valid,
                 int N, int H, int W, int K, cudaStream_t stream) {
  K5Stages st = {};
  if (n_stages < 0 || n_stages > K5_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  st.n = n_stages;
  for (int s = 0, first = 0; s < n_stages; first += stage_sizes[s++]) {
    if (stage_sizes[s] < 1 || stage_sizes[s] > 32 ||
        first + stage_sizes[s] > K5_MAX_OFFSETS)
      return (int)cudaErrorInvalidValue;
    st.size[s] = stage_sizes[s];
    for (int a = 0; a < stage_sizes[s]; ++a)
      st.off[first + a] = offsets[first + a];
  }
  if (N == 0 || K == 0) return 0;
  const int HW = H * W, NK = N * K;
  const K5Slots t = k5_slots(scratch, N, H, K);
  cudaError_t err = cudaMemsetAsync(t.psum, 0, k5_zeroed_bytes(NK), stream);
  if (err != cudaSuccess) return (int)err;
  if (HW > 0) {
    const dim3 pgrid(cdiv(HW, 256 * RUN), N);
    k5_moments1<<<pgrid, 256, 0, stream>>>(keyed, prob, H, W, K, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    k5_rows<<<cdiv((long)NK * 32, 256), 256, 0, stream>>>(H, W, NK, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    k5_moments2<<<pgrid, 256, 0, stream>>>(keyed, H, W, K, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  k5_search<<<dim3(cdiv(K, K5_WARPS), N), K5_WARPS * 32, 0, stream>>>(
      valid_root, hole_sum, hole_cnt, H, K, st, t, corners, sides, scores,
      valid);
  return (int)cudaGetLastError();
}

// K7/K8 stats (bbox_stats): cnt (N,K) int32, psum (N,K) f64 and bbox (N,K,4)
// int32 [xmin, ymin, xmax, ymax] per slot of keyed (N,HW) over prob
// (N,HW); an empty slot gets 0, 0 and [W, H, -1, -1]. scratch:
// cc_bbox_stats_scratch_bytes(N, K) bytes, no init by the caller (also for
// cc_poly_stats).
size_t cc_bbox_stats_scratch_bytes(int N, int K) {
  return k7_scratch_bytes(N, K);
}

int cc_bbox_stats(const int* keyed, const float* prob, void* scratch,
                  int* cnt, double* psum, int* bbox, int N, int H, int W,
                  int K, cudaStream_t stream) {
  K7Out out = {};
  out.cnt = cnt;
  out.psum = psum;
  out.bbox = reinterpret_cast<int4*>(bbox);
  return k7_run<false>(keyed, prob, scratch, out, N, H, W, K, stream);
}

// K7 stats with the polygon path's epilogue (poly_stats): bboxes (N,K,4)
// int32 as above, scores (N,K) f32 and valid (N,K) 0/1 bytes (a bool
// tensor's storage) from keyed and prob as above, valid_root (N,K) uint8
// (K4's) and hole_sum/hole_cnt (N,K) f32 (K6's).
int cc_poly_stats(const int* keyed, const float* prob,
                  const uint8_t* valid_root, const float* hole_sum,
                  const float* hole_cnt, void* scratch, int* bboxes,
                  float* scores, uint8_t* valid, int N, int H, int W, int K,
                  cudaStream_t stream) {
  K7Out out = {};
  out.bbox = reinterpret_cast<int4*>(bboxes);
  out.valid_root = valid_root;
  out.hole_sum = hole_sum;
  out.hole_cnt = hole_cnt;
  out.scores = scores;
  out.valid = valid;
  return k7_run<true>(keyed, prob, scratch, out, N, H, W, K, stream);
}

// K7 bit-pack: packed (N,H,ceil(W/8)) uint8 from mask (N,H,W) uint8 (any
// nonzero byte is 1).
int cc_pack_bits(const uint8_t* mask, uint8_t* packed, int N, int H, int W,
                 cudaStream_t stream) {
  if (W % 8 == 0) {
    const long total = (long)N * H * W;
    if (total == 0) return 0;
    const bool vec = reinterpret_cast<uintptr_t>(mask) % 16 == 0;
    k7_pack_words<<<cdiv(total, 16 * 256), 256, 0, stream>>>(mask, packed,
                                                             total, vec);
  } else {
    const int W8 = (W + 7) / 8;
    const long total = (long)N * H * W8;
    if (total == 0) return 0;
    k7_pack_rows<<<cdiv(total, 256), 256, 0, stream>>>(mask, packed, W, W8,
                                                       total);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
