// Connected components and per-component oriented-box statistics for the
// device rect postprocess, written for Hopper (sm_90a).
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
//
// Every pass reads each input pixel once or a few times and does a handful
// of integer or float operations on it, so all four are bound by memory
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
// Union-find labelling (Playne and Hawick's scheme). Design: one 32x32 tile
// per block is labelled in shared memory first, so most unions never touch
// device memory; only pixels on a tile edge then hook across tiles with
// atomicMin in device memory; a last pass points every pixel at its root.
// Hooking always links the larger root under the smaller one, so a parent
// index is always below its child's and every root is the minimum linear
// index of its component: the label the TPU version produces, and what K4
// relies on (label == index at roots). No round cap: the result is exact for
// any shape.

constexpr int TILE = 32;

__device__ __forceinline__ int uf_find(const int* parent, int x) {
  const volatile int* p = parent;
  int up = p[x];
  while (up != x) {
    x = up;
    up = p[x];
  }
  return x;
}

// Works on shared or device memory (generic addressing).
__device__ __forceinline__ void uf_union(int* parent, int a, int b) {
  bool done = false;
  while (!done) {
    a = uf_find(parent, a);
    b = uf_find(parent, b);
    if (a < b) {
      int old = atomicMin(&parent[b], a);
      done = (old == b);
      b = old;
    } else if (b < a) {
      int old = atomicMin(&parent[a], b);
      done = (old == a);
      a = old;
    } else {
      done = true;
    }
  }
}

__global__ void k3_local(const uint8_t* __restrict__ mask, int* labels,
                         int H, int W, int conn) {
  __shared__ int L[TILE * TILE];
  __shared__ uint8_t M[TILE * TILE];
  const size_t base = (size_t)blockIdx.z * H * W;
  const int lx = threadIdx.x, ly = threadIdx.y;
  const int x = blockIdx.x * TILE + lx, y = blockIdx.y * TILE + ly;
  const bool in = x < W && y < H;
  const int li = ly * TILE + lx;
  const uint8_t fg = in ? mask[base + (size_t)y * W + x] : 0;
  M[li] = fg;
  L[li] = li;
  __syncthreads();
  if (fg) {
    if (lx > 0 && M[li - 1]) uf_union(L, li, li - 1);
    if (ly > 0) {
      if (M[li - TILE]) uf_union(L, li, li - TILE);
      if (conn == 8) {
        if (lx > 0 && M[li - TILE - 1]) uf_union(L, li, li - TILE - 1);
        if (lx < TILE - 1 && M[li - TILE + 1]) uf_union(L, li, li - TILE + 1);
      }
    }
  }
  __syncthreads();
  if (in) {
    int out = -1;
    if (fg) {
      // row-major order inside a tile is the image's linear order, so the
      // tile-local minimum is the global minimum of the tile's fragment
      const int r = uf_find(L, li);
      out = (blockIdx.y * TILE + r / TILE) * W + blockIdx.x * TILE + r % TILE;
    }
    labels[base + (size_t)y * W + x] = out;
  }
}

// Edges that cross a tile border, each taken once from its later pixel.
__global__ void k3_merge(const uint8_t* __restrict__ mask, int* labels,
                         int H, int W, int conn) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t base = (size_t)blockIdx.z * H * W;
  const uint8_t* m = mask + base;
  int* L = labels + base;
  const int p = y * W + x;
  if (!m[p]) return;
  const int tx = x % TILE, ty = y % TILE;
  if (tx == 0 && x > 0 && m[p - 1]) uf_union(L, p, p - 1);
  if (y > 0) {
    if (ty == 0 && m[p - W]) uf_union(L, p, p - W);
    if (conn == 8) {
      if (x > 0 && (tx == 0 || ty == 0) && m[p - W - 1])
        uf_union(L, p, p - W - 1);
      if (x < W - 1 && (tx == TILE - 1 || ty == 0) && m[p - W + 1])
        uf_union(L, p, p - W + 1);
    }
  }
}

__global__ void k3_flatten(const uint8_t* __restrict__ mask, int* labels,
                           int HW) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const size_t base = (size_t)blockIdx.y * HW;
  if (mask[base + p]) labels[base + p] = uf_find(labels + base, p);
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

inline int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" {

// K3: labels (N,H,W) int32 from mask (N,H,W) uint8; conn is 4 or 8.
int cc_label(const uint8_t* mask, int* labels, int N, int H, int W, int conn,
             cudaStream_t stream) {
  const dim3 tile(TILE, TILE);
  const dim3 tiles(cdiv(W, TILE), cdiv(H, TILE), N);
  k3_local<<<tiles, tile, 0, stream>>>(mask, labels, H, W, conn);
  const dim3 blk(32, 8);
  const dim3 grid(cdiv(W, 32), cdiv(H, 8), N);
  k3_merge<<<grid, blk, 0, stream>>>(mask, labels, H, W, conn);
  const int HW = H * W;
  k3_flatten<<<dim3(cdiv(HW, 256), N), 256, 0, stream>>>(mask, labels, HW);
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

}  // extern "C"
