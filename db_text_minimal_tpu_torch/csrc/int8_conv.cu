// The int8 convolution of the quantized forward, with P1's epilogue in its
// register tail, written for Hopper (sm_90a).
//
// Replaces, in one launch, what the JAX int8 forward does at
// db_text_minimal_tpu/models/quant_infer.py:238-243: the XLA convolution
// conv_general_dilated(int8 NHWC, int8 HWIO, preferred_element_type=int32)
// and the epilogue XLA fuses into it, whose hand-written TPU form is the
// probe's Pallas kernel _epi_kernel / epilogue
// (benchmarks/int8_conv_probe.py:103-122). Per output pixel p and channel c:
//
//   acc = sum over taps (kh, kw) and input channels ci of
//         q[n, oh*s - pad + kh, ow*s - pad + kw, ci] * w[c, kh, kw, ci]
//         (zero outside the image), exact in int32 in any order
//   y = acc * scale[c] + bias[c]        (f32 product, then f32 add)
//   y = max(y, 0)                       (when relu)
//   f32 form:  out = y
//   int8 form: out = clip(rint(y * (1 / out_scale)), -127, 127)
//
// the bits of ops/int8.int8_conv2d (im2col, torch._int_mm) followed by P1
// (csrc/int8_epilogue.cu): __fmul_rn / __fadd_rn keep nvcc from contracting
// to an FMA, rintf rounds half to even, and the reciprocal of the output
// scale is __frcp_rn's, the correctly rounded one torch.reciprocal gives.
//
// Bound, at the forward's 17 convs (batch 8, 640x640): 523 G int8
// operations, 0.26 ms at 1,979 TOP/s. The two convs at 160x160 (the FPN
// output conv, 256 -> 256, and the head's conv1, 256 -> 128; K = 2304) hold
// 69 % of them and are bound by the tensor cores (0.122 and 0.061 ms
// against 0.078 and 0.047 ms for their bytes in the f32 form). Layer 2's
// convs at 80x80 and the 1x1 downsamples are bound by their bytes (the f32
// output above all: 4 B a value against 1 B in), layers 3-4 by operations;
// at 40x40 and 20x20 they are 100 and 25 row tiles, too few to fill 132
// SMs, so launch and tail set their time.
//
// Design: an implicit GEMM. M = N*Ho*Wo output pixels, N = output
// channels, K = k*k*Cs with the input's channels padded per tap to Cs, a
// multiple of 16, so that every 16-byte chunk of K lies in one tap.
//  - A block computes 128 output pixels x BN channels with two warpgroups,
//    each issuing wgmma.mma_async m64nBNk32 s32.s8.s8 (both operands
//    K-major from shared memory, as int8 wgmma requires and as NHWC
//    activations and (Cout, kh*kw*cin) weights already are), the int32
//    accumulators in registers. BN is 256 (each warpgroup 64 x 256, 128
//    accumulators a thread: half the A copies per operation) where Cout >=
//    256 and there are at least half as many row tiles as SMs (the FPN
//    output conv, layer 3); else 128 (two blocks an SM).
//  - K goes in stages of 64 bytes through a ring of 5 stages in shared
//    memory, filled by cp.async 16-byte copies 3 stages ahead of the
//    tensor cores. The A tile is gathered straight from the
//    NHWC input: each row is an output pixel, each 16-byte chunk one (tap,
//    channel slice); rows outside the image, past M or past K are
//    zero-filled by a source size of 0, so no padded copy of the input and
//    no column matrix is made. The weights' B tile comes the same way.
//    Four threads share a row, so a warp's copy asks for 64-byte runs, and
//    the copies allocate in L1 (.ca).
//  - Tiles are stored in wgmma's 64-byte-swizzled K-major layout: a row's
//    16-byte chunks are permuted by its row bits, so neither the copies nor
//    the tensor cores' reads meet bank conflicts (without the swizzle a
//    row's chunks lay 128 bytes apart, 4-way conflicts, and the kernel took
//    1.5x as long at the FPN output conv). The tile shapes, ring depth and
//    stage size were chosen by timing the forward's shapes on an H100.
//  - The epilogue runs on the accumulators in registers with the tile's
//    scales and biases from shared memory, stages 128 columns at a time in
//    shared memory (padded rows: no bank conflicts) and stores them by
//    16-byte rows. The int32 accumulators never reach device memory.
// Not yet: a producer warp with TMA (and multicast of the shared operand
// across a cluster), to take the copies' address arithmetic and L2 requests
// off the warpgroups that run wgmma; split K for layers 3-4's small grids.
// Odd widths: the wrapper pads the input's channels (a copy, at pruned
// widths only) and the weights per tap to Cs with zeros; output channels
// run to the weights' row count, a multiple of 8 (zero rows give zeros).
//
// The extern "C" entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so that the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;             // output pixels a block
constexpr int THREADS = 256;        // two warpgroups, 64 rows each
constexpr int CHUNKS = 4;           // 16-byte chunks of K a stage: 64 bytes
constexpr int STAGES = 5;           // the ring; the copies run 3 ahead
constexpr int F32_PITCH = 128 + 8;  // floats a staged output row
constexpr int I8_PITCH = 128 + 16;  // bytes a staged output row
constexpr int EPI_BYTES = BM * F32_PITCH * 4;   // 128 columns at a time

// A block's shared memory at BN output channels: the ring of A (BM rows)
// and B (BN rows) tiles, on a 1024-byte boundary, then the tile's scales
// and biases
template <int BN>
struct Tile {
  static constexpr int A_BYTES = BM * CHUNKS * 16;
  static constexpr int STAGE_BYTES = (BM + BN) * CHUNKS * 16;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static_assert(RING_BYTES >= EPI_BYTES, "the output tile fits the ring");
  static constexpr int SMEM_BYTES = 1024 + RING_BYTES + 2 * BN * 4;
};

struct Params {
  const int8_t* q;          // NHWC int8, a pixel every ldq bytes
  const int8_t* w;          // (rows, kchunks * 16) int8, taps padded to cs
  const float* scale;       // (rows,)
  const float* bias;        // (rows,)
  const float* out_scale;   // device scalar: the int8 form; null: f32
  void* out;                // (m, rows), int8 or f32
  long long m;              // n * ho * wo
  int h, w_in, ldq, cs16;   // input size, pixel stride, chunks a tap
  int k, stride, pad, ho, wo;
  int rows, kchunks;        // output channels; 16-byte chunks of K
  int relu;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The K-major descriptor of a tile in tile_offset's layout: start address,
// stride byte offset 512 (the 8-row step), layout type 2 (64-byte
// swizzle); the leading byte offset is not read for swizzled K-major
// operands (1, as CUTLASS sets it).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float affine(int acc, float scale, float bias,
                                        bool relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return relu ? fmaxf(y, 0.0f) : y;
}

__device__ __forceinline__ signed char requant(float y, float inv) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.0f), 127.0f);
  return static_cast<signed char>(__float2int_rn(r));
}

// Where a thread's next chunk of K lies: tap (kh, kw) and 16-byte channel
// slice c16; kh == k once it is past K.
struct Chunk {
  int kh, kw, c16;
};

__device__ __forceinline__ void advance(Chunk& c, int by, int k, int cs16) {
  c.c16 += by;
  while (c.c16 >= cs16) {
    c.c16 -= cs16;
    if (++c.kw == k) {
      c.kw = 0;
      ++c.kh;
    }
  }
}

// Byte offset of (row, 16-byte chunk) in a tile: rows of 64 contiguous
// bytes in 512-byte atoms of 8 rows, each row's chunk index XORed with its
// row bits 1-2, as wgmma's 64-byte swizzle lays them out, so that the two
// rows' chunks that 8 threads of a copy write, and the 8 rows that wgmma
// reads, fall in different banks. The tiles start on 1024-byte boundaries.
__device__ __forceinline__ uint32_t tile_offset(int row, int chunk) {
  return (uint32_t)(row * CHUNKS * 16 + ((chunk ^ ((row & 7) >> 1)) << 4));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k32(d, da, db);
  else
    wgmma_m64n128k32(d, da, db);
}

template <int BN, bool QUANT>
__global__ void __launch_bounds__(THREADS, BN == 128 ? 2 : 1)
    int8_conv_kernel(Params p) {
  using T = Tile<BN>;
  // Which copies a thread makes: 4 consecutive threads share a tile row
  // and take its 4 chunks, so one copy instruction of a warp asks for 8
  // rows' 64-byte runs (whole sectors, where a tap's channels are a
  // multiple of 64 bytes); the copies allocate in L1 (cp.async.ca).
  constexpr int A_ROWS = BM * CHUNKS / THREADS;   // rows a thread
  constexpr int B_ROWS = BN * CHUNKS / THREADS;
  extern __shared__ __align__(128) uint8_t smem[];
  // the ring on a 1024-byte boundary (the swizzles' atoms), then the
  // tile's scales and biases
  uint8_t* ring = smem + ((1024 - smem_addr(smem) % 1024) % 1024);
  float* s_scale = reinterpret_cast<float*>(ring + T::RING_BYTES);
  float* s_bias = s_scale + BN;

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  for (int i = tid; i < BN; i += THREADS) {
    const int c = n0 + i;
    s_scale[i] = c < p.rows ? p.scale[c] : 0.0f;
    s_bias[i] = c < p.rows ? p.bias[c] : 0.0f;
  }

  const int chunk = tid % CHUNKS;
  auto row_of = [&](int ri) { return tid / CHUNKS + (THREADS / CHUNKS) * ri; };

  // the A rows' output pixels: their window's corner and image
  int ih0[A_ROWS], iw0[A_ROWS];
  bool row_ok[A_ROWS];
  const int8_t* qimg[A_ROWS];
#pragma unroll
  for (int ri = 0; ri < A_ROWS; ++ri) {
    const long long mrow = m0 + row_of(ri);
    row_ok[ri] = mrow < p.m;
    ih0[ri] = iw0[ri] = 0;
    qimg[ri] = p.q;
    if (row_ok[ri]) {
      const int ow = (int)(mrow % p.wo);
      const long long t = mrow / p.wo;
      const int oh = (int)(t % p.ho);
      const long long img = t / p.ho;
      ih0[ri] = oh * p.stride - p.pad;
      iw0[ri] = ow * p.stride - p.pad;
      qimg[ri] = p.q + img * p.h * p.w_in * (long long)p.ldq;
    }
  }
  const int8_t* wrow[B_ROWS];
  bool wrow_ok[B_ROWS];
#pragma unroll
  for (int ri = 0; ri < B_ROWS; ++ri) {
    const int c = n0 + row_of(ri);
    wrow_ok[ri] = c < p.rows;
    wrow[ri] = p.w + (long long)(wrow_ok[ri] ? c : 0) * p.kchunks * 16;
  }
  Chunk ch = {0, 0, 0};
  advance(ch, chunk, p.k, p.cs16);
  int g = chunk;   // this thread's chunk of K in the next stage
  const uint32_t sbase = smem_addr(ring);

  auto load_stage = [&](int slot) {
    const uint32_t sa = sbase + slot * T::STAGE_BYTES;
    const uint32_t sb = sa + T::A_BYTES;
#pragma unroll
    for (int ri = 0; ri < A_ROWS; ++ri) {
      const int ih = ih0[ri] + ch.kh, iw = iw0[ri] + ch.kw;
      const bool ok = row_ok[ri] && ch.kh < p.k &&
                      (unsigned)ih < (unsigned)p.h &&
                      (unsigned)iw < (unsigned)p.w_in;
      const int8_t* src =
          ok ? qimg[ri] + ((long long)ih * p.w_in + iw) * p.ldq + ch.c16 * 16
             : p.q;
      cp_async16(sa + tile_offset(row_of(ri), chunk), src, ok);
    }
    advance(ch, CHUNKS, p.k, p.cs16);
#pragma unroll
    for (int ri = 0; ri < B_ROWS; ++ri) {
      const bool ok = wrow_ok[ri] && g < p.kchunks;
      cp_async16(sb + tile_offset(row_of(ri), chunk),
                 ok ? wrow[ri] + g * 16 : p.w, ok);
    }
    g += CHUNKS;
  };

  const int ktiles = (p.kchunks + CHUNKS - 1) / CHUNKS;
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < ktiles) load_stage(s);
    cp_async_commit();
  }

  int d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;

  const int wg = tid >> 7;   // warpgroup: output rows 64 * wg ..
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 3>();   // this thread's copies of stage kt
    // the copies were the generic proxy's writes; wgmma reads by the async
    // proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // every copy of stage kt; every wgmma of kt - 2 done
    const uint32_t sa = sbase + (kt % STAGES) * T::STAGE_BYTES;
    const uint32_t sb = sa + T::A_BYTES;
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < CHUNKS / 2; ++kk) {
      const uint64_t da = descriptor(sa + wg * 64 * CHUNKS * 16 + kk * 32);
      const uint64_t db = descriptor(sb + kk * 32);
      wgmma_tile<BN>(d, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_operands(d);
    const int next = kt + STAGES - 2;   // into the slot of kt - 2
    if (next < ktiles) load_stage(next % STAGES);
    cp_async_commit();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(d);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();   // the ring is free: the output is staged there

  // accumulator d[i] of thread (warp wi, lane l) of warpgroup wg: row
  // 64 wg + 16 wi + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4)
  // + i % 2; staged and stored 128 columns at a time
  const int lane = tid & 31;
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const bool relu = p.relu != 0;
  const float inv = QUANT ? __frcp_rn(__ldg(p.out_scale)) : 0.0f;
#pragma unroll
  for (int part = 0; part < BN / 128; ++part) {
    const int nb = n0 + 128 * part;   // the part's first output channel
    if (part) __syncthreads();        // the last part's stores have read
    if (QUANT) {
      int8_t* so = reinterpret_cast<int8_t*>(ring);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + c0, sc = 128 * part + c;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 64 * part + 4 * j + 2 * hh;
          char2 v;
          v.x = requant(affine(d[i], s_scale[sc], s_bias[sc], relu), inv);
          v.y = requant(
              affine(d[i + 1], s_scale[sc + 1], s_bias[sc + 1], relu), inv);
          *reinterpret_cast<char2*>(so + (r0 + 8 * hh) * I8_PITCH + c) = v;
        }
      }
      __syncthreads();
      int8_t* out = static_cast<int8_t*>(p.out);
      const bool wide = p.rows % 16 == 0;
#pragma unroll
      for (int pass = 0; pass < BM / (THREADS / 8); ++pass) {
        const int r = pass * (THREADS / 8) + tid / 8;
        const int c = 16 * (tid % 8);
        const long long mr = m0 + r;
        if (mr >= p.m || nb + c >= p.rows) continue;
        int8_t* dst = out + mr * p.rows + nb + c;
        const int4 v = *reinterpret_cast<const int4*>(so + r * I8_PITCH + c);
        if (wide) {
          *reinterpret_cast<int4*>(dst) = v;
        } else {   // rows % 8 == 0: 8-byte halves
          *reinterpret_cast<int2*>(dst) = make_int2(v.x, v.y);
          if (nb + c + 8 < p.rows)
            *reinterpret_cast<int2*>(dst + 8) = make_int2(v.z, v.w);
        }
      }
    } else {
      float* so = reinterpret_cast<float*>(ring);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + c0, sc = 128 * part + c;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 64 * part + 4 * j + 2 * hh;
          const float2 v = make_float2(
              affine(d[i], s_scale[sc], s_bias[sc], relu),
              affine(d[i + 1], s_scale[sc + 1], s_bias[sc + 1], relu));
          *reinterpret_cast<float2*>(so + (r0 + 8 * hh) * F32_PITCH + c) = v;
        }
      }
      __syncthreads();
      float* out = static_cast<float*>(p.out);
#pragma unroll 4
      for (int pass = 0; pass < BM / (THREADS / 32); ++pass) {
        const int r = pass * (THREADS / 32) + tid / 32;
        const int c = 4 * (tid % 32);
        const long long mr = m0 + r;
        if (mr >= p.m || nb + c >= p.rows) continue;
        *reinterpret_cast<float4*>(out + mr * p.rows + nb + c) =
            *reinterpret_cast<const float4*>(so + r * F32_PITCH + c);
      }
    }
  }
}

template <int BN, bool QUANT>
cudaError_t launch_tile(const Params& p, cudaStream_t stream) {
  auto kernel = int8_conv_kernel<BN, QUANT>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<BN>::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((unsigned)((p.m + BM - 1) / BM), (p.rows + BN - 1) / BN);
  kernel<<<grid, THREADS, Tile<BN>::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.out_scale != nullptr ? launch_tile<BN, true>(p, stream)
                                : launch_tile<BN, false>(p, stream);
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

Params make_params(const int8_t* q, const int8_t* w, const float* scale,
                   const float* bias, const float* out_scale, void* out,
                   int n, int h, int w_in, int ldq, int cs16, int k,
                   int stride, int pad, int ho, int wo, int rows, int relu) {
  Params p;
  p.q = q;
  p.w = w;
  p.scale = scale;
  p.bias = bias;
  p.out_scale = out_scale;
  p.out = out;
  p.m = (long long)n * ho * wo;
  p.h = h;
  p.w_in = w_in;
  p.ldq = ldq;
  p.cs16 = cs16;
  p.k = k;
  p.stride = stride;
  p.pad = pad;
  p.ho = ho;
  p.wo = wo;
  p.rows = rows;
  p.kchunks = k * k * cs16;
  p.relu = relu;
  return p;
}

}  // namespace

extern "C" {

// q: (n, h, w_in) pixels of int8 channels, a pixel every ldq bytes, the
// first cs = 16 * cs16 of them read (ldq % 16 == 0, ldq >= cs, q 16-byte
// aligned); w: (rows, k * k * cs) int8, the taps' channels padded to cs;
// scale, bias: (rows,) f32; out_scale: null (f32 output) or a device f32
// scalar (int8 output); out: (n, ho, wo, rows). rows % 8 == 0 (the wrapper
// checks all of it).
int int8_conv(const int8_t* q, const int8_t* w, const float* scale,
              const float* bias, const float* out_scale, void* out, int n,
              int h, int w_in, int ldq, int cs16, int k, int stride, int pad,
              int ho, int wo, int rows, int relu, cudaStream_t stream) {
  const Params p = make_params(q, w, scale, bias, out_scale, out, n, h, w_in,
                               ldq, cs16, k, stride, pad, ho, wo, rows, relu);
  if (p.m == 0 || rows == 0) return (int)cudaGetLastError();
  // 128 x 256 tiles (each warpgroup 64 x 256: half the A copies per
  // operation) where there are at least half as many row tiles as SMs;
  // else 128 x 128, twice the blocks
  if (rows >= 256 && 2 * ((p.m + BM - 1) / BM) >= sm_count())
    return (int)launch<256>(p, stream);
  return (int)launch<128>(p, stream);
}

}  // extern "C"
