// Int8 convolution with int32 accumulation for Hopper (sm_90a), K6, with a
// plain C interface loaded through ctypes (petr_tpu_torch/ops/conv_int8.py).
//
// Replaces no Pallas kernel: petr_tpu's int8 PTQ backbone computes this conv
// with XLA (petr_tpu/models/layers.py:202-229, ConvBNReLU._int8_forward,
// conv_general_dilated on int8 with preferred_element_type=int32), and
// PyTorch has no CUDA call that convolves int8 into int32 sums. Two kernels:
//
// * quantize_act_kernel: xi = clip(rint(x / sa), -127, 127) as int8, the
//   per-tensor activation quantisation (rint rounds half to even, as
//   jnp.round; x / sa is the true quotient, as in petr_tpu: x times the
//   rounded reciprocal decides wherever no half-integer lies within its few
//   ulps of error, the true division elsewhere), from NCHW x (bf16 or fp32)
//   into the layout the conv reads: a row per pixel of Cp bytes (C rounded up
//   to 32, zeros past C), stored as 16-channel planes (3x3 stride 1), planes
//   within blocks of 128 rows (1x1) or channels-last (stride 2). For a 3x3
//   stride-1 conv the rows are "flat padded": each image row is preceded by
//   one zero pixel and each view by one zero row (W + 1 pixels a row, one zero
//   row shared between neighbouring views), so that a 3x3 tap is a constant
//   shift of the row index. A block reads 32 channels x 256 pixels with
//   16-byte loads, transposes them in shared memory and writes 16-byte
//   stores; extra blocks write the zero pixels.
// * conv_int8_kernel: the conv of xi with the BN-folded per-output-channel
//   int8 weight (quantised and laid out once per model, ops/conv_int8.py
//   tile_weight), at kernel 1 or 3, stride 1 or 2, padding k // 2, as an
//   implicit GEMM on the int8 tensor cores: wgmma.mma_async m64nNk32 s8 x s8
//   -> s32, a tile of 128 output pixels (two consumer warpgroups of 64) by
//   N = 64..256 output channels. K = k * k * Cp is walked in 32-byte slices,
//   chunk-major (32 channels, then their taps); a producer warp keeps a ring
//   of 2 to 4 stages in flight, each a group of slices completed on one
//   mbarrier and released by the consumers' arrivals. A stage is:
//   - B: one bulk copy (cp.async.bulk) of its slices of the weight tile, laid
//     out once per model as the no-swizzle K-major image the wgmma reads;
//   - A, 3x3 stride 1: the output pixel q of the flat padded grid (W + 1
//     columns, H + 1 rows a view: one junk column and one junk row, never
//     stored) reads row q + kh (W + 1) + kw, so a chunk's 9 taps are row
//     shifts of one halo: two bulk copies (the chunk's two 16-channel
//     planes, rows q0 .. q0 + 2 (W + 1) + 129), each tap's wgmma descriptor
//     starting (kh (W + 1) + kw) rows into it; where two such stages do not
//     fit, a stage is one kernel row's 3 taps (130 rows);
//   - A, 1x1: one bulk copy of 4 chunks' planes of the tile's 128-row block;
//   - A, stride 2: a tile is tw x th output pixels of one view, and a slice
//     one TMA box (32 channels, tw, th, 1 view) with element stride 2 over
//     the channels-last rows, its out-of-bounds elements (the padding) filled
//     with zeros by the TMA unit, in the 32-byte swizzle.
//   A stage's products are issued straight between one fence and one commit
//   (a product behind a branch makes ptxas serialize every wgmma of the
//   kernel: measured 5-7x slower). Where the tiles alone do not fill the 132
//   SMs the plan splits K: each split reduces its int32 partial sums into a
//   workspace in L2 (cp.reduce.async.bulk .add: integer sums do not depend
//   on their order, so the result is exact), and the split that arrives last
//   (a counter per tile) reads the total back, zeroes the workspace and the
//   counter for the next launch, and runs the epilogue. The epilogue is
//   y = float(acc) * scale + add (scale = sa * sw per output channel, both
//   products rounded as written: no fused multiply-add, as the plain version
//   computes it), ReLU if asked, one rounding to the output type; or the
//   int32 sums themselves (the checks hold them to the plain version bit for
//   bit). It stages the tile in shared memory channel-major and stores along
//   the output's pixels: 16 bytes a thread where every 16-byte run of the
//   tile is whole and aligned in the output (the 1x1 convs of stages 2-4,
//   the stride-2 stem), else one element a thread, neighbouring threads on
//   neighbouring pixels; its scales are fetched before the main loop.
//
// What bounds it: V-99's 99 convs at 6 views of 320x800 do 1.01 TOP of int8
// products (0.51 ms at 1,979 TOPS) and move 1.84 GB, each bf16 input read
// once and each bf16 output written once (0.55 ms at 3.35 TB/s). This design
// reaches 14-40% of the bound by shape (PERF.md): a block's fixed costs
// (its launch, the ring's first fill, the epilogue) weigh on the deep
// stages' small tiles, and the stem's Cin = 3 is padded to 32 channels a tap.
//
// The plan (tile shapes, split, the layouts, the tensor-map box) is made and
// checked in Python (ops/conv_int8.py: conv_plan, tensor_map_args); this
// file trusts its arithmetic and checks its ranges.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"  // mbarriers, TMA and bulk copies, wgmma fences, the tensor-map encoder

namespace {

namespace k6 {
constexpr int BM = 128;                  // output pixels per tile: two consumer warpgroups of 64 rows
constexpr int KS = 32;                   // K per slice: one tap's 32 channels, one wgmma k32
constexpr int MAX_STAGES = 4;
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int A_BYTES = BM * KS;         // 4096
constexpr int QP = 256;                  // the quantisation pass's pixels per block (x 32 channels)
}  // namespace k6

// The conv's plan (conv_plan in ops/conv_int8.py, field for field).
struct Plan {
  int mode;  // 0 flat (stride 1), 1 rect (stride 2)
  int B, Cp, H, W, Co, k, stride, pad, Ho, Wo;
  int chunks, slices, tiles_m, tiles_n, splits, per_split;
  int Wp, QV;  // flat: the padded row pitch and pixels per view of the output grid
  int tw, th, tiles_w, tiles_h;  // rect: the tile's shape and the tiles of a view
  int rows_alloc;  // flat 3x3: the rows of each 16-channel plane of the quantised activation
  int group;       // K slices per pipeline stage: 9 or 3 (flat 3x3: a chunk's taps, or one kernel row's), 4
  int halo;        // flat 3x3: rows of a plane one stage's A copy takes (128 + the taps' row shifts)
  int stages;      // ring stages (2 to 4) of stage_bytes each
  int stage_bytes;
  int out_kind;  // 0 fp32, 1 bf16, 2 the int32 sums
  int relu;
};

// The quantisation pass's plan (quant_plan in ops/conv_int8.py).
struct QuantPlan {
  int B, C, Cp, H, W;
  int Wp, row0, vstride;  // pixel (b, ih, iw) -> row row0 + b vstride + ih Wp + iw
  int p_blocks, c_blocks, data_blocks;
  int pads;  // zero pixels to write (flat padded layout), 0 otherwise
  int plane_stride, row_stride;  // channel group j of row r at 16 (j plane_stride + r row_stride) bytes,
  int blocked;                   // or, blocked (1x1 convs), at 2048 ((r / 128) Cp / 16 + j) + 16 (r % 128)
};

__device__ __forceinline__ long long row_offset(const QuantPlan& q, long long group, long long row) {
  return q.blocked ? ((row >> 7) * (q.Cp / 16) + group) * 2048 + (row & 127) * 16
                   : 16 * (group * q.plane_stride + row * q.row_stride);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// xi = clip(rint(x / sa), +-127) for the true quotient x / sa (rounded to fp32,
// then half to even), as petr_tpu computes it. q = x * rsa (rsa = RN(1 / sa))
// lies within 2 ulps of the rounded quotient, so it rounds to the same integer
// unless a half-integer lies within that distance: there (ties, near-ties) the
// true division decides. |q| >= 128 clamps either way.
__device__ __forceinline__ uint32_t quantize(float v, float sa, float rsa) {
  float q = v * rsa;
  if (fabsf(q) < 128.0f && fabsf(q - floorf(q) - 0.5f) <= fmaxf(fabsf(q), 1.0f) * 0x1p-20f) q = v / sa;
  const float r = rintf(q);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f))));
}

// eight consecutive elements of x from an aligned address (16 bytes bf16, 32 fp32)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(256) quantize_act_kernel(const T* __restrict__ x, const float* __restrict__ sa_ptr,
                                                           int8_t* __restrict__ xq, const QuantPlan q) {
  using namespace k6;
  // [channel group of 4][pixel]: a word holds one pixel's 4 channels, channel order in its bytes
  __shared__ __align__(16) uint32_t tile[8][QP + 4];
  const int t = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= q.data_blocks) {  // the zero pixels of the flat padded layout
    const int units = q.Cp / 16;
    const long long u = (long long)(blockIdx.x - q.data_blocks) * 256 + t;
    if (u >= (long long)q.pads * units) return;
    const int i = static_cast<int>(u / units), part = static_cast<int>(u - (long long)i * units);
    const int j = i - (q.B + 1) * q.Wp;
    long long row;
    if (j < 0) {  // the zero rows: above view 0 and below each view
      row = (long long)(i / q.Wp) * (q.H + 1) * q.Wp + i % q.Wp;
    } else if (j < q.B * q.H) {  // the zero pixel before each image row
      row = (long long)(1 + (j / q.H) * (q.H + 1) + j % q.H) * q.Wp;
    } else {  // the one after the last row, which the last view's last tap reads
      row = (long long)(1 + q.B * (q.H + 1)) * q.Wp;
    }
    *reinterpret_cast<uint4*>(xq + row_offset(q, part, row)) = make_uint4(0, 0, 0, 0);
    return;
  }
  const int cb = blockIdx.x % q.c_blocks, rest = blockIdx.x / q.c_blocks;
  const int pb = rest % q.p_blocks, b = rest / q.p_blocks;
  const int HW = q.H * q.W, p0 = pb * QP, c0 = cb * 32;
  const float sa = *sa_ptr, rsa = __frcp_rn(sa);
  // load: warp w takes channels c0 + 4w .. + 3, lane l pixels p0 + 8l .. + 7
  {
    const int w = t >> 5, l = t & 31, p = p0 + 8 * l;
    const bool vec = (HW & 7) == 0 && p + 8 <= HW;
    uint32_t word[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
      const int c = c0 + 4 * w + ci;
      if (c >= q.C) continue;
      const T* src = x + ((long long)b * q.C + c) * HW + p;
      float v[8];
      if (vec) {
        load8(src, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = p + i < HW ? to_float(src[i]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) word[i] |= quantize(v[i], sa, rsa) << (8 * ci);
    }
    uint4* dst = reinterpret_cast<uint4*>(&tile[w][8 * l]);
    dst[0] = make_uint4(word[0], word[1], word[2], word[3]);
    dst[1] = make_uint4(word[4], word[5], word[6], word[7]);
  }
  __syncthreads();
  // store: pixel px's 16-byte half h (channels c0 + 16h .. + 15) to its row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = t + 256 * r, px = idx >> 1, h = idx & 1, p = p0 + px;
    if (p >= HW) continue;
    const int ih = p / q.W, iw = p - ih * q.W;
    const long long row = q.row0 + (long long)b * q.vstride + (long long)ih * q.Wp + iw;
    const uint4 v = make_uint4(tile[4 * h][px], tile[4 * h + 1][px], tile[4 * h + 2][px], tile[4 * h + 3][px]);
    const long long group = c0 / 16 + h;
    *reinterpret_cast<uint4*>(xq + row_offset(q, group, row)) = v;
  }
}

// ------------------------------------------------------ K6's products
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// D (64 x N, s32) += A (64 x 32 s8, K-major) B (N x 32 s8, K-major), A and B
// from shared memory through their descriptors. D's fragments: thread t of the
// warpgroup holds, for each n8 block j, d[4j + r] = (16 (t / 32) + (t % 32) / 4
// + 8 (r / 2), 8j + 2 (t % 4) + r % 2).
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int32_t (&d)[80], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int32_t (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int32_t (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__host__ __device__ constexpr int min_blocks() {  // blocks per SM the register budget is held to (conv_plan's RESIDENT)
  return BN <= 128 ? 2 : 1;
}
template <int BN>
__host__ __device__ constexpr int ring_cap() {  // the ring's shared memory (conv_plan's RING_BYTES)
  return BN <= 128 ? 104 * 1024 : 200 * 1024;
}
template <int BN>
__host__ __device__ constexpr int stage_bytes() {  // the epilogue's tile: int32, channel-major, rows of BM + 4
  return BN * (k6::BM + 4) * 4;
}
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  static_assert(stage_bytes<BN>() <= ring_cap<BN>(), "the epilogue's tile overlays the ring");
  return 1024 + ring_cap<BN>() + BN * k6::KS + 2 * BN * 4 + k6::BM * 4 + 16 + 2 * k6::MAX_STAGES * 8;
}

template <typename T>
__device__ __forceinline__ T to_out(float y);
template <>
__device__ __forceinline__ float to_out<float>(float y) {
  return y;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float y) {
  return __float2bfloat16_rn(y);
}

// y = float(acc) * scale + add, two roundings (no fused multiply-add), ReLU
__device__ __forceinline__ float affine(int32_t v, float sc, float ad, int relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(v), sc), ad);
  return relu ? fmaxf(y, 0.0f) : y;
}

// The tile's int32 sums, staged channel-major in shared memory (S[nn][m],
// rows of BM + 4), -> the output: warp w stores channel rows w, w + 8, ..;
// pix[m] is output pixel m's offset in (B, Co, Ho, Wo) at channel 0, or -1
// (junk). With vec_ok each lane takes 16 bytes of consecutive pixels, else
// one pixel, neighbouring lanes on neighbouring pixels.
template <typename T, int BN>
__device__ __forceinline__ void store_tile(const int32_t* S, const int* pix, int vec_ok, const Plan& p,
                                           const float* sc_add, T* __restrict__ out, int n0) {
  using namespace k6;
  constexpr int SROW = BM + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, HoWo = p.Ho * p.Wo;
  const int n_valid = min(BN, p.Co - n0);
  for (int nn = warp; nn < n_valid; nn += CONSUMERS / 32) {
    const int n = n0 + nn;
    const int32_t* row = S + nn * SROW;
    T* o_n = out + (long long)n * HoWo;
    if constexpr (std::is_integral<T>::value) {  // int32: the sums themselves
      for (int m = lane; m < BM; m += 32)
        if (pix[m] >= 0) o_n[pix[m]] = row[m];
    } else {
      const float sc = sc_add[nn], ad = sc_add[BN + nn];
      if (vec_ok) {
        constexpr int VEC = 16 / sizeof(T);
        for (int m = lane * VEC; m < BM; m += 32 * VEC) {
          const int o = pix[m];
          if (o < 0) continue;
          alignas(16) T v[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[i] = to_out<T>(affine(row[m + i], sc, ad, p.relu));
          *reinterpret_cast<uint4*>(o_n + o) = *reinterpret_cast<const uint4*>(v);
        }
      } else {
        for (int m = lane; m < BM; m += 32)
          if (pix[m] >= 0) o_n[pix[m]] = to_out<T>(affine(row[m], sc, ad, p.relu));
      }
    }
  }
}

// The consumers' main loop at G slices a stage: each stage's G products are
// issued straight, between one fence and one commit, their descriptors
// computed in line without branches (a product behind a branch makes ptxas
// serialize them all; descriptors kept in an array spill), a missing slice of
// the last stage multiplying the zero tile. A: no swizzle, 16-byte rows, a
// slice's second 16 channels lbo bytes on; flat 3x3, slice j of a stage is tap
// (j / 3, j % 3) of its rows, j / 3 rows of W + 1 and j % 3 pixels into the
// halo; 1x1, 4 KB per slice; rect, 32-byte rows in the 32-byte swizzle, 4 KB
// per slice. B: no swizzle, halves BN x 16 apart.
template <int G, int BN>
__device__ __forceinline__ void consume(int32_t (&acc)[BN / 2], const uint8_t* smem, const uint8_t* zeros,
                                        uint64_t* full, uint64_t* empty, const Plan& p, int a_stage, int lbo3,
                                        int n_iter, int n_stage, int wg, int lane) {
  using namespace k6;
  constexpr int B_BYTES = BN * KS;
  const bool flat3 = p.mode == 0 && p.k == 3, rect = p.mode == 1;
  // a descriptor: the address / 16 in bits 0-13, then the leading (K) and stride (8-row)
  // byte offsets / 16 in bits 16-29 and 32-45, the layout in 62-63 (0 none, 3 the 32-byte swizzle)
  const uint64_t a_hi = rect ? ((uint64_t)1 << 16) | ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62)
                             : ((uint64_t)((flat3 ? lbo3 : A_BYTES / 2) >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
  const uint64_t b_hi = ((uint64_t)(BN * 16 >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
  // slice j's A: step1 j + step3 (j / 3) bytes on, from the warpgroup's first row
  const uint32_t step1 = flat3 ? 16 : A_BYTES, step3 = flat3 ? p.Wp * 16 - 48 : 0;
  const uint32_t wg_row = wg * 64 * (rect ? KS : 16);
  for (int st = 0; st < n_stage; ++st) {
    const int stage = st % p.stages, n_sl = min(G, n_iter - st * G);
    const uint32_t a = smem_u32(smem + stage * p.stage_bytes) + wg_row;
    const uint32_t bt = smem_u32(smem + stage * p.stage_bytes + a_stage), zero = smem_u32(zeros);
    mbar_wait(&full[stage], (st / p.stages) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const uint32_t aj = a + (j < n_sl ? j * step1 + (j / 3) * step3 : 0);
      const uint32_t bj = j < n_sl ? bt + j * B_BYTES : zero;
      wgmma_s8(acc, a_hi | ((aj & 0x3FFFF) >> 4), b_hi | ((bj & 0x3FFFF) >> 4));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: it is free
    if (st > 0 && lane == 0) mbar_arrive(&empty[(st - 1) % p.stages]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

template <int BN>
__global__ void __launch_bounds__(k6::THREADS, min_blocks<BN>())
    conv_int8_kernel(const __grid_constant__ CUtensorMap amap, const int8_t* __restrict__ xq,
                     const int8_t* __restrict__ wt, const Plan p, const float* __restrict__ scale,
                     const float* __restrict__ add, void* __restrict__ out, int32_t* __restrict__ ws,
                     int32_t* __restrict__ counters) {
  using namespace k6;
  constexpr int B_BYTES = BN * KS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* zeros = smem + ring_cap<BN>();  // B of a stage's missing slices: a product of 0
  float* sc_add = reinterpret_cast<float*>(zeros + B_BYTES);  // the tile's scale, then add (the epilogue's)
  int* pix = reinterpret_cast<int*>(sc_add + 2 * BN);
  int* flags = pix + BM;                        // [0] last split, [1] 16-byte stores
  uint64_t* full = reinterpret_cast<uint64_t*>(flags + 4);
  uint64_t* empty = full + MAX_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile_m = blockIdx.x, tile_n = blockIdx.y;
  const int s_begin = blockIdx.z * p.per_split;
  const int n_iter = min(p.per_split, p.slices - s_begin);  // K slices of this block
  const int n_stage = (n_iter + p.group - 1) / p.group;
  const int taps = p.k * p.k, STAGES = p.stages;
  // a stage: A (flat 3x3: two planes of `halo` rows; otherwise `group` slices of 4 KB), then B
  const int a_stage = p.mode == 0 && p.k == 3 ? 2 * ((p.halo + 7) / 8 * 8) * 16 : p.group * A_BYTES;
  const int lbo3 = (p.halo + 7) / 8 * 8 * 16;  // flat 3x3: from a row's first 16 channels to its second
  if (tid == CONSUMERS) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < B_BYTES / 16; i += THREADS) reinterpret_cast<uint4*>(zeros)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < BN; i += THREADS) {  // fetched now, read after the main loop
    const int n = blockIdx.y * BN + i;
    const bool ok = n < p.Co && p.out_kind != 2;
    sc_add[i] = ok ? scale[n] : 0.0f;
    sc_add[BN + i] = ok ? add[n] : 0.0f;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the wgmma reads them
  __syncthreads();

  // the tile's place: flat, its first output pixel q0; rect, its view and corner
  int q0 = 0, b = 0, oh0 = 0, ow0 = 0;
  if (p.mode == 0) {
    q0 = tile_m * BM;
  } else {
    const int per_view = p.tiles_h * p.tiles_w, r = tile_m % per_view;
    b = tile_m / per_view;
    oh0 = (r / p.tiles_w) * p.th;
    ow0 = (r % p.tiles_w) * p.tw;
  }

  // K slice s is chunk s / taps (32 channels), tap s % taps (kh = tap / k, kw = tap % k)
  if (warp == CONSUMERS / 32) {  // the producer warp: its lanes issue a stage's copies together
    const int8_t* w_tile = wt + (long long)tile_n * p.slices * B_BYTES;
    for (int st = 0; st < n_stage; ++st) {
      const int stage = st % STAGES, first = s_begin + st * p.group, n_sl = min(p.group, n_iter - st * p.group);
      const int chunk = first / taps, tap0 = first - chunk * taps;
      mbar_wait(&empty[stage], ((st / STAGES) & 1) ^ 1);
      uint8_t* a_dst = smem + stage * p.stage_bytes;
      if (p.mode == 0 && p.k == 3) {  // lanes 0, 1: the chunk's two planes, rows q0 + kh0 Wp ..
        if (lane == 0) mbar_expect_tx(&full[stage], 2 * p.halo * 16 + n_sl * B_BYTES);
        __syncwarp();
        if (lane < 2)
          bulk_load(a_dst + lane * lbo3, xq + 16 * ((2LL * chunk + lane) * p.rows_alloc + q0 + (tap0 / 3) * p.Wp),
                    p.halo * 16, &full[stage]);
      } else if (p.mode == 0) {  // 1x1: n_sl chunks' planes of the tile, contiguous in the blocked rows
        if (lane == 0) mbar_expect_tx(&full[stage], n_sl * (A_BYTES + B_BYTES));
        __syncwarp();
        if (lane == 0)
          bulk_load(a_dst, xq + ((long long)tile_m * p.chunks + first) * A_BYTES, n_sl * A_BYTES, &full[stage]);
      } else {  // rect: one strided box a slice
        if (lane == 0) mbar_expect_tx(&full[stage], n_sl * (A_BYTES + B_BYTES));
        __syncwarp();
        if (lane < n_sl) {
          const int s = first + lane, c = s / taps, tap = s - c * taps, kh = tap / p.k, kw = tap - kh * p.k;
          tma_load_4d(a_dst + lane * A_BYTES, &amap, &full[stage], c * KS, ow0 * p.stride - p.pad + kw,
                      oh0 * p.stride - p.pad + kh, b);
        }
      }
      if (lane == 31)  // the stage's B: n_sl consecutive slices of the weight tile, contiguous
        bulk_load(a_dst + a_stage, w_tile + (long long)first * B_BYTES, n_sl * B_BYTES, &full[stage]);
    }
    return;
  }

  // the consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63 of the tile.
  const int wg = warp >> 2;
  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  if (p.group == 9) {
    consume<9, BN>(acc, smem, zeros, full, empty, p, a_stage, lbo3, n_iter, n_stage, wg, lane);
  } else if (p.group == 3) {
    consume<3, BN>(acc, smem, zeros, full, empty, p, a_stage, lbo3, n_iter, n_stage, wg, lane);
  } else {
    consume<4, BN>(acc, smem, zeros, full, empty, p, a_stage, lbo3, n_iter, n_stage, wg, lane);
  }
  consumers_sync();  // both warpgroups' products done: the ring may be overwritten

  const int tile = tile_n * p.tiles_m + tile_m;
  if (p.splits > 1) {  // add the partial sums in L2; the last split to arrive finishes the tile
    int32_t* part = reinterpret_cast<int32_t*>(smem);
    int32_t* w = ws + (long long)tile * (BM * BN);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[i * CONSUMERS + tid] = acc[i];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the reduction reads them
    consumers_sync();
    if (tid == 0) {
      bulk_reduce_add(w, part, BM * BN * 4);
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      __threadfence();
      flags[0] = atomicAdd(&counters[tile], 1) == p.splits - 1;
    }
    consumers_sync();
    if (!flags[0]) return;
    __threadfence();
    w += tid;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = __ldcg(w + i * CONSUMERS);  // all in flight, then
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) __stcg(w + i * CONSUMERS, 0);        // zero for the next launch
    if (tid == 0) counters[tile] = 0;
    consumers_sync();  // the partial sums read: the staging below may overwrite them
  }

  // the sums, channel-major: thread t of warpgroup wg holds, for each n8 block
  // j, rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8j + 2 (t % 4) (+ 1)
  {
    int32_t* S = reinterpret_cast<int32_t*>(smem);
    const int t = tid & 127, row0 = 64 * wg + 16 * (t >> 5) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int nn = 8 * j + 2 * (lane & 3) + c;
        S[nn * (BM + 4) + row0] = acc[4 * j + c];
        S[nn * (BM + 4) + row0 + 8] = acc[4 * j + 2 + c];
      }
  }
  // output pixel m of the tile -> its offset in (B, Co, Ho, Wo) at channel 0, or -1
  const int HoWo = p.Ho * p.Wo, vec = p.out_kind == 1 ? 8 : 4;
  if (tid < BM) {
    int o = -1;
    if (p.mode == 0) {
      const int q = q0 + tid, vb = q / p.QV, r = q - vb * p.QV, oh = r / p.Wp, ow = r - oh * p.Wp;
      if (vb < p.B && oh < p.Ho && ow < p.Wo) o = vb * p.Co * HoWo + oh * p.Wo + ow;
    } else {
      const int oh = oh0 + tid / p.tw, ow = ow0 + tid % p.tw;
      if (oh < p.Ho && ow < p.Wo) o = b * p.Co * HoWo + oh * p.Wo + ow;
    }
    pix[tid] = o;
  }
  if (tid == 0) flags[1] = HoWo % vec == 0 && p.out_kind != 2;
  consumers_sync();
  if (tid < BM / vec) {  // a run of vec pixels: all junk, or whole and aligned in the output
    const int o = pix[tid * vec];
    bool ok = o < 0 || o % vec == 0;
    for (int i = 1; i < vec; ++i) ok = ok && pix[tid * vec + i] == (o < 0 ? -1 : o + i);
    if (!ok) flags[1] = 0;
  }
  consumers_sync();
  const int vec_ok = flags[1], n0 = tile_n * BN;
  const int32_t* S = reinterpret_cast<const int32_t*>(smem);
  if (p.out_kind == 0) {
    store_tile<float, BN>(S, pix, vec_ok, p, sc_add, static_cast<float*>(out), n0);
  } else if (p.out_kind == 1) {
    store_tile<__nv_bfloat16, BN>(S, pix, vec_ok, p, sc_add, static_cast<__nv_bfloat16*>(out), n0);
  } else {
    store_tile<int32_t, BN>(S, pix, vec_ok, p, sc_add, static_cast<int32_t*>(out), n0);
  }
}

// m = [rank, dims[5], strides[4] (bytes, dims 1..), box[5], element strides[5]] (tensor_map_args)
int encode(CUtensorMap* map, const void* base, const long long* m) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ENCODE_FAILED + CUDA_ERROR_NOT_FOUND;
  const int rank = static_cast<int>(m[0]);
  if (rank < 2 || rank > 5) return (int)cudaErrorInvalidValue;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5], es[5];
  for (int i = 0; i < 5; ++i) {
    dims[i] = static_cast<cuuint64_t>(m[1 + i]);
    box[i] = static_cast<cuuint32_t>(m[10 + i]);
    es[i] = static_cast<cuuint32_t>(m[15 + i]);
  }
  for (int i = 0; i < 4; ++i) strides[i] = static_cast<cuuint64_t>(m[6 + i]);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims, strides, box, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + static_cast<int>(r);
}

template <int BN>
int launch(const CUtensorMap& amap, const int8_t* xq, const int8_t* wt, const Plan& p, const float* scale,
           const float* add, void* out, int32_t* ws, int32_t* counters, cudaStream_t s) {
  static bool sized = false;  // the dynamic shared memory above 48 KB, once per instantiation
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(conv_int8_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BN>());
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid(p.tiles_m, p.tiles_n, p.splits);
  conv_int8_kernel<BN><<<grid, k6::THREADS, smem_bytes<BN>(), s>>>(amap, xq, wt, p, scale, add, out, ws, counters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, C, H, W) contiguous, bf16 (dtype 1) or fp32 (dtype 0); sa one fp32 on
// the device; xq the rows of quant_plan's layout, Cp int8 each, 16-byte aligned.
// plan: QuantPlan's fields in order. Returns cudaGetLastError() after the launch.
int petr_quantize_act(const void* x, int dtype, const void* sa, void* xq, const int* plan, void* stream) {
  QuantPlan q;
  static_assert(sizeof(QuantPlan) == 15 * sizeof(int), "QuantPlan is 15 ints");
  memcpy(&q, plan, sizeof(q));
  if (q.B <= 0 || q.C <= 0 || q.H <= 0 || q.W <= 0 || q.Cp < q.C || q.Cp % 32 != 0 || q.c_blocks != q.Cp / 32 ||
      q.p_blocks != (q.H * q.W + k6::QP - 1) / k6::QP || q.data_blocks != q.B * q.p_blocks * q.c_blocks ||
      q.pads < 0 || q.plane_stride <= 0 || q.row_stride <= 0 || (q.blocked != 0 && q.blocked != 1))
    return (int)cudaErrorInvalidValue;
  const long long blocks = q.data_blocks + ((long long)q.pads * (q.Cp / 16) + 255) / 256;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    quantize_act_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(sa), static_cast<int8_t*>(xq), q);
  } else if (dtype == 0) {
    quantize_act_kernel<float><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(sa), static_cast<int8_t*>(xq), q);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// xq: the rows quantize_act wrote (flat: 16-channel planes of rows_alloc rows,
// rect: channels-last rows); wt the weight tiles (tiles_n, slices, 2, bn, 16)
// int8; scale and add (Co,) fp32 (unread for the int32 sums); out (B, Co, Ho,
// Wo) fp32, bf16 or int32 (plan's out_kind); plan: Plan's fields in order; bn
// the tile's output channels (64, 128, 160, 192 or 256); amap the rect
// mode's tensor map arguments over xq (unread in the flat mode); ws and
// counters the split workspace (tiles_m x tiles_n x 128 x bn and tiles_m x
// tiles_n int32, all zero, left zero) when plan's splits > 1. Returns
// cudaGetLastError() after the launch.
static long long ring_cap_of(int bn) {
  return bn <= 128 ? ring_cap<128>() : ring_cap<256>();
}

int petr_conv_int8_fwd(const void* xq, const void* wt, const void* scale, const void* add, void* out,
                       const int* plan, int bn, const long long* amap, void* ws, void* counters, void* stream) {
  Plan p;
  static_assert(sizeof(Plan) == 30 * sizeof(int), "Plan is 30 ints");
  memcpy(&p, plan, sizeof(p));
  if (p.B <= 0 || p.Cp <= 0 || p.Cp % 32 != 0 || p.Co <= 0 || (p.k != 1 && p.k != 3) ||
      (p.stride != 1 && p.stride != 2) || p.pad != p.k / 2 || p.Ho != (p.H + 2 * p.pad - p.k) / p.stride + 1 ||
      p.Wo != (p.W + 2 * p.pad - p.k) / p.stride + 1 || p.chunks != p.Cp / 32 ||
      p.slices != p.k * p.k * p.chunks || p.tiles_m <= 0 || p.tiles_n != (p.Co + bn - 1) / bn || p.splits <= 0 ||
      p.splits > 65535 || p.tiles_n > 65535 || p.per_split <= 0 || (p.splits - 1) * p.per_split >= p.slices ||
      p.splits * p.per_split < p.slices || (p.mode == 1 && (p.tw * p.th != k6::BM || p.tw <= 0)) ||
      (p.mode != 0 && p.mode != 1) ||
      (p.mode == 0 && (p.stride != 1 || p.Wp <= 0 || p.QV <= 0 || p.rows_alloc < p.tiles_m * k6::BM)) ||
      (p.group != 9 && p.group != 4 && p.group != 3) || p.stages < 2 || p.stages > k6::MAX_STAGES ||
      p.stage_bytes % 1024 != 0 || (long long)p.stages * p.stage_bytes > ring_cap_of(bn) ||
      (p.mode == 0 && p.k == 3 && ((p.group != 9 && p.group != 3) || p.per_split % p.group != 0 ||
                                   p.halo != 128 + (p.group == 9 ? 2 * p.Wp : 0) + 2)) ||
      p.out_kind < 0 || p.out_kind > 2 || (p.splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (p.out_kind != 2 && (scale == nullptr || add == nullptr)) || (long long)p.B * p.Co * p.Ho * p.Wo > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap am;
  memset(&am, 0, sizeof(am));
  if (p.mode == 1) {
    const int err = encode(&am, xq, amap);
    if (err != 0) return err;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x8 = static_cast<const int8_t*>(xq);
  const auto* w8 = static_cast<const int8_t*>(wt);
  const auto* sc = static_cast<const float*>(scale);
  const auto* ad = static_cast<const float*>(add);
  auto* w32 = static_cast<int32_t*>(ws);
  auto* c32 = static_cast<int32_t*>(counters);
  switch (bn) {
    case 64: return launch<64>(am, x8, w8, p, sc, ad, out, w32, c32, s);
    case 128: return launch<128>(am, x8, w8, p, sc, ad, out, w32, c32, s);
    case 160: return launch<160>(am, x8, w8, p, sc, ad, out, w32, c32, s);
    case 192: return launch<192>(am, x8, w8, p, sc, ad, out, w32, c32, s);
    case 256: return launch<256>(am, x8, w8, p, sc, ad, out, w32, c32, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* petr_cuda_error_string(int err) {
  if (err >= ENCODE_FAILED) return "cuTensorMapEncodeTiled refused the tensor map (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
