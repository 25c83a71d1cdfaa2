// Fused 3x3 convolution (stride 1, padding 1) + scale/shift + ReLU for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (petr_tpu_torch/ops/conv3x3.py).
//
// Replaces petr_tpu/ops/pallas/conv3x3.py::_conv3x3_raw (kernel body
// _make_kernel): out = act(conv3x3(x, w) * mul + add), the conv summed in
// fp32, mul and add (the folded frozen BN) in fp32, the optional ReLU, and
// one rounding to x's type. Layout NCHW: x (B, C, H, W), mul and add (Co,)
// fp32 or absent, out (B, Co, H, W) in x's type. It is the opt-in route of
// ConvBNReLU (PETR_TPU_TORCH_CONV_IMPL=cuda), taken by the 80 VoVNet OSA
// convs of a flagship forward. Three kernels, chosen by the caller by dtype:
//
// * bf16, the route's: layout_kernel, then conv3x3_wgmma_kernel.
// * conv3x3_bn_relu_fp32_kernel, fp32, on the CUDA cores: for fp32 callers
//   (the tests and the fp32 checks), whose 2e-5 x max|ref| bound TF32 would
//   break.
//
// What bounds the route. The 80 convs of a flagship forward (6 views of
// 320x800; Cin -> Co of 128 -> 128 at 80x200, 160..512 -> 160 at 40x100,
// 192..768 -> 192 at 20x50, 224..1024 -> 224 at 10x25) do 0.68 TFLOP of
// products: 0.685 ms at 989 TFLOP/s bf16. Their bytes (x read once, out
// written once, bf16) take under 0.1 ms at 3.35 TB/s. The products bound it.
// On the CUDA cores (the fp32 kernel) their floor is 67 TFLOP/s, about 10 ms.
//
// The bf16 design is K6's 3x3 stride-1 plan (conv_int8.cu) in bf16: a
// k16 slice of bf16 is 32 bytes a row, as K6's k32 slice of int8 is, and
// costs the tensor cores the same clocks, so the plan (tile width, split,
// stages) is K6's, made in ops/conv3x3.py::conv_plan.
// * layout_kernel, one pass over x: NCHW bf16 into 8-channel planes of the
//   "flat padded" grid (each image row preceded by one zero pixel, each view
//   by one zero row: W + 1 pixels a row), 16 bytes a row, channels past C
//   zero, the padding pixels written as zeros by extra blocks. A block reads
//   16 channels x 256 pixels with 16-byte loads, transposes them in shared
//   memory and writes 16-byte stores. It reads and writes x once per conv:
//   the price of taking NCHW x as ConvBNReLU hands it (the alternative, a
//   TMA box per tap straight from NCHW, would need one box per tap, since a
//   one-pixel shift there is 2 bytes, not a 16-byte row).
// * conv3x3_wgmma_kernel: an implicit GEMM on wgmma.mma_async m64nNk16 bf16
//   with fp32 sums, a tile of 128 output pixels of the flat grid (two
//   consumer warpgroups of 64 rows) by N = 64..256 output channels. K =
//   9 Cp is walked chunk-major (16 channels, then their 9 taps). Output
//   pixel q reads input row q + kh (W + 1) + kw, so a chunk's 9 taps are row
//   shifts of one halo: a producer warp brings a stage's A as two bulk
//   copies (the chunk's two 8-channel planes, 128 + 2 (W + 1) + 2 rows, or
//   130 rows of one kernel row's 3 taps where two such stages do not fit)
//   and its B, the weight image's slices (laid out once per weight version,
//   ops/conv3x3.py::weight_image, as the no-swizzle K-major tiles the wgmma
//   reads), as one bulk copy, on a ring of 2 to 4 stages and mbarriers; each
//   tap's wgmma descriptor starts kh (W + 1) + kw rows into the halo. A
//   stage's products are issued straight between one fence and one commit
//   (a wgmma behind a branch makes ptxas serialise them all).
//   Where the tiles alone do not fill the SMs the plan splits K: each split
//   writes its fp32 partial sums to a workspace, and the split that arrives
//   last (a counter per tile) adds all of them in split order, so the result
//   does not depend on which block finished first, then runs the epilogue.
//   The epilogue: acc * mul + add in fp32 (two roundings, no fused
//   multiply-add, as the plain version), ReLU, one rounding to bf16, staged
//   in shared memory channel-major and stored along the output's pixels.
//
// What still holds it back (PERF.md, K5's row): the layout pass (about a
// tenth of a call's device time), and at the deep stages a block's fixed
// costs (the ring's first fill, the epilogue, a split's partial sums
// through L2) against few slices; the conv runs at 10-42% of the tensor
// cores' peak by shape (chip_smoke.py's phase 3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"  // mbarriers, bulk copies, wgmma

namespace {

// ------------------------------------------------------- fp32, CUDA cores
namespace fp32 {
constexpr int TH = 4;              // output rows per block
constexpr int TW = 16;             // output columns per block
constexpr int BO = 64;             // output channels per block
constexpr int CC = 8;              // input channels per chunk
constexpr int THREADS = 256;
constexpr int TP = 4;              // pixels per thread (one row, 4 columns)
constexpr int TO = 4;              // output channels per thread
constexpr int WPAD = BO + 4;       // weight tile row: 4-way bank conflicts at most on its stores
}  // namespace fp32

// A block owns one image, 4 x 16 output pixels and 64 output channels; it
// stages an 8-channel halo and its (8 * 9, 64) weights as fp32 in shared
// memory and each thread adds a 4x4 tile of (pixel, channel) products.
__global__ void __launch_bounds__(fp32::THREADS)
conv3x3_bn_relu_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ mul, const float* __restrict__ add,
                            float* __restrict__ out, int C, int H, int W, int Co, int tiles_w,
                            int affine, int relu) {
  using namespace fp32;
  __shared__ float s_x[CC][TH + 2][TW + 2];           // the chunk's input halo
  __shared__ __align__(16) float s_w[CC * 9][WPAD];   // the chunk's weights, (c * 9 + k, o)

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int o0 = blockIdx.y * BO;
  const int J = C * 9;

  const int tx = tid % (BO / TO);        // channels tx * 4 .. + 3
  const int ty = tid / (BO / TO);        // pixels ty * 4 .. + 3 of the tile
  const int prow = ty / (TW / TP);       // their row in the tile
  const int pcol = (ty % (TW / TP)) * TP;  // their first column

  float acc[TP][TO];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int c = 0; c < TO; ++c) acc[i][c] = 0.f;

  const float* xb = x + (size_t)b * C * H * W;
  constexpr int HALO = (TH + 2) * (TW + 2);
  for (int c0 = 0; c0 < C; c0 += CC) {
    for (int i = tid; i < CC * HALO; i += THREADS) {
      const int c = i / HALO, rem = i - c * HALO;
      const int hy = rem / (TW + 2), hx = rem - hy * (TW + 2);
      const int gy = y0 + hy - 1, gx = x0 + hx - 1;
      float v = 0.f;
      if (c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = xb[((size_t)(c0 + c) * H + gy) * W + gx];
      s_x[c][hy][hx] = v;
    }
    for (int i = tid; i < CC * 9 * BO; i += THREADS) {
      const int r = i % (CC * 9), o = i / (CC * 9);
      const int j = c0 * 9 + r, oo = o0 + o;
      s_w[r][o] = (j < J && oo < Co) ? w[(size_t)oo * J + j] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < CC; ++c) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int kh = k / 3, kw = k % 3;
        float av[TP];
#pragma unroll
        for (int i = 0; i < TP; ++i) av[i] = s_x[c][prow + kh][pcol + i + kw];
        const float4 bw = *reinterpret_cast<const float4*>(&s_w[c * 9 + k][tx * TO]);
        const float bv[TO] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
        for (int i = 0; i < TP; ++i)
#pragma unroll
          for (int cc = 0; cc < TO; ++cc) acc[i][cc] = fmaf(av[i], bv[cc], acc[i][cc]);
      }
    }
    __syncthreads();
  }

  const int row = y0 + prow;
  if (row >= H) return;
#pragma unroll
  for (int cc = 0; cc < TO; ++cc) {
    const int oo = o0 + tx * TO + cc;
    if (oo >= Co) continue;
    const float m = affine ? mul[oo] : 1.f;
    const float a = affine ? add[oo] : 0.f;
    float* orow = out + (((size_t)b * Co + oo) * H + row) * W;
#pragma unroll
    for (int i = 0; i < TP; ++i) {
      const int col = x0 + pcol + i;
      if (col >= W) continue;
      float v = acc[i][cc];
      if (affine) v = v * m + a;
      if (relu) v = fmaxf(v, 0.f);
      orow[col] = v;
    }
  }
}

// --------------------------------------------------- bf16, tensor cores
namespace k5 {
constexpr int BM = 128;                  // output pixels per tile: two consumer warpgroups of 64 rows
constexpr int SLICE_BYTES = 32;          // a K slice's row: one tap's 16 channels, one wgmma k16
constexpr int MAX_STAGES = 4;
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int LP = 256;                  // the layout pass's pixels per block (x 16 channels)
}  // namespace k5

// The plan (ops/conv3x3.py: ConvPlan.kernel_args, field for field). Output
// pixel (b, oh, ow) is row q = b QV + oh Wp + ow of the flat grid (Wp = W + 1
// columns, H + 1 rows a view: a junk column and a junk row, never stored);
// input pixel (b, ih, iw) sits at row Wp + 1 + b QV + ih Wp + iw of each
// 8-channel plane (rows_alloc rows of 16 bytes); a 3x3 tap (kh, kw) of
// output row q reads row q + kh Wp + kw.
struct Plan {
  int B, C, Cp, H, W, Co;
  int chunks, slices;  // Cp / 16, 9 chunks: K slice s is chunk s / 9, tap s % 9
  int tiles_m, tiles_n, splits, per_split;
  int Wp, QV, rows_alloc;
  int group;        // K slices per pipeline stage: 9 (a chunk's taps) or 3 (one kernel row's)
  int halo;         // rows of a plane one stage's A copy takes (128 + the taps' row shifts)
  int stages, stage_bytes;
  int p_blocks, data_blocks, pads;  // the layout pass: pixel blocks per view, its data blocks, zero pixels
  int affine, relu;
};

__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// NCHW bf16 x -> the 8-channel planes of the flat padded grid. Blocks below
// data_blocks each take 16 channels x 256 pixels of one view; the rest write
// the zero pixels.
__global__ void __launch_bounds__(256) conv3x3_bn_relu_layout_kernel(const __nv_bfloat16* __restrict__ x,
                                                                     __nv_bfloat16* __restrict__ xp, const Plan p) {
  using namespace k5;
  // [channel pair][pixel]: a word holds one pixel's two channels, the even one low
  __shared__ __align__(16) uint32_t tile[8][LP + 4];
  const int t = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= p.data_blocks) {
    const int planes = p.Cp / 8;
    const long long u = (long long)(blockIdx.x - p.data_blocks) * 256 + t;
    if (u >= (long long)p.pads * planes) return;
    const int i = static_cast<int>(u / planes), j = static_cast<int>(u - (long long)i * planes);
    const int z = i - (p.B + 1) * p.Wp;
    long long row;
    if (z < 0) {  // the zero rows: above view 0 and below each view
      row = (long long)(i / p.Wp) * (p.H + 1) * p.Wp + i % p.Wp;
    } else if (z < p.B * p.H) {  // the zero pixel before each image row
      row = (long long)(1 + (z / p.H) * (p.H + 1) + z % p.H) * p.Wp;
    } else {  // the one after the last row, which the last view's last tap reads
      row = (long long)(1 + p.B * (p.H + 1)) * p.Wp;
    }
    *reinterpret_cast<uint4*>(xp + 8 * ((long long)j * p.rows_alloc + row)) = make_uint4(0, 0, 0, 0);
    return;
  }
  const int cblocks = p.Cp / 16;
  const int cb = blockIdx.x % cblocks, rest = blockIdx.x / cblocks;
  const int pb = rest % p.p_blocks, b = rest / p.p_blocks;
  const int HW = p.H * p.W, p0 = pb * LP, c0 = cb * 16;
  // load: warp w takes channels c0 + 2w and c0 + 2w + 1, lane l pixels p0 + 8l .. + 7
  {
    const int w = t >> 5, l = t & 31, px = p0 + 8 * l;
    const bool vec = (HW & 7) == 0 && px + 8 <= HW;
    uint32_t v[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};  // a channel's 8 pixels, in pairs
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int c = c0 + 2 * w + ci;
      if (c >= p.C) continue;
      const __nv_bfloat16* src = x + ((long long)b * p.C + c) * HW + px;
      if (vec) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        v[ci][0] = u.x;
        v[ci][1] = u.y;
        v[ci][2] = u.z;
        v[ci][3] = u.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (px + i < HW) v[ci][i >> 1] |= bf16_bits(src[i]) << (16 * (i & 1));
      }
    }
    uint32_t word[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t lo = (v[0][i >> 1] >> (16 * (i & 1))) & 0xffffu;
      const uint32_t hi = (v[1][i >> 1] >> (16 * (i & 1))) & 0xffffu;
      word[i] = lo | (hi << 16);
    }
    uint4* dst = reinterpret_cast<uint4*>(&tile[w][8 * l]);
    dst[0] = make_uint4(word[0], word[1], word[2], word[3]);
    dst[1] = make_uint4(word[4], word[5], word[6], word[7]);
  }
  __syncthreads();
  // store: pixel px's plane j (channels c0 + 8j .. + 7) to its row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = t + 256 * r, px = idx >> 1, j = idx & 1, pix = p0 + px;
    if (pix >= HW) continue;
    const int ih = pix / p.W, iw = pix - ih * p.W;
    const long long row = (p.Wp + 1) + (long long)b * p.QV + (long long)ih * p.Wp + iw;
    const uint4 val = make_uint4(tile[4 * j][px], tile[4 * j + 1][px], tile[4 * j + 2][px], tile[4 * j + 3][px]);
    *reinterpret_cast<uint4*>(xp + 8 * ((long long)(c0 / 8 + j) * p.rows_alloc + row)) = val;
  }
}

template <int BN>
__host__ __device__ constexpr int min_blocks() {  // blocks per SM the register budget is held to (conv_int8.RESIDENT)
  return BN <= 128 ? 2 : 1;
}
template <int BN>
__host__ __device__ constexpr int ring_cap() {  // the ring's shared memory (conv_int8.RING_BYTES)
  return BN <= 128 ? 104 * 1024 : 200 * 1024;
}
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  static_assert(BN * (k5::BM + 4) * 4 <= ring_cap<BN>(), "the epilogue's tile overlays the ring");
  return 1024 + ring_cap<BN>() + 2 * BN * 4 + k5::BM * 4 + 16 + 2 * k5::MAX_STAGES * 8;
}

// The consumers' main loop at G slices a stage: each stage's G products are
// issued straight, between one fence and one commit, their descriptors
// computed in line without branches. A: no swizzle, 16-byte rows, a slice's
// second 8 channels `lbo` bytes on (the next plane); slice j of a stage is tap
// (j / 3, j % 3) of its rows, j / 3 rows of Wp and j % 3 pixels into the halo.
// B: no swizzle, halves BN x 16 bytes apart.
template <int G, int BN>
__device__ __forceinline__ void consume(float (&acc)[BN / 2], const uint8_t* smem, uint64_t* full, uint64_t* empty,
                                        const Plan& p, int a_stage, int lbo, int n_stage, int wg, int lane) {
  constexpr int B_BYTES = BN * k5::SLICE_BYTES;
  const uint64_t a_hi = ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
  const uint64_t b_hi = ((uint64_t)(BN * 16 >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
  const uint32_t step3 = p.Wp * 16 - 48;  // slice j's A: 16 j + step3 (j / 3) bytes on
  const uint32_t wg_row = wg * 64 * 16;
  for (int st = 0; st < n_stage; ++st) {
    const int stage = st % p.stages;
    const uint32_t a = smem_u32(smem + stage * p.stage_bytes) + wg_row;
    const uint32_t bt = smem_u32(smem + stage * p.stage_bytes + a_stage);
    mbar_wait(&full[stage], (st / p.stages) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const uint32_t aj = a + j * 16 + (j / 3) * step3;
      const uint32_t bj = bt + j * B_BYTES;
      wgmma_ss(acc, a_hi | ((aj & 0x3FFFF) >> 4), b_hi | ((bj & 0x3FFFF) >> 4), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: it is free
    if (st > 0 && lane == 0) mbar_arrive(&empty[(st - 1) % p.stages]);
  }
  wgmma_wait<0>();
  wgmma_hold(acc);
}

// xp: the planes the layout pass wrote; wt: the weight image (tiles_n,
// slices, 2, BN, 8) bf16; ws and counters: a split plan's fp32 partial sums
// (tiles_m x tiles_n x splits x 128 x BN) and per-tile counters (zero, left
// zero).
template <int BN>
__global__ void __launch_bounds__(k5::THREADS, min_blocks<BN>())
    conv3x3_bn_relu_wgmma_kernel(const __nv_bfloat16* __restrict__ xp, const __nv_bfloat16* __restrict__ wt,
                                 const Plan p, const float* __restrict__ mul, const float* __restrict__ add,
                                 __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters) {
  using namespace k5;
  constexpr int B_BYTES = BN * SLICE_BYTES;
  constexpr int SROW = BM + 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* sc_add = reinterpret_cast<float*>(smem + ring_cap<BN>());  // the tile's mul, then add (the epilogue's)
  int* pix = reinterpret_cast<int*>(sc_add + 2 * BN);
  int* flags = pix + BM;  // [0] last split
  uint64_t* full = reinterpret_cast<uint64_t*>(flags + 4);
  uint64_t* empty = full + MAX_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile_m = blockIdx.x, tile_n = blockIdx.y;
  const int s_begin = blockIdx.z * p.per_split;
  const int n_stage = min(p.per_split, p.slices - s_begin) / p.group;  // whole stages (the plan's multiples)
  const int lbo = (p.halo + 7) / 8 * 8 * 16;                             // from a plane of the halo to the next
  const int a_stage = 2 * lbo;                                           // a stage: A (two planes), then B
  if (tid == CONSUMERS) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  for (int i = tid; i < BN; i += THREADS) {  // fetched now, read after the main loop
    const int n = tile_n * BN + i;
    const bool ok = n < p.Co && p.affine;
    sc_add[i] = ok ? mul[n] : 1.0f;
    sc_add[BN + i] = ok ? add[n] : 0.0f;
  }
  __syncthreads();
  const int q0 = tile_m * BM;

  if (warp == CONSUMERS / 32) {  // the producer warp: lanes 0, 1 copy the chunk's two planes, lane 31 its B
    const __nv_bfloat16* w_tile = wt + (long long)tile_n * p.slices * (B_BYTES / 2);
    for (int st = 0; st < n_stage; ++st) {
      const int stage = st % p.stages, first = s_begin + st * p.group;
      const int chunk = first / 9, tap0 = first - chunk * 9;
      mbar_wait(&empty[stage], ((st / p.stages) & 1) ^ 1);
      uint8_t* a_dst = smem + stage * p.stage_bytes;
      if (lane == 0) mbar_expect_tx(&full[stage], 2 * p.halo * 16 + p.group * B_BYTES);
      __syncwarp();
      if (lane < 2)
        bulk_load(a_dst + lane * lbo, xp + 8 * ((2LL * chunk + lane) * p.rows_alloc + q0 + (tap0 / 3) * p.Wp),
                  p.halo * 16, &full[stage]);
      if (lane == 31)
        bulk_load(a_dst + a_stage, w_tile + (long long)first * (B_BYTES / 2), p.group * B_BYTES, &full[stage]);
    }
    return;
  }

  // the consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  if (p.group == 9) {
    consume<9, BN>(acc, smem, full, empty, p, a_stage, lbo, n_stage, wg, lane);
  } else {
    consume<3, BN>(acc, smem, full, empty, p, a_stage, lbo, n_stage, wg, lane);
  }
  consumers_sync();  // both warpgroups' products done: the ring may be overwritten

  if (p.splits > 1) {  // every split stores its sums; the last to arrive adds them all in split order
    constexpr int TILE = BM * BN;
    const long long tile = (long long)tile_n * p.tiles_m + tile_m;
    float* part = ws + tile * p.splits * TILE + tid;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) __stcg(part + (long long)blockIdx.z * TILE + i * CONSUMERS, acc[i]);
    __threadfence();
    consumers_sync();
    if (tid == 0) flags[0] = atomicAdd(&counters[tile], 1) == p.splits - 1;
    consumers_sync();
    if (!flags[0]) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = __ldcg(part + i * CONSUMERS);
    for (int s = 1; s < p.splits; ++s) {
      const float* ps = part + (long long)s * TILE;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += __ldcg(ps + i * CONSUMERS);
    }
    if (tid == 0) counters[tile] = 0;  // for the next launch
  }

  // the sums, channel-major: thread t of warpgroup wg holds, for each n8 block
  // j, rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8j + 2 (t % 4) (+ 1)
  float* S = reinterpret_cast<float*>(smem);
  {
    const int t = tid & 127, row0 = 64 * wg + 16 * (t >> 5) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int nn = 8 * j + 2 * (lane & 3) + c;
        S[nn * SROW + row0] = acc[4 * j + c];
        S[nn * SROW + row0 + 8] = acc[4 * j + 2 + c];
      }
  }
  // output pixel m of the tile -> its offset in (B, Co, H, W) at channel 0, or -1 (junk)
  const int HW = p.H * p.W;
  if (tid < BM) {
    const int q = q0 + tid, vb = q / p.QV, r = q - vb * p.QV, oh = r / p.Wp, ow = r - oh * p.Wp;
    pix[tid] = vb < p.B && oh < p.H && ow < p.W ? vb * p.Co * HW + oh * p.W + ow : -1;
  }
  consumers_sync();
  // warp w stores channel rows w, w + 8, ..; neighbouring lanes on neighbouring pixels
  const int n0 = tile_n * BN, n_valid = min(BN, p.Co - n0);
  for (int nn = warp; nn < n_valid; nn += CONSUMERS / 32) {
    const float* row = S + nn * SROW;
    __nv_bfloat16* o_n = out + (long long)(n0 + nn) * HW;
    const float sc = sc_add[nn], ad = sc_add[BN + nn];
    for (int m = lane; m < BM; m += 32) {
      const int o = pix[m];
      if (o < 0) continue;
      float v = row[m];
      if (p.affine) v = __fadd_rn(__fmul_rn(v, sc), ad);
      if (p.relu) v = fmaxf(v, 0.0f);
      o_n[o] = __float2bfloat16_rn(v);
    }
  }
}

template <int BN>
int launch(const __nv_bfloat16* xp, const __nv_bfloat16* wt, const Plan& p, const float* mul, const float* add,
           __nv_bfloat16* out, float* ws, int* counters, cudaStream_t s) {
  static bool sized = false;  // the dynamic shared memory above 48 KB, once per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(conv3x3_bn_relu_wgmma_kernel<BN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BN>());
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid(p.tiles_m, p.tiles_n, p.splits);
  conv3x3_bn_relu_wgmma_kernel<BN><<<grid, k5::THREADS, smem_bytes<BN>(), s>>>(xp, wt, p, mul, add, out, ws, counters);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int ring_cap_of(int bn) { return bn <= 128 ? ring_cap<128>() : ring_cap<256>(); }

// The plan's ranges (its arithmetic is ops/conv3x3.py::conv_plan's, which the
// CPU tests hold): the layout pass's, then the conv's
bool layout_ok(const Plan& p) {
  using namespace k5;
  return p.B > 0 && p.C > 0 && p.Cp >= p.C && p.Cp % 16 == 0 && p.H > 0 && p.W > 0 && p.Wp == p.W + 1 &&
         p.QV == (p.H + 1) * p.Wp && (long long)p.rows_alloc >= (long long)(1 + p.B * (p.H + 1)) * p.Wp + 1 &&
         p.p_blocks == (p.H * p.W + LP - 1) / LP && (long long)p.data_blocks == (long long)p.B * p.p_blocks * (p.Cp / 16) &&
         p.pads == (p.B + 1) * p.Wp + p.B * p.H + 1 && (long long)p.B * p.C * p.H * p.W <= 2147483647LL;
}

bool plan_ok(const Plan& p, int bn) {
  using namespace k5;
  const int lbo = (p.halo + 7) / 8 * 8 * 16;
  return layout_ok(p) && p.Co > 0 && p.chunks == p.Cp / 16 && p.slices == 9 * p.chunks &&
         (long long)p.tiles_m * BM >= (long long)(p.B * (p.H + 1) - 1) * p.Wp && p.tiles_m > 0 &&
         p.tiles_n == (p.Co + bn - 1) / bn && p.tiles_n <= 65535 && p.splits > 0 && p.splits <= 65535 &&
         p.per_split > 0 && (long long)(p.splits - 1) * p.per_split < p.slices &&
         (long long)p.splits * p.per_split >= p.slices && (p.group == 9 || p.group == 3) &&
         p.per_split % p.group == 0 && p.slices % p.group == 0 &&
         p.halo == 128 + (p.group == 9 ? 2 * p.Wp : 0) + 2 &&
         (long long)p.rows_alloc >= (long long)p.tiles_m * BM + 2 * p.Wp + 2 && p.stages >= 2 &&
         p.stages <= MAX_STAGES && p.stage_bytes % 1024 == 0 && p.stage_bytes >= 2 * lbo + p.group * bn * 32 &&
         (long long)p.stages * p.stage_bytes <= ring_cap_of(bn) && (long long)p.B * p.Co * p.H * p.W <= 2147483647LL &&
         (p.affine == 0 || p.affine == 1) && (p.relu == 0 || p.relu == 1);
}

int layout(const void* x, void* xp, const Plan& p, cudaStream_t s) {
  const long long blocks = p.data_blocks + ((long long)p.pads * (p.Cp / 8) + 255) / 256;
  if (blocks > 2147483647LL || !aligned16(xp)) return (int)cudaErrorInvalidValue;
  conv3x3_bn_relu_layout_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(xp), p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 on the CUDA cores. x (B, C, H, W), w (Co, C, 3, 3), out (B, Co, H, W)
// fp32 contiguous; mul and add (Co,) fp32, or both NULL for a plain conv.
// Returns cudaGetLastError() after the launch.
int petr_conv3x3_bn_relu_fp32_fwd(const void* x, const void* w, const void* mul, const void* add,
                                  void* out, int B, int C, int H, int W, int Co, int relu,
                                  void* stream) {
  using namespace fp32;
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || Co <= 0 || B > 65535 ||
      (Co + BO - 1) / BO > 65535 || ((mul == nullptr) != (add == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(((H + TH - 1) / TH) * tiles_w, (Co + BO - 1) / BO, B);
  conv3x3_bn_relu_fp32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(mul),
      static_cast<const float*>(add), static_cast<float*>(out), C, H, W, Co, tiles_w,
      mul != nullptr, relu);
  return (int)cudaGetLastError();
}

// bf16, the layout pass alone: x (B, C, H, W) bf16 contiguous -> xp, the
// plan's Cp / 8 planes of rows_alloc rows of 8 bf16 (16-byte aligned); plan:
// Plan's fields in order. Returns cudaGetLastError() after the launch.
int petr_conv3x3_layout(const void* x, void* xp, const int* plan, void* stream) {
  Plan p;
  static_assert(sizeof(Plan) == 24 * sizeof(int), "Plan is 24 ints");
  memcpy(&p, plan, sizeof(p));
  if (!layout_ok(p) || !aligned16(x)) return (int)cudaErrorInvalidValue;
  return layout(x, xp, p, static_cast<cudaStream_t>(stream));
}

// bf16 on the tensor cores: the layout pass of x (B, C, H, W) into xp (as
// above), then the conv of xp and wt, the weight image (tiles_n, slices, 2,
// bn, 8) bf16 (ops/conv3x3.py::weight_image), into out (B, Co, H, W) bf16
// contiguous. mul and add (Co,) fp32, or both NULL (plan's affine 0); bn the
// tile's output channels (64, 128, 160, 192 or 256); ws and counters the
// split workspace (fp32 tiles_m x tiles_n x splits x 128 x bn; int32
// tiles_m x tiles_n, zero, left zero) when plan's splits > 1. Returns
// cudaGetLastError() after the launches.
int petr_conv3x3_bn_relu_tc_fwd(const void* x, void* xp, const void* wt, const void* mul, const void* add,
                                void* out, const int* plan, int bn, void* ws, void* counters, void* stream) {
  Plan p;
  memcpy(&p, plan, sizeof(p));
  if (!plan_ok(p, bn) || !aligned16(x) || !aligned16(wt) || (p.affine && (mul == nullptr || add == nullptr)) ||
      (p.splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int err = layout(x, xp, p, s);
  if (err != 0) return err;
  const auto* x16 = static_cast<const __nv_bfloat16*>(xp);
  const auto* w16 = static_cast<const __nv_bfloat16*>(wt);
  const auto* m = static_cast<const float*>(mul);
  const auto* a = static_cast<const float*>(add);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* w32 = static_cast<float*>(ws);
  auto* c32 = static_cast<int*>(counters);
  switch (bn) {
    case 64: return launch<64>(x16, w16, p, m, a, o, w32, c32, s);
    case 128: return launch<128>(x16, w16, p, m, a, o, w32, c32, s);
    case 160: return launch<160>(x16, w16, p, m, a, o, w32, c32, s);
    case 192: return launch<192>(x16, w16, p, m, a, o, w32, c32, s);
    case 256: return launch<256>(x16, w16, p, m, a, o, w32, c32, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* petr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
