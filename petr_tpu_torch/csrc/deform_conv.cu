// Modulated deformable 3x3 convolution (DCNv2) forward for Hopper (sm_90a),
// with a plain C interface loaded through ctypes (petr_tpu_torch/ops/dcn.py).
//
// Replaces petr_tpu/ops/pallas/dcn.py::_dcn_pallas_raw (its production body
// _make_onehot_kernel): for each output pixel o and tap k of the 3x3 kernel,
// x is sampled bilinearly at o * stride + (k - 1) * dilation + (dy, dx), each
// corner read where it lies inside the plane and counted as 0 where it does
// not, scaled by sigmoid(mask logit), and the (P, 9 * Cin) samples are
// contracted with the (9 * Cin, Cout) weight. off_mask (B, 27, Ho, Wo) fp32
// or bf16 holds [interleaved (dy, dx) per tap | 9 mask logits], taps in
// row-major order; out is (B, Cout, Ho, Wo) in x's type.
//
// What bounds it. At both r50dcn stages on 6 views of 512x1408 (stage 3: x
// (6,256,32,88), stage 4: x (6,512,16,44)) one call is 19.9 GFLOP of
// products: 0.0202 ms at the H100's 989 TFLOP/s bf16, against about 20 MB of
// device-memory traffic (each input read once, the output written once),
// about 6 us at 3.35 TB/s. The products bound it; the gather of the four
// corners of every (pixel, tap, channel) sample comes next (39 M samples per
// call, 156 M corner values, from L2 and L1), and each sample costs about 17
// instructions (4 unpacks, 12 fp32 operations in the plain version's order,
// a share of the bf16 pack) against 2 x 256 products on the tensor cores.
//
// Two kernels, chosen by the caller by dtype:
//
// * deform_conv_fwd_wgmma_kernel, bf16, the model's kernel: an implicit GEMM
//   on wgmma.mma_async m64n128k16 (bf16 in, fp32 sums), warp-specialised. A
//   block owns 64 output pixels (of the B Ho Wo pixels taken as one axis, so
//   a tile may span two images) and 256 output channels. Its 16 warps:
//   - 8 sampler warps (256 threads) first work out the four corners and the
//     bilinear fractions and modulation (the sigmoid, taken here as the plain
//     version takes it: 1 / (1 + exp(-logit)) in fp32) of each of the
//     block's (tap, pixel) pairs into shared memory, once. Then for each
//     chunk of the reduction axis, in petr_tpu's patch order j = tap * Cin +
//     c (patch_ref[:, k*C:(k+1)*C]), 64 channels of one tap, each thread
//     gathers two 8-channel groups of one pixel (a corner of 8 channels is
//     one 16-byte load from the channels-last copy of x that
//     deform_conv_channels_last_kernel makes first, in the same call, 16
//     bytes a load and a store; a warp's lanes read
//     8 pixels' corners 64 contiguous bytes at a time), sums the four corners
//     in fp32 in the plain version's order ((v00 (1-fx))(1-fy) + (v01
//     fx)(1-fy) + (v10 (1-fx)) fy + (v11 fx) fy, then times the modulation),
//     rounds once to bf16 and stores them into the ring's A tile in wgmma's
//     no-swizzle K-major layout ([8 channel groups][64 pixels][8], 16-byte
//     stores, neighbouring lanes on neighbouring rows). The next chunk's
//     corner loads are in flight while a chunk's samples are summed. One
//     sampler thread brings the chunk's B, 256 channels x 64 of the weight
//     image (laid out once per weight version, ops/dcn.py::weight_image), by
//     one bulk copy on the stage's mbarrier; every sampler thread fences its
//     stores for the async proxy and arrives there too.
//   - 2 consumer warpgroups each multiply the 64 x 64 A tile by their 128
//     channels of B: four k16 products a chunk, issued straight between one
//     fence and one commit, waited for, then the stage released to the
//     samplers.
//   A ring of 4 stages (40 KB each). The epilogue rounds once to bf16 and
//   goes through shared memory so that the NCHW stores run along the pixels.
//   Each (pixel, tap, channel) sample is gathered once per 256 output
//   channels: once at stage 3 (Cout 256, 264 blocks), twice at stage 4 (Cout
//   512: 66 pixel tiles x 2, 132 blocks). A block over all 512 channels
//   would gather once, but its two consumer warpgroups would hold 128 fp32
//   sums a thread and, at 66 blocks, leave half the SMs idle. The sums
//   of a block are taken in one fixed order (no atomics, no split of K), so
//   the kernel and the plain version with operand_dtype=bfloat16 round the
//   same samples and weights to bf16 and differ only in the order of the
//   fp32 sums, and two calls give the same bits.
// * deform_conv_fwd_kernel, fp32, on the CUDA cores: for fp32 callers (the
//   tests and the fp32 train-step checks). A block owns 64 output pixels of
//   one image and 64 output channels; it works out the corners of its (tap,
//   pixel) pairs with the bilinear weight times the modulation, then walks
//   j = c * 9 + k (the OIHW weight's order) in chunks of 32: it gathers the
//   chunk's modulated samples straight from NCHW x into shared memory and
//   adds 4x4 tiles of (pixel, channel) products into fp32 registers.
//
// What still holds the bf16 kernel back (PERF.md, K4's row): the samplers.
// They never wait for a stage while the consumers wait for them half the
// time (clock64() stamps, tools/k4_clock_split.py), and their gathers are
// bound by how many misses an SM keeps in flight to L2: two chunks of
// corners in flight (registers moved to the samplers by setmaxnreg) were
// no faster, and bulk copies of whole corner rows into shared memory were
// slower. Without the gathers the kernel would run at the pace of its
// products, with a stage released after each chunk's products.
//
// The floor of a coordinate is floorf, never an int cast: (int)(-0.5f) is 0,
// which would read a full edge pixel for a point half a pixel above the plane
// instead of half of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, bulk copies, wgmma

// clock64() stamps for petr_tpu_torch/tools/k4_clock_split.py, which defines
// these through a forced include; empty in the library
#ifndef K4_STAMP
#define K4_START
#define K4_STAMP(i)
#define K4_FLUSH
#endif

namespace {

constexpr int TAPS = 9;

// ------------------------------------------------------- fp32, CUDA cores
namespace fp32 {
constexpr int BP = 64;             // output pixels per block
constexpr int BO = 64;             // output channels per block
constexpr int BJ = 32;             // reduction rows (c * 9 + k) per chunk
constexpr int THREADS = 256;
constexpr int TP = 4;              // pixels per thread
constexpr int TO = 4;              // output channels per thread
constexpr int WPAD = BO + 4;       // weight tile row: 4-way bank conflicts at most on its stores
}  // namespace fp32

__global__ void __launch_bounds__(fp32::THREADS)
deform_conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ om,
                       const float* __restrict__ w, float* __restrict__ out,
                       int Cin, int H, int W, int Cout, int Ho, int Wo,
                       int stride, int dilation) {
  using namespace fp32;
  __shared__ int s_idx[TAPS][4][BP];                 // corner offset y * W + x in a plane
  __shared__ float s_wgt[TAPS][4][BP];               // bilinear weight x modulation; 0 outside
  __shared__ __align__(16) float s_col[BJ][BP];      // the chunk's modulated samples
  __shared__ __align__(16) float s_w[BJ][WPAD];      // the chunk's weights, (j, o)

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * BP;
  const int o0 = blockIdx.y * BO;
  const int P = Ho * Wo;
  const int HW = H * W;
  const int J = Cin * TAPS;

  // 1. the four corners of every (tap, pixel) of the block
  for (int i = tid; i < TAPS * BP; i += THREADS) {
    const int k = i / BP, p = i - k * BP;
    const int pix = p0 + p;
    int idx[4] = {0, 0, 0, 0};
    float wgt[4] = {0.f, 0.f, 0.f, 0.f};
    if (pix < P) {
      const int oy = pix / Wo, ox = pix - oy * Wo;
      const float* omp = om + (size_t)b * 27 * P + pix;
      const float dy = omp[(size_t)(2 * k) * P];
      const float dx = omp[(size_t)(2 * k + 1) * P];
      const float m = 1.f / (1.f + expf(-omp[(size_t)(18 + k) * P]));
      const float sy = (float)(oy * stride + (k / 3 - 1) * dilation) + dy;
      const float sx = (float)(ox * stride + (k % 3 - 1) * dilation) + dx;
      const float y0 = floorf(sy), x0 = floorf(sx);
      const float fy = sy - y0, fx = sx - x0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float yy = y0 + (float)(q >> 1);
        const float xx = x0 + (float)(q & 1);
        if (yy >= 0.f && yy < (float)H && xx >= 0.f && xx < (float)W) {
          idx[q] = (int)yy * W + (int)xx;
          wgt[q] = ((q >> 1) ? fy : 1.f - fy) * ((q & 1) ? fx : 1.f - fx) * m;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s_idx[k][q][p] = idx[q];
      s_wgt[k][q][p] = wgt[q];
    }
  }
  __syncthreads();

  const int tx = tid % (BO / TO);  // channel group: channels tx * 4 .. + 3
  const int ty = tid / (BO / TO);  // pixel group: pixels ty * 4 .. + 3
  float acc[TP][TO];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int c = 0; c < TO; ++c) acc[i][c] = 0.f;

  const float* xb = x + (size_t)b * Cin * HW;
  for (int j0 = 0; j0 < J; j0 += BJ) {
    // 2. the chunk's samples: thread -> pixel tid % 64, rows tid / 64 + 4 r
    {
      const int p = tid % BP;
      for (int r = tid / BP; r < BJ; r += THREADS / BP) {
        const int j = j0 + r;
        float v = 0.f;
        if (j < J) {
          const int c = j / TAPS, k = j - c * TAPS;
          const float* plane = xb + (size_t)c * HW;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float g = s_wgt[k][q][p];
            if (g != 0.f) v = fmaf(g, plane[s_idx[k][q][p]], v);
          }
        }
        s_col[r][p] = v;
      }
    }
    // 3. the chunk's weights: thread -> row tid % 32, channels tid / 32 + 8 r
    {
      const int r = tid % BJ;
      const int j = j0 + r;
      for (int o = tid / BJ; o < BO; o += THREADS / BJ) {
        const int oo = o0 + o;
        s_w[r][o] = (j < J && oo < Cout) ? w[(size_t)oo * J + j] : 0.f;
      }
    }
    __syncthreads();
    // 4. the 4x4 tile of products
#pragma unroll 8
    for (int r = 0; r < BJ; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&s_col[r][ty * TP]);
      const float4 bw = *reinterpret_cast<const float4*>(&s_w[r][tx * TO]);
      const float av[TP] = {a.x, a.y, a.z, a.w};
      const float bv[TO] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int c = 0; c < TO; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
    __syncthreads();
  }

  // 5. the outputs
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int pix = p0 + ty * TP + i;
    if (pix >= P) continue;
#pragma unroll
    for (int c = 0; c < TO; ++c) {
      const int oo = o0 + tx * TO + c;
      if (oo < Cout) out[((size_t)b * Cout + oo) * P + pix] = acc[i][c];
    }
  }
}



// ---------------------------------------------------- bf16, wgmma (K4)
namespace k4 {
constexpr int BM = 64;                    // output pixels per tile
constexpr int BN = 256;                   // output channels per tile: two consumer warpgroups of 128
constexpr int KC = 64;                    // reduction rows per chunk: 64 channels of one tap, four k16
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;            // warps 0-7: two warpgroups
constexpr int SAMPLERS = 256;             // warps 8-15
constexpr int THREADS = CONSUMERS + SAMPLERS;
constexpr int A_BYTES = BM * KC * 2;      // [KC / 8][BM][8] bf16
constexpr int B_BYTES = BN * KC * 2;      // [KC / 8][BN][8] bf16, one chunk of the weight image
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int OS = BM + 8;                // the epilogue tile: elements per output channel
// dynamic shared memory: the ring, the corners of every (tap, pixel) and
// their fx, fy and modulation, the barriers; the epilogue tile reuses the ring
constexpr int CORNER_BYTES = TAPS * BM * (4 * 4 + 3 * 4);
constexpr int SMEM_BYTES = 1024 + RING_BYTES + CORNER_BYTES + 2 * STAGES * 8;
static_assert(BN * OS * 2 <= RING_BYTES, "the epilogue tile must fit");
}  // namespace k4

using bf16 = __nv_bfloat16;

// NCHW bf16 x -> channels-last (B, H, W, Cp), zeros past C. A block takes 16
// channels x 256 pixels of one image: 16-byte loads along the pixels, a
// transpose in shared memory, 16-byte stores of 8 channels a pixel.
__global__ void __launch_bounds__(256) deform_conv_channels_last_kernel(const bf16* __restrict__ x,
                                                                        bf16* __restrict__ xs, int C, int Cp,
                                                                        int HW, int p_blocks) {
  __shared__ __align__(16) uint32_t tile[8][256 + 4];  // [channel pair][pixel], the even channel low
  const int t = threadIdx.x, cblocks = (Cp + 15) / 16;
  const int cb = blockIdx.x % cblocks, rest = blockIdx.x / cblocks;
  const int pb = rest % p_blocks, b = rest / p_blocks;
  const int p0 = pb * 256, c0 = cb * 16;
  {
    const int w = t >> 5, l = t & 31, px = p0 + 8 * l;
    const bool vec = (HW & 7) == 0 && px + 8 <= HW;
    uint32_t v[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int c = c0 + 2 * w + ci;
      if (c >= C) continue;
      const bf16* src = x + ((long long)b * C + c) * HW + px;
      if (vec) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        v[ci][0] = u.x;
        v[ci][1] = u.y;
        v[ci][2] = u.z;
        v[ci][3] = u.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (px + i < HW) v[ci][i >> 1] |= (uint32_t)__bfloat16_as_ushort(src[i]) << (16 * (i & 1));
      }
    }
    uint32_t word[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      word[i] = ((v[0][i >> 1] >> (16 * (i & 1))) & 0xffffu) | (((v[1][i >> 1] >> (16 * (i & 1))) & 0xffffu) << 16);
    uint4* dst = reinterpret_cast<uint4*>(&tile[w][8 * l]);
    dst[0] = make_uint4(word[0], word[1], word[2], word[3]);
    dst[1] = make_uint4(word[4], word[5], word[6], word[7]);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = t + 256 * r, px = idx >> 1, j = idx & 1, pix = p0 + px;
    if (pix >= HW || c0 + 8 * j >= Cp) continue;
    *reinterpret_cast<uint4*>(xs + ((long long)b * HW + pix) * Cp + c0 + 8 * j) =
        make_uint4(tile[4 * j][px], tile[4 * j + 1][px], tile[4 * j + 2][px], tile[4 * j + 3][px]);
  }
}

// the four corners of 8 channels of one sample, one 16-byte load each
struct Corners {
  uint4 r[4];
  // channel i of corner q in fp32
  __device__ __forceinline__ float at(int q, int i) const {
    const uint32_t w = (i >> 1) == 0 ? r[q].x : (i >> 1) == 1 ? r[q].y : (i >> 1) == 2 ? r[q].z : r[q].w;
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

__global__ void __launch_bounds__(k4::THREADS, 1)
deform_conv_fwd_wgmma_kernel(const bf16* __restrict__ x, const void* __restrict__ om, int om_bf16,
                             const bf16* __restrict__ wimg, bf16* __restrict__ out, int B, int Cp, int H, int W,
                             int Cout, int Ho, int Wo, int stride, int dilation, int nct) {
  using namespace k4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* corner = reinterpret_cast<int*>(smem + RING_BYTES);         // [TAPS][4][BM]: offsets in x, -1 outside
  float* frac = reinterpret_cast<float*>(corner + TAPS * 4 * BM);  // [TAPS][3][BM]: fx, fy, modulation
  uint64_t* full = reinterpret_cast<uint64_t*>(frac + TAPS * 3 * BM);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, tile_n = blockIdx.y;
  const int P = Ho * Wo;
  const int nch = TAPS * nct;  // chunks in petr_tpu's patch order: tap ch / nct, channels (ch % nct) * KC ..
  K4_START
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], SAMPLERS + 1);  // every sampler's arrival and the B copy's expect_tx
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // ------------------------------------ the samplers
    const int st = tid - CONSUMERS;
    // 1. the four corners of every (tap, pixel) of the block
    for (int i = st; i < TAPS * BM; i += SAMPLERS) {
      const int k = i / BM, p = i - k * BM;
      const int m = m0 + p;
      float fx = 0.f, fy = 0.f, mod = 0.f;
      int idx[4] = {-1, -1, -1, -1};
      if (m < B * P) {
        const int b = m / P, pix = m - b * P;
        const int oy = pix / Wo, ox = pix - oy * Wo;
        const long long o = (long long)b * 27 * P + pix;
        float dy, dx, logit;
        if (om_bf16) {
          const bf16* omh = static_cast<const bf16*>(om) + o;
          dy = __bfloat162float(omh[(long long)(2 * k) * P]);
          dx = __bfloat162float(omh[(long long)(2 * k + 1) * P]);
          logit = __bfloat162float(omh[(long long)(18 + k) * P]);
        } else {
          const float* omf = static_cast<const float*>(om) + o;
          dy = omf[(long long)(2 * k) * P];
          dx = omf[(long long)(2 * k + 1) * P];
          logit = omf[(long long)(18 + k) * P];
        }
        const float sy = (float)(oy * stride + (k / 3 - 1) * dilation) + dy;
        const float sx = (float)(ox * stride + (k % 3 - 1) * dilation) + dx;
        const float y0 = floorf(sy), x0 = floorf(sx);
        fy = sy - y0;
        fx = sx - x0;
        mod = 1.f / (1.f + expf(-logit));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float yy = y0 + (float)(q >> 1);
          const float xx = x0 + (float)(q & 1);
          if (yy >= 0.f && yy < (float)H && xx >= 0.f && xx < (float)W)
            idx[q] = (((b * H) + (int)yy) * W + (int)xx) * Cp;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) corner[(k * 4 + q) * BM + p] = idx[q];
      frac[(k * 3 + 0) * BM + p] = fx;
      frac[(k * 3 + 1) * BM + p] = fy;
      frac[(k * 3 + 2) * BM + p] = mod;
    }
    named_sync(2, SAMPLERS);
    K4_STAMP(0)

    // 2. the chunks. This thread: pixel p, channel groups g0 and g0 + 4 of each chunk
    const int p = 8 * (st >> 5) + (lane & 7), g0 = lane >> 3;
    const bf16* b_src = wimg + (long long)tile_n * nch * (B_BYTES / 2);
    auto load = [&](int ch, Corners (&cv)[2]) {
      const int k = ch / nct, c0 = (ch - k * nct) * KC;
      int off[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) off[q] = corner[(k * 4 + q) * BM + p];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = c0 + 8 * (g0 + 4 * i);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cv[i].r[q] = off[q] >= 0 && c < Cp ? __ldg(reinterpret_cast<const uint4*>(x + off[q] + c))
                                             : make_uint4(0u, 0u, 0u, 0u);
      }
    };
    Corners cur[2], nxt[2];
    load(0, cur);
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      const int stage = ch % STAGES;
      if (ch + 1 < nch) load(ch + 1, nxt);  // in flight while this chunk is summed
      K4_STAMP(1)
      mbar_wait(&empty[stage], ((ch / STAGES) & 1) ^ 1);
      K4_STAMP(2)
      uint8_t* a_dst = smem + stage * STAGE_BYTES;
      if (st == 0) {
        mbar_expect_tx(&full[stage], B_BYTES);
        bulk_load(a_dst + A_BYTES, b_src + (long long)ch * (B_BYTES / 2), B_BYTES, &full[stage]);
      }
      const int k = ch / nct;
      const float fx = frac[(k * 3 + 0) * BM + p], fy = frac[(k * 3 + 1) * BM + p];
      const float mod = frac[(k * 3 + 2) * BM + p];
      const float wx0 = __fsub_rn(1.f, fx), wx1 = fx, wy0 = __fsub_rn(1.f, fy), wy1 = fy;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t packed[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float sv[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float acc = __fadd_rn(__fmul_rn(__fmul_rn(cur[i].at(0, e + u), wx0), wy0),
                                  __fmul_rn(__fmul_rn(cur[i].at(1, e + u), wx1), wy0));
            acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(cur[i].at(2, e + u), wx0), wy1));
            acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(cur[i].at(3, e + u), wx1), wy1));
            sv[u] = __fmul_rn(acc, mod);
          }
          packed[e >> 1] = pack_bf16(sv[0], sv[1]);
        }
        *reinterpret_cast<uint4*>(a_dst + ((g0 + 4 * i) * BM + p) * 16) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the wgmma reads them
      mbar_arrive(&full[stage]);
      K4_STAMP(3)
#pragma unroll
      for (int i = 0; i < 2; ++i) cur[i] = nxt[i];
    }
    K4_FLUSH
    return;
  }

  // --------------------------------------------------------- the consumers
  // warpgroup wg multiplies the 64 x 64 A tile by channels 128 wg .. + 127 of the tile's B
  const int wg = warp >> 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // descriptors, no swizzle: A's next 8 channels BM x 16 bytes on, B's BN x 16; 8 rows 128 bytes
  const uint64_t a_hi = ((uint64_t)(BM * 16 >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
  const uint64_t b_hi = ((uint64_t)(BN * 16 >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
#pragma unroll 1
  for (int ch = 0; ch < nch; ++ch) {
    const int stage = ch % STAGES;
    const uint32_t a = smem_u32(smem + stage * STAGE_BYTES);
    const uint32_t bt = a + A_BYTES + wg * 128 * 16;
    K4_STAMP(5)
    mbar_wait(&full[stage], (ch / STAGES) & 1);
    K4_STAMP(4)
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KC / 16; ++s) {
      const uint32_t as = a + s * 2 * BM * 16, bs = bt + s * 2 * BN * 16;
      wgmma_ss(acc, a_hi | ((as & 0x3FFFF) >> 4), b_hi | ((bs & 0x3FFFF) >> 4), 1);
    }
    wgmma_commit();
    // This chunk's products done, its stage is free. Leaving one group in
    // flight into the next chunk (waiting for the previous one only, as K5
    // and K6 do) is no faster here, and with it ptxas put the epilogue's
    // conversions of the accumulators above the wait for the last group, so
    // that chunk's products were partly lost (ops/sass_check.py finds this).
    wgmma_wait<0>();
    wgmma_hold(acc);
    if (lane == 0) mbar_arrive(&empty[stage]);
  }
  K4_STAMP(5)
  named_sync(1, CONSUMERS);  // both warpgroups done: the ring may be overwritten

  // epilogue: one rounding, then (channel, pixel) through shared memory so
  // that the NCHW stores run along the pixels. Thread t of warpgroup wg holds,
  // for each n8 block j, rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns
  // 128 wg + 8j + 2 (t % 4) (+ 1).
  bf16* ot = reinterpret_cast<bf16*>(smem);  // [BN][OS]
  {
    const int t = tid & 127, row0 = 16 * (t >> 5) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 128 * wg + 8 * j + 2 * (lane & 3) + c;
        ot[n * OS + row0] = __float2bfloat16_rn(acc[4 * j + c]);
        ot[n * OS + row0 + 8] = __float2bfloat16_rn(acc[4 * j + 2 + c]);
      }
  }
  named_sync(1, CONSUMERS);
  const int n0 = tile_n * BN, M = B * P;
  const bool vec = P % 8 == 0;  // then a run of 8 pixels from a multiple of 8 stays in one image, aligned
  for (int i = tid; i < BN * (BM / 8); i += CONSUMERS) {
    const int n = i / (BM / 8), piece = i % (BM / 8);
    const int o = n0 + n, m = m0 + piece * 8;
    if (o >= Cout || m >= M) continue;
    const bf16* src = ot + n * OS + piece * 8;
    if (vec && m + 8 <= M) {
      const int b = m / P, pix = m - b * P;
      *reinterpret_cast<uint4*>(out + ((long long)b * Cout + o) * P + pix) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int u = 0; u < 8 && m + u < M; ++u) {
        const int b = (m + u) / P, pix = m + u - b * P;
        out[((long long)b * Cout + o) * P + pix] = src[u];
      }
    }
  }
  K4_STAMP(6)
  K4_FLUSH
}

}  // namespace

extern "C" {

// The fp32 kernel. x (B, Cin, H, W), off_mask (B, 27, Ho, Wo), weight
// (Cout, Cin, 3, 3) and out (B, Cout, Ho, Wo), all fp32 and contiguous.
// Returns cudaGetLastError() after the launch.
int petr_deform_conv_fp32_fwd(const void* x, const void* off_mask, const void* weight, void* out,
                              int B, int Cin, int H, int W, int Cout, int Ho, int Wo,
                              int stride, int dilation, void* stream) {
  if (B <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Ho <= 0 || Wo <= 0 ||
      stride <= 0 || dilation <= 0 || B > 65535 || (Cout + fp32::BO - 1) / fp32::BO > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Ho * Wo + fp32::BP - 1) / fp32::BP, (Cout + fp32::BO - 1) / fp32::BO, B);
  deform_conv_fwd_kernel<<<grid, fp32::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(off_mask), static_cast<const float*>(weight),
      static_cast<float*>(out), Cin, H, W, Cout, Ho, Wo, stride, dilation);
  return (int)cudaGetLastError();
}

// The bf16 kernels: x (B, Cin, H, W) bf16 copied channels-last into xs (B, H,
// W, Cp) bf16, Cp >= Cin a multiple of 8, zero past Cin; then the conv.
// off_mask (B, 27, Ho, Wo), fp32 (om_bf16 0) or bf16 (1); weight the image
// (ceil(Cout / 256), 9 * nct, 8, 256, 8) bf16 of ops/dcn.py::weight_image
// (nct = ceil(Cp / 64) chunks a tap); out (B, Cout, Ho, Wo) bf16. All
// contiguous, x, xs, the weight and out 16-byte aligned. Returns
// cudaGetLastError() after the launches.
int petr_deform_conv_tc_fwd(const void* x, void* xs, const void* off_mask, int om_bf16, const void* weight, void* out,
                            int B, int Cin, int Cp, int H, int W, int Cout, int Ho, int Wo, int stride, int dilation,
                            void* stream) {
  using namespace k4;
  const int nct = (Cp + KC - 1) / KC;
  if (B <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Ho <= 0 || Wo <= 0 || stride <= 0 || dilation <= 0 ||
      Cp % 8 || Cp < Cin || (om_bf16 != 0 && om_bf16 != 1) || (long long)B * H * W * Cp > 2147483647LL ||
      (long long)B * Ho * Wo > 2147483647LL - BM || (long long)B * 27 * Ho * Wo > 2147483647LL ||
      (Cout + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(xs) | reinterpret_cast<uintptr_t>(weight) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int p_blocks = (H * W + 255) / 256;
  const long long cl_blocks = (long long)B * p_blocks * ((Cp + 15) / 16);
  if (cl_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  deform_conv_channels_last_kernel<<<(unsigned)cl_blocks, 256, 0, s>>>(static_cast<const bf16*>(x),
                                                                      static_cast<bf16*>(xs), Cin, Cp, H * W, p_blocks);
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess) return (int)le;
  static bool sized = false;  // the dynamic shared memory above 48 KB, once
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(deform_conv_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid((unsigned)(((long long)B * Ho * Wo + BM - 1) / BM), (Cout + BN - 1) / BN);
  deform_conv_fwd_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(xs), off_mask, om_bf16, static_cast<const bf16*>(weight), static_cast<bf16*>(out), B,
      Cp, H, W, Cout, Ho, Wo, stride, dilation, nct);
  return (int)cudaGetLastError();
}

const char* petr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
