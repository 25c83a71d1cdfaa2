// Modulated deformable 3x3 convolution (DCNv2) forward for Hopper (sm_90a),
// with a plain C interface loaded through ctypes (petr_tpu_torch/ops/dcn.py).
//
// Replaces petr_tpu/ops/pallas/dcn.py::_dcn_pallas_raw (its production body
// _make_onehot_kernel): for each output pixel o and tap k of the 3x3 kernel,
// x is sampled bilinearly at o * stride + (k - 1) * dilation + (dy, dx), each
// corner read where it lies inside the plane and counted as 0 where it does
// not, scaled by sigmoid(mask logit), and the (P, 9 * Cin) samples are
// contracted with the (9 * Cin, Cout) weight. off_mask (B, 27, Ho, Wo) fp32
// holds [interleaved (dy, dx) per tap | 9 mask logits], taps in row-major
// order; out is (B, Cout, Ho, Wo) in x's type.
//
// What bounds it. At both r50dcn stages on 6 views of 512x1408 (stage 3: x
// (6,256,32,88), stage 4: x (6,512,16,44)) one call is 19.9 GFLOP of
// products: 0.0202 ms at the H100's 989 TFLOP/s bf16, against about 20 MB of
// device-memory traffic (each input read once, the output written once),
// about 6 us at 3.35 TB/s. The products bound it; the gather of the four
// corners of every (pixel, tap, channel) sample comes next (39 M samples per
// call, 156 M corner values).
//
// Two kernels, chosen by the caller by dtype:
//
// * deform_conv_fwd_tc_kernel, bf16, on the tensor cores (mma.sync.m16n8k16,
//   bf16 in, fp32 sums; tensor_core.cuh): the model's kernel. A block owns
//   64 output pixels of one image and 256 output channels (all of Cout at
//   stage 3: 264 blocks; half of it at stage 4: 132 blocks), so each sample
//   is gathered once per 256 output channels; 8 warps hold 32 pixels x 64
//   channels each, 64 fp32 sums per thread. The reduction axis is walked in
//   petr_tpu's patch order j = tap * Cin + c (patch_ref[:, k*C:(k+1)*C]), in
//   chunks of 32 channels of one tap, so a chunk's samples share each
//   pixel's four corners and bilinear weights, worked out once per (pixel,
//   tap) into shared memory. The caller passes x channels-last, (B, H, W,
//   Cp) with Cp = Cin rounded up to 8 (one copy of x per call), so each
//   corner of 8 channels is one 16-byte load (a gather of one channel per
//   load from the planes of NCHW x was slower at both r50 stages). The four
//   corners are summed in fp32 in the plain version's order
//   ((v00 (1-fx))(1-fy) + (v01 fx)(1-fy) + (v10 (1-fx)) fy + (v11 fx) fy, then
//   times the modulation, passed in as the sigmoid the plain version takes),
//   rounded once to bf16 into a tile laid out for ldmatrix, and multiplied by
//   the weight, repacked per call to bf16 (Cout, 3, 3, Cp) in j-order (x's
//   dtype, as petr_tpu's wf = weight.astype(x.dtype)) and staged by 16-byte
//   cp.async. Two-stage rings: chunk i + 1's corner loads are issued into
//   registers and its weights into shared memory before chunk i's products,
//   and its samples are stored after them. The epilogue rounds once to bf16
//   and goes through shared memory so that the NCHW stores run along the
//   pixels. So the bf16 kernel and the plain version with
//   operand_dtype=bfloat16 round the same samples and weights to bf16 and
//   differ only in the order of the fp32 sums.
// * deform_conv_fwd_kernel, fp32, on the CUDA cores: for fp32 callers (the
//   tests and the fp32 train-step checks). A block owns 64 output pixels of
//   one image and 64 output channels; it works out the corners of its (tap,
//   pixel) pairs with the bilinear weight times the modulation, then walks
//   j = c * 9 + k (the OIHW weight's order) in chunks of 32: it gathers the
//   chunk's modulated samples straight from NCHW x into shared memory and
//   adds 4x4 tiles of (pixel, channel) products into fp32 registers.
//
// The floor of a coordinate is floorf, never an int cast: (int)(-0.5f) is 0,
// which would read a full edge pixel for a point half a pixel above the plane
// instead of half of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

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


// ------------------------------------------------------ bf16, tensor cores
namespace tc {
constexpr int BM = 64;            // output pixels per block
constexpr int BN = 256;           // output channels per block
constexpr int BJ = 32;            // reduction rows per chunk: 32 channels of one tap
constexpr int THREADS = 256;
constexpr int WARPS_M = 2;        // 32 pixels per warp; 4 warps along N, 64 channels each
constexpr int RS = BJ + 8;        // A and weight tile rows: 80 bytes, ldmatrix rows in distinct banks
constexpr int OS = BM + 8;        // epilogue tile: elements per output channel
constexpr int A_STAGE = BM * RS;  // elements of one sample stage
constexpr int W_STAGE = BN * RS;  // elements of one weight stage
// dynamic shared memory: the two rings, then the corners of every (tap,
// pixel) and their fx, fy and modulation; the epilogue tile reuses the rings
constexpr size_t RING_BYTES = 2 * (A_STAGE + W_STAGE) * sizeof(__nv_bfloat16);
constexpr size_t SMEM_BYTES = RING_BYTES + TAPS * BM * (4 * sizeof(int) + 3 * sizeof(float));
static_assert(BN * OS * sizeof(__nv_bfloat16) <= RING_BYTES, "the epilogue tile must fit");
}  // namespace tc

using bf16 = __nv_bfloat16;

// the four corners of 8 channels of one sample, one 16-byte load each
struct Corners {
  uint4 r[4];
  // channel i of corner q in fp32
  __device__ __forceinline__ float at(int q, int i) const {
    const uint32_t w = (i >> 1) == 0 ? r[q].x : (i >> 1) == 1 ? r[q].y : (i >> 1) == 2 ? r[q].z : r[q].w;
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

__global__ void __launch_bounds__(tc::THREADS, 2)
deform_conv_fwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ om,
                          const float* __restrict__ mod, const bf16* __restrict__ wr,
                          bf16* __restrict__ out, int Cp, int H, int W, int Cout,
                          int Ho, int Wo, int stride, int dilation) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);   // [2][BM][RS]
  bf16* ws = as + 2 * A_STAGE;                    // [2][BN][RS]
  int* corner = reinterpret_cast<int*>(smem_raw + RING_BYTES);  // [TAPS][4][BM], -1 outside the plane
  float* frac = reinterpret_cast<float*>(corner + TAPS * 4 * BM);  // [TAPS][3][BM]: fx, fy, modulation

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int P = Ho * Wo;

  // 1. the four corners of every (tap, pixel) of the block: the offsets of
  // their channel vectors in x's image
  for (int i = tid; i < TAPS * BM; i += THREADS) {
    const int k = i / BM, p = i - k * BM;
    const int pix = p0 + p;
    float fx = 0.f, fy = 0.f, m = 0.f;
    int idx[4] = {-1, -1, -1, -1};
    if (pix < P) {
      const int oy = pix / Wo, ox = pix - oy * Wo;
      const float* omp = om + (size_t)b * 27 * P + pix;
      const float sy = (float)(oy * stride + (k / 3 - 1) * dilation) + omp[(size_t)(2 * k) * P];
      const float sx = (float)(ox * stride + (k % 3 - 1) * dilation) + omp[(size_t)(2 * k + 1) * P];
      const float y0 = floorf(sy), x0 = floorf(sx);
      fy = sy - y0;
      fx = sx - x0;
      m = mod[((size_t)b * TAPS + k) * P + pix];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float yy = y0 + (float)(q >> 1);
        const float xx = x0 + (float)(q & 1);
        if (yy >= 0.f && yy < (float)H && xx >= 0.f && xx < (float)W)
          idx[q] = ((int)yy * W + (int)xx) * Cp;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) corner[(k * 4 + q) * BM + p] = idx[q];
    frac[(k * 3 + 0) * BM + p] = fx;
    frac[(k * 3 + 1) * BM + p] = fy;
    frac[(k * 3 + 2) * BM + p] = m;
  }

  // this thread's sample of each chunk: pixel tid / 4 and channels (tid % 4)
  // * 8 .. + 7, so that neighbouring lanes read one corner's 64 contiguous bytes
  const int sp = tid >> 2;
  const int sc = (tid & 3) * 8;
  const bf16* xb = x + (long long)b * H * W * Cp;
  const int nct = (Cp + BJ - 1) / BJ;  // chunks per tap
  const int nch = TAPS * nct;

  auto gather_load = [&](int ch, Corners& cv) {
    const int k = ch / nct, c = (ch - k * nct) * BJ + sc;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int off = corner[(k * 4 + q) * BM + sp];
      cv.r[q] = off >= 0 && c < Cp ? *reinterpret_cast<const uint4*>(xb + off + c) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // the corners summed in the plain version's order, times the modulation,
  // rounded once to bf16 into stage s of the sample ring
  auto gather_store = [&](int ch, const Corners& cv, int s) {
    const int k = ch / nct;
    const float fx = frac[(k * 3 + 0) * BM + sp], fy = frac[(k * 3 + 1) * BM + sp];
    const float m = frac[(k * 3 + 2) * BM + sp];
    const float wx0 = __fsub_rn(1.f, fx), wx1 = fx, wy0 = __fsub_rn(1.f, fy), wy1 = fy;
    uint32_t packed[4];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      float sv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float acc = __fadd_rn(__fmul_rn(__fmul_rn(cv.at(0, i + u), wx0), wy0),
                              __fmul_rn(__fmul_rn(cv.at(1, i + u), wx1), wy0));
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(cv.at(2, i + u), wx0), wy1));
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(cv.at(3, i + u), wx1), wy1));
        sv[u] = __fmul_rn(acc, m);
      }
      packed[i >> 1] = pack_bf16(sv[0], sv[1]);
    }
    *reinterpret_cast<uint4*>(as + s * A_STAGE + sp * RS + sc) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  };
  // chunk ch's weights, rows n0 .. n0 + 255 of (Cout, 9, Cp), by cp.async into stage s
  auto load_weights = [&](int ch, int s) {
    const int k = ch / nct, c0 = (ch - k * nct) * BJ;
    for (int i = tid; i < BN * (BJ / 8); i += THREADS) {
      const int n = i / (BJ / 8), piece = i % (BJ / 8);
      const int o = n0 + n, c = c0 + piece * 8;
      const bool ok = o < Cout && c < Cp;
      cp_async16(ws + s * W_STAGE + n * RS + piece * 8, ok ? wr + ((long long)o * TAPS + k) * Cp + c : wr,
                 ok ? 16 : 0);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix row addresses (elements). A: lane l gives pixel l % 16 of an
  // m16 tile, k (l / 16) * 8 .. + 7. B: lane l gives output channel (l / 16)
  // * 8 + l % 8 of an n16 pair, k (l / 8 % 2) * 8 .. + 7.
  int a_off[2], b_off[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) a_off[i] = (wm * 32 + i * 16 + (lane & 15)) * RS + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) b_off[j] = (wn * 64 + j * 16 + (lane >> 4) * 8 + (lane & 7)) * RS + ((lane >> 3) & 1) * 8;

  Corners cv;
  load_weights(0, 0);
  cp_async_commit();
  __syncthreads();  // the corners are in shared memory
  gather_load(0, cv);
  gather_store(0, cv, 0);
  for (int ch = 0; ch < nch; ++ch) {
    const int s = ch & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk ch's weights and samples are in; every warp is done with chunk ch - 1
    const bool more = ch + 1 < nch;
    if (more) load_weights(ch + 1, s ^ 1);
    cp_async_commit();
    if (more) gather_load(ch + 1, cv);  // in flight during the products
    const bf16* at = as + s * A_STAGE;
    const bf16* wt = ws + s * W_STAGE;
#pragma unroll
    for (int kk = 0; kk < BJ / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], at + a_off[i] + kk * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bw[4];
        ldmatrix_x4(bw, wt + b_off[j] + kk * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * j], a[i], bw[0], bw[1]);
          mma_bf16(acc[i][2 * j + 1], a[i], bw[2], bw[3]);
        }
      }
    }
    if (more) gather_store(ch + 1, cv, s ^ 1);
  }

  // epilogue: one rounding, then (channel, pixel) through shared memory so
  // that the NCHW stores run along the pixels
  cp_async_wait<0>();
  __syncthreads();
  bf16* ot = reinterpret_cast<bf16*>(smem_raw);  // [BN][OS]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ot[(wn * 64 + nt * 8 + 2 * t4 + (e & 1)) * OS + wm * 32 + i * 16 + g + 8 * (e >> 1)] =
            __float2bfloat16(acc[i][nt][e]);
  __syncthreads();
  const bool vec = P % 8 == 0;
  for (int i = tid; i < BN * (BM / 8); i += THREADS) {
    const int n = i / (BM / 8), piece = i % (BM / 8);
    const int o = n0 + n, px = p0 + piece * 8;
    if (o >= Cout || px >= P) continue;
    bf16* dst = out + ((long long)b * Cout + o) * P + px;
    const bf16* src = ot + n * OS + piece * 8;
    if (vec && px + 8 <= P) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int u = 0; u < 8 && px + u < P; ++u) dst[u] = src[u];
    }
  }
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

// The bf16 kernel. x channels-last (B, H, W, Cp); off_mask (B, 27, Ho, Wo) fp32 (its first 18
// channels, the offsets, are read); modulation (B, 9, Ho, Wo) fp32, the
// sigmoid of the mask logits; weight (Cout, 3, 3, Cp) bf16, Cp a multiple of
// 8 and zero past Cin; out (B, Cout, Ho, Wo) bf16. All contiguous, x and the
// weight 16-byte aligned. Returns cudaGetLastError() after the launch.
int petr_deform_conv_tc_fwd(const void* x, const void* off_mask, const void* modulation,
                            const void* weight, void* out, int B, int Cin, int Cp, int H, int W,
                            int Cout, int Ho, int Wo, int stride, int dilation, void* stream) {
  if (B <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Ho <= 0 || Wo <= 0 ||
      stride <= 0 || dilation <= 0 || B > 65535 || (Cout + tc::BN - 1) / tc::BN > 65535 ||
      Cp % 8 || Cp < Cin)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(weight) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((Ho * Wo + tc::BM - 1) / tc::BM, (Cout + tc::BN - 1) / tc::BN, B);
  const cudaError_t e = cudaFuncSetAttribute(deform_conv_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)tc::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  deform_conv_fwd_tc_kernel<<<grid, tc::THREADS, tc::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(off_mask), static_cast<const float*>(modulation),
      static_cast<const bf16*>(weight), static_cast<bf16*>(out), Cp, H, W, Cout, Ho, Wo, stride, dilation);
  return (int)cudaGetLastError();
}

const char* petr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
