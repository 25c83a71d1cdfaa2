// Modulated deformable 3x3 convolution (DCNv2) forward for Hopper (sm_90a),
// with a plain C interface loaded through ctypes (petr_tpu_torch/ops/dcn.py).
//
// Replaces petr_tpu/ops/pallas/dcn.py::_dcn_pallas_raw (its production body
// _make_onehot_kernel): for each output pixel o and tap k of the 3x3 kernel,
// x is sampled bilinearly at o * stride + (k - 1) * dilation + (dy, dx), each
// corner read where it lies inside the plane and counted as 0 where it does
// not, scaled by sigmoid(mask logit), and the (P, 9 * Cin) samples are
// contracted with the (9 * Cin, Cout) weight. Layout NCHW: x (B, Cin, H, W)
// in fp32 or bf16, off_mask (B, 27, Ho, Wo) fp32 as [interleaved (dy, dx) per
// tap | 9 mask logits], taps in row-major order, weight (Cout, Cin, 3, 3)
// fp32, out (B, Cout, Ho, Wo) in x's type. Numerics follow the XLA
// formulation that petr_tpu differentiates (petr_tpu/ops/dcn.py:62-99), not
// the TPU body: samples, mask and weight in fp32, fp32 sums, one rounding of
// the output. So in bf16 this kernel and the plain version differ only in the
// order of the sums.
//
// What bounds it. At both r50dcn stages on 6 views of 512x1408 (stage 3: x
// (6,256,32,88), stage 4: x (6,512,16,44)) one call is 19.9 GFLOP of
// products: 0.0202 ms at the H100's 989 TFLOP/s bf16, against about 20 MB of
// device-memory traffic (each input read once, the output written once),
// about 6 us at 3.35 TB/s. The products bound it. This version does them on
// the fp32 CUDA cores, not the tensor cores: 10 G FMA per call, a floor near
// 0.3 ms at 67 TFLOP/s fp32. wgmma on bf16 samples comes later.
//
// Design. One fused kernel; the (P, 9 * Cin) sample matrix never reaches
// device memory. A block owns 64 output pixels of one image and 64 output
// channels. It first works out, for its pixels and the 9 taps, the four
// corner offsets and their bilinear weights times the modulation (zero for a
// corner outside the plane) into shared memory. Then it walks the reduction
// axis j = c * 9 + k (the weight's own OIHW order) in chunks of 32: it gathers
// the chunk's modulated samples from the four corners into shared memory in
// fp32, stages the fp32 weight chunk beside them, and each thread adds a 4x4
// tile of (pixel, channel) products into fp32 registers. The TPU kernel built
// a dense one-hot interpolation matrix to put the gather on the MXU; here the
// four corners are gathered directly, through L1 and L2 (a stage-3 plane of
// one image is 1.4 MB in bf16). Within one row j of a chunk, neighbouring
// output pixels sample neighbouring addresses of one channel plane, so the
// gathers of a warp mostly share cache lines without a channels-last copy of
// x: the kernel reads x in NCHW as it is.
//
// The floor of a coordinate is floorf, never an int cast: (int)(-0.5f) is 0,
// which would read a full edge pixel for a point half a pixel above the plane
// instead of half of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 9;
constexpr int BP = 64;             // output pixels per block
constexpr int BO = 64;             // output channels per block
constexpr int BJ = 32;             // reduction rows (c * 9 + k) per chunk
constexpr int THREADS = 256;
constexpr int TP = 4;              // pixels per thread
constexpr int TO = 4;              // output channels per thread
constexpr int WPAD = BO + 4;       // weight tile row: 4-way bank conflicts at most on its stores

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
deform_conv_fwd_kernel(const T* __restrict__ x, const float* __restrict__ om,
                       const float* __restrict__ w, T* __restrict__ out,
                       int Cin, int H, int W, int Cout, int Ho, int Wo,
                       int stride, int dilation) {
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

  const T* xb = x + (size_t)b * Cin * HW;
  for (int j0 = 0; j0 < J; j0 += BJ) {
    // 2. the chunk's samples: thread -> pixel tid % 64, rows tid / 64 + 4 r
    {
      const int p = tid % BP;
      for (int r = tid / BP; r < BJ; r += THREADS / BP) {
        const int j = j0 + r;
        float v = 0.f;
        if (j < J) {
          const int c = j / TAPS, k = j - c * TAPS;
          const T* plane = xb + (size_t)c * HW;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float g = s_wgt[k][q][p];
            if (g != 0.f) v = fmaf(g, to_float(plane[s_idx[k][q][p]]), v);
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

  // 5. one rounding of each output to x's type
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int pix = p0 + ty * TP + i;
    if (pix >= P) continue;
#pragma unroll
    for (int c = 0; c < TO; ++c) {
      const int oo = o0 + tx * TO + c;
      if (oo < Cout) store(out + ((size_t)b * Cout + oo) * P + pix, acc[i][c]);
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out); off_mask and weight are fp32.
// All tensors contiguous. Returns cudaGetLastError() after the launch.
int petr_deform_conv_fwd(const void* x, const void* off_mask, const void* weight, void* out,
                         int B, int Cin, int H, int W, int Cout, int Ho, int Wo,
                         int stride, int dilation, int dtype, void* stream) {
  if (B <= 0 || Cin <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Ho <= 0 || Wo <= 0 ||
      stride <= 0 || dilation <= 0 || B > 65535 || (Cout + BO - 1) / BO > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Ho * Wo + BP - 1) / BP, (Cout + BO - 1) / BO, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* om = static_cast<const float*>(off_mask);
  const float* w = static_cast<const float*>(weight);
  if (dtype == 0) {
    deform_conv_fwd_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), om, w, static_cast<float*>(out),
        Cin, H, W, Cout, Ho, Wo, stride, dilation);
  } else if (dtype == 1) {
    deform_conv_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), om, w, static_cast<__nv_bfloat16*>(out),
        Cin, H, W, Cout, Ho, Wo, stride, dilation);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* petr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
