// Fused 3x3 convolution (stride 1, padding 1) + scale/shift + ReLU for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (petr_tpu_torch/ops/conv3x3.py).
//
// Replaces petr_tpu/ops/pallas/conv3x3.py::_conv3x3_raw (kernel body
// _make_kernel): out = act(conv3x3(x, w) * mul + add), the conv summed in
// fp32, mul and add (the folded frozen BN) in fp32, the optional ReLU, and
// one rounding to x's type. Layout NCHW: x (B, C, H, W) and w (Co, C, 3, 3)
// in one type (fp32 or bf16), mul and add (Co,) fp32 or absent, out
// (B, Co, H, W) in x's type. It is the opt-in route of ConvBNReLU
// (PETR_TPU_TORCH_CONV_IMPL=cuda), taken by the VoVNet OSA convs.
//
// What bounds it, on 6 views of the flagship at 320x800: stage 2 (128 -> 128
// channels at 80x200) is 28.3 GFLOP of products, 0.0286 ms at the H100's
// 989 TFLOP/s bf16, against 49 MB of traffic in bf16 (x read once, out
// written once: 15 us at 3.35 TB/s); stage 4 (192 -> 192 at 20x50), which
// takes 45 of the 80 launches of a forward, is 3.98 GFLOP, 0.0040 ms, against
// 5.3 MB (1.6 us). The products
// bound it. This version does them on the fp32 CUDA cores, so its own floor
// is the fp32 FMA rate (stage 2: 14.2 G FMA, about 0.42 ms at 67 TFLOP/s).
//
// Design: an implicit GEMM. A block owns one image, a tile of 4 x 16 output
// pixels and 64 output channels. It walks the input channels in chunks of 8:
// it stages the chunk's input halo (8 channels x 6 rows x 18 columns, zero
// outside the plane, so no padded copy of x is made) and the chunk's
// (8 * 9, 64) weights in shared memory as fp32, and each thread adds a 4x4
// tile of (pixel, channel) products into fp32 registers, reading the nine
// shifted taps straight from the halo. The epilogue applies mul, add and the
// ReLU to the fp32 sums before the single store. The TPU kernel held the
// whole padded plane in VMEM and built the (rows, 9C) patch matrix for one
// MXU product; here the patch matrix exists only as shifted reads of the
// halo.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 4;              // output rows per block
constexpr int TW = 16;             // output columns per block
constexpr int BO = 64;             // output channels per block
constexpr int CC = 8;              // input channels per chunk
constexpr int THREADS = 256;
constexpr int TP = 4;              // pixels per thread (one row, 4 columns)
constexpr int TO = 4;              // output channels per thread
constexpr int WPAD = BO + 4;       // weight tile row: 4-way bank conflicts at most on its stores

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ mul, const float* __restrict__ add,
                       T* __restrict__ out, int C, int H, int W, int Co, int tiles_w,
                       int affine, int relu) {
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

  const T* xb = x + (size_t)b * C * H * W;
  constexpr int HALO = (TH + 2) * (TW + 2);
  for (int c0 = 0; c0 < C; c0 += CC) {
    for (int i = tid; i < CC * HALO; i += THREADS) {
      const int c = i / HALO, rem = i - c * HALO;
      const int hy = rem / (TW + 2), hx = rem - hy * (TW + 2);
      const int gy = y0 + hy - 1, gx = x0 + hx - 1;
      float v = 0.f;
      if (c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_float(xb[((size_t)(c0 + c) * H + gy) * W + gx]);
      s_x[c][hy][hx] = v;
    }
    for (int i = tid; i < CC * 9 * BO; i += THREADS) {
      const int r = i % (CC * 9), o = i / (CC * 9);
      const int j = c0 * 9 + r, oo = o0 + o;
      s_w[r][o] = (j < J && oo < Co) ? to_float(w[(size_t)oo * J + j]) : 0.f;
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
    T* orow = out + (((size_t)b * Co + oo) * H + row) * W;
#pragma unroll
    for (int i = 0; i < TP; ++i) {
      const int col = x0 + pcol + i;
      if (col >= W) continue;
      float v = acc[i][cc];
      if (affine) v = v * m + a;
      if (relu) v = fmaxf(v, 0.f);
      store(orow + col, v);
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out). mul and add: (Co,) fp32,
// or both NULL for a plain conv. All tensors contiguous. Returns
// cudaGetLastError() after the launch.
int petr_conv3x3_bn_relu_fwd(const void* x, const void* w, const void* mul, const void* add,
                             void* out, int B, int C, int H, int W, int Co, int relu,
                             int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || Co <= 0 || B > 65535 ||
      (Co + BO - 1) / BO > 65535 || ((mul == nullptr) != (add == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(((H + TH - 1) / TH) * tiles_w, (Co + BO - 1) / BO, B);
  const int affine = mul != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mul);
  const float* a = static_cast<const float*>(add);
  if (dtype == 0) {
    conv3x3_bn_relu_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), m, a,
        static_cast<float*>(out), C, H, W, Co, tiles_w, affine, relu);
  } else if (dtype == 1) {
    conv3x3_bn_relu_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), m, a,
        static_cast<__nv_bfloat16*>(out), C, H, W, Co, tiles_w, affine, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* petr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
