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
//   jnp.round; x / sa is a true division, as in petr_tpu), from NCHW x (bf16
//   or fp32) into a channels-last copy (B, H, W, Cp), Cp = C rounded up to 32
//   with zeros past C. A 32 x 32 (channels x pixels) tile is transposed in
//   shared memory, so that both the NCHW reads and the NHWC writes run along
//   contiguous addresses.
// * conv_int8_kernel: the conv of xi with the BN-folded per-output-channel
//   int8 weight, at kernel 1 or 3, stride 1 or 2, padding k // 2, as an
//   implicit GEMM on mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: M =
//   the B * Ho * Wo output pixels, N = Co, K = k * k * Cp walked tap-major in
//   32-channel steps (the weight arrives repacked to (Co, k, k, Cp), so one
//   K step is one tap's 32 contiguous channels of one input pixel, a 32-byte
//   row of xi). Then the epilogue y = float(acc) * scale + add (scale = sa *
//   sw per output channel, both products rounded as written: no fused
//   multiply-add, as the plain version computes it), ReLU if asked, one
//   rounding to the output type. The int32 sums themselves can be written
//   out too (the checks hold them to the plain version bit for bit).
//
// The tiling follows K5's (conv3x3_bn_relu.cu, an implicit GEMM with a BN/ReLU
// epilogue), with int8 in place of bf16: a block owns 128 output pixels x 64
// output channels, 8 warps of 32 x 32 each (2 m16 x 4 n8 tiles); each K step
// stages a 128 x 32-byte A tile (one 16-byte cp.async per thread, zero-filled
// outside the image: that is the padding) and a 64 x 32-byte B tile in a
// two-stage ring, step s + 1 in flight while step s is multiplied. Shared rows
// are padded to 48 bytes, so the 32-bit fragment loads of a warp hit 32
// distinct banks. The stem's first conv (Cin = 3) pads its channels to 32;
// every other Cin of V-99 is a multiple of 32.
//
// What bounds it: V-99's 99 convs at 6 views of 320x800 do 1.01 TOP of int8
// products (0.51 ms at 1,979 TOPS) and move 1.84 GB, each bf16 input read
// once and each bf16 output written once (0.55 ms at 3.35 TB/s): the two
// bounds are about equal over a forward; the large planes (stem, stage 2) are
// bound by bytes, the deep stages by products. This simple kernel (mma.sync,
// not wgmma; the weight tile fetched by every block; a separate quantisation
// pass that writes an int8 copy and reads it back) is far from either bound:
// a first, right version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

namespace i8 {
constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // K per step: one tap's 32 channels
constexpr int ROW = 48;      // bytes per staged row: 32 of data, 16 of padding
constexpr int THREADS = 256;
constexpr int QT = 32;       // the quantisation pass's tile (channels x pixels)
}  // namespace i8

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// c += a b: a 16x32 int8 (row), b 32x8 int8 (col), c 16x8 int32.
// Fragments (g = lane / 4, t = lane % 4): a[0] = row g, bytes 4t..4t+3;
// a[1] = row g + 8, the same bytes; a[2], a[3] the same rows, bytes 16 + 4t..;
// b[0] = column g, k = 4t..4t+3; b[1] = column g, k = 16 + 4t..;
// c = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__global__ void __launch_bounds__(i8::QT * 8) quantize_act_kernel(
    const T* __restrict__ x, const float* __restrict__ sa_ptr, int8_t* __restrict__ xq, int C, int HW, int Cp) {
  using namespace i8;
  __shared__ int8_t tile[QT][QT + 4];  // [channel][pixel]
  const int p0 = blockIdx.x * QT, c0 = blockIdx.y * QT, b = blockIdx.z;
  const float sa = *sa_ptr;
  for (int i = threadIdx.y; i < QT; i += 8) {
    const int c = c0 + i, p = p0 + threadIdx.x;
    int8_t q = 0;
    if (c < C && p < HW) {
      const float r = rintf(to_float(x[((long long)b * C + c) * HW + p]) / sa);
      q = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
    }
    tile[i][threadIdx.x] = q;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < QT; i += 8) {
    const int p = p0 + i, c = c0 + threadIdx.x;
    if (p < HW && c < Cp) xq[((long long)b * HW + p) * Cp + c] = tile[threadIdx.x][i];
  }
}

template <typename Out>
__global__ void __launch_bounds__(i8::THREADS) conv_int8_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq, const float* __restrict__ scale,
    const float* __restrict__ add, Out* __restrict__ out, int32_t* __restrict__ acc_out, int B, int Cp,
    int H, int W, int Co, int k, int stride, int Ho, int Wo, int relu) {
  using namespace i8;
  __shared__ __align__(16) int8_t As[2][BM * ROW];
  __shared__ __align__(16) int8_t Bs[2][BN * ROW];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int HWo = Ho * Wo;
  const long long M = (long long)B * HWo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int pad = k / 2;

  // the A row (output pixel) and 16-byte half this thread stages
  const int a_row = tid >> 1, half = tid & 1;
  const long long pa = m0 + a_row;
  const bool a_valid = pa < M;
  int ab = 0, aoh = 0, aow = 0;
  if (a_valid) {
    ab = static_cast<int>(pa / HWo);
    const int r = static_cast<int>(pa - (long long)ab * HWo);
    aoh = r / Wo;
    aow = r - aoh * Wo;
  }
  const int chunks = Cp / BK;
  const int steps = k * k * chunks;
  const long long Kw = (long long)k * k * Cp;

  auto load = [&](int s, int buf) {
    const int tap = s / chunks, c0 = (s - tap * chunks) * BK;
    const int kh = tap / k, kw = tap - kh * k;
    const int ih = aoh * stride - pad + kh, iw = aow * stride - pad + kw;
    const bool ok = a_valid && ih >= 0 && ih < H && iw >= 0 && iw < W;
    const int8_t* src = ok ? xq + (((long long)ab * H + ih) * W + iw) * Cp + c0 + half * 16 : xq;
    cp_async16(&As[buf][a_row * ROW + half * 16], src, ok ? 16 : 0);
    if (tid < BN * 2) {
      const int n = n0 + a_row;
      const bool okb = n < Co;
      const int8_t* srcb = okb ? wq + (long long)n * Kw + (long long)s * BK + half * 16 : wq;
      cp_async16(&Bs[buf][a_row * ROW + half * 16], srcb, okb ? 16 : 0);
    }
    cp_async_commit();
  };

  int32_t acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load(0, 0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load(s + 1, (s + 1) & 1);
    } else {
      cp_async_commit();  // an empty group keeps the wait count uniform
    }
    cp_async_wait<1>();
    __syncthreads();
    const int8_t* as = As[s & 1];
    const int8_t* bs = Bs[s & 1];
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = warp_m * 32 + mt * 16 + g;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(as + row * ROW + t * 4);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(as + (row + 8) * ROW + t * 4);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(as + row * ROW + 16 + t * 4);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(as + (row + 8) * ROW + 16 + t * 4);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = warp_n * 32 + nt * 8 + g;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bs + n * ROW + t * 4);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bs + n * ROW + 16 + t * 4);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long p = m0 + warp_m * 32 + mt * 16 + g + (e >> 1) * 8;
        const int n = n0 + warp_n * 32 + nt * 8 + t * 2 + (e & 1);
        if (p >= M || n >= Co) continue;
        const int b = static_cast<int>(p / HWo);
        const long long idx = ((long long)b * Co + n) * HWo + (p - (long long)b * HWo);
        const int32_t v = acc[mt][nt][e];
        if (acc_out != nullptr) acc_out[idx] = v;
        if (out != nullptr) {
          float y = __fadd_rn(__fmul_rn(__int2float_rn(v), scale[n]), add[n]);
          if (relu) y = fmaxf(y, 0.0f);
          store(out + idx, y);
        }
      }
}

}  // namespace

extern "C" {

// x (B, C, H, W) contiguous, bf16 (dtype 1) or fp32 (dtype 0); sa one fp32 on
// the device; xq (B, H, W, Cp) int8 contiguous, Cp >= C a multiple of 32.
// Returns cudaGetLastError() after the launch.
int petr_quantize_act(const void* x, int dtype, const void* sa, void* xq, int B, int C, int H, int W, int Cp,
                      void* stream) {
  using namespace i8;
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || Cp < C || Cp % BK != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int HW = H * W;
  const dim3 grid((HW + QT - 1) / QT, Cp / QT, B), block(QT, 8);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    quantize_act_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(sa), static_cast<int8_t*>(xq), C, HW, Cp);
  } else if (dtype == 0) {
    quantize_act_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(sa), static_cast<int8_t*>(xq), C, HW, Cp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// xq (B, H, W, Cp) and wq (Co, k, k, Cp) int8 contiguous, 16-byte aligned,
// Cp a multiple of 32; scale and add (Co,) fp32; out (B, Co, Ho, Wo) in
// dtype (1 bf16, 0 fp32) or NULL; acc (B, Co, Ho, Wo) int32 or NULL (the raw
// sums). k 1 or 3, stride 1 or 2, padding k / 2. Returns cudaGetLastError()
// after the launch.
int petr_conv_int8_fwd(const void* xq, const void* wq, const void* scale, const void* add, void* out, void* acc,
                       int dtype, int B, int Cp, int H, int W, int Co, int k, int stride, int Ho, int Wo,
                       int relu, void* stream) {
  using namespace i8;
  if (B <= 0 || Cp <= 0 || Cp % BK != 0 || H <= 0 || W <= 0 || Co <= 0 || (k != 1 && k != 3) ||
      (stride != 1 && stride != 2) || Ho != (H + 2 * (k / 2) - k) / stride + 1 ||
      Wo != (W + 2 * (k / 2) - k) / stride + 1 || (out == nullptr && acc == nullptr) ||
      (out != nullptr && (scale == nullptr || add == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * Ho * Wo;
  const long long blocks = (M + BM - 1) / BM;
  if (blocks > 2147483647LL || (Co + BN - 1) / BN > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), (Co + BN - 1) / BN);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x8 = static_cast<const int8_t*>(xq);
  const auto* w8 = static_cast<const int8_t*>(wq);
  const auto* sc = static_cast<const float*>(scale);
  const auto* ad = static_cast<const float*>(add);
  auto* a32 = static_cast<int32_t*>(acc);
  if (dtype == 1) {
    conv_int8_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        x8, w8, sc, ad, static_cast<__nv_bfloat16*>(out), a32, B, Cp, H, W, Co, k, stride, Ho, Wo, relu);
  } else if (dtype == 0) {
    conv_int8_kernel<float><<<grid, THREADS, 0, s>>>(
        x8, w8, sc, ad, static_cast<float*>(out), a32, B, Cp, H, W, Co, k, stride, Ho, Wo, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* petr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
