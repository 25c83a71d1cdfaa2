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
// convs of a flagship forward. Two kernels, chosen by the caller by dtype:
//
// * conv3x3_bn_relu_tc_kernel, bf16, on the tensor cores: the route's kernel.
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
// The bf16 design: an implicit GEMM on mma.sync.m16n8k16 (bf16 in, fp32
// sums). A block owns one image, a tile of up to 128 output pixels (TH x TW,
// chosen by the caller from the plane so that few lanes idle at W = 25, 50,
// 100 and 200) and 64 output channels; 8 warps hold 32 pixels x 32 channels
// each. K = 9 * Cin is walked as chunks of 16 input channels x 9 taps:
//   * the chunk's input halo, (TH + 2) x (TW + 2) x 16 channels, arrives by
//     4-byte cp.async from NCHW rows into a staging ring of two stages (x is
//     read in place: no padded or channels-last copy is made), then one pass
//     transposes it in shared memory to channels-innermost, with zeros
//     outside the plane, 48 bytes per position so that ldmatrix rows fall in
//     distinct banks;
//   * the nine taps are shifted views of that halo: each lane of ldmatrix
//     gives its own pixel's row address, shifted by (kh, kw), so the A
//     fragments load straight from the halo and no im2col is built;
//   * the weight chunk, (64 channels, 9 taps x 16), arrives by 16-byte
//     cp.async into its own two-stage ring. K is tap-major and channel-minor,
//     petr_tpu's wf = weight.reshape(9 * C, Co) order: the wrapper repacks
//     OIHW to (Co, 3, 3, Cp) once per call (one copy kernel, which also casts
//     to bf16; Cp = Cin rounded up to 8, zero-padded);
//   * chunk i + 1 is in flight while chunk i is transposed and multiplied;
//   * where the tiles alone give too few blocks for the card (20x50 and
//     10x25: 144 and 48 blocks), the chunks are split over up to a few
//     blocks per tile (split K): each writes its fp32 partial sums, and a
//     second kernel adds them in a fixed order before the epilogue, so the
//     result stays deterministic (no atomics);
//   * the epilogue applies mul, add and the ReLU in fp32 to the sums, rounds
//     once and goes through shared memory so that the NCHW stores run along W.
//
// What holds it back now: per 16-channel chunk, staging the halo (4-byte
// copies, then the transpose) and the weights costs about as many
// instructions as the 72 mma.sync of each warp; the weights are fetched
// again by every block (at 80x200, 1,536 blocks); and at 20x50 and 10x25
// the split K adds a pass over fp32 partial sums. wgmma on TMA-fed tiles,
// with larger tiles per block, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

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
namespace tc {
constexpr int BM = 128;          // output pixels per block: a TH x TW tile, TH * TW <= BM
constexpr int BN = 64;           // output channels per block
constexpr int CK = 16;           // input channels per chunk: one k16 step per tap
constexpr int WARPS_M = 4;               // warps along M; 2 along N (32 channels each)
constexpr int WM = BM / WARPS_M;         // pixels per warp
constexpr int MT = WM / 16;              // m16 tiles per warp
constexpr int THREADS = 64 * WARPS_M;
constexpr int PS = CK + 8;       // halo: elements per position (48 B: ldmatrix rows in distinct banks)
constexpr int WS = 9 * CK + 8;   // weights: elements per output channel (304 B, the same)
constexpr int OS = BM + 8;       // epilogue tile: elements per output channel
constexpr int W_STAGE = BN * WS; // elements of one weight stage

// Element offsets into the dynamic shared memory for a TH x TW tile: two
// weight stages, two staged-halo stages (NCHW rows as copied), the
// transposed halo; the epilogue reuses the start.
struct Layout {
  int hr, hc;      // halo rows and columns
  int nw, sr;      // 4-byte words per staged row, and its length in elements
  int stage;       // elements of one staged-halo stage
  int staged;      // offset of staged-halo stage 0
  int halo;        // offset of the transposed halo
  int bytes;       // the whole
};

__host__ __device__ inline Layout layout(int TH, int TW) {
  Layout l;
  l.hr = TH + 2;
  l.hc = TW + 2;
  l.nw = (l.hc + 2) / 2;  // hc elements from an offset of 0 or 1 in an aligned word
  l.sr = 2 * l.nw;
  l.stage = (CK * l.hr * l.sr + 7) / 8 * 8;
  l.staged = 2 * W_STAGE;
  l.halo = l.staged + 2 * l.stage;
  const int end = l.halo + l.hr * l.hc * PS;
  l.bytes = 2 * (end > BN * OS ? end : BN * OS);
  return l;
}

}  // namespace tc

// A flat index i over three digits (a, b, c) with radices (-, nb, nc),
// stepped by a fixed stride with carries instead of divisions.
struct Walk {
  int a, b, c;     // the digits of i
  int da, db, dc;  // the digits of the stride
  int nb, nc;
  __device__ Walk(int start, int stride, int nb_, int nc_) : nb(nb_), nc(nc_) {
    a = start / (nb * nc), b = start / nc % nb, c = start % nc;
    da = stride / (nb * nc), db = stride / nc % nb, dc = stride % nc;
  }
  __device__ void step() {
    c += dc;
    int carry = c >= nc;
    c -= carry ? nc : 0;
    b += db + carry;
    carry = b >= nb;
    b -= carry ? nb : 0;
    a += da + carry;
  }
};

// wr: the weight repacked to (Co, 3, 3, Cp) bf16, Cp >= C a multiple of 8,
// zero past C. x, wr 16-byte aligned. With ksplit > 1, block z = b * ksplit
// + split sums only its share of the chunks and writes the raw fp32 sums to
// part[split] (B, Co, H, W); conv3x3_bn_relu_tc_splitk_reduce_kernel finishes
// them.
__global__ void __launch_bounds__(tc::THREADS, 2)
conv3x3_bn_relu_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wr,
                          const float* __restrict__ mul, const float* __restrict__ add,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ part, int C, int Cp,
                          int H, int W, int Co, int TH, int TW, int tiles_w, int ksplit, int affine,
                          int relu) {
  using namespace tc;
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  const unsigned short* sm16 = reinterpret_cast<const unsigned short*>(sm);
  const Layout L = layout(TH, TW);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int b = blockIdx.z / ksplit, split = blockIdx.z % ksplit;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const int npix = TH * TW;
  const long long numel = (long long)(gridDim.z / ksplit) * C * H * W;
  const unsigned plane = (unsigned)H * (unsigned)W;

  // ldmatrix row addresses (elements). A: lane l gives pixel l % 16 of an m16
  // tile, channels (l / 16) * 8 .. + 7. B: lane l gives output channel
  // (l / 16) * 8 + l % 8 of an n16 pair, k (l / 8 % 2) * 8 .. + 7.
  int a_off[MT], b_off[2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = wm * WM + i * 16 + (lane & 15);
    const int pos = m < npix ? (m / TW) * L.hc + m % TW : 0;
    a_off[i] = L.halo + pos * PS + (lane >> 4) * 8;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = wn * 32 + j * 16 + (lane >> 4) * 8 + (lane & 7);
    b_off[j] = n * WS + ((lane >> 3) & 1) * 8;
  }

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // chunk ch's weights and halo rows, by cp.async, into stage s. The halo
  // words are walked as (channel, row, word) digits stepped without
  // divisions; a row starts at element (c0 + c, y0 - 1 + r, x0 - 1).
  const int per_c = L.hr * L.nw;
  const Walk halo_walk(tid, THREADS, L.hr, L.nw);
  auto load_chunk = [&](int ch, int s) {
    const int c0 = ch * CK;
    __nv_bfloat16* wst = sm + s * W_STAGE;
    for (int i = tid; i < BN * 9 * (CK / 8); i += THREADS) {
      const int piece = i % (CK / 8), t = (i / (CK / 8)) % 9, n = i / (9 * (CK / 8));
      const int o = n0 + n, c = c0 + piece * 8;
      const bool ok = o < Co && c < Cp;
      cp_async16(wst + n * WS + t * CK + piece * 8, ok ? wr + ((long long)o * 9 + t) * Cp + c : wr,
                 ok ? 16 : 0);
    }
    __nv_bfloat16* stg = sm + L.staged + s * L.stage;
    const long long corner = ((long long)(b * C + c0) * H + (y0 - 1)) * W + (x0 - 1);
    Walk w = halo_walk;
    for (int i = tid; i < CK * per_c; i += THREADS, w.step()) {
      const int c = w.a, r = w.b, wd = w.c;
      const int gy = y0 - 1 + r;
      if (c0 + c >= C || gy < 0 || gy >= H) continue;  // the transpose writes zeros there
      const long long row = corner + (long long)c * plane + r * W;
      const long long e = (row & ~1LL) + 2 * wd;        // an aligned pair of elements
      if (e < 0 || e >= numel) continue;                // only columns outside the plane
      cp_async4(stg + (c * L.hr + r) * L.sr + 2 * wd, x + e, e + 1 < numel ? 4 : 2);
    }
  };

  // stage s's rows -> the halo, channels innermost, zeros outside the plane;
  // walked as (channel group of 8, row, column)
  const int npos = L.hr * L.hc;
  const int crow = L.hr * L.sr;  // elements from one channel's staged rows to the next
  const unsigned odd_plane = plane & 1u;
  const Walk halo_pos_walk(tid, THREADS, L.hr, L.hc);
  auto transpose = [&](int ch, int s) {
    const int c0 = ch * CK;
    const int stg = L.staged + s * L.stage;
    Walk w = halo_pos_walk;
    for (int i = tid; i < npos * (CK / 8); i += THREADS, w.step()) {
      const int g = w.a, r = w.b, col = w.c;
      const int gy = y0 - 1 + r, gx = x0 - 1 + col;
      const int cg = c0 + g * 8;
      uint32_t packed[4] = {0u, 0u, 0u, 0u};
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        // a staged row starts at offset (the global index of its first element & 1)
        const unsigned par = ((unsigned)(b * C + cg) * plane + (unsigned)(gy * W + x0 - 1)) & 1u;
        const int src = stg + (g * 8 * L.hr + r) * L.sr + col;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t v = cg + k < C ? sm16[src + k * crow + ((par + k * odd_plane) & 1u)] : 0u;
          packed[k >> 1] |= v << (16 * (k & 1));
        }
      }
      *reinterpret_cast<uint4*>(sm + L.halo + (r * L.hc + col) * PS + g * 8) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  };

  // this block's chunks: all, or its share of them when K is split
  const int nch = (C + CK - 1) / CK;
  const int c_lo = (int)((long long)split * nch / ksplit);
  const int c_hi = (int)((long long)(split + 1) * nch / ksplit);
  load_chunk(c_lo, 0);
  cp_async_commit();
  for (int ch = c_lo; ch < c_hi; ++ch) {
    const int s = (ch - c_lo) & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk ch has landed; every warp is done with chunk ch - 1
    if (ch + 1 < c_hi) load_chunk(ch + 1, s ^ 1);
    cp_async_commit();
    transpose(ch, s);
    __syncthreads();
    const __nv_bfloat16* wst = sm + s * W_STAGE;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int shift = (t / 3) * L.hc + t % 3;  // tap (kh, kw): halo position + kh rows + kw columns
      uint32_t a[MT][4], bw[2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], sm + a_off[i] + shift * PS);
#pragma unroll
      for (int j = 0; j < 2; ++j) ldmatrix_x4(bw[j], wst + b_off[j] + t * CK);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[i][2 * j], a[i], bw[j][0], bw[j][1]);
          mma_bf16(acc[i][2 * j + 1], a[i], bw[j][2], bw[j][3]);
        }
    }
  }

  // epilogue: fp32 scale, shift and ReLU, one rounding, then (channel, pixel)
  // through shared memory so that the stores run along the output rows; a
  // share of a split K stores its raw fp32 sums the same way
  cp_async_wait<0>();
  __syncthreads();
  const int g = lane >> 2, t4 = lane & 3;
  if (part != nullptr) {
    float* pt = reinterpret_cast<float*>(sm);  // [BN][BM + 4]
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pt[(wn * 32 + nt * 8 + 2 * t4 + (e & 1)) * (BM + 4) + wm * WM + i * 16 + g + 8 * (e >> 1)] =
              acc[i][nt][e];
    __syncthreads();
    float* pb = part + (long long)split * (numel / C) * Co;
    for (int i = tid; i < BN * BM; i += THREADS) {
      const int n = i / BM, m = i % BM;
      const int o = n0 + n;
      if (m >= npix || o >= Co) continue;
      const int gy = y0 + m / TW, gx = x0 + m % TW;
      if (gy >= H || gx >= W) continue;
      pb[(((long long)b * Co + o) * H + gy) * W + gx] = pt[n * (BM + 4) + m];
    }
    return;
  }
  __nv_bfloat16* ot = sm;  // [BN][OS]
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = wn * 32 + nt * 8 + 2 * t4 + j;
      const int o = n0 + n;
      const float mo = affine && o < Co ? mul[o] : 1.f;
      const float ao = affine && o < Co ? add[o] : 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = acc[i][nt][2 * h + j];
          if (affine) v = v * mo + ao;
          if (relu) v = fmaxf(v, 0.f);
          ot[n * OS + wm * WM + i * 16 + g + 8 * h] = __float2bfloat16(v);
        }
    }
  __syncthreads();
  for (int i = tid; i < BN * BM; i += THREADS) {
    const int n = i / BM, m = i % BM;
    const int o = n0 + n;
    if (m >= npix || o >= Co) continue;
    const int gy = y0 + m / TW, gx = x0 + m % TW;
    if (gy >= H || gx >= W) continue;
    out[(((long long)b * Co + o) * H + gy) * W + gx] = ot[n * OS + m];
  }
}

// out = act(sum over s of part[s] * mul + add), the splits summed in order:
// the result of a split K does not depend on which block finished first
__global__ void conv3x3_bn_relu_tc_splitk_reduce_kernel(const float* __restrict__ part,
                                                        const float* __restrict__ mul,
                                                        const float* __restrict__ add,
                                                        __nv_bfloat16* __restrict__ out, long long n,
                                                        int plane, int Co, int ksplit, int affine,
                                                        int relu) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < ksplit; ++s) v += part[s * n + i];
    if (affine) {
      const int o = (int)((i / plane) % Co);
      v = v * mul[o] + add[o];
    }
    if (relu) v = fmaxf(v, 0.f);
    out[i] = __float2bfloat16(v);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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

// bf16 on the tensor cores. x (B, C, H, W) and out (B, Co, H, W) bf16
// contiguous; wr the weight repacked to (Co, 3, 3, Cp) bf16 contiguous, Cp >=
// C a multiple of 8, zero past C; x and wr 16-byte aligned. mul and add as
// above. The output tile is TH x TW pixels, TH * TW <= 128. ksplit > 1
// splits the 16-channel chunks over that many blocks per tile (at most one
// per chunk) and needs part, fp32 scratch of ksplit * B * Co * H * W; the
// conv kernel then writes partial sums there and a second kernel adds them
// in order and applies the epilogue. Returns cudaGetLastError() after the
// launches.
int petr_conv3x3_bn_relu_tc_fwd(const void* x, const void* wr, const void* mul, const void* add,
                                void* out, void* part, int B, int C, int Cp, int H, int W, int Co,
                                int TH, int TW, int ksplit, int relu, void* stream) {
  using namespace tc;
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || Co <= 0 || Cp < C || Cp % 8 != 0 ||
      TH <= 0 || TW <= 0 || TH * TW > BM || (Co + BN - 1) / BN > 65535 ||
      ((mul == nullptr) != (add == nullptr)) || !aligned16(x) || !aligned16(wr) || ksplit < 1 ||
      ksplit > (C + CK - 1) / CK || (long long)B * ksplit > 65535 || ((ksplit > 1) != (part != nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long tiles_w = (W + TW - 1) / TW;
  const long long tiles = ((H + TH - 1) / TH) * tiles_w;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Layout l = layout(TH, TW);
  static int granted = 48 * 1024;  // the dynamic shared memory the kernel is allowed so far
  if (l.bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(conv3x3_bn_relu_tc_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
    if (e != cudaSuccess) return (int)e;
    granted = l.bytes;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)tiles, (Co + BN - 1) / BN, B * ksplit);
  conv3x3_bn_relu_tc_kernel<<<grid, THREADS, l.bytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wr),
      static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), C, Cp, H, W, Co, TH, TW,
      (int)tiles_w, ksplit, mul != nullptr, relu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ksplit == 1) return (int)e;
  const long long n = (long long)B * Co * H * W;
  const long long blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  conv3x3_bn_relu_tc_splitk_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<__nv_bfloat16*>(out), n, H * W, Co, ksplit, mul != nullptr, relu);
  return (int)cudaGetLastError();
}

const char* petr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
