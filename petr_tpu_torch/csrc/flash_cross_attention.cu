// Flash cross-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (petr_tpu_torch/ops/cross_attention.py).
//
// Replaces petr_tpu/ops/pallas/cross_attention.py::_kernel, driven there by
// _flash_forward: masked multi-head attention of q (B,H,Q,D) over k, v
// (B,H,L,D), scaled by 1/sqrt(D), with a (B,L) key-padding mask (nonzero =
// padded). Returns out (B,H,Q,D) in the input type and the per-row fp32
// logsumexp (B,H,Q). A row whose keys are all masked gets out = 0 and
// lse = +1e30, the sentinel the backward and the sequence-parallel combine
// rely on. With dropout (the train step's attention dropout), the normalised
// probabilities are dropped by the hashed keep mask of dropout_hash.cuh and
// the kept ones divided by (1 - rate); the softmax denominator and lse are
// taken before dropout, as in _kernel.
//
// What bounds it. At the flagship shape (B=1, H=8, Q=900, L=6000, D=32) one
// call needs 5.5 GFLOP of products (5.6 us at 989 TFLOP/s bf16), 43.2 M
// exponentials (about 10 us at 16 per SM per clock on 132 SMs at 1.98 GHz)
// and about 7 MB of traffic (2 us at 3.35 TB/s): the exponentials bound it.
// This version does its products on the fp32 CUDA cores, not on the tensor
// cores, so its own ceiling is the fp32 FMA rate (2.76 G FMA, about 80 us);
// wgmma, TMA and warp specialisation come later.
//
// Design. The (Q, L) logits never reach device memory: each block owns BQ
// query rows of one (b, h), loops over K/V tiles of BK keys staged in shared
// memory as fp32, and keeps an online softmax (max m, sum l, accumulator) in
// fp32 registers. The TPU kernel runs its key loop as a sequential grid axis;
// here the loop lives inside the block, and the block's threads also split
// each tile's keys NSPLIT ways (thread t: row t % BQ, split t / BQ), so that
// the flagship's 8 heads x 29 query tiles give 232 blocks of 8 warps, two
// resident per SM, instead of 120 blocks for 132 SMs with 64-row tiles. The
// NSPLIT partial softmax states of a row are merged through shared memory at
// the end. Keys past L are masked here, so no padded copies are made.
// K/V of one head (768 KB in bf16 at the flagship) stay in the 50 MB L2 while
// the query tiles of that head read them again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int BQ = 32;                 // query rows per block
constexpr int NSPLIT = 8;              // ways each key tile is split
constexpr int THREADS = BQ * NSPLIT;   // 256
constexpr int BK = 128;                // keys per staged tile
constexpr int KPT = BK / NSPLIT;       // keys per thread per tile
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
};

template <int D>
constexpr size_t smem_floats() {
  // K and V tiles plus the mask tile, reused at the end for the NSPLIT
  // partial states (m, l, acc[D]) of every row
  return (2 * BK * D + BK) > (NSPLIT * BQ * (D + 2)) ? (2 * BK * D + BK)
                                                     : (NSPLIT * BQ * (D + 2));
}

template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, D <= 32 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse,
                 int H, int Q, int L, Strides st, float scale,
                 uint32_t seed, uint32_t thresh, float keep_prob) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;            // [BK][D]
  float* vs = ks + BK * D;     // [BK][D]
  float* mtile = vs + BK * D;  // [BK], 1 = masked

  const int tid = threadIdx.x;
  const int row = tid % BQ;
  const int split = tid / BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int qi = blockIdx.x * BQ + row;
  const bool row_ok = qi < Q;

  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + h * st.k_h;
  const T* vb = v + b * st.v_b + h * st.v_h;
  const uint8_t* mb = mask ? mask + (long long)b * L : nullptr;
  const uint32_t mix = dropout_mix(seed, (uint32_t)bh);

  // logits are kept in log2 units: exp(x) == exp2(x * log2(e))
  const float qscale = scale * LOG2E;
  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? to_float(qb[qi * st.q_s + d]) * qscale : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG;
  float l = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D;
      const int d = i % D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < L) {
        kv = to_float(kb[key * st.k_s + d]);
        vv = to_float(vb[key * st.v_s + d]);
      }
      ks[i] = kv;
      vs[i] = vv;
    }
    for (int j = tid; j < BK; j += THREADS) {
      const int key = k0 + j;
      mtile[j] = (key >= L || (mb != nullptr && mb[key] != 0)) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[KPT];
    float tile_max = NEG;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = split * KPT + jj;
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      s[jj] = mtile[j] != 0.f ? NEG : dot;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    const float m_new = fmaxf(m, tile_max);
    // while every key so far is masked, m_new == NEG and alpha == 1; the
    // explicit zero on masked keys keeps such rows at exactly 0
    const float alpha = exp2f(m - m_new);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = split * KPT + jj;
      float p = mtile[j] != 0.f ? 0.f : exp2f(s[jj] - m_new);
      psum += p;  // the denominator is taken before dropout
      if (DROPOUT) p = dropout_keep(mix, qi, k0 + j, thresh) ? p / keep_prob : 0.f;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  // merge the NSPLIT partial states of each row
  __syncthreads();
  constexpr int SW = D + 2;
  float* my = smem + (split * BQ + row) * SW;
  my[0] = m;
  my[1] = l;
#pragma unroll
  for (int d = 0; d < D; ++d) my[2 + d] = acc[d];
  __syncthreads();

  if (!row_ok) return;
  constexpr int DPT = D / NSPLIT;  // output columns per thread
  float mmax = NEG;
#pragma unroll
  for (int s2 = 0; s2 < NSPLIT; ++s2) mmax = fmaxf(mmax, smem[(s2 * BQ + row) * SW]);
  T* orow = out + b * st.o_b + h * st.o_h + qi * st.o_s;
  const int d0 = split * DPT;
  if (mmax <= NEG * 0.5f) {  // every key of this row is masked
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) store(orow + d0 + dd, 0.f);
    if (split == 0) lse[(long long)bh * Q + qi] = -NEG;
    return;
  }
  float lsum = 0.f;
  float o[DPT];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) o[dd] = 0.f;
#pragma unroll
  for (int s2 = 0; s2 < NSPLIT; ++s2) {
    const float* ps = smem + (s2 * BQ + row) * SW;
    const float w = exp2f(ps[0] - mmax);
    lsum = fmaf(ps[1], w, lsum);
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) o[dd] = fmaf(ps[2 + d0 + dd], w, o[dd]);
  }
  const float inv = 1.f / fmaxf(lsum, 1e-20f);
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) store(orow + d0 + dd, o[dd] * inv);
  if (split == 0) lse[(long long)bh * Q + qi] = (mmax + log2f(lsum)) * LN2;
}

struct Dropout {
  bool on;
  uint32_t seed, thresh;
  float keep_prob;
};

template <typename T, int D, bool DROPOUT>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* lse, int B, int H, int Q, int L, const Strides& st,
           float scale, const Dropout& dr, cudaStream_t stream) {
  static_assert(D % NSPLIT == 0 && D % 4 == 0, "D must split evenly");
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, DROPOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Q + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D, DROPOUT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out),
      static_cast<float*>(lse), H, Q, L, st, scale, dr.seed, dr.thresh, dr.keep_prob);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_dropout(const void* q, const void* k, const void* v, const void* mask,
                     void* out, void* lse, int B, int H, int Q, int L,
                     const Strides& st, float scale, const Dropout& dr, cudaStream_t stream) {
  if (dr.on) return launch<T, D, true>(q, k, v, mask, out, lse, B, H, Q, L, st, scale, dr, stream);
  return launch<T, D, false>(q, k, v, mask, out, lse, B, H, Q, L, st, scale, dr, stream);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* mask,
               void* out, void* lse, int B, int H, int Q, int L, int D,
               const Strides& st, float scale, const Dropout& dr, cudaStream_t stream) {
  switch (D) {
    case 16: return dispatch_dropout<T, 16>(q, k, v, mask, out, lse, B, H, Q, L, st, scale, dr, stream);
    case 32: return dispatch_dropout<T, 32>(q, k, v, mask, out, lse, B, H, Q, L, st, scale, dr, stream);
    case 64: return dispatch_dropout<T, 64>(q, k, v, mask, out, lse, B, H, Q, L, st, scale, dr, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, for q, k, v
// and out in turn, each (batch, head, row); the last axis is contiguous.
// mask: (B, L) bytes or NULL. dropout: 0 = off; else seed (the int32 seed's
// bits), thresh and keep_prob = 1 - rate drop the probabilities as
// dropout_hash.cuh says. Returns cudaGetLastError() after the launch.
int petr_flash_cross_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse,
                                   int B, int H, int Q, int L, int D, int dtype,
                                   const long long* strides, float scale,
                                   int dropout, uint32_t seed, uint32_t thresh,
                                   float keep_prob, void* stream) {
  Strides st;
  st.q_b = strides[0]; st.q_h = strides[1]; st.q_s = strides[2];
  st.k_b = strides[3]; st.k_h = strides[4]; st.k_s = strides[5];
  st.v_b = strides[6]; st.v_h = strides[7]; st.v_s = strides[8];
  st.o_b = strides[9]; st.o_h = strides[10]; st.o_s = strides[11];
  const Dropout dr{dropout != 0, seed, thresh, keep_prob};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, mask, out, lse, B, H, Q, L, D, st, scale, dr, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, mask, out, lse, B, H, Q, L, D, st, scale, dr, s);
  return (int)cudaErrorInvalidValue;
}

const char* petr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
