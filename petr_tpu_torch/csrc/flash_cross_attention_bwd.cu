// Flash cross-attention backward for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (petr_tpu_torch/ops/cross_attention.py).
//
// Replaces petr_tpu/ops/pallas/cross_attention.py::_bwd_kernel, driven there
// by _flash_backward_impl and _flash_bwd_shared: the FlashAttention-2
// backward of the forward in flash_cross_attention.cu. For every (query,
// key) pair of one (b, h) it recomputes
//     p   = exp(min(s - lse, 0))          s = q.k / sqrt(D); 0 on masked keys
//     dp  = dO . v
//     ds  = p * (keep(dp) - delta)        delta = rowsum(dO * O) - g_lse
// and accumulates dV += keep(p) dO, dK += ds q / sqrt(D), dQ += ds k / sqrt(D),
// where keep(x) = x / (1 - rate) on the keys the forward kept and 0 on the
// others (dropout_hash.cuh regenerates the forward's mask from the
// coordinates). The clamp at 0 is the round-3 overflow fix of _bwd_kernel: p
// is a probability, and a recomputed logit a rounding step above the saved
// lse must not overflow exp. A row whose keys are all masked carries
// lse = +1e30, so its p, and every gradient it feeds, is exactly 0.
//
// Design. The TPU kernel walks key blocks in a sequential grid and keeps dQ
// resident across them. Blocks of a GPU grid run in parallel, so here two
// kernels split the work and neither needs atomics, which keeps dQ
// deterministic:
//   * flash_bwd_dkdv_kernel: one block per (b*h, 64 keys). Each key belongs
//     to D/16 neighbouring threads that hold 16 of its dims of k, v, dk, dv
//     in registers; the two dot products per pair are summed over those
//     threads with warp shuffles. The block walks all queries in tiles of
//     64 rows of q and dO (plus lse and delta) staged in shared memory as
//     fp32, which every thread reads by broadcast.
//   * flash_bwd_dq_kernel: one block per (b*h, 32 queries), laid out as the
//     forward: thread (row, split) holds its row's q, dO and dq, and takes
//     1/8 of each 128-key tile of k and v staged in shared memory; the 8
//     partial dq of a row are summed through shared memory at the end.
//
// What bounds it. At the flagship shape (B=1, H=8, Q=900, L=6000 with 5,100
// unmasked, D=32) the pairs need 10*D flops each (s, dp, dV, dQ, dK): 11.7
// GFLOP, 12 us on the bf16 tensor cores, and one exp each: about 9 us on
// the SFUs; the bytes are a few MB. Like the forward, this first version
// does its products on the fp32 CUDA cores (and recomputes s and dp in both
// kernels): 7 G FMA, about 0.2 ms at the fp32 peak. Tensor cores come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float BIG = 1e30f;  // lse of a padded row: p = 0

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// element strides (batch, head, row) of q, k, v, dO, dq, dk, dv; the last
// axis of each is contiguous
struct Strides {
  long long q[3], k[3], v[3], o[3], dq[3], dk[3], dv[3];
};

struct Dropout {
  bool on;
  uint32_t seed, thresh;
  float keep_prob;
};

// ---------------------------------------------------------------- dK, dV
constexpr int KB = 64;  // keys per block
constexpr int QT = 64;  // queries per staged tile
constexpr int DP = 16;  // head dims per thread

template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(KB * (D / DP))
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const uint8_t* __restrict__ mask,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Q, int L, Strides st,
                      float scale, uint32_t seed, uint32_t thresh, float keep_prob) {
  constexpr int TPK = D / DP;  // threads per key
  constexpr int THREADS = KB * TPK;
  __shared__ float4 qs4[QT * D / 4];
  __shared__ float4 dos4[QT * D / 4];
  __shared__ float lse2s[QT];
  __shared__ float dels[QT];
  float* qs = reinterpret_cast<float*>(qs4);
  float* dos = reinterpret_cast<float*>(dos4);

  const int tid = threadIdx.x;
  const int key = blockIdx.x * KB + tid / TPK;
  const int d0 = (tid % TPK) * DP;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const bool in_range = key < L;
  const bool live = in_range && (mask == nullptr || mask[(long long)b * L + key] == 0);

  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* ob = dout + b * st.o[0] + h * st.o[1];
  const float* lseb = lse + (long long)bh * Q;
  const float* delb = delta + (long long)bh * Q;
  const uint32_t mix = dropout_mix(seed, (uint32_t)bh);

  // this key's dims, k pre-scaled so that q.k comes out in log2 units
  const float kscale = scale * LOG2E;
  float kr[DP], vr[DP], dkr[DP], dvr[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    kr[d] = in_range ? to_float(k[b * st.k[0] + h * st.k[1] + key * st.k[2] + d0 + d]) * kscale : 0.f;
    vr[d] = in_range ? to_float(v[b * st.v[0] + h * st.v[1] + key * st.v[2] + d0 + d]) : 0.f;
    dkr[d] = 0.f;
    dvr[d] = 0.f;
  }

  for (int q0 = 0; q0 < Q; q0 += QT) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < QT * D; i += THREADS) {
      const int r = q0 + i / D;
      const int d = i % D;
      const bool ok = r < Q;
      qs[i] = ok ? to_float(qb[r * st.q[2] + d]) : 0.f;
      dos[i] = ok ? to_float(ob[r * st.o[2] + d]) : 0.f;
    }
    for (int i = tid; i < QT; i += THREADS) {
      const bool ok = q0 + i < Q;
      lse2s[i] = ok ? lseb[q0 + i] * LOG2E : BIG;
      dels[i] = ok ? delb[q0 + i] : 0.f;
    }
    __syncthreads();

    const int nq = min(QT, Q - q0);  // the same for every thread
#pragma unroll 2
    for (int r = 0; r < nq; ++r) {
      const float4* qrow = reinterpret_cast<const float4*>(qs + r * D + d0);
      const float4* orow = reinterpret_cast<const float4*>(dos + r * D + d0);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DP / 4; ++d4) {
        const float4 qq = qrow[d4];
        const float4 oo = orow[d4];
        s = fmaf(kr[4 * d4 + 0], qq.x, s);
        s = fmaf(kr[4 * d4 + 1], qq.y, s);
        s = fmaf(kr[4 * d4 + 2], qq.z, s);
        s = fmaf(kr[4 * d4 + 3], qq.w, s);
        dp = fmaf(vr[4 * d4 + 0], oo.x, dp);
        dp = fmaf(vr[4 * d4 + 1], oo.y, dp);
        dp = fmaf(vr[4 * d4 + 2], oo.z, dp);
        dp = fmaf(vr[4 * d4 + 3], oo.w, dp);
      }
#pragma unroll
      for (int off = 1; off < TPK; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        dp += __shfl_xor_sync(0xffffffffu, dp, off);
      }
      const float p = live ? exp2f(fminf(s - lse2s[r], 0.f)) : 0.f;
      float pd = p;
      if (DROPOUT) {
        const bool keep = dropout_keep(mix, q0 + r, key, thresh);
        pd = keep ? p / keep_prob : 0.f;
        dp = keep ? dp / keep_prob : 0.f;
      }
      const float ds = p * (dp - dels[r]);
#pragma unroll
      for (int d4 = 0; d4 < DP / 4; ++d4) {
        const float4 qq = qrow[d4];
        const float4 oo = orow[d4];
        dvr[4 * d4 + 0] = fmaf(pd, oo.x, dvr[4 * d4 + 0]);
        dvr[4 * d4 + 1] = fmaf(pd, oo.y, dvr[4 * d4 + 1]);
        dvr[4 * d4 + 2] = fmaf(pd, oo.z, dvr[4 * d4 + 2]);
        dvr[4 * d4 + 3] = fmaf(pd, oo.w, dvr[4 * d4 + 3]);
        dkr[4 * d4 + 0] = fmaf(ds, qq.x, dkr[4 * d4 + 0]);
        dkr[4 * d4 + 1] = fmaf(ds, qq.y, dkr[4 * d4 + 1]);
        dkr[4 * d4 + 2] = fmaf(ds, qq.z, dkr[4 * d4 + 2]);
        dkr[4 * d4 + 3] = fmaf(ds, qq.w, dkr[4 * d4 + 3]);
      }
    }
  }

  if (!in_range) return;
  T* dkrow = dk + b * st.dk[0] + h * st.dk[1] + key * st.dk[2] + d0;
  T* dvrow = dv + b * st.dv[0] + h * st.dv[1] + key * st.dv[2] + d0;
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    store(dkrow + d, dkr[d] * scale);
    store(dvrow + d, dvr[d]);
  }
}

// ------------------------------------------------------------------- dQ
constexpr int BQ = 32;               // query rows per block
constexpr int NSPLIT = 8;            // ways each key tile is split
constexpr int THREADS = BQ * NSPLIT; // 256
constexpr int BK = 128;              // keys per staged tile
constexpr int KPT = BK / NSPLIT;     // keys per thread per tile

template <int D>
constexpr size_t dq_smem_floats() {
  // K and V tiles plus the mask tile, reused at the end for the NSPLIT
  // partial dq of every row (row stride D + 1 against bank conflicts)
  return (2 * BK * D + BK) > (NSPLIT * BQ * (D + 1)) ? (2 * BK * D + BK)
                                                    : (NSPLIT * BQ * (D + 1));
}

template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, D <= 32 ? 2 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Q, int L, Strides st, float scale,
                    uint32_t seed, uint32_t thresh, float keep_prob) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;            // [BK][D]
  float* vs = ks + BK * D;     // [BK][D]
  float* mtile = vs + BK * D;  // [BK], 1 = masked or past L

  const int tid = threadIdx.x;
  const int row = tid % BQ;
  const int split = tid / BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int qi = blockIdx.x * BQ + row;
  const bool row_ok = qi < Q;

  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb = mask ? mask + (long long)b * L : nullptr;
  const uint32_t mix = dropout_mix(seed, (uint32_t)bh);

  const float qscale = scale * LOG2E;
  float qr[D], orr[D], dqr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? to_float(q[b * st.q[0] + h * st.q[1] + qi * st.q[2] + d]) * qscale : 0.f;
    orr[d] = row_ok ? to_float(dout[b * st.o[0] + h * st.o[1] + qi * st.o[2] + d]) : 0.f;
    dqr[d] = 0.f;
  }
  const float lse2 = row_ok ? lse[(long long)bh * Q + qi] * LOG2E : BIG;
  const float del = row_ok ? delta[(long long)bh * Q + qi] : 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int key = k0 + i / D;
      const int d = i % D;
      const bool ok = key < L;
      ks[i] = ok ? to_float(kb[key * st.k[2] + d]) : 0.f;
      vs[i] = ok ? to_float(vb[key * st.v[2] + d]) : 0.f;
    }
    for (int j = tid; j < BK; j += THREADS) {
      const int key = k0 + j;
      mtile[j] = (key >= L || (mb != nullptr && mb[key] != 0)) ? 1.f : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = split * KPT + jj;
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        const float4 vv = vr[d4];
        s = fmaf(qr[4 * d4 + 0], kk.x, s);
        s = fmaf(qr[4 * d4 + 1], kk.y, s);
        s = fmaf(qr[4 * d4 + 2], kk.z, s);
        s = fmaf(qr[4 * d4 + 3], kk.w, s);
        dp = fmaf(orr[4 * d4 + 0], vv.x, dp);
        dp = fmaf(orr[4 * d4 + 1], vv.y, dp);
        dp = fmaf(orr[4 * d4 + 2], vv.z, dp);
        dp = fmaf(orr[4 * d4 + 3], vv.w, dp);
      }
      const float p = mtile[j] != 0.f ? 0.f : exp2f(fminf(s - lse2, 0.f));
      if (DROPOUT)
        dp = dropout_keep(mix, qi, k0 + j, thresh) ? dp / keep_prob : 0.f;
      const float ds = p * (dp - del);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        dqr[4 * d4 + 0] = fmaf(ds, kk.x, dqr[4 * d4 + 0]);
        dqr[4 * d4 + 1] = fmaf(ds, kk.y, dqr[4 * d4 + 1]);
        dqr[4 * d4 + 2] = fmaf(ds, kk.z, dqr[4 * d4 + 2]);
        dqr[4 * d4 + 3] = fmaf(ds, kk.w, dqr[4 * d4 + 3]);
      }
    }
  }

  // sum the NSPLIT partial dq of each row
  __syncthreads();
  constexpr int SW = D + 1;
  float* my = smem + (split * BQ + row) * SW;
#pragma unroll
  for (int d = 0; d < D; ++d) my[d] = dqr[d];
  __syncthreads();
  if (!row_ok) return;
  constexpr int DPT = D / NSPLIT;  // output columns per thread
  T* dqrow = dq + b * st.dq[0] + h * st.dq[1] + qi * st.dq[2];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) {
    const int col = split * DPT + dd;
    float sum = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < NSPLIT; ++s2) sum += smem[(s2 * BQ + row) * SW + col];
    store(dqrow + col, sum * scale);
  }
}

// ------------------------------------------------------------- launches
struct Args {
  const void *q, *k, *v, *mask, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Q, L;
  Strides st;
  float scale;
  Dropout dr;
  cudaStream_t stream;
};

template <typename T, int D, bool DROPOUT>
int launch_dkdv(const Args& a) {
  static_assert(D % DP == 0 && (KB * (D / DP)) % 32 == 0, "D must split evenly");
  const dim3 grid((a.L + KB - 1) / KB, a.B * a.H);
  flash_bwd_dkdv_kernel<T, D, DROPOUT><<<grid, KB * (D / DP), 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Q, a.L, a.st, a.scale,
      a.dr.seed, a.dr.thresh, a.dr.keep_prob);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool DROPOUT>
int launch_dq(const Args& a) {
  static_assert(D % NSPLIT == 0 && D % 4 == 0, "D must split evenly");
  constexpr size_t smem = dq_smem_floats<D>() * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D, DROPOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Q + BQ - 1) / BQ, a.B * a.H);
  flash_bwd_dq_kernel<T, D, DROPOUT><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.H, a.Q, a.L, a.st, a.scale,
      a.dr.seed, a.dr.thresh, a.dr.keep_prob);
  return (int)cudaGetLastError();
}

// which = 0: dK/dV kernel, 1: dQ kernel
template <typename T, int D>
int dispatch_kernel(int which, const Args& a) {
  if (which == 0) return a.dr.on ? launch_dkdv<T, D, true>(a) : launch_dkdv<T, D, false>(a);
  return a.dr.on ? launch_dq<T, D, true>(a) : launch_dq<T, D, false>(a);
}

template <typename T>
int dispatch_d(int which, int D, const Args& a) {
  switch (D) {
    case 16: return dispatch_kernel<T, 16>(which, a);
    case 32: return dispatch_kernel<T, 32>(which, a);
    case 64: return dispatch_kernel<T, 64>(which, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(int which, const void* q, const void* k, const void* v, const void* mask,
        const void* dout, const void* lse, const void* delta, void* dq, void* dk,
        void* dv, int B, int H, int Q, int L, int D, int dtype,
        const long long* strides, float scale, int dropout, uint32_t seed,
        uint32_t thresh, float keep_prob, void* stream) {
  Args a{q, k, v, mask, dout, lse, delta, dq, dk, dv, B, H, Q, L, {}, scale,
         {dropout != 0, seed, thresh, keep_prob}, static_cast<cudaStream_t>(stream)};
  long long* dst[7] = {a.st.q, a.st.k, a.st.v, a.st.o, a.st.dq, a.st.dk, a.st.dv};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  if (dtype == 0) return dispatch_d<float>(which, D, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(which, D, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, dout and the gradients.
// strides: 21 element strides, (batch, head, row) of q, k, v, dout, dq, dk
// and dv in turn; the last axis of each is contiguous. mask: (B, L) bytes or
// NULL. lse and delta: (B, H, Q) fp32, delta = rowsum(dO * O) - g_lse.
// dropout as in petr_flash_cross_attention_fwd. Each returns
// cudaGetLastError() after its launch.
int petr_flash_cross_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Q,
    int L, int D, int dtype, const long long* strides, float scale, int dropout,
    uint32_t seed, uint32_t thresh, float keep_prob, void* stream) {
  return run(0, q, k, v, mask, dout, lse, delta, nullptr, dk, dv, B, H, Q, L, D, dtype,
             strides, scale, dropout, seed, thresh, keep_prob, stream);
}

int petr_flash_cross_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Q, int L, int D,
    int dtype, const long long* strides, float scale, int dropout, uint32_t seed,
    uint32_t thresh, float keep_prob, void* stream) {
  return run(1, q, k, v, mask, dout, lse, delta, dq, nullptr, nullptr, B, H, Q, L, D,
             dtype, strides, scale, dropout, seed, thresh, keep_prob, stream);
}

const char* petr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
