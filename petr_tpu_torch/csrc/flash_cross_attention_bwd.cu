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
// Two kernels split the work and neither needs atomics, which keeps dQ
// deterministic: one per (b*h, key tile) for dK and dV, one per (b*h, query
// tile) for dQ. Each comes in two variants, chosen by the caller by dtype:
// bf16 on the tensor cores (the train path's), fp32 on the CUDA cores (the
// fp32 checks', which hold a train step to 1e-3 and would lose that in bf16).
//
// What bounds it. At the flagship shape (B=1, H=8, Q=900, L=6000 with 5,100
// unmasked, D=32) the pairs need 10*D flops each (s, dp, dV, dQ, dK): 11.7
// GFLOP, 12 us on the bf16 tensor cores; one exp each per kernel, about 9
// us on the SFUs; and, with dropout, the hash (about 10 integer operations
// per pair per kernel). The bytes are a few MB. So once the products are on
// the tensor cores the per-pair work of the epilogue (exp, hash, scaling,
// rounding) sets the floor; on the CUDA cores (the fp32 kernels) the products
// are 7 G FMA, about 0.2 ms at the fp32 peak.
//
// The bf16 design (mma.sync.m16n8k16, bf16 in, fp32 sums; tensor_core.cuh):
//   * flash_bwd_dkdv_tc_kernel: one block of 8 warps per (b*h, 128 keys),
//     16 keys per warp, three blocks per SM. The warp holds its keys' k and
//     v as A fragments in registers and computes, 16 queries at a time,
//     S^T = K Q^T and dP^T = V dO^T, rows = keys, so
//     that P^T and dS^T come out in C-fragment layout; rounded to bf16 in
//     pairs they are the A fragments of dV += P^T_drop dO and dK += dS^T Q,
//     whose B operands (dO, Q) load with ldmatrix.trans. Q and dO (16-byte
//     pieces) and lse and delta (4-byte) arrive in tiles of 64 queries by
//     cp.async into a two-stage ring.
//   * flash_bwd_dq_tc_kernel: one block of 8 warps per (b*h, 32 queries): 2
//     query warps of 16 rows x 4 key quarters, so that the 29 query tiles of
//     Q = 900 still give 232 blocks of 8 warps for 132 SMs. A warp holds its
//     rows' q and dO as A fragments, computes S = Q K^T and dP = dO V^T over
//     its quarter of each 128-key tile (K and V by cp.async, two stages),
//     then dQ += dS K (K through ldmatrix.trans). A lane reads the mask
//     byte of its key one tile ahead, and a warp ballot gives the warp its
//     32 keys' flags. The four partial dQ of a row are summed through shared
//     memory in a fixed order.
//   * The dropout hash is evaluated per accumulator element from its global
//     coordinates: element e of C fragment n-tile j holds row g + 8 (e / 2)
//     and column 8 j + 2 t + e % 2 (g = lane / 4, t = lane % 4); in dK/dV the
//     row is a key and the column a query, and the hash takes (query, key).
//   * A warp whose keys (dK/dV: its 16; dQ: its 32 of a tile) are all
//     masked skips their products: their p is 0.
//   * Rounding P and dS to bf16 for their products is rounding the fp32
//     kernel does not do; the bf16 gradients keep the bound of the fp32 sums
//     rounded once (chip_smoke.py BWD_TOL).
//
// What holds it back now: the per-pair epilogue above, run by 4 to 6
// warps per scheduler with the exp and the hash in one dependent chain per
// element, and the two kernels each recompute S and dP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float BIG = 1e30f;  // lse of a padded row: p = 0

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ------------------------------------------------- fp32, CUDA cores: dK, dV
// One block per (b*h, 64 keys). Each key belongs to D/16 neighbouring
// threads that hold 16 of its dims of k, v, dk, dv in registers; the two dot
// products per pair are summed over those threads with warp shuffles. The
// block walks all queries in tiles of 64 rows of q and dO (plus lse and
// delta) staged in shared memory, which every thread reads by broadcast.
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

// ---------------------------------------------------- fp32, CUDA cores: dQ
// One block per (b*h, 32 queries): thread (row, split) holds its row's q, dO
// and dq, and takes 1/8 of each 128-key tile of k and v staged in shared
// memory; the 8 partial dq of a row are summed through shared memory.
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

// ------------------------------------------------ bf16, tensor cores
namespace tc {
constexpr int KV_WARPS = 8;          // dK/dV: warps per block
constexpr int KV_THREADS = 32 * KV_WARPS;
constexpr int KV_BLOCK = 16 * KV_WARPS;  // dK/dV: keys per block, 16 per warp
constexpr int QT = 64;               // dK/dV: queries per staged tile
constexpr int QSUB = 16;             // dK/dV: queries per step of a warp (fewer live registers)
constexpr int QB = 32;               // dQ: queries per block, 16 per query warp
constexpr int KSPLIT = 4;            // dQ: key quarters, one per warp of a query warp's row
constexpr int DQ_THREADS = 64 * KSPLIT;
constexpr int KT = 32 * KSPLIT;      // dQ: keys per staged tile, 32 per warp

// dQ's dynamic shared memory: two stages of K and V rows (D + 8 bf16 apart,
// so that ldmatrix rows fall in distinct banks); the partial dQ of the key
// quarters reuse it at the end
template <int D>
constexpr size_t dq_smem_bytes() {
  return 2 * 2 * KT * (D + 8) * 2;
}
}  // namespace tc

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t load_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(tc::KV_THREADS, D <= 32 ? 3 : 1)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int H, int Q, int L, Strides st, float scale,
                         uint32_t seed, uint32_t thresh, float keep_prob) {
  constexpr int RS = D + 8;  // smem row stride
  constexpr int KS = D / 16; // k16 steps over the head dim
  constexpr int NT = D / 8;  // n8 tiles over the head dim
  __shared__ __align__(16) bf16 qs[2][tc::QT][RS];
  __shared__ __align__(16) bf16 os[2][tc::QT][RS];
  __shared__ float lses[2][tc::QT];
  __shared__ float dels[2][tc::QT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int ka = blockIdx.x * tc::KV_BLOCK + warp * 16 + g;  // this thread's rows: keys ka, kb
  const int kb = ka + 8;
  const bool live_a = ka < L && (mask == nullptr || mask[(long long)b * L + ka] == 0);
  const bool live_b = kb < L && (mask == nullptr || mask[(long long)b * L + kb] == 0);
  const bool warp_live = __any_sync(0xffffffffu, live_a || live_b);
  const bf16* qg = q + b * st.q[0] + h * st.q[1];
  const bf16* og = dout + b * st.o[0] + h * st.o[1];
  const bf16* kg = k + b * st.k[0] + h * st.k[1];
  const bf16* vg = v + b * st.v[0] + h * st.v[1];

  // the warp's 16 keys of k and v as A fragments, for all of D
  uint32_t kf[KS][4], vf[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = (r & 1) ? kb : ka;
      const int col = s * 16 + (r >> 1) * 8 + 2 * t4;
      kf[s][r] = key < L ? load_pair(kg + key * st.k[2] + col) : 0u;
      vf[s][r] = key < L ? load_pair(vg + key * st.v[2] + col) : 0u;
    }

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const uint32_t mix = dropout_mix(seed, (uint32_t)bh);
  const float sl2 = scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;

  // query tile qt's rows of q and dO and its lse and delta by cp.async, into
  // stage s. Rows past Q arrive as zeros: their p is then exp2(0) = 1, but dO
  // and q are 0 there, so they add 0 to dV and dK.
  auto load_tile = [&](int qt, int s) {
    const int q0 = qt * tc::QT;
    for (int i = tid; i < 2 * tc::QT * (D / 8); i += tc::KV_THREADS) {
      const int which = i / (tc::QT * (D / 8)), rem = i % (tc::QT * (D / 8));
      const int r = rem / (D / 8), piece = rem % (D / 8);
      const int qi = q0 + r;
      const bool ok = qi < Q;
      const bf16* src = which ? og + (ok ? qi * st.o[2] : 0) : qg + (ok ? qi * st.q[2] : 0);
      cp_async16(which ? &os[s][r][piece * 8] : &qs[s][r][piece * 8], src + piece * 8, ok ? 16 : 0);
    }
    for (int i = tid; i < 2 * tc::QT; i += tc::KV_THREADS) {
      const int which = i / tc::QT, r = i % tc::QT, qi = q0 + r;
      const float* src = (which ? delta : lse) + (long long)bh * Q + (qi < Q ? qi : 0);
      cp_async4(which ? &dels[s][r] : &lses[s][r], src, qi < Q ? 4 : 0);
    }
  };

  const int nqt = (Q + tc::QT - 1) / tc::QT;
  load_tile(0, 0);
  cp_async_commit();
  for (int qt = 0; qt < nqt; ++qt) {
    const int s = qt & 1, q0 = qt * tc::QT;
    cp_async_wait<0>();
    __syncthreads();  // tile qt has landed; every warp is done with tile qt - 1
    if (qt + 1 < nqt) load_tile(qt + 1, s ^ 1);
    cp_async_commit();
    if (!warp_live) continue;  // its 16 keys are all masked: dK = dV = 0
#pragma unroll
    for (int sub = 0; sub < tc::QT / tc::QSUB; ++sub) {
      const int qb0 = sub * tc::QSUB;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x QSUB queries, in n8 tiles
      constexpr int NQ = tc::QSUB / 8;  // n8 tiles of queries
      float sacc[NQ][4], pacc[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = pacc[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          const int row = qb0 + np * 16 + (lane >> 4) * 8 + (lane & 7);
          const int col = ks * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bf[4];
          ldmatrix_x4(bf, &qs[s][row][col]);
          mma_bf16(sacc[2 * np], kf[ks], bf[0], bf[1]);
          mma_bf16(sacc[2 * np + 1], kf[ks], bf[2], bf[3]);
          ldmatrix_x4(bf, &os[s][row][col]);
          mma_bf16(pacc[2 * np], vf[ks], bf[0], bf[1]);
          mma_bf16(pacc[2 * np + 1], vf[ks], bf[2], bf[3]);
        }
      // element e of n-tile n: key (e < 2 ? ka : kb), query q0 + qb0 + 8 n + 2 t4 + e % 2
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qb0 + n * 8 + 2 * t4 + (e & 1);
          const float p = (e < 2 ? live_a : live_b)
                              ? exp2_ftz(fminf(sacc[n][e] * sl2 - lses[s][qc] * LOG2E, 0.f)) : 0.f;
          float dp = pacc[n][e], pd = p;
          if (DROPOUT) {
            const int qi = q0 + qc, key = e < 2 ? ka : kb;
            const bool keep = dropout_keep(mix, qi, key, thresh);
            pd = keep ? p * inv_keep : 0.f;
            dp = keep ? dp * inv_keep : 0.f;
          }
          sacc[n][e] = pd;                      // P^T after dropout
          pacc[n][e] = p * (dp - dels[s][qc]);  // dS^T
        }
      // dV += P^T dO and dK += dS^T Q over the QSUB queries, in k16 steps
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        const uint32_t ap[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                                pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                                pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                                pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
        const uint32_t ad[4] = {pack_bf16(pacc[2 * kk][0], pacc[2 * kk][1]),
                                pack_bf16(pacc[2 * kk][2], pacc[2 * kk][3]),
                                pack_bf16(pacc[2 * kk + 1][0], pacc[2 * kk + 1][1]),
                                pack_bf16(pacc[2 * kk + 1][2], pacc[2 * kk + 1][3])};
#pragma unroll
        for (int dn = 0; dn < NT / 2; ++dn) {
          const int row = qb0 + kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          const int col = dn * 16 + (lane >> 4) * 8;
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, &os[s][row][col]);
          mma_bf16(dva[2 * dn], ap, bf[0], bf[1]);
          mma_bf16(dva[2 * dn + 1], ap, bf[2], bf[3]);
          ldmatrix_x4_trans(bf, &qs[s][row][col]);
          mma_bf16(dka[2 * dn], ad, bf[0], bf[1]);
          mma_bf16(dka[2 * dn + 1], ad, bf[2], bf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + 2 * t4;
    if (ka < L) {
      *reinterpret_cast<uint32_t*>(dk + b * st.dk[0] + h * st.dk[1] + ka * st.dk[2] + d) =
          pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + b * st.dv[0] + h * st.dv[1] + ka * st.dv[2] + d) =
          pack_bf16(dva[n][0], dva[n][1]);
    }
    if (kb < L) {
      *reinterpret_cast<uint32_t*>(dk + b * st.dk[0] + h * st.dk[1] + kb * st.dk[2] + d) =
          pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + b * st.dv[0] + h * st.dv[1] + kb * st.dv[2] + d) =
          pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(tc::DQ_THREADS, D <= 32 ? 2 : 1)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Q,
                       int L, Strides st, float scale, uint32_t seed, uint32_t thresh,
                       float keep_prob) {
  constexpr int RS = D + 8;
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  constexpr int PS = D + 4;  // row stride of the partial dQ, in floats
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16(*ksm)[tc::KT][RS] = reinterpret_cast<bf16(*)[tc::KT][RS]>(smem_raw);
  bf16(*vsm)[tc::KT][RS] = reinterpret_cast<bf16(*)[tc::KT][RS]>(smem_raw + 2 * tc::KT * RS * sizeof(bf16));
  float* partial = reinterpret_cast<float*>(smem_raw);  // [KSPLIT - 1][QB][PS], at the end

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wq = warp & 1, wk = warp >> 1;  // query half, key quarter
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int qa = blockIdx.x * tc::QB + wq * 16 + g;  // this thread's rows: queries qa, qb
  const int qb = qa + 8;
  const bf16* qg = q + b * st.q[0] + h * st.q[1];
  const bf16* og = dout + b * st.o[0] + h * st.o[1];
  const bf16* kg = k + b * st.k[0] + h * st.k[1];
  const bf16* vg = v + b * st.v[0] + h * st.v[1];
  const uint8_t* mb = mask ? mask + (long long)b * L : nullptr;

  // the warp's 16 query rows of q and dO as A fragments
  uint32_t qf[KS][4], of[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r & 1) ? qb : qa;
      const int col = s * 16 + (r >> 1) * 8 + 2 * t4;
      qf[s][r] = row < Q ? load_pair(qg + row * st.q[2] + col) : 0u;
      of[s][r] = row < Q ? load_pair(og + row * st.o[2] + col) : 0u;
    }
  const float lse2_a = qa < Q ? lse[(long long)bh * Q + qa] * LOG2E : BIG;
  const float lse2_b = qb < Q ? lse[(long long)bh * Q + qb] * LOG2E : BIG;
  const float del_a = qa < Q ? delta[(long long)bh * Q + qa] : 0.f;
  const float del_b = qb < Q ? delta[(long long)bh * Q + qb] : 0.f;

  float dqa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  const uint32_t mix = dropout_mix(seed, (uint32_t)bh);
  const float sl2 = scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;

  // key tile kt's rows of k and v by cp.async, into stage s
  auto load_tile = [&](int kt, int s) {
    const int k0 = kt * tc::KT;
    for (int i = tid; i < 2 * tc::KT * (D / 8); i += tc::DQ_THREADS) {
      const int which = i / (tc::KT * (D / 8)), rem = i % (tc::KT * (D / 8));
      const int r = rem / (D / 8), piece = rem % (D / 8);
      const int key = k0 + r;
      const bool ok = key < L;
      const bf16* src = which ? vg + (ok ? key * st.v[2] : 0) : kg + (ok ? key * st.k[2] : 0);
      cp_async16(which ? &vsm[s][r][piece * 8] : &ksm[s][r][piece * 8], src + piece * 8, ok ? 16 : 0);
    }
  };

  const int nkt = (L + tc::KT - 1) / tc::KT;
  const int kb0 = wk * 32;  // this warp's keys of each tile
  // lane j's key of the warp's 32 in tile kt is masked or past L; read one
  // tile ahead, so that the load is in flight while a tile is multiplied
  auto key_dead = [&](int kt) {
    const int key = kt * tc::KT + kb0 + lane;
    return key >= L || (mb != nullptr && mb[key] != 0);
  };
  bool dead = key_dead(0);
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt & 1, k0 = kt * tc::KT;
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    if (kt + 1 < nkt) load_tile(kt + 1, s ^ 1);
    cp_async_commit();
    const unsigned dead_bits = __ballot_sync(0xffffffffu, dead);  // bit j: key k0 + kb0 + j
    if (kt + 1 < nkt) dead = key_dead(kt + 1);
    if (dead_bits == 0xffffffffu) continue;  // the warp's 32 keys are all masked
    // S = Q K^T and dP = dO V^T: 16 queries x 32 keys, four n8 tiles
    float sacc[4][4], pacc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = pacc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int row = kb0 + np * 16 + (lane >> 4) * 8 + (lane & 7);
        const int col = ks * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bf[4];
        ldmatrix_x4(bf, &ksm[s][row][col]);
        mma_bf16(sacc[2 * np], qf[ks], bf[0], bf[1]);
        mma_bf16(sacc[2 * np + 1], qf[ks], bf[2], bf[3]);
        ldmatrix_x4(bf, &vsm[s][row][col]);
        mma_bf16(pacc[2 * np], of[ks], bf[0], bf[1]);
        mma_bf16(pacc[2 * np + 1], of[ks], bf[2], bf[3]);
      }
    // element e of n-tile n: query (e < 2 ? qa : qb), key k0 + kb0 + 8 n + 2 t4 + e % 2
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = kb0 + n * 8 + 2 * t4 + (e & 1);
        const float lse2 = e < 2 ? lse2_a : lse2_b;
        const float p = (dead_bits >> (kc - kb0)) & 1u ? 0.f : exp2_ftz(fminf(sacc[n][e] * sl2 - lse2, 0.f));
        float dp = pacc[n][e];
        if (DROPOUT) {
          const int qrow = e < 2 ? qa : qb, key = k0 + kc;
          dp = dropout_keep(mix, qrow, key, thresh) ? dp * inv_keep : 0.f;
        }
        pacc[n][e] = p * (dp - (e < 2 ? del_a : del_b));  // dS
      }
    // dQ += dS K over the warp's 32 keys: two k16 steps
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t ad[4] = {pack_bf16(pacc[2 * kk][0], pacc[2 * kk][1]),
                              pack_bf16(pacc[2 * kk][2], pacc[2 * kk][3]),
                              pack_bf16(pacc[2 * kk + 1][0], pacc[2 * kk + 1][1]),
                              pack_bf16(pacc[2 * kk + 1][2], pacc[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < NT / 2; ++dn) {
        const int row = kb0 + kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int col = dn * 16 + (lane >> 4) * 8;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &ksm[s][row][col]);
        mma_bf16(dqa[2 * dn], ad, bf[0], bf[1]);
        mma_bf16(dqa[2 * dn + 1], ad, bf[2], bf[3]);
      }
    }
  }

  // the key quarters 1..3 hand their partial dQ to quarter 0, which sums
  // them in a fixed order and stores
  cp_async_wait<0>();
  __syncthreads();
  if (wk > 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        partial[((wk - 1) * tc::QB + wq * 16 + g + 8 * (e >> 1)) * PS + n * 8 + 2 * t4 + (e & 1)] = dqa[n][e];
  }
  __syncthreads();
  if (wk > 0) return;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int w = 0; w < tc::KSPLIT - 1; ++w)
        dqa[n][e] += partial[(w * tc::QB + wq * 16 + g + 8 * (e >> 1)) * PS + n * 8 + 2 * t4 + (e & 1)];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + 2 * t4;
    if (qa < Q)
      *reinterpret_cast<uint32_t*>(dq + b * st.dq[0] + h * st.dq[1] + qa * st.dq[2] + d) =
          pack_bf16(dqa[n][0] * scale, dqa[n][1] * scale);
    if (qb < Q)
      *reinterpret_cast<uint32_t*>(dq + b * st.dq[0] + h * st.dq[1] + qb * st.dq[2] + d) =
          pack_bf16(dqa[n][2] * scale, dqa[n][3] * scale);
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

template <int D, bool DROPOUT>
int launch_dkdv(const Args& a) {
  static_assert(D % DP == 0 && (KB * (D / DP)) % 32 == 0, "D must split evenly");
  const dim3 grid((a.L + KB - 1) / KB, a.B * a.H);
  flash_bwd_dkdv_kernel<float, D, DROPOUT><<<grid, KB * (D / DP), 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.Q, a.L, a.st, a.scale,
      a.dr.seed, a.dr.thresh, a.dr.keep_prob);
  return (int)cudaGetLastError();
}

template <int D, bool DROPOUT>
int launch_dq(const Args& a) {
  static_assert(D % NSPLIT == 0 && D % 4 == 0, "D must split evenly");
  constexpr size_t smem = dq_smem_floats<D>() * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<float, D, DROPOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Q + BQ - 1) / BQ, a.B * a.H);
  flash_bwd_dq_kernel<float, D, DROPOUT><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), a.H, a.Q, a.L, a.st, a.scale,
      a.dr.seed, a.dr.thresh, a.dr.keep_prob);
  return (int)cudaGetLastError();
}

template <int D, bool DROPOUT>
int launch_dkdv_tc(const Args& a) {
  const dim3 grid((a.L + tc::KV_BLOCK - 1) / tc::KV_BLOCK, a.B * a.H);
  flash_bwd_dkdv_tc_kernel<D, DROPOUT><<<grid, tc::KV_THREADS, 0, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.Q, a.L, a.st, a.scale,
      a.dr.seed, a.dr.thresh, a.dr.keep_prob);
  return (int)cudaGetLastError();
}

template <int D, bool DROPOUT>
int launch_dq_tc(const Args& a) {
  constexpr size_t smem = tc::dq_smem_bytes<D>();
  static_assert((tc::KSPLIT - 1) * tc::QB * (D + 4) * sizeof(float) <= smem, "partial dQ must fit");
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<D, DROPOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Q + tc::QB - 1) / tc::QB, a.B * a.H);
  flash_bwd_dq_tc_kernel<D, DROPOUT><<<grid, tc::DQ_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dq), a.H, a.Q, a.L, a.st, a.scale,
      a.dr.seed, a.dr.thresh, a.dr.keep_prob);
  return (int)cudaGetLastError();
}

// which = 0: dK/dV kernel, 1: dQ kernel; tc: the bf16 tensor-core variants
template <int D>
int dispatch_kernel(int which, bool tc_route, const Args& a) {
  const bool d = a.dr.on;
  if (tc_route) {
    if (which == 0) return d ? launch_dkdv_tc<D, true>(a) : launch_dkdv_tc<D, false>(a);
    return d ? launch_dq_tc<D, true>(a) : launch_dq_tc<D, false>(a);
  }
  if (which == 0) return d ? launch_dkdv<D, true>(a) : launch_dkdv<D, false>(a);
  return d ? launch_dq<D, true>(a) : launch_dq<D, false>(a);
}

// the bf16 kernels load rows in 16-byte pieces and store pairs: inputs
// 16-byte aligned with strides in multiples of 8 elements, outputs 4-byte
// aligned with even strides
bool tc_layout_ok(const Args& a) {
  const void* in[4] = {a.q, a.k, a.v, a.dout};
  const long long* in_st[4] = {a.st.q, a.st.k, a.st.v, a.st.o};
  for (int t = 0; t < 4; ++t) {
    if (reinterpret_cast<uintptr_t>(in[t]) & 15) return false;
    for (int i = 0; i < 3; ++i)
      if (in_st[t][i] % 8) return false;
  }
  const void* out[3] = {a.dq, a.dk, a.dv};
  const long long* out_st[3] = {a.st.dq, a.st.dk, a.st.dv};
  for (int t = 0; t < 3; ++t) {
    if (reinterpret_cast<uintptr_t>(out[t]) & 3) return false;
    for (int i = 0; i < 3; ++i)
      if (out_st[t][i] % 2) return false;
  }
  return true;
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool tc_route = dtype == 1;
  if (tc_route && !tc_layout_ok(a)) return (int)cudaErrorMisalignedAddress;
  switch (D) {
    case 16: return dispatch_kernel<16>(which, tc_route, a);
    case 32: return dispatch_kernel<32>(which, tc_route, a);
    case 64: return dispatch_kernel<64>(which, tc_route, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (the tensor-core
// kernels; inputs 16-byte aligned, strides multiples of 8), for q, k, v,
// dout and the gradients.
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
