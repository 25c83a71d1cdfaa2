// Flash cross-attention backward for Hopper (sm_90a), K2, with a plain C
// interface loaded through ctypes (petr_tpu_torch/ops/cross_attention.py).
//
// Replaces petr_tpu/ops/pallas/cross_attention.py::_bwd_kernel (:198), driven
// there by _flash_backward_impl and _flash_bwd_shared: the FlashAttention-2
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
// deterministic: one per (b*h, 64 keys) for dK and dV, one per (b*h, 64
// queries) for dQ. Each comes in two variants, chosen by the caller by dtype:
// bf16 on wgmma (the train path's), fp32 on the CUDA cores (the fp32 checks',
// which hold a train step to 1e-3 and would lose that in bf16).
//
// What bounds it. At the flagship shape (B=1, H=8, Q=900, L=6000 with 5,100
// unmasked, D=32) the pairs need 10*D flops each (s, dp, dV, dQ, dK): 11.7
// GFLOP, 12 us on the bf16 tensor cores; one exp each per kernel, 36.7 M,
// about 9 us on the SFUs per kernel; and, with dropout, the hash (about 10
// integer operations per pair per kernel). The bytes are a few MB. So the
// per-pair epilogue (exp, hash, scaling, rounding) sets the floor.
//
// The bf16 design (wgmma.mma_async, bf16 in, fp32 sums; hopper.cuh): both
// kernels are a producer warp and two consumer warpgroups. The block owns 64
// rows (keys for dK/dV, queries for dQ) whose tiles the producer brings once
// by TMA; it then streams the other side's tiles of 64 rows through a ring of
// 4 stages on mbarriers; consumer warpgroup w takes half w of every tile (32
// rows, m64n32 products, so that two blocks fit on an SM at D <= 32), and one
// warpgroup's exponentials and hashes overlap the other's products (S and dP
// are committed apart, so that the exponentials start while dP is on the
// tensor cores). Their partial sums are added at the end in a fixed order
// (warpgroup 0's first). Measured against one wait for a tile's last product
// and the next tile's first: slower, the held registers spill.
//   * flash_bwd_dkdv_wgmma_kernel: S^T = K Q^T and dP^T = V dO^T (m64n32,
//     both operands K-major in shared memory), keys as rows, so that P^T
//     after dropout and dS^T, rounded to bf16 in pairs, are the register A
//     fragments of dV += P^T dO and dK += dS^T Q, with dO and Q read as
//     MN-major B operands: no transposed copy. Q and dO arrive by TMA, lse
//     and delta by cp.async completing on the same mbarrier. A block whose
//     64 keys are all masked writes zeros and stops.
//   * flash_bwd_dq_wgmma_kernel: S = Q K^T, dP = dO V^T, dQ += dS K (K read
//     MN-major); key tiles whose keys are all masked are never loaded. Where
//     the row tiles alone do not fill the card the keys are split as K1's
//     (forward_splits), and flash_bwd_dq_merge_kernel adds the splits'
//     partial dQ in split order.
//   * The dropout hash is evaluated per accumulator element from its global
//     coordinates; in dK/dV the row is a key and the column a query, and the
//     hash takes (query, key).
//   * Rounding P and dS to bf16 for their products is rounding the fp32
//     kernel does not do; the bf16 gradients keep the bound of the fp32 sums
//     rounded once (chip_smoke.py BWD_TOL).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

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
  uint32_t bh_offset, key_offset;  // the shard's first global b*H + h and key
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
                      float scale, uint32_t seed, uint32_t thresh, float keep_prob,
                      uint32_t bh_offset, uint32_t key_offset) {
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
  const uint32_t mix = dropout_mix(seed, (uint32_t)bh + bh_offset, key_offset);

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
                    uint32_t seed, uint32_t thresh, float keep_prob,
                    uint32_t bh_offset, uint32_t key_offset) {
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
  const uint32_t mix = dropout_mix(seed, (uint32_t)bh + bh_offset, key_offset);

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

// ------------------------------------------------- bf16, wgmma (Hopper)
namespace k2 {
constexpr int BR = 64;                   // rows a block owns: keys (dK/dV) or queries (dQ)
constexpr int BT = 64;                   // rows of a streamed tile: queries (dK/dV) or keys (dQ)
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int MAX_TILES = 1024;          // dQ: key tiles of 64 (L <= 65,536)

// dK/dV's dynamic shared memory, from a 1024-byte aligned base
template <int D>
struct KvSmem {
  static constexpr int TILE = BT * D * 2;          // bf16 [D / 8][64][8]
  static constexpr int OWN = 0;                    // K, then V, of the block's keys
  static constexpr int STAGE = 2 * TILE + 2 * BT * 4;  // Q, dO, lse[64], delta[64]
  static constexpr int RING = OWN + 2 * TILE;
  static constexpr int MERGE = RING + STAGES * STAGE;  // the second warpgroup's dK, dV (fragment order)
  static constexpr int BARS = MERGE + 2 * BR * D * 4;  // full[STAGES], empty[STAGES], the block's K/V
  static constexpr int ALLOC = BARS + 8 * (2 * STAGES + 1) + 1024;
};

// dQ's
template <int D>
struct QSmem {
  static constexpr int TILE = BT * D * 2;
  static constexpr int OWN = 0;                    // Q, then dO, of the block's queries
  static constexpr int STAGE = 2 * TILE;           // K, V
  static constexpr int RING = OWN + 2 * TILE;
  static constexpr int MERGE = RING + STAGES * STAGE;  // the second warpgroup's dQ
  static constexpr int LIVE = MERGE + BR * D * 4;      // uint64 per key tile: bit j = key 64 t + j live
  static constexpr int LIST = LIVE + MAX_TILES * 8;    // int: the live tiles, in order
  static constexpr int BARS = LIST + MAX_TILES * 4;    // full[STAGES], empty[STAGES], Q/dO, then a count
  static constexpr int ALLOC = BARS + 8 * (2 * STAGES + 1) + 16 + 1024;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// the A fragments of the k16 steps of a 64 x 16 K accumulator, rounded to bf16
template <int K>
__device__ __forceinline__ void to_a_frags(const float (&x)[K / 2], uint32_t (&a)[K / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}
}  // namespace k2

// dK and dV of 64 keys of one (b, h). The producer warp brings the block's K
// and V once, then every query tile (64 rows of q and dO by TMA, their lse
// and delta by cp.async) through a ring of 4 stages; consumer warpgroup w
// takes half w of every tile (32 queries), and the two are summed at the
// end, warpgroup 0's first. S^T = K Q^T and dP^T = V dO^T come out with the keys as rows, so P^T
// (after dropout) and dS^T, rounded to bf16, are the register A operands of
// dV += P^T dO and dK += dS^T Q, whose B operands (dO, Q) are read MN-major.
// The halves (m64n32 products) keep both warpgroups busy however few the
// query tiles, and leave registers for two blocks on an SM (D <= 32).
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(k2::THREADS, D <= 32 ? 2 : 1)  // D = 64: one block's shared memory a SM
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                            const MapOrder qo, const MapOrder ko, const MapOrder vo, const MapOrder oo,
                            const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                            int Q, int L, Strides st, float scale, uint32_t seed, uint32_t thresh, float keep_prob,
                            uint32_t bh_offset, uint32_t key_offset) {
  using namespace k2;
  using S = KvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const bf16* ks = reinterpret_cast<const bf16*>(smem + S::OWN);
  const bf16* vs = ks + BR * D;
  float* merge = reinterpret_cast<float*>(smem + S::MERGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BR;
  const int r0 = 16 * (warp & 3) + (lane >> 2), r1 = r0 + 8;  // a consumer's rows: keys k0 + r0, k0 + r1
  const int ka = k0 + r0, kb = k0 + r1;
  const bool live_a = warp < CONSUMERS / 32 && ka < L && (mask == nullptr || mask[(long long)b * L + ka] == 0);
  const bool live_b = warp < CONSUMERS / 32 && kb < L && (mask == nullptr || mask[(long long)b * L + kb] == 0);
  bf16* dkb = dk + b * st.dk[0] + h * st.dk[1];
  bf16* dvb = dv + b * st.dv[0] + h * st.dv[1];
  if (!__syncthreads_or(live_a || live_b)) {  // the block's keys are all masked: dK = dV = 0
    if (warp < 4 && (lane & 3) == 0) {
      for (int d = 0; d < D; d += 2)
        for (int r = 0; r < 2; ++r) {
          const int key = r ? kb : ka;
          if (key < L) {
            *reinterpret_cast<uint32_t*>(dkb + key * st.dk[2] + d) = 0u;
            *reinterpret_cast<uint32_t*>(dvb + key * st.dv[2] + d) = 0u;
          }
        }
    }
    return;
  }
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1 + 32);  // the TMA's bytes and each producer lane's cp.async
      mbar_init(&empty[i], CONSUMERS / 32);  // lane 0 of each consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int nq = (Q + BT - 1) / BT;

  if (warp == CONSUMERS / 32) {  // the producer warp
    if (lane == 0) mbar_expect_tx(kvbar, 2 * S::TILE);
    __syncwarp();
    if (lane < D / 4) {
      const int which = lane / (D / 8), j = lane % (D / 8);
      tma_rows(smem + S::OWN + which * S::TILE + j * BR * 16, which ? &vmap : &kmap, which ? vo : ko, kvbar, j * 8,
               k0, h, b);
    }
    const float* lse_b = lse + (long long)bh * Q;
    const float* del_b = delta + (long long)bh * Q;
    for (int n = 0; n < nq; ++n) {
      const int stage = n % STAGES;
      uint8_t* base = smem + S::RING + stage * S::STAGE;
      mbar_wait(&empty[stage], ((n / STAGES) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(&full[stage], 2 * S::TILE);
      __syncwarp();
      if (lane < D / 4) {  // Q's column blocks, then dO's
        const int which = lane / (D / 8), j = lane % (D / 8);
        tma_rows(base + which * S::TILE + j * BT * 16, which ? &omap : &qmap, which ? oo : qo, &full[stage], j * 8,
                 n * BT, h, b);
      }
      // rows past Q arrive as zeros: their q and dO are zeros too, so they add 0 to dK and dV
      float* ld = reinterpret_cast<float*>(base + 2 * S::TILE);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = lane + 32 * r, qi = n * BT + i;
        cp_async4(ld + i, lse_b + (qi < Q ? qi : 0), qi < Q ? 4 : 0);
        cp_async4(ld + BT + i, del_b + (qi < Q ? qi : 0), qi < Q ? 4 : 0);
      }
      cp_async_mbar_arrive(&full[stage]);
    }
    return;
  }

  const int wg = warp >> 2, t = tid & 127, t4 = lane & 3;
  const uint32_t mix = dropout_mix(seed, (uint32_t)bh + bh_offset, key_offset);
  const float sl2 = scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kvbar, 0);

  for (int n = 0; n < nq; ++n) {
    const int stage = n % STAGES, q0 = n * BT;
    const uint8_t* base = smem + S::RING + stage * S::STAGE;
    const bf16* qt = reinterpret_cast<const bf16*>(base);
    const bf16* ot = qt + BT * D;
    const float* lses = reinterpret_cast<const float*>(base + 2 * S::TILE);
    const float* dels = lses + BT;
    mbar_wait(&full[stage], (n / STAGES) & 1);
    {
      const int h0 = wg * (BT / 2);  // the warpgroup's half of the tile: its first query
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 queries, committed apart so
      // that the exponentials start while dP^T is on the tensor cores
      float sacc[16], pacc[16];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        wgmma_ss(sacc, wgmma_desc(ks + kd * 2 * BR * 8, BR * 16, 128),
                 wgmma_desc(qt + kd * 2 * BT * 8 + h0 * 8, BT * 16, 128), kd > 0);
      wgmma_commit();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        wgmma_ss(pacc, wgmma_desc(vs + kd * 2 * BR * 8, BR * 16, 128),
                 wgmma_desc(ot + kd * 2 * BT * 8 + h0 * 8, BT * 16, 128), kd > 0);
      wgmma_commit();
      wgmma_wait<1>();
      wgmma_hold(sacc);
      // element 4j + e: key (e < 2 ? ka : kb), query q0 + h0 + 8j + 2 t4 + e % 2
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = h0 + 8 * j + 2 * t4 + (e & 1);
          sacc[4 * j + e] = (e < 2 ? live_a : live_b)
                                ? exp2_ftz(fminf(sacc[4 * j + e] * sl2 - lses[qc] * LOG2E, 0.f)) : 0.f;
        }
      wgmma_wait<0>();
      wgmma_hold(pacc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = h0 + 8 * j + 2 * t4 + (e & 1);
          const float p = sacc[4 * j + e];
          float dp = pacc[4 * j + e], pd = p;
          if (DROPOUT) {
            const int qi = q0 + qc, key = e < 2 ? ka : kb;
            const bool keep = dropout_keep(mix, qi, key, thresh);
            pd = keep ? p * inv_keep : 0.f;
            dp = keep ? dp * inv_keep : 0.f;
          }
          sacc[4 * j + e] = pd;                    // P^T after dropout
          pacc[4 * j + e] = p * (dp - dels[qc]);  // dS^T
        }
      uint32_t ap[2][4], ad[2][4];
      to_a_frags<32>(sacc, ap);
      to_a_frags<32>(pacc, ad);
      // dV += P^T dO and dK += dS^T Q, two k16 steps over the half's queries
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_rs(dva, ap[kk], wgmma_desc(ot + (h0 + kk * 16) * 8, 128, BT * 16));
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_rs(dka, ad[kk], wgmma_desc(qt + (h0 + kk * 16) * 8, 128, BT * 16));
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(dva);
      wgmma_hold(dka);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      merge[i * 128 + t] = dka[i];
      merge[(D / 2 + i) * 128 + t] = dva[i];
    }
  }
  named_sync(1, CONSUMERS);
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dka[i] += merge[i * 128 + t];
    dva[i] += merge[(D / 2 + i) * 128 + t];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = 8 * j + 2 * t4;
    if (ka < L) {
      *reinterpret_cast<uint32_t*>(dkb + ka * st.dk[2] + d) = pack_bf16(dka[4 * j] * scale, dka[4 * j + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + ka * st.dv[2] + d) = pack_bf16(dva[4 * j], dva[4 * j + 1]);
    }
    if (kb < L) {
      *reinterpret_cast<uint32_t*>(dkb + kb * st.dk[2] + d) =
          pack_bf16(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + kb * st.dv[2] + d) = pack_bf16(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

// dQ of 64 queries of one (b, h) over one split of the keys. The producer
// warp brings the block's Q and dO once, then the split's live key tiles (K
// and V by TMA; tiles whose keys are all masked are skipped) through a ring
// of 4 stages; consumer warpgroup w takes half w of every tile (32 keys), and
// the two are summed at the end, warpgroup 0's first. S = Q K^T and dP = dO V^T from shared memory; dS, rounded to bf16,
// is the register A operand of dQ += dS K, whose B operand (K) is read
// MN-major.
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(k2::THREADS, D <= 32 ? 2 : 1)  // D = 64: one block's shared memory a SM
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                          const MapOrder qo, const MapOrder ko, const MapOrder vo, const MapOrder oo,
                          const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq, float* __restrict__ ws, int H,
                          int Q, int L, int splits, Strides st, float scale, uint32_t seed, uint32_t thresh,
                          float keep_prob, uint32_t bh_offset, uint32_t key_offset) {
  using namespace k2;
  using S = QSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const bf16* qs = reinterpret_cast<const bf16*>(smem + S::OWN);
  const bf16* os = qs + BR * D;
  float* merge = reinterpret_cast<float*>(smem + S::MERGE);
  uint64_t* live = reinterpret_cast<uint64_t*>(smem + S::LIVE);
  int* list = reinterpret_cast<int*>(smem + S::LIST);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  int* count = reinterpret_cast<int*>(qbar + 1);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BR, split = blockIdx.z;
  const int tiles = (L + BT - 1) / BT;
  const int t_begin = (int)((long long)split * tiles / splits), t_end = (int)((long long)(split + 1) * tiles / splits);
  const uint8_t* mb = mask ? mask + (long long)b * L : nullptr;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  // the live keys of each tile of the split, then the live tiles in order
  for (int kt = t_begin + warp; kt < t_end; kt += k2::THREADS / 32) {
    const int key = kt * BT + lane;
    const bool lo = key < L && (mb == nullptr || mb[key] == 0);
    const bool hi = key + 32 < L && (mb == nullptr || mb[key + 32] == 0);
    const uint32_t blo = __ballot_sync(0xffffffffu, lo), bhi = __ballot_sync(0xffffffffu, hi);
    if (lane == 0) live[kt - t_begin] = blo | (uint64_t)bhi << 32;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < t_end - t_begin; base += 32) {
      const int i = base + lane;
      const bool on = i < t_end - t_begin && live[i] != 0;
      const uint32_t m = __ballot_sync(0xffffffffu, on);
      if (on) list[n + __popc(m & ((1u << lane) - 1))] = i;
      n += __popc(m);
    }
    if (lane == 0) count[0] = n;
  }
  __syncthreads();
  const int n_live = count[0];

  if (warp == CONSUMERS / 32) {  // the producer warp
    if (lane == 0) mbar_expect_tx(qbar, 2 * S::TILE);
    __syncwarp();
    if (lane < D / 4) {  // Q's column blocks, then dO's
      const int which = lane / (D / 8), j = lane % (D / 8);
      tma_rows(smem + S::OWN + which * S::TILE + j * BR * 16, which ? &omap : &qmap, which ? oo : qo, qbar, j * 8,
               q0, h, b);
    }
    for (int n = 0; n < n_live; ++n) {
      const int stage = n % STAGES, kt = t_begin + list[n];
      mbar_wait(&empty[stage], ((n / STAGES) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(&full[stage], S::STAGE);
      __syncwarp();
      if (lane < D / 4) {  // K's column blocks, then V's
        const int which = lane / (D / 8), j = lane % (D / 8);
        tma_rows(smem + S::RING + stage * S::STAGE + which * S::TILE + j * BT * 16, which ? &vmap : &kmap,
                 which ? vo : ko, &full[stage], j * 8, kt * BT, h, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, t = tid & 127, t4 = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2), r1 = r0 + 8;
  const int qa = q0 + r0, qb = q0 + r1;
  const float lse2_a = qa < Q ? lse[(long long)bh * Q + qa] * LOG2E : BIG;
  const float lse2_b = qb < Q ? lse[(long long)bh * Q + qb] * LOG2E : BIG;
  const float del_a = qa < Q ? delta[(long long)bh * Q + qa] : 0.f;
  const float del_b = qb < Q ? delta[(long long)bh * Q + qb] : 0.f;
  const uint32_t mix = dropout_mix(seed, (uint32_t)bh + bh_offset, key_offset);
  const float sl2 = scale * LOG2E;
  const float inv_keep = 1.f / keep_prob;
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int n = 0; n < n_live; ++n) {
    const int stage = n % STAGES, key0 = (t_begin + list[n]) * BT;
    const uint64_t bits = live[list[n]];
    const bf16* kt = reinterpret_cast<const bf16*>(smem + S::RING + stage * S::STAGE);
    const bf16* vt = kt + BT * D;
    mbar_wait(&full[stage], (n / STAGES) & 1);
    {
      const int h0 = wg * (BT / 2);  // the warpgroup's half of the tile: its first key
      // S = Q K^T and dP = dO V^T: 64 queries x 32 keys, committed apart so that
      // the exponentials start while dP is on the tensor cores
      float sacc[16], pacc[16];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        wgmma_ss(sacc, wgmma_desc(qs + kd * 2 * BR * 8, BR * 16, 128),
                 wgmma_desc(kt + kd * 2 * BT * 8 + h0 * 8, BT * 16, 128), kd > 0);
      wgmma_commit();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        wgmma_ss(pacc, wgmma_desc(os + kd * 2 * BR * 8, BR * 16, 128),
                 wgmma_desc(vt + kd * 2 * BT * 8 + h0 * 8, BT * 16, 128), kd > 0);
      wgmma_commit();
      wgmma_wait<1>();
      wgmma_hold(sacc);
      // the live keys' p (the half's keys all live, as in most tiles: no test)
      const uint32_t half_bits = (uint32_t)(bits >> h0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t4 + (e & 1);
          const float p = exp2_ftz(fminf(sacc[4 * j + e] * sl2 - (e < 2 ? lse2_a : lse2_b), 0.f));
          sacc[4 * j + e] = half_bits == ~0u || (half_bits >> c) & 1 ? p : 0.f;
        }
      wgmma_wait<0>();
      wgmma_hold(pacc);
      // element 4j + e: query (e < 2 ? qa : qb), key key0 + h0 + 8j + 2 t4 + e % 2
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = h0 + 8 * j + 2 * t4 + (e & 1);
          const float p = sacc[4 * j + e];
          float dp = pacc[4 * j + e];
          if (DROPOUT) {
            const int qrow = e < 2 ? qa : qb, key = key0 + c;
            dp = dropout_keep(mix, qrow, key, thresh) ? dp * inv_keep : 0.f;
          }
          pacc[4 * j + e] = p * (dp - (e < 2 ? del_a : del_b));  // dS
        }
      uint32_t ad[2][4];
      to_a_frags<32>(pacc, ad);
      // dQ += dS K, two k16 steps over the half's keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_rs(dqa, ad[kk], wgmma_desc(kt + (h0 + kk * 16) * 8, 128, BT * 16));
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(dqa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) merge[i * 128 + t] = dqa[i];
  }
  named_sync(1, CONSUMERS);
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] += merge[i * 128 + t];
  if (splits == 1) {
    bf16* dqb = dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      if (qa < Q)
        *reinterpret_cast<uint32_t*>(dqb + qa * st.dq[2] + d) = pack_bf16(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
      if (qb < Q)
        *reinterpret_cast<uint32_t*>(dqb + qb * st.dq[2] + d) =
            pack_bf16(dqa[4 * j + 2] * scale, dqa[4 * j + 3] * scale);
    }
  } else {  // the split's partial sums, added by flash_bwd_dq_merge_kernel
    float* wo = ws + ((long long)split * gridDim.y + bh) * Q * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      if (qa < Q) *reinterpret_cast<float2*>(wo + (long long)qa * D + d) = make_float2(dqa[4 * j], dqa[4 * j + 1]);
      if (qb < Q) *reinterpret_cast<float2*>(wo + (long long)qb * D + d) = make_float2(dqa[4 * j + 2], dqa[4 * j + 3]);
    }
  }
}

// The splits' partial dQ of each row added in split order, then scaled and
// rounded: one thread per (row, 8 columns).
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_merge_kernel(const float* __restrict__ ws, bf16* __restrict__ dq, int BH, int H, int Q, int splits,
                          Strides st, float scale) {
  constexpr int CH = D / 8;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long BHQ = (long long)BH * Q;
  if (i >= BHQ * CH) return;
  const int c = (int)(i % CH);
  const long long row = i / CH;
  float o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float4* src = reinterpret_cast<const float4*>(ws + (s * BHQ + row) * D + 8 * c);
    const float4 u = src[0], v = src[1];
    const float w[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] += w[j];
  }
  const int bh = (int)(row / Q), q = (int)(row % Q), b = bh / H, h = bh % H;
  bf16* orow = dq + b * st.dq[0] + h * st.dq[1] + (long long)q * st.dq[2] + 8 * c;
#pragma unroll
  for (int j = 0; j < 8; j += 2) *reinterpret_cast<uint32_t*>(orow + j) = pack_bf16(o[j] * scale, o[j + 1] * scale);
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
  int splits;  // the bf16 dQ kernel's key splits; above 1, ws holds their partial sums
  float* ws;
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
      a.dr.seed, a.dr.thresh, a.dr.keep_prob, a.dr.bh_offset, a.dr.key_offset);
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
      a.dr.seed, a.dr.thresh, a.dr.keep_prob, a.dr.bh_offset, a.dr.key_offset);
  return (int)cudaGetLastError();
}

template <int D, bool DROPOUT>
int launch_wgmma(int which, const Args& a) {
  CUtensorMap qm, km, vm, om;
  MapOrder qo, ko, vo, oo;
  int err = encode_rows(&qm, &qo, a.q, a.B, a.H, a.Q, D, a.st.q, 64);
  if (err == 0) err = encode_rows(&km, &ko, a.k, a.B, a.H, a.L, D, a.st.k, 64);
  if (err == 0) err = encode_rows(&vm, &vo, a.v, a.B, a.H, a.L, D, a.st.v, 64);
  if (err == 0) err = encode_rows(&om, &oo, a.dout, a.B, a.H, a.Q, D, a.st.o, 64);
  if (err != 0) return err;
  const auto* mask = static_cast<const uint8_t*>(a.mask);
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* delta = static_cast<const float*>(a.delta);
  if (which == 0) {
    static bool sized = false;  // the dynamic shared memory above 48 KB, once per instantiation
    if (!sized) {
      const cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D, DROPOUT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, k2::KvSmem<D>::ALLOC);
      if (e != cudaSuccess) return (int)e;
      sized = true;
    }
    const dim3 grid((a.L + k2::BR - 1) / k2::BR, a.B * a.H);
    flash_bwd_dkdv_wgmma_kernel<D, DROPOUT><<<grid, k2::THREADS, k2::KvSmem<D>::ALLOC, a.stream>>>(
        qm, km, vm, om, qo, ko, vo, oo, mask, lse, delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H,
        a.Q, a.L, a.st, a.scale, a.dr.seed, a.dr.thresh, a.dr.keep_prob, a.dr.bh_offset, a.dr.key_offset);
  } else {
    static bool sized = false;
    if (!sized) {
      const cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D, DROPOUT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, k2::QSmem<D>::ALLOC);
      if (e != cudaSuccess) return (int)e;
      sized = true;
    }
    const dim3 grid((a.Q + k2::BR - 1) / k2::BR, a.B * a.H, a.splits);
    flash_bwd_dq_wgmma_kernel<D, DROPOUT><<<grid, k2::THREADS, k2::QSmem<D>::ALLOC, a.stream>>>(
        qm, km, vm, om, qo, ko, vo, oo, mask, lse, delta, static_cast<bf16*>(a.dq), a.ws, a.H, a.Q, a.L, a.splits,
        a.st, a.scale, a.dr.seed, a.dr.thresh, a.dr.keep_prob, a.dr.bh_offset, a.dr.key_offset);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || a.splits == 1) return (int)e;
    const long long threads = (long long)a.B * a.H * a.Q * (D / 8);
    flash_bwd_dq_merge_kernel<D><<<(unsigned)((threads + 255) / 256), 256, 0, a.stream>>>(
        a.ws, static_cast<bf16*>(a.dq), a.B * a.H, a.H, a.Q, a.splits, a.st, a.scale);
  }
  return (int)cudaGetLastError();
}

// which = 0: dK/dV kernel, 1: dQ kernel; bf16_route: the wgmma variants
template <int D>
int dispatch_kernel(int which, bool bf16_route, const Args& a) {
  const bool d = a.dr.on;
  if (bf16_route) return d ? launch_wgmma<D, true>(which, a) : launch_wgmma<D, false>(which, a);
  if (which == 0) return d ? launch_dkdv<D, true>(a) : launch_dkdv<D, false>(a);
  return d ? launch_dq<D, true>(a) : launch_dq<D, false>(a);
}

// the bf16 kernels read their inputs by TMA (16-byte aligned, strides in
// multiples of 8 elements) and store pairs (4-byte aligned, even strides)
bool wgmma_layout_ok(const Args& a) {
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
        uint32_t thresh, float keep_prob, uint32_t bh_offset, uint32_t key_offset,
        int splits, void* ws, void* stream) {
  Args a{q, k, v, mask, dout, lse, delta, dq, dk, dv, B, H, Q, L, {}, scale,
         {dropout != 0, seed, thresh, keep_prob, bh_offset, key_offset},
         static_cast<cudaStream_t>(stream), splits, static_cast<float*>(ws)};
  long long* dst[7] = {a.st.q, a.st.k, a.st.v, a.st.o, a.st.dq, a.st.dk, a.st.dv};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool bf16_route = dtype == 1;
  if (bf16_route && !wgmma_layout_ok(a)) return (int)cudaErrorMisalignedAddress;
  if (bf16_route && which == 1 &&
      (splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr) ||
       ((L + k2::BT - 1) / k2::BT + splits - 1) / splits > k2::MAX_TILES))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return dispatch_kernel<16>(which, bf16_route, a);
    case 32: return dispatch_kernel<32>(which, bf16_route, a);
    case 64: return dispatch_kernel<64>(which, bf16_route, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core kernels), 1 = bfloat16 (the wgmma
// kernels; inputs 16-byte aligned, strides multiples of 8; L at most 65,536),
// for q, k, v, dout and the gradients.
// strides: 21 element strides, (batch, head, row) of q, k, v, dout, dq, dk
// and dv in turn; the last axis of each is contiguous. mask: (B, L) bytes or
// NULL. lse and delta: (B, H, Q) fp32, delta = rowsum(dO * O) - g_lse.
// dropout and its offsets as in petr_flash_cross_attention_fwd. splits (dQ,
// bf16): the key splits, each at most 1,024 tiles of 64 keys; above 1, ws
// holds splits x B x H x Q x D floats of workspace and a merge kernel
// follows. Each returns cudaGetLastError() after its launches, or 10000 + the
// CUresult where a tensor map is refused.
int petr_flash_cross_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Q,
    int L, int D, int dtype, const long long* strides, float scale, int dropout,
    uint32_t seed, uint32_t thresh, float keep_prob, uint32_t bh_offset, uint32_t key_offset,
    void* stream) {
  return run(0, q, k, v, mask, dout, lse, delta, nullptr, dk, dv, B, H, Q, L, D, dtype,
             strides, scale, dropout, seed, thresh, keep_prob, bh_offset, key_offset, 1, nullptr, stream);
}

int petr_flash_cross_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Q, int L, int D,
    int dtype, const long long* strides, float scale, int dropout, uint32_t seed,
    uint32_t thresh, float keep_prob, uint32_t bh_offset, uint32_t key_offset, int splits, void* ws,
    void* stream) {
  return run(1, q, k, v, mask, dout, lse, delta, dq, nullptr, nullptr, B, H, Q, L, D,
             dtype, strides, scale, dropout, seed, thresh, keep_prob, bh_offset, key_offset, splits, ws, stream);
}

const char* petr_cuda_error_string(int err) {
  if (err >= ENCODE_FAILED) return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
