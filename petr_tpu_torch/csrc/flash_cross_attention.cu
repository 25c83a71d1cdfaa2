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
// What bounds it. At the flagship shape (B=1, H=8, Q=900, L=6000 with 5,100
// unmasked, D=32) one call needs 4.7 GFLOP of products over the unmasked
// pairs (4.8 us at 989 TFLOP/s bf16), 36.7 M exponentials (about 9 us at 16
// per SM per clock on 132 SMs at 1.98 GHz) and about 7 MB of traffic (2 us
// at 3.35 TB/s): the exponentials bound it.
//
// Two kernels, chosen by the caller by dtype:
//
// * flash_fwd_tc_kernel, bf16, on the tensor cores (mma.sync.m16n8k16, bf16
//   in, fp32 sums; tensor_core.cuh): the model's kernel. A block of 8 warps
//   owns QW x 16 query rows of one (b, h) (QW = 2 or 4, the caller's choice
//   from the grid: 29 tiles of 32 rows x 8 heads = 232 blocks at the
//   flagship, two resident per SM, where 64-row tiles would give 120 blocks
//   for 132 SMs) and splits every staged K/V tile KS = 8 / QW ways across its
//   warps: warp (wq, wk) takes rows wq * 16 .. + 15 and keys wk * 64 .. + 63
//   of each tile of KS * 64 keys. The warp holds its rows of q as A
//   fragments, computes S = Q K^T with K through ldmatrix, and O += P V with
//   V through ldmatrix.trans; P goes from two n8 C tiles into one k16 A
//   fragment by pack_bf16 and never touches shared memory. K and V tiles
//   arrive by 16-byte cp.async into a two-stage ring; keys past L are
//   zero-filled and masked, so no padded copies are made.
//   Two passes over the keys. The first computes S alone and takes each
//   row's exact maximum (merged across the key splits through shared
//   memory); the second computes S again and accumulates p = exp2(s * scale
//   * log2e - max) without any rescaling. So every p is rounded to bf16 once,
//   against the row's final maximum: the rounding the plain version makes
//   with round_p=True, at the same point, which an online softmax (p against
//   a running maximum, rescaled later) would not give. The second pass's
//   partial sums (l, O) of the key splits are added in split order through
//   shared memory at the end: no atomics, the result is deterministic.
//   The scale is applied to the fp32 S (q is not pre-scaled in bf16), and
//   exp2 is one MUFU.EX2, so rounding P is the only rounding the fp32 kernel
//   does not make. The dropout hash is evaluated per C-fragment element from
//   its global (query, key). A lane reads the mask byte of its keys one tile
//   ahead, and a warp skips its 64 keys of a tile when all are masked.
// * flash_fwd_kernel, fp32, on the CUDA cores: for fp32 callers (the tests
//   and the fp32 train-step checks). One block per (b*h, 32 queries); the
//   block's threads split each 128-key tile 8 ways (thread t: row t % 32,
//   split t / 32), K and V staged in shared memory as fp32, an online softmax
//   in fp32 registers, the 8 partial states of a row merged at the end.
//
// K/V of one head (768 KB in bf16 at the flagship, 2.1 MB at the r50dcn
// decoder's L = 16,896) stay in the 50 MB L2 while the query tiles of that
// head, which run together (blockIdx.x is the query tile), read them again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
};

// ------------------------------------------------------- fp32, CUDA cores
namespace fp32 {
constexpr int BQ = 32;                 // query rows per block
constexpr int NSPLIT = 8;              // ways each key tile is split
constexpr int THREADS = BQ * NSPLIT;   // 256
constexpr int BK = 128;                // keys per staged tile
constexpr int KPT = BK / NSPLIT;       // keys per thread per tile

template <int D>
constexpr size_t smem_floats() {
  // K and V tiles plus the mask tile, reused at the end for the NSPLIT
  // partial states (m, l, acc[D]) of every row
  return (2 * BK * D + BK) > (NSPLIT * BQ * (D + 2)) ? (2 * BK * D + BK)
                                                     : (NSPLIT * BQ * (D + 2));
}
}  // namespace fp32

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(fp32::THREADS, D <= 32 ? 2 : 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ lse,
                 int H, int Q, int L, Strides st, float scale,
                 uint32_t seed, uint32_t thresh, float keep_prob) {
  using namespace fp32;
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

  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;
  const uint8_t* mb = mask ? mask + (long long)b * L : nullptr;
  const uint32_t mix = dropout_mix(seed, (uint32_t)bh);

  // logits are kept in log2 units: exp(x) == exp2(x * log2(e))
  const float qscale = scale * LOG2E;
  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? qb[qi * st.q_s + d] * qscale : 0.f;
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
        kv = kb[key * st.k_s + d];
        vv = vb[key * st.v_s + d];
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
  float* orow = out + b * st.o_b + h * st.o_h + qi * st.o_s;
  const int d0 = split * DPT;
  if (mmax <= NEG * 0.5f) {  // every key of this row is masked
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) orow[d0 + dd] = 0.f;
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
  for (int dd = 0; dd < DPT; ++dd) orow[d0 + dd] = o[dd] * inv;
  if (split == 0) lse[(long long)bh * Q + qi] = (mmax + log2f(lsum)) * LN2;
}

// ------------------------------------------------------ bf16, tensor cores
namespace tc {
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int KW = 64;  // keys per warp per staged tile

// dynamic shared memory: two stages of K and V tiles (rows D + 8 bf16 apart,
// so that ldmatrix rows fall in distinct banks); the key splits' partial
// sums reuse it at the end
template <int D, int QW>
constexpr size_t smem_bytes() {
  return 2 * 2 * (WARPS / QW) * KW * (D + 8) * sizeof(__nv_bfloat16);
}
}  // namespace tc

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t load_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D, int QW, bool DROPOUT>
__global__ void __launch_bounds__(tc::THREADS, D <= 32 ? 2 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                    bf16* __restrict__ out, float* __restrict__ lse,
                    int H, int Q, int L, Strides st, float scale,
                    uint32_t seed, uint32_t thresh, float keep_prob) {
  constexpr int KS = tc::WARPS / QW;  // key splits
  constexpr int KT = KS * tc::KW;     // keys per staged tile
  constexpr int RS = D + 8;           // shared-memory row stride
  constexpr int KD = D / 16;          // k16 steps over the head dim
  constexpr int NT = D / 8;           // n8 tiles over the head dim
  constexpr int BR = QW * 16;         // query rows per block
  constexpr int PS = D + 4;           // row stride of the partial sums, in floats
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16(*ksm)[KT][RS] = reinterpret_cast<bf16(*)[KT][RS]>(smem_raw);
  bf16(*vsm)[KT][RS] = reinterpret_cast<bf16(*)[KT][RS]>(smem_raw + 2 * KT * RS * sizeof(bf16));
  float* partial = reinterpret_cast<float*>(smem_raw);  // [KS - 1][BR][PS], at the end
  __shared__ float red[KS][BR];  // per key split: row maxima, then row sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wq = warp % QW, wk = warp / QW;  // query warp, key split
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int ra = wq * 16 + g, rb = ra + 8;   // this thread's rows in the block
  const int qa = blockIdx.x * BR + ra, qb = qa + 8;
  const bf16* qg = q + b * st.q_b + h * st.q_h;
  const bf16* kg = k + b * st.k_b + h * st.k_h;
  const bf16* vg = v + b * st.v_b + h * st.v_h;
  const uint8_t* mb = mask ? mask + (long long)b * L : nullptr;

  // the warp's 16 query rows of q as A fragments
  uint32_t qf[KD][4];
#pragma unroll
  for (int s = 0; s < KD; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r & 1) ? qb : qa;
      const int col = s * 16 + (r >> 1) * 8 + 2 * t4;
      qf[s][r] = row < Q ? load_pair(qg + row * st.q_s + col) : 0u;
    }

  const uint32_t mix = dropout_mix(seed, (uint32_t)bh);
  const float sl2 = scale * LOG2E;  // logits in log2 units: exp(x) == exp2(x log2 e)

  // key tile kt's rows of k (and of v) by cp.async, into stage s
  auto load_tile = [&](int kt, int s, bool with_v) {
    const int k0 = kt * KT;
    const int n = (with_v ? 2 : 1) * KT * (D / 8);
    for (int i = tid; i < n; i += tc::THREADS) {
      const int which = i / (KT * (D / 8)), rem = i % (KT * (D / 8));
      const int r = rem / (D / 8), piece = rem % (D / 8);
      const int key = k0 + r;
      const bool ok = key < L;
      const bf16* src = which ? vg + (ok ? key * st.v_s : 0) : kg + (ok ? key * st.k_s : 0);
      cp_async16(which ? &vsm[s][r][piece * 8] : &ksm[s][r][piece * 8], src + piece * 8, ok ? 16 : 0);
    }
  };

  const int nkt = (L + KT - 1) / KT;
  const int kb0 = wk * tc::KW;  // this warp's keys of each tile
  // lane j's keys kb0 + j and kb0 + 32 + j of tile kt are masked or past L
  auto key_dead = [&](int kt, int half) {
    const int key = kt * KT + kb0 + half * 32 + lane;
    return key >= L || (mb != nullptr && mb[key] != 0);
  };
  // S = Q K^T over the warp's 64 keys of stage s: eight n8 tiles; element e
  // of tile n is row (e < 2 ? qa : qb), key kb0 + 8 n + 2 t4 + e % 2
  auto scores = [&](int s, float (&sacc)[8][4]) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int row = kb0 + np * 16 + (lane >> 4) * 8 + (lane & 7);
        const int col = ks * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bfr[4];
        ldmatrix_x4(bfr, &ksm[s][row][col]);
        mma_bf16(sacc[2 * np], qf[ks], bfr[0], bfr[1]);
        mma_bf16(sacc[2 * np + 1], qf[ks], bfr[2], bfr[3]);
      }
  };

  // pass 1: each row's maximum of s * scale * log2e over its unmasked keys
  float ma = NEG, mbx = NEG;
  {
    bool d0 = key_dead(0, 0), d1 = key_dead(0, 1);
    if (nkt > 0) load_tile(0, 0, false);
    cp_async_commit();
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt & 1;
      cp_async_wait<0>();
      __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
      if (kt + 1 < nkt) load_tile(kt + 1, s ^ 1, false);
      cp_async_commit();
      const unsigned dead_lo = __ballot_sync(0xffffffffu, d0), dead_hi = __ballot_sync(0xffffffffu, d1);
      if (kt + 1 < nkt) d0 = key_dead(kt + 1, 0), d1 = key_dead(kt + 1, 1);
      if ((dead_lo & dead_hi) == 0xffffffffu) continue;  // the warp's 64 keys are all masked
      float sacc[8][4];
      scores(s, sacc);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (n & 3) * 8 + 2 * t4 + (e & 1);
          if (((n < 4 ? dead_lo : dead_hi) >> c) & 1u) continue;
          const float t = __fmul_rn(sacc[n][e], sl2);
          if (e < 2) ma = fmaxf(ma, t);
          else mbx = fmaxf(mbx, t);
        }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
    mbx = fmaxf(mbx, __shfl_xor_sync(0xffffffffu, mbx, off));
  }
  if (t4 == 0) {
    red[wk][ra] = ma;
    red[wk][rb] = mbx;
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int w = 0; w < KS; ++w) {
    ma = fmaxf(ma, red[w][ra]);
    mbx = fmaxf(mbx, red[w][rb]);
  }
  __syncthreads();  // red is written again below

  // pass 2: p = exp2(s * scale * log2e - max), l += p, O += keep(p) V
  float la = 0.f, lb = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  {
    bool d0 = key_dead(0, 0), d1 = key_dead(0, 1);
    if (nkt > 0) load_tile(0, 0, true);
    cp_async_commit();
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt & 1, k0 = kt * KT;
      cp_async_wait<0>();
      __syncthreads();
      if (kt + 1 < nkt) load_tile(kt + 1, s ^ 1, true);
      cp_async_commit();
      const unsigned dead_lo = __ballot_sync(0xffffffffu, d0), dead_hi = __ballot_sync(0xffffffffu, d1);
      if (kt + 1 < nkt) d0 = key_dead(kt + 1, 0), d1 = key_dead(kt + 1, 1);
      if ((dead_lo & dead_hi) == 0xffffffffu) continue;
      float sacc[8][4];
      scores(s, sacc);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (n & 3) * 8 + 2 * t4 + (e & 1);
          const bool dead = ((n < 4 ? dead_lo : dead_hi) >> c) & 1u;
          float p = dead ? 0.f : exp2_ftz(__fsub_rn(__fmul_rn(sacc[n][e], sl2), e < 2 ? ma : mbx));
          if (e < 2) la += p;  // the denominator is taken before dropout
          else lb += p;
          if (DROPOUT) {
            const int qrow = e < 2 ? qa : qb, key = k0 + kb0 + n * 8 + 2 * t4 + (e & 1);
            p = dropout_keep(mix, qrow, key, thresh) ? p : 0.f;
          }
          sacc[n][e] = p;
        }
      // O += P V over the warp's 64 keys: four k16 steps
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t ap[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                                pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                                pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                                pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
        for (int dn = 0; dn < NT / 2; ++dn) {
          const int row = kb0 + kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          const int col = dn * 16 + (lane >> 4) * 8;
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, &vsm[s][row][col]);
          mma_bf16(acc[2 * dn], ap, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dn + 1], ap, bfr[2], bfr[3]);
        }
      }
    }
  }

  // the row sums of the quad, then of the key splits, and the key splits'
  // partial O, added in split order by split 0
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, off);
    lb += __shfl_xor_sync(0xffffffffu, lb, off);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  if (t4 == 0) {
    red[wk][ra] = la;
    red[wk][rb] = lb;
  }
  if (wk > 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        partial[((wk - 1) * BR + (e < 2 ? ra : rb)) * PS + n * 8 + 2 * t4 + (e & 1)] = acc[n][e];
  }
  __syncthreads();
  if (wk > 0) return;
  la = red[0][ra];
  lb = red[0][rb];
#pragma unroll
  for (int w = 1; w < KS; ++w) {
    la += red[w][ra];
    lb += red[w][rb];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] += partial[((w - 1) * BR + (e < 2 ? ra : rb)) * PS + n * 8 + 2 * t4 + (e & 1)];
  }
  // a fully masked row has acc = 0 and gives 0
  const float inv_a = 1.f / (keep_prob * fmaxf(la, 1e-20f));
  const float inv_b = 1.f / (keep_prob * fmaxf(lb, 1e-20f));
  bf16* ob = out + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + 2 * t4;
    if (qa < Q)
      *reinterpret_cast<uint32_t*>(ob + qa * st.o_s + d) = pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
    if (qb < Q)
      *reinterpret_cast<uint32_t*>(ob + qb * st.o_s + d) = pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
  }
  if (t4 == 0) {
    if (qa < Q) lse[(long long)bh * Q + qa] = ma <= NEG * 0.5f ? -NEG : (ma + log2f(la)) * LN2;
    if (qb < Q) lse[(long long)bh * Q + qb] = mbx <= NEG * 0.5f ? -NEG : (mbx + log2f(lb)) * LN2;
  }
}

// ------------------------------------------------------------- launches
struct Dropout {
  bool on;
  uint32_t seed, thresh;
  float keep_prob;
};

struct Args {
  const void *q, *k, *v, *mask;
  void *out, *lse;
  int B, H, Q, L;
  Strides st;
  float scale;
  Dropout dr;
  cudaStream_t stream;
};

template <int D, bool DROPOUT>
int launch_fp32(const Args& a) {
  static_assert(D % fp32::NSPLIT == 0 && D % 4 == 0, "D must split evenly");
  constexpr size_t smem = fp32::smem_floats<D>() * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, DROPOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Q + fp32::BQ - 1) / fp32::BQ, a.B * a.H);
  flash_fwd_kernel<D, DROPOUT><<<grid, fp32::THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<float*>(a.out), static_cast<float*>(a.lse),
      a.H, a.Q, a.L, a.st, a.scale, a.dr.seed, a.dr.thresh, a.dr.keep_prob);
  return (int)cudaGetLastError();
}

template <int D, int QW, bool DROPOUT>
int launch_tc(const Args& a) {
  constexpr size_t smem = tc::smem_bytes<D, QW>();
  static_assert((tc::WARPS / QW - 1) * QW * 16 * (D + 4) * sizeof(float) <= smem, "partial sums must fit");
  // always: with the static shared memory, 48 KB of dynamic (D = 16) is past the default limit
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D, QW, DROPOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Q + QW * 16 - 1) / (QW * 16), a.B * a.H);
  flash_fwd_tc_kernel<D, QW, DROPOUT><<<grid, tc::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<bf16*>(a.out), static_cast<float*>(a.lse),
      a.H, a.Q, a.L, a.st, a.scale, a.dr.seed, a.dr.thresh, a.dr.keep_prob);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(bool tc_route, int query_warps, const Args& a) {
  const bool d = a.dr.on;
  if (!tc_route) return d ? launch_fp32<D, true>(a) : launch_fp32<D, false>(a);
  if (query_warps == 2) return d ? launch_tc<D, 2, true>(a) : launch_tc<D, 2, false>(a);
  if (query_warps == 4) return d ? launch_tc<D, 4, true>(a) : launch_tc<D, 4, false>(a);
  return (int)cudaErrorInvalidValue;
}

// the bf16 kernel loads k and v rows in 16-byte pieces and q and out in
// pairs: k and v 16-byte aligned with strides in multiples of 8 elements,
// q and out 4-byte aligned with even strides
bool tc_layout_ok(const Args& a) {
  const long long kv[6] = {a.st.k_b, a.st.k_h, a.st.k_s, a.st.v_b, a.st.v_h, a.st.v_s};
  const long long qo[6] = {a.st.q_b, a.st.q_h, a.st.q_s, a.st.o_b, a.st.o_h, a.st.o_s};
  if ((reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v)) & 15) return false;
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.out)) & 3) return false;
  for (int i = 0; i < 6; ++i)
    if (kv[i] % 8 || qo[i] % 2) return false;
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel; k and v 16-byte aligned with strides in multiples of 8, q and out
// with even strides), for q, k, v and out. strides: 12 element strides, for
// q, k, v and out in turn, each (batch, head, row); the last axis is
// contiguous. mask: (B, L) bytes or NULL. dropout: 0 = off; else seed (the
// int32 seed's bits), thresh and keep_prob = 1 - rate drop the probabilities
// as dropout_hash.cuh says. query_warps: the bf16 kernel's query rows per
// block over 16 (2 or 4; its key splits are 8 / query_warps). Returns
// cudaGetLastError() after the launch.
int petr_flash_cross_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse,
                                   int B, int H, int Q, int L, int D, int dtype,
                                   const long long* strides, float scale,
                                   int dropout, uint32_t seed, uint32_t thresh,
                                   float keep_prob, int query_warps, void* stream) {
  Args a{q, k, v, mask, out, lse, B, H, Q, L, {}, scale,
         {dropout != 0, seed, thresh, keep_prob}, static_cast<cudaStream_t>(stream)};
  a.st.q_b = strides[0]; a.st.q_h = strides[1]; a.st.q_s = strides[2];
  a.st.k_b = strides[3]; a.st.k_h = strides[4]; a.st.k_s = strides[5];
  a.st.v_b = strides[6]; a.st.v_h = strides[7]; a.st.v_s = strides[8];
  a.st.o_b = strides[9]; a.st.o_h = strides[10]; a.st.o_s = strides[11];
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool tc_route = dtype == 1;
  if (tc_route && !tc_layout_ok(a)) return (int)cudaErrorMisalignedAddress;
  switch (D) {
    case 16: return dispatch<16>(tc_route, query_warps, a);
    case 32: return dispatch<32>(tc_route, query_warps, a);
    case 64: return dispatch<64>(tc_route, query_warps, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* petr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
