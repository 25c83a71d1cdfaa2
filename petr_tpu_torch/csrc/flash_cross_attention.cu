// Flash cross-attention forward for Hopper (sm_90a), K1, with a plain C
// interface loaded through ctypes (petr_tpu_torch/ops/cross_attention.py).
//
// Replaces petr_tpu/ops/pallas/cross_attention.py::_kernel (:62), driven there
// by _flash_forward: masked multi-head attention of q (B,H,Q,D) over k, v
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
// at 3.35 TB/s): the exponentials bound it, and with them the per-pair chain
// of scale, mask, maximum, exponent and rounding that feeds the tensor cores.
//
// Two kernels, chosen by the caller by dtype:
//
// * flash_fwd_wgmma_kernel, bf16: the model's kernel. One pass over the keys
//   with an online softmax on wgmma.mma_async (bf16 in, fp32 sums). A block
//   holds 64 query rows of one (b, h) and one split of the keys; a producer
//   warp brings Q once and the split's live key tiles (64 keys of K and of V)
//   by TMA into a ring of 4 stages on mbarriers, skipping tiles whose keys
//   are all masked; two consumer warpgroups take alternate tiles, so one
//   warpgroup's exponentials and hashes run while the other's products do.
//   S = Q K^T is one m64n64 product per k16 step from shared memory (both
//   K-major); O += P V takes P from registers (the S accumulator rounded to
//   bf16 in pairs is the A fragment) and V from shared memory as an MN-major
//   operand, so P never touches shared memory and no copy of V is
//   transposed. The tiles land in the no-swizzle core-matrix layout, D / 8
//   boxes of 8 columns a tile (hopper.cuh), from strided (B, H, ., D) views.
//   Rounding: every p is rounded to bf16 for its product with v. A one-pass
//   kernel cannot round p against the row's final maximum, so p is taken
//   against a reference the order of the keys cannot move: y = s * scale *
//   log2 e - t_ref, t_ref the logit of the row's first unmasked key, and p =
//   2^(y - rint y) * 2^(rint y - K), K the running maximum of rint y. The
//   fraction's exponential is one MUFU.EX2 of an exact argument, the integer
//   part is added to its exponent field, and every rescale of the running
//   sums is an exact power of two built from exponent bits. So each rounded
//   p, rescaled, is bf16(2^(y - rint y)) 2^(rint y - K_final) whatever the
//   tiling, the splits or the order: the plain version's floor
//   (flash_cross_attention_reference with round_p=True) computes the same
//   values, and the kernel differs from it only in the order of its fp32
//   sums. The scale is applied to the fp32 S (q is not pre-scaled in bf16).
//   The dropout hash is evaluated per accumulator element from its global
//   (query, key).
//   Filling the card: at the flagship 15 row tiles x 8 heads are 120 blocks
//   for 132 SMs; the caller splits the keys (forward_splits in
//   ops/cross_attention.py: 2 at the flagship, 240 blocks, two resident per
//   SM), each split writes its rows' partial (K, l, O) to a workspace, and
//   flash_fwd_merge_kernel adds the partials in split order. No float
//   atomics anywhere: the result is deterministic.
// * flash_fwd_kernel, fp32, on the CUDA cores: for fp32 callers (the tests
//   and the fp32 train-step checks). One block per (b*h, 32 queries); the
//   block's threads split each 128-key tile 8 ways (thread t: row t % 32,
//   split t / 32), K and V staged in shared memory as fp32, an online softmax
//   in fp32 registers, the 8 partial states of a row merged at the end.
//
// K/V of one head (768 KB in bf16 at the flagship, 2.1 MB at the r50dcn
// decoder's L = 16,896) stay in the 50 MB L2 while the blocks of that head,
// which run together (blockIdx.x is the query tile), read them again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
};

using bf16 = __nv_bfloat16;

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
                 uint32_t seed, uint32_t thresh, float keep_prob,
                 uint32_t bh_offset, uint32_t key_offset) {
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
  const uint32_t mix = dropout_mix(seed, (uint32_t)bh + bh_offset, key_offset);

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

// ------------------------------------------------- bf16, wgmma (Hopper)
namespace k1 {
constexpr int BM = 64;                   // query rows per block, shared by both consumer warpgroups
constexpr int BN = 64;                   // keys per tile
constexpr int STAGES = 4;                // the ring of K/V tiles
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int MAX_TILES = 512;           // key tiles of one block's range (the plan splits longer ones)
constexpr int NONE = -(1 << 30);         // the integer maximum of a row that has seen no key
constexpr float MAGIC = 12582912.0f;     // 1.5 * 2^23: y + MAGIC holds rint(y) in its low bits

// the dynamic shared memory, from a 1024-byte aligned base
template <int D>
struct Smem {
  static constexpr int Q = 0;                          // bf16 [D / 8][BM][8]
  static constexpr int TILE = BN * D * 2;              // K or V: bf16 [D / 8][BN][8]
  static constexpr int RING = Q + BM * D * 2;          // STAGES x (K, V)
  static constexpr int MERGE = RING + STAGES * 2 * TILE;  // the second warpgroup's O (fragment order), l, K
  static constexpr int LIVE = MERGE + BM * D * 4 + BM * 8;  // uint64 per key tile: bit j = key 64 t + j live
  static constexpr int LIST = LIVE + MAX_TILES * 8;    // int: the live tiles, in order
  static constexpr int BARS = LIST + MAX_TILES * 4;    // full[STAGES], empty[STAGES], q, then ints
  static constexpr int BYTES = BARS + 8 * (2 * STAGES + 1) + 16;
  static constexpr int ALLOC = BYTES + 1024;
};

// 2^e for an integer e <= 0; 0 below 2^-126
__device__ __forceinline__ float pow2i(int e) { return e < -126 ? 0.f : __int_as_float((127 + e) << 23); }
}  // namespace k1

// One block: 64 query rows of one (b, h) over one split of the keys. The
// producer warp streams the split's live key tiles (K and V by TMA) through a
// ring of 4 stages on mbarriers; the two consumer warpgroups take alternate
// tiles (stage n to warpgroup n % 2), each keeping its own online softmax
// over the block's 64 rows, and are merged at the end, warpgroup 0's first.
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(k1::THREADS, 2)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const MapOrder qo, const MapOrder ko,
                       const MapOrder vo, const bf16* __restrict__ k, const uint8_t* __restrict__ mask,
                       bf16* __restrict__ out, float* __restrict__ lse, float* __restrict__ ws, int H, int Q, int L,
                       int splits, Strides st, float scale, uint32_t seed, uint32_t thresh, float keep_prob,
                       uint32_t bh_offset, uint32_t key_offset) {
  using namespace k1;
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qs = reinterpret_cast<bf16*>(smem + S::Q);
  float* merge_o = reinterpret_cast<float*>(smem + S::MERGE);
  float* merge_l = merge_o + BM * D;
  int* merge_k = reinterpret_cast<int*>(merge_l + BM);
  uint64_t* live = reinterpret_cast<uint64_t*>(smem + S::LIVE);
  int* list = reinterpret_cast<int*>(smem + S::LIST);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  int* counts = reinterpret_cast<int*>(qbar + 1);  // [0] live tiles, [1] the row's first unmasked key

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM, split = blockIdx.z;
  const int tiles = (L + BN - 1) / BN;
  const int t_begin = (int)((long long)split * tiles / splits), t_end = (int)((long long)(split + 1) * tiles / splits);
  const uint8_t* mb = mask ? mask + (long long)b * L : nullptr;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // lane 0 of each warp of the consuming warpgroup
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
    counts[1] = mb ? L : 0;
  }
  // the row's first unmasked key, j0: p is taken against its logit
  for (int base = 0;; base += THREADS) {
    __syncthreads();
    const int found = counts[1];
    __syncthreads();  // read by every thread before the atomics below
    if (found < L || base >= L) break;
    const int key = base + tid;
    if (key < L && mb[key] == 0) atomicMin(&counts[1], key);
  }
  // the live keys of each tile of the split, then the live tiles in order
  for (int t = t_begin + warp; t < t_end; t += THREADS / 32) {
    const int key = t * BN + lane;
    const bool lo = key < L && (mb == nullptr || mb[key] == 0);
    const bool hi = key + 32 < L && (mb == nullptr || mb[key + 32] == 0);
    const uint32_t blo = __ballot_sync(0xffffffffu, lo), bhi = __ballot_sync(0xffffffffu, hi);
    if (lane == 0) live[t - t_begin] = blo | (uint64_t)bhi << 32;
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
    if (lane == 0) counts[0] = n;
  }
  __syncthreads();
  const int n_live = counts[0], j0 = counts[1];

  if (warp == CONSUMERS / 32) {  // the producer warp
    if (lane == 0) mbar_expect_tx(qbar, BM * D * 2);
    __syncwarp();
    if (lane < D / 8) tma_rows(qs + lane * BM * 8, &qmap, qo, qbar, lane * 8, q0, h, b);
    for (int n = 0; n < n_live; ++n) {
      const int stage = n % STAGES, t = t_begin + list[n];
      mbar_wait(&empty[stage], ((n / STAGES) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(&full[stage], 2 * S::TILE);
      __syncwarp();
      if (lane < D / 4) {  // lanes 0 .. D/8 - 1: K's column blocks, then V's
        const int which = lane / (D / 8), j = lane % (D / 8);
        uint8_t* dst = smem + S::RING + (stage * 2 + which) * S::TILE + j * BN * 16;
        tma_rows(dst, which ? &vmap : &kmap, which ? vo : ko, &full[stage], j * 8, t * BN, h, b);
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes stages wg, wg + 2, ..; this thread holds
  // rows r0 = 16 (warp % 4) + lane / 4 and r1 = r0 + 8 of the block's 64, and of
  // each tile's keys the columns 8j + 2 (lane % 4) + {0, 1}, j = 0..7
  const int wg = warp >> 2, t = tid & 127, t4 = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2), r1 = r0 + 8;
  const int qa = q0 + r0, qb = q0 + r1;
  const uint32_t mix = dropout_mix(seed, (uint32_t)bh + bh_offset, key_offset);
  const float sl2 = scale * LOG2E;  // logits in log2 units: exp(x) == exp2(x log2 e)
  mbar_wait(qbar, 0);

  // t_ref, the logit of key j0, for both rows (0 for a row with no unmasked key)
  float tr0 = 0.f, tr1 = 0.f;
  if (j0 < L) {
    const bf16* kr = k + b * st.k_b + h * st.k_h + (long long)j0 * st.k_s;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float kd = __bfloat162float(kr[d]);
      s0 = __fmaf_rn(__bfloat162float(qs[(d >> 3) * BM * 8 + r0 * 8 + (d & 7)]), kd, s0);
      s1 = __fmaf_rn(__bfloat162float(qs[(d >> 3) * BM * 8 + r1 * 8 + (d & 7)]), kd, s1);
    }
    tr0 = __fmul_rn(s0, sl2);
    tr1 = __fmul_rn(s1, sl2);
  }

  int kr0 = NONE, kr1 = NONE;  // the rows' running maxima, integers
  float l0 = 0.f, l1 = 0.f;    // this thread's share of the rows' sums against 2^kr
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int n = wg; n < n_live; n += 2) {
    const int stage = n % STAGES, key0 = (t_begin + list[n]) * BN;
    mbar_wait(&full[stage], (n / STAGES) & 1);
    const uint64_t bits = live[list[n]];
    const bf16* kt = reinterpret_cast<const bf16*>(smem + S::RING + stage * 2 * S::TILE);
    const bf16* vt = kt + BN * D;
    // S = Q K^T: 64 x 64, fp32
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(s, wgmma_desc(qs + ks * 2 * BM * 8, BM * 16, 128), wgmma_desc(kt + ks * 2 * BN * 8, BN * 16, 128),
               ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(s);
    // y = s * scale * log2 e - t_ref on the live keys, the rows' maxima (most
    // tiles have every key live: they skip the test, the same for the warp)
    float m0 = -INFINITY, m1 = -INFINITY;
    if (bits == ~0ull) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = __fsub_rn(__fmul_rn(s[4 * j + e], sl2), e < 2 ? tr0 : tr1);
          s[4 * j + e] = y;
          if (e < 2) m0 = fmaxf(m0, y);
          else m1 = fmaxf(m1, y);
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t4 + (e & 1);
          const float y = (bits >> c) & 1 ? __fsub_rn(__fmul_rn(s[4 * j + e], sl2), e < 2 ? tr0 : tr1) : -INFINITY;
          s[4 * j + e] = y;
          if (e < 2) m0 = fmaxf(m0, y);
          else m1 = fmaxf(m1, y);
        }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    // the running maxima stay integers, so a rescale is an exact power of two
    {
      const int n0 = max(kr0, m0 == -INFINITY ? NONE : __float2int_rn(m0));
      const int n1 = max(kr1, m1 == -INFINITY ? NONE : __float2int_rn(m1));
      const float a0 = pow2i(kr0 - n0), a1 = pow2i(kr1 - n1);
      kr0 = n0;
      kr1 = n1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
    }
    // p = 2^(y - rint y) 2^(rint y - kr): the exponential of the fraction, its
    // exponent field raised by the integer part (exact while p is normal)
    const float c0 = (float)(kr0 - 125), c1 = (float)(kr1 - 125);
    const uint32_t ksh0 = (uint32_t)kr0 << 23, ksh1 = (uint32_t)kr1 << 23;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = s[4 * j + e];
        const float rp = __fadd_rn(y, MAGIC);
        const float x = __fsub_rn(y, __fsub_rn(rp, MAGIC));
        const uint32_t pb = __float_as_uint(exp2_ftz(x)) + (__float_as_uint(rp) << 23) - (e < 2 ? ksh0 : ksh1);
        float p = y > (e < 2 ? c0 : c1) ? __uint_as_float(pb) : 0.f;
        if (e < 2) l0 += p;  // the denominator is taken before dropout
        else l1 += p;
        if (DROPOUT) {
          const int qrow = e < 2 ? qa : qb, key = key0 + 8 * j + 2 * t4 + (e & 1);
          p = dropout_keep(mix, qrow, key, thresh) ? p : 0.f;
        }
        s[4 * j + e] = p;
      }
    // O += P V: P from registers, four k16 steps over the tile's keys
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, a[kk], wgmma_desc(vt + kk * 16 * 8, 128, BN * 16));
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // warpgroup 1 hands its partial to warpgroup 0, which adds it second
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) merge_o[i * 128 + t] = o[i];
    if (t4 == 0) {
      merge_l[r0] = l0;
      merge_l[r1] = l1;
      merge_k[r0] = kr0;
      merge_k[r1] = kr1;
    }
  }
  named_sync(1, CONSUMERS);
  if (wg == 1) return;
  {
    const int n0 = max(kr0, merge_k[r0]), n1 = max(kr1, merge_k[r1]);
    const float a00 = pow2i(kr0 - n0), a01 = pow2i(merge_k[r0] - n0);
    const float a10 = pow2i(kr1 - n1), a11 = pow2i(merge_k[r1] - n1);
    l0 = __fadd_rn(__fmul_rn(l0, a00), __fmul_rn(merge_l[r0], a01));
    l1 = __fadd_rn(__fmul_rn(l1, a10), __fmul_rn(merge_l[r1], a11));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const bool row1 = i & 2;
      o[i] = __fadd_rn(__fmul_rn(o[i], row1 ? a10 : a00), __fmul_rn(merge_o[i * 128 + t], row1 ? a11 : a01));
    }
    kr0 = n0;
    kr1 = n1;
  }
  if (splits == 1) {  // the rows' outputs and lse; a row with no unmasked key gives 0 and +1e30
    const float inv0 = 1.f / (keep_prob * fmaxf(l0, 1e-20f)), inv1 = 1.f / (keep_prob * fmaxf(l1, 1e-20f));
    bf16* ob = out + b * st.o_b + h * st.o_h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      if (qa < Q)
        *reinterpret_cast<uint32_t*>(ob + qa * st.o_s + d) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (qb < Q)
        *reinterpret_cast<uint32_t*>(ob + qb * st.o_s + d) = pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (t4 == 0) {
      if (qa < Q) lse[(long long)bh * Q + qa] = kr0 == NONE ? -NEG : (__fadd_rn(tr0, (float)kr0) + log2f(l0)) * LN2;
      if (qb < Q) lse[(long long)bh * Q + qb] = kr1 == NONE ? -NEG : (__fadd_rn(tr1, (float)kr1) + log2f(l1)) * LN2;
    }
  } else {  // the split's partial: O against 2^kr, then (kr, l, t_ref) per row
    const long long BHQ = (long long)gridDim.y * Q;
    float* wo = ws + ((long long)split * BHQ + (long long)bh * Q) * D;
    float* wst = ws + (long long)splits * BHQ * D + ((long long)split * BHQ + (long long)bh * Q) * 4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      if (qa < Q) *reinterpret_cast<float2*>(wo + (long long)qa * D + d) = make_float2(o[4 * j], o[4 * j + 1]);
      if (qb < Q) *reinterpret_cast<float2*>(wo + (long long)qb * D + d) = make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
    if (t4 == 0) {
      if (qa < Q) *reinterpret_cast<float4*>(wst + (long long)qa * 4) = make_float4((float)kr0, l0, tr0, 0.f);
      if (qb < Q) *reinterpret_cast<float4*>(wst + (long long)qb * 4) = make_float4((float)kr1, l1, tr1, 0.f);
    }
  }
}

// The splits' partials of each row added in split order: one thread per
// (row, 8 columns). The rescales are exact powers of two, as in the block.
template <int D>
__global__ void __launch_bounds__(256)
flash_fwd_merge_kernel(const float* __restrict__ ws, bf16* __restrict__ out, float* __restrict__ lse, int BH, int H,
                       int Q, int splits, Strides st, float keep_prob) {
  using namespace k1;
  constexpr int CH = D / 8;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long BHQ = (long long)BH * Q;
  if (i >= BHQ * CH) return;
  const int c = (int)(i % CH);
  const long long row = i / CH;
  const float* wst = ws + (long long)splits * BHQ * D;
  int km = NONE;
  for (int s = 0; s < splits; ++s) km = max(km, (int)wst[(s * BHQ + row) * 4]);
  float l = 0.f, o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float a = pow2i((int)wst[(s * BHQ + row) * 4] - km);
    l = __fadd_rn(l, __fmul_rn(wst[(s * BHQ + row) * 4 + 1], a));
    const float4* src = reinterpret_cast<const float4*>(ws + (s * BHQ + row) * D + 8 * c);
    const float4 u = src[0], v = src[1];
    const float w[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __fadd_rn(o[j], __fmul_rn(w[j], a));
  }
  const int bh = (int)(row / Q), q = (int)(row % Q), b = bh / H, h = bh % H;
  const float inv = 1.f / (keep_prob * fmaxf(l, 1e-20f));
  bf16* orow = out + b * st.o_b + h * st.o_h + (long long)q * st.o_s + 8 * c;
#pragma unroll
  for (int j = 0; j < 8; j += 2) *reinterpret_cast<uint32_t*>(orow + j) = pack_bf16(o[j] * inv, o[j + 1] * inv);
  if (c == 0) lse[row] = km == NONE ? -NEG : (__fadd_rn(wst[row * 4 + 2], (float)km) + log2f(l)) * LN2;
}

// ------------------------------------------------------------- launches
struct Dropout {
  bool on;
  uint32_t seed, thresh;
  float keep_prob;
  uint32_t bh_offset, key_offset;  // the shard's first global b*H + h and key
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
      a.H, a.Q, a.L, a.st, a.scale, a.dr.seed, a.dr.thresh, a.dr.keep_prob, a.dr.bh_offset, a.dr.key_offset);
  return (int)cudaGetLastError();
}

template <int D, bool DROPOUT>
int launch_wgmma(const Args& a, int splits, float* ws) {
  using S = k1::Smem<D>;
  CUtensorMap qm, km, vm;
  MapOrder qo, ko, vo;
  const long long qst[3] = {a.st.q_b, a.st.q_h, a.st.q_s}, kst[3] = {a.st.k_b, a.st.k_h, a.st.k_s},
                  vst[3] = {a.st.v_b, a.st.v_h, a.st.v_s};
  int err = encode_rows(&qm, &qo, a.q, a.B, a.H, a.Q, D, qst, k1::BM);
  if (err == 0) err = encode_rows(&km, &ko, a.k, a.B, a.H, a.L, D, kst, k1::BN);
  if (err == 0) err = encode_rows(&vm, &vo, a.v, a.B, a.H, a.L, D, vst, k1::BN);
  if (err != 0) return err;
  static bool sized = false;  // the dynamic shared memory above 48 KB, once per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, DROPOUT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, S::ALLOC);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid((a.Q + k1::BM - 1) / k1::BM, a.B * a.H, splits);
  flash_fwd_wgmma_kernel<D, DROPOUT><<<grid, k1::THREADS, S::ALLOC, a.stream>>>(
      qm, km, vm, qo, ko, vo, static_cast<const bf16*>(a.k), static_cast<const uint8_t*>(a.mask),
      static_cast<bf16*>(a.out), static_cast<float*>(a.lse), ws, a.H, a.Q, a.L, splits, a.st, a.scale, a.dr.seed,
      a.dr.thresh, a.dr.keep_prob, a.dr.bh_offset, a.dr.key_offset);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long threads = (long long)a.B * a.H * a.Q * (D / 8);
  flash_fwd_merge_kernel<D><<<(unsigned)((threads + 255) / 256), 256, 0, a.stream>>>(
      ws, static_cast<bf16*>(a.out), static_cast<float*>(a.lse), a.B * a.H, a.H, a.Q, splits, a.st, a.dr.keep_prob);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(bool bf16_route, int splits, float* ws, const Args& a) {
  const bool d = a.dr.on;
  if (!bf16_route) return d ? launch_fp32<D, true>(a) : launch_fp32<D, false>(a);
  return d ? launch_wgmma<D, true>(a, splits, ws) : launch_wgmma<D, false>(a, splits, ws);
}

// the bf16 kernel reads q, k and v by TMA (16-byte aligned, strides in
// multiples of 8 elements) and stores out in pairs (4-byte aligned, even
// strides)
bool wgmma_layout_ok(const Args& a) {
  const long long in[9] = {a.st.q_b, a.st.q_h, a.st.q_s, a.st.k_b, a.st.k_h, a.st.k_s, a.st.v_b, a.st.v_h, a.st.v_s};
  const long long o[3] = {a.st.o_b, a.st.o_h, a.st.o_s};
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v)) & 15)
    return false;
  if (reinterpret_cast<uintptr_t>(a.out) & 3) return false;
  for (int i = 0; i < 9; ++i)
    if (in[i] % 8) return false;
  for (int i = 0; i < 3; ++i)
    if (o[i] % 2) return false;
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the wgmma kernel;
// q, k and v 16-byte aligned with strides in multiples of 8, out with even
// strides), for q, k, v and out. strides: 12 element strides, for q, k, v and
// out in turn, each (batch, head, row); the last axis is contiguous. mask:
// (B, L) bytes or NULL. dropout: 0 = off; else seed (the int32 seed's bits),
// thresh and keep_prob = 1 - rate drop the probabilities as dropout_hash.cuh
// says, at the global coordinates of a shard whose first b*H + h is bh_offset
// and whose first key is key_offset (0 and 0 for a whole problem). splits
// (bf16): the key splits, each at most 512 tiles of 64 keys; above 1, ws
// holds splits x B x H x Q x (D + 4) floats of workspace and a merge kernel
// follows. Returns cudaGetLastError() after the launches, or 10000 + the
// CUresult where a tensor map is refused.
int petr_flash_cross_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse,
                                   int B, int H, int Q, int L, int D, int dtype,
                                   const long long* strides, float scale,
                                   int dropout, uint32_t seed, uint32_t thresh,
                                   float keep_prob, uint32_t bh_offset, uint32_t key_offset,
                                   int splits, void* ws, void* stream) {
  Args a{q, k, v, mask, out, lse, B, H, Q, L, {}, scale,
         {dropout != 0, seed, thresh, keep_prob, bh_offset, key_offset},
         static_cast<cudaStream_t>(stream)};
  a.st.q_b = strides[0]; a.st.q_h = strides[1]; a.st.q_s = strides[2];
  a.st.k_b = strides[3]; a.st.k_h = strides[4]; a.st.k_s = strides[5];
  a.st.v_b = strides[6]; a.st.v_h = strides[7]; a.st.v_s = strides[8];
  a.st.o_b = strides[9]; a.st.o_h = strides[10]; a.st.o_s = strides[11];
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool bf16_route = dtype == 1;
  if (bf16_route) {
    const int tiles = (L + k1::BN - 1) / k1::BN;
    if (!wgmma_layout_ok(a)) return (int)cudaErrorMisalignedAddress;
    if (splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr) ||
        (tiles + splits - 1) / splits > k1::MAX_TILES)
      return (int)cudaErrorInvalidValue;
  }
  switch (D) {
    case 16: return dispatch<16>(bf16_route, splits, static_cast<float*>(ws), a);
    case 32: return dispatch<32>(bf16_route, splits, static_cast<float*>(ws), a);
    case 64: return dispatch<64>(bf16_route, splits, static_cast<float*>(ws), a);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* petr_cuda_error_string(int err) {
  if (err >= ENCODE_FAILED) return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
