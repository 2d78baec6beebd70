// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ, bf16 in and
// out, fp32 accumulation and statistics.
//
// Replaces: kubeflow_tpu/ops/flash_attention.py, `_flash_bwd_pallas` -- the
// `pl.pallas_call` of `_bwd_dkdv_kernel` (dK and dV summed over every GQA
// group head and every query block that attends to a kv block) and the
// `pl.pallas_call` of `_bwd_dq_kernel` (dQ over the kv sweep). Both recompute
// the attention probabilities from the forward's saved log-sum-exp:
//   s  = q k^T * sm_scale (then tanh softcap), causal mask to the finite
//        NEG_INF at a static q_offset,
//   p  = exp(s - lse), forced to 0 where s <= NEG_INF / 2 (a fully masked
//        row, whose lse is NEG_INF too, gives no gradient),
//   dV += bf16(p)^T dO,   dP = dO v^T,
//   dS = p * (dP - delta) [* (1 - tanh^2) with softcap] * sm_scale,
//   dK += bf16(dS)^T q,   dQ += bf16(dS) k,
// with delta = rowsum(dO * O) computed by the caller, as the JAX package
// computes it outside its kernels. p and dS are rounded to bf16 before the
// products, at the same places as the TPU kernels.
//
// Bound on an H100 SXM: operations. At the training shape (B = 2, H = 32,
// KH = 8, S = 2048, D = 128, causal) each product over the causal half is
// 2 * B * H * (S^2 / 2) * D * 2 = 34.4 GFLOP. dK/dV does four (q k^T,
// dO v^T, p^T dO, dS^T q): 137 GFLOP, ~0.139 ms at 989 bf16 TFLOP/s. dQ does
// three (q k^T, dO v^T, dS k): 103 GFLOP, ~0.104 ms. The bytes each kernel
// must move are ~0.1 GB (~0.03 ms at 3.35 TB/s), far below.
//
// dK/dV (namespace dkdv), the warp-specialised Hopper design: one block per
// (batch x kv head, 128-row kv tile), three warpgroups, 1 KB-aligned tiles
// in the layout of sm90.cuh.
//  - Producer (warpgroup 2, setmaxnreg 40; its first warp): one thread
//    TMA-loads the block's K and V tiles once, then streams the Q and dO
//    tiles (64 rows) through a 2-stage ring with full and empty mbarriers,
//    for every head of the GQA group and every q tile at or after the
//    diagonal; the warp copies each tile's lse and delta rows beside them
//    (a row's start need not be 16-byte aligned, which TMA requires) and
//    each lane arrives on the stage's full barrier after its stores.
//  - Consumers (warpgroups 0 and 1, setmaxnreg 232), 64 kv rows each:
//    S^T = K Q^T and dP^T = V dO^T by wgmma SS (m64n64k16, all K-major);
//    p, the causal/softcap/NEG_INF/2 rules and dS in registers, p as
//    expf(s - lse) like the plain version (bf16(p) feeds dV, and exp2 with
//    log2(e) folded in flips that rounding more often); then dV +=
//    bf16(P^T) dO and dK += bf16(dS^T) Q by wgmma RS (m64nDk16), dO and Q
//    read MN-major. Masks are applied only on diagonal and ragged tiles.
//    A p >= 1/4 whose fp32 value lies near a midpoint between two bf16
//    values (within 128 fp32 ulps, about 0.4% of values) is recomputed
//    from its exact score: the tensor cores' fp32 accumulation is off by a
//    few ulps of the score, enough to round such a p to the other bf16
//    neighbour than the exact score does, which moves dV by ulp(p) |dO|
//    (2^-8 |dO| for p >= 1/2). A warp marks its p >= 1/4 by a running max
//    and, only if it holds one, filters them and sums each chosen score
//    with all 32 lanes in fp64 (D / 32 products per lane, a fixed-order
//    shuffle reduction). dS takes the new p, not an exact dP (recomputing
//    dP too, for |dS| >= 1/2, cost 23% of the kernel's time). Cost at the
//    training shape (PERF.md): about 9% on random inputs, where it rarely
//    sums, and about 9% with an attention sink, where every query puts
//    p >= 1/2 on one key. `-DFLASH_DKDV_EXACT_P=0` builds the kernel
//    without the recompute, to measure that cost.
//    dK and dV stay in registers for the whole sweep (2 x D / 2 fp32 per
//    thread) and are rounded to bf16 once. The group's heads are summed
//    inside the block in a fixed order, with no atomics: results repeat bit
//    for bit.
//  - Shared memory per block at D = 128: K 32 KB + V 32 KB + 2 x (Q 16 KB
//    + dO 16 KB + 512 B of lse/delta) = 129 KB, one block per SM.
//  - Order: the grid's slow axis walks kv tiles from 0, which meets the
//    most q tiles under the causal mask, so the heaviest blocks start first.
//
// dQ (namespace dq), the same shape turned around: one block per (batch x
// q head, 128-row q tile), three warpgroups.
//  - Producer (warpgroup 2, setmaxnreg 24; one of its threads): TMA-loads
//    the block's Q and dO tiles once, then streams the 64-row K and V tiles
//    of kv head h / (H / KH) through a 3-stage ring with full and empty
//    mbarriers, up to the causal diagonal of the block's last row.
//  - Consumers (warpgroups 0 and 1, setmaxnreg 240), 64 query rows each:
//    S = Q K^T and dP = dO V^T by wgmma SS (m64n64k16, all K-major); p and
//    dS in registers under the rules of dK/dV, but in base 2 with the
//    scales folded into lse and delta (a multiply-add and one ex2 per
//    element; with expf and the scales applied per element this math took
//    more time than the products); masks only on diagonal and ragged
//    tiles; then dQ +=
//    bf16(dS) K by wgmma RS (m64nDk16), dS packed straight from the dP
//    accumulator into the A fragment and K read MN-major (transpose bit).
//    The two warpgroups take turns at the tensor cores (named barriers, as
//    FlashAttention-3's ping-pong): turn k issues tile k - 1's dQ product
//    and tile k's S and dP, hands over, and waits for them; tile k's p
//    and dS are then computed on the CUDA cores while the other
//    warpgroup's products run. No wgmma is in flight while other
//    instructions write its registers, so ptxas does not serialize them
//    (its C7515 note). The ring holds three tiles.
//    Each thread's two rows of lse and delta are read once into registers
//    (a row's start need not be 16-byte aligned, so not TMA). A tile wholly
//    in a warpgroup's future is skipped. dQ stays in fp32 registers for the
//    sweep (D / 2 per thread) and is rounded to bf16 once.
//  - No atomics: each block owns its rows and sums its kv tiles in a fixed
//    order, so dQ repeats bit for bit. Rows that see no key (negative
//    q_offset) have every p = 0 and get dQ exactly 0; a block all of whose
//    rows see none loads nothing and writes zeros.
//  - Shared memory per block at D = 128: Q 32 KB + dO 32 KB + 3 x (K 16 KB
//    + V 16 KB) = 161 KB with the barriers, one block per SM; half at
//    D = 64.
//  - Order: the grid's slow axis walks q tiles from the last, which meets
//    the most kv tiles under the causal mask, so the heaviest blocks start
//    first.
//
// Layout: q, dO, dQ [B, H, Sq, D]; k, v, dK, dV [B, KH, Skv, D] (bf16,
// contiguous; q, k, v and dO 16-byte aligned for TMA); lse, delta
// [B, H, Sq] fp32. q-head h reads kv-head h / (H / KH). TMA reads each
// tensor as [planes, rows, D], so a ragged tile is filled with zeros, not
// the next head's rows, and masked in the kernels.

#include <cfloat>
#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
// The masked-logit value of kubeflow_tpu/ops/attention.py (NEG_INF).
constexpr float NEG_INF = -0.7f * FLT_MAX;

// ---- dK/dV: TMA, wgmma and warp specialisation ----------------------------

namespace dkdv {

constexpr int BQ = 64;         // query rows per streamed tile
constexpr int BKV = 128;       // kv rows per block
constexpr int STAGES = 2;      // Q/dO/lse/delta ring depth
constexpr int CONSUMERS = 2;   // warpgroups of 64 kv rows
constexpr int THREADS = (CONSUMERS + 1) * 128;

// Whether the fp32 `p` lies within NEAR_MID fp32 ulps of a midpoint
// between two bf16 values, where bf16(p) can round either way under a
// small error of p's score. The tensor cores' scores differ from exact
// ones by a few ulps (4 ulps of p at the S = 255 edge case that showed a
// flip); 128 ulps is 2^-9 of a bf16 step, so about 0.4% of values qualify.
#ifndef FLASH_DKDV_EXACT_P
#define FLASH_DKDV_EXACT_P 1    // 0 builds the kernel without the recompute
#endif
constexpr uint32_t NEAR_MID = 128;
DEV bool near_bf16_midpoint(float p) {
  return (__float_as_uint(p) & 0xffffu) - (0x8000u - NEAR_MID) < 2 * NEAR_MID;
}

// The exact score of query row `qr` of a staged Q tile (BQ rows) and kv
// row `kr` of the K tile (BKV rows), both in the swizzled layout of
// sm90.cuh, summed by the whole warp: each lane multiplies D / 32 elements
// (bf16 products are exact in fp64) and the lanes' fp64 sums are reduced
// in a fixed order, then rounded once to fp32. Every lane returns it.
template <int D>
DEV float exact_dot(const bf16* qt, const bf16* kt, int qr, int kr,
                    int lane) {
  constexpr int E = D / 32;                        // elements per lane
  const int at = lane * E * 2;                     // byte in the D row
  const int half = at / 128, chunk = (at % 128) / 16, within = at % 16;
  const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(
      reinterpret_cast<const unsigned char*>(qt + half * BQ * 64) +
      qr * 128 + ((chunk ^ (qr & 7)) << 4) + within);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(
      reinterpret_cast<const unsigned char*>(kt + half * BKV * 64) +
      kr * 128 + ((chunk ^ (kr & 7)) << 4) + within);
  double acc = 0.0;
#pragma unroll
  for (int e = 0; e < E; ++e)
    acc += double(__bfloat162float(a[e])) * double(__bfloat162float(b[e]));
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return float(acc);
}

// What p and dS need besides the scores: positions, lengths and the
// logit transform.
struct Rule {
  int q0, krow, col2, Sq, Skv, causal, q_offset;
  float sm_scale;
  int has_softcap;
  float softcap;
};

// p = exp(s - lse), forced to 0 where s <= NEG_INF / 2 (MASK: the causal
// mask to NEG_INF, rows and columns past the tensors), and dS = p (dP -
// delta) [(1 - tanh^2)] sm_scale, in place of the R score and dP registers
// (register 4j + 2i + e is kv row krow + 8i, query column 8j + col2 + e).
// Returns the largest p.
template <bool MASK, int R>
DEV float probs_and_grads(float (&st)[R], float (&dpt)[R],
                          const float* lrow, const float* drow,
                          const Rule& u) {
  float pmax = 0.f;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + u.col2 + e;
      const int qi = u.q0 + c;
      const float l = lrow[c];
      const float dl = drow[c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 4 * j + 2 * i + e;
        const int kpos = u.krow + 8 * i;
        const float s_raw = st[r] * u.sm_scale;
        float x = s_raw, t = 0.f;
        if (u.has_softcap) {
          t = tanhf(s_raw / u.softcap);
          x = t * u.softcap;
        }
        bool keep = x > NEG_INF * 0.5f;
        if (MASK) {
          if (u.causal && kpos > u.q_offset + qi) x = NEG_INF;
          keep = x > NEG_INF * 0.5f && qi < u.Sq && kpos < u.Skv;
        }
        const float p = keep ? expf(x - l) : 0.f;
        float ds = p * (dpt[r] - dl);
        if (u.has_softcap) ds *= 1.f - t * t;
        st[r] = p;
        dpt[r] = keep ? ds * u.sm_scale : 0.f;
        pmax = fmaxf(pmax, p);
      }
    }
  }
  return pmax;
}

template <int D>
struct Smem {
  static constexpr uint32_t kv_bytes = BKV * D * 2;
  static constexpr uint32_t q_bytes = BQ * D * 2;
  static constexpr uint32_t row_bytes = BQ * 4;
  static constexpr uint32_t stage_tx = 2 * q_bytes;   // Q and dO by TMA
  static constexpr size_t v = kv_bytes;
  static constexpr size_t q = v + kv_bytes;                 // STAGES tiles
  static constexpr size_t dout = q + STAGES * q_bytes;      // STAGES tiles
  static constexpr size_t lse = dout + STAGES * q_bytes;    // STAGES rows
  static constexpr size_t delta = lse + STAGES * row_bytes;
  static constexpr size_t bars = delta + STAGES * row_bytes;
  // kv_full, full[STAGES], empty[STAGES]; 1 KB of slack to align the base.
  static constexpr size_t total = bars + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                      int KH, int Sq, int Skv, int causal, int q_offset,
                      float sm_scale, int has_softcap, float softcap) {
  using S = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + S::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + S::dout);
  float* lse_s = reinterpret_cast<float*>(smem + S::lse);
  float* delta_s = reinterpret_cast<float*>(smem + S::delta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int bkv = blockIdx.x;                    // b * KH + kv head
  const int j0 = blockIdx.y * BKV;               // kv tile 0 (heaviest) first
  const int G = H / KH;
  const int bh0 = (bkv / KH) * H + (bkv % KH) * G;   // first head of the group
  const int n_q = (Sq + BQ - 1) / BQ;
  // Causal skip: q tiles whose last query sits before this kv tile.
  int t_first = 0;
  if (causal) {
    const int need = j0 - q_offset - BQ + 1;     // q0 >= need
    t_first = need <= 0 ? 0 : min(n_q, (need + BQ - 1) / BQ);
  }
  const int per_head = n_q - t_first;
  const int n_it = G * per_head;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);   // TMA bytes + the warp
      sm90::mbar_init(&empty[s], CONSUMERS * 4);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: K and V once, then (Q, dO, lse, delta) per q tile ------
    sm90::regs_dealloc<40>();
    if (threadIdx.x / 32 == CONSUMERS * 4) {       // the first warp
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        sm90::prefetch_map(&qmap);
        sm90::prefetch_map(&domap);
        sm90::mbar_expect_tx(kv_full, 2 * S::kv_bytes);
        for (int half = 0; half < D / 64; ++half) {
          sm90::tma_load_3d(Ks + half * BKV * 64, &kmap, kv_full, half * 64,
                            j0, bkv);
          sm90::tma_load_3d(Vs + half * BKV * 64, &vmap, kv_full, half * 64,
                            j0, bkv);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        const int bh = bh0 + it / per_head;
        const int q0 = (t_first + it % per_head) * BQ;
        if (it >= STAGES) sm90::mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        if (lane == 0) {
          sm90::mbar_expect_tx(&full[s], S::stage_tx);
          for (int half = 0; half < D / 64; ++half) {
            sm90::tma_load_3d(Qs + s * BQ * D + half * BQ * 64, &qmap,
                              &full[s], half * 64, q0, bh);
            sm90::tma_load_3d(dOs + s * BQ * D + half * BQ * 64, &domap,
                              &full[s], half * 64, q0, bh);
          }
        }
        // lse and delta rows (a row start need not be 16-byte aligned, so
        // not TMA): the warp stores them, each lane arrives once after its
        // stores. Rows past Sq get 0 and are masked out below.
        for (int c = lane; c < BQ; c += 32) {
          const bool ok = q0 + c < Sq;
          const size_t at = size_t(bh) * Sq + q0 + c;
          lse_s[s * BQ + c] = ok ? lse[at] : 0.f;
          delta_s[s * BQ + c] = ok ? delta[at] : 0.f;
        }
        sm90::mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: 64 kv rows each ---------------------------------------
    sm90::regs_alloc<232>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int kloc = wg * 64 + (tid / 32) * 16 + lane / 4;   // in the tile
    const int krow = j0 + kloc;                                  // i = 0
    const int col2 = 2 * (lane % 4);

    float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) {
      acc_dk[r] = 0.f;
      acc_dv[r] = 0.f;
    }
    sm90::mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES;
      const int q0 = (t_first + it % per_head) * BQ;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      const bf16* qt = Qs + s * BQ * D;
      const bf16* dot = dOs + s * BQ * D;

      // S^T = K Q^T and dP^T = V dO^T: 64 kv rows by the tile's 64 queries.
      float st[BQ / 2], dpt[BQ / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int half = kk / 4, step = (kk % 4) * 16;
        const int a_off = half * BKV * 64 + wg * 64 * 64 + step;
        const int b_off = half * BQ * 64 + step;
        sm90::wgmma_ss<BQ, 0>(st, sm90::smem_desc(Ks + a_off, 16, 1024),
                              sm90::smem_desc(qt + b_off, 16, 1024), kk > 0);
        sm90::wgmma_ss<BQ, 0>(dpt, sm90::smem_desc(Vs + a_off, 16, 1024),
                              sm90::smem_desc(dot + b_off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      // p and dS in registers; masks only where a key can lie in a
      // query's future or a row or column past the tensors.
      const float* lrow = lse_s + s * BQ;
      const float* drow = delta_s + s * BQ;
      const bool edge = (causal && q_offset + q0 < j0 + wg * 64 + 63) ||
                        q0 + BQ > Sq || j0 + wg * 64 + 64 > Skv;
      const Rule rule{q0, krow, col2, Sq, Skv, causal, q_offset, sm_scale,
                      has_softcap, softcap};
      const float pmax = edge ? probs_and_grads<true, BQ / 2>(st, dpt, lrow,
                                                               drow, rule)
                              : probs_and_grads<false, BQ / 2>(st, dpt, lrow,
                                                                drow, rule);
      // bf16(p) feeds dV with a weight of ulp(p) |dO|, 2^-8 |dO| for
      // p >= 1/2: each p >= 1/4 near a bf16 midpoint comes from its exact
      // score, so it rounds as it does from exact scores and not by the
      // tensor cores' accumulation error; dS follows it. The warp takes
      // its lanes' terms one at a time, all 32 lanes summing each.
#if FLASH_DKDV_EXACT_P
      uint32_t large = 0, lanes = 0;
      if (__any_sync(0xffffffffu, pmax >= 0.25f)) {
#pragma unroll
        for (int k = 0; k < BQ / 2; ++k)
          large |= uint32_t(st[k] >= 0.25f && near_bf16_midpoint(st[k])) << k;
        lanes = __ballot_sync(0xffffffffu, large != 0);
      }
      for (; lanes; lanes = __ballot_sync(0xffffffffu, large != 0)) {
        const int src = __ffs(lanes) - 1;
        const int r = __ffs(__shfl_sync(0xffffffffu, large, src)) - 1;
        const int c = 8 * (r / 4) + 2 * (src % 4) + r % 2;
        const int kr = kloc - lane / 4 + src / 4 + 8 * ((r / 2) % 2);
        const float s_raw = exact_dot<D>(qt, Ks, c, kr, lane) * sm_scale;
        if (lane == src) {
          large &= large - 1;
          const float x =
              has_softcap ? tanhf(s_raw / softcap) * softcap : s_raw;
          const float p = expf(x - lrow[c]);
          float old = 0.f;
#pragma unroll
          for (int k = 0; k < BQ / 2; ++k) old = k == r ? st[k] : old;
          const float ratio = p / old;
#pragma unroll
          for (int k = 0; k < BQ / 2; ++k) {
            if (k == r) {
              dpt[k] *= ratio;
              st[k] = p;
            }
          }
        }
      }
#else
      (void)pmax;
#endif

      // dV += bf16(P^T) dO, dK += bf16(dS^T) Q: A from registers, dO and Q
      // read MN-major (transpose bit).
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int k = 0; k < BQ / 16; ++k) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          pa[k][f] = sm90::pack_bf16(st[8 * k + 2 * f], st[8 * k + 2 * f + 1]);
          da[k][f] =
              sm90::pack_bf16(dpt[8 * k + 2 * f], dpt[8 * k + 2 * f + 1]);
        }
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < BQ / 16; ++k) {
        sm90::wgmma_rs<D, 1>(
            acc_dv, pa[k], sm90::smem_desc(dot + k * 16 * 64, BQ * 128, 1024),
            1);
        sm90::wgmma_rs<D, 1>(
            acc_dk, da[k], sm90::smem_desc(qt + k * 16 * 64, BQ * 128, 1024),
            1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc_dv);
      sm90::fence_regs(acc_dk);
#pragma unroll
      for (int k = 0; k < BQ / 16; ++k) {
        sm90::fence_regs(pa[k]);
        sm90::fence_regs(da[k]);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[s]);   // stage s is free
    }

    // dK and dV, summed over the group in fp32, rounded once.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kpos = krow + 8 * i;
      if (kpos < Skv) {
        const size_t base = (size_t(bkv) * Skv + kpos) * D + col2;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * j) =
              __floats2bfloat162_rn(acc_dk[4 * j + 2 * i],
                                    acc_dk[4 * j + 2 * i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * j) =
              __floats2bfloat162_rn(acc_dv[4 * j + 2 * i],
                                    acc_dv[4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int H, int KH, int Sq, int Skv,
                   int causal, int q_offset, float sm_scale, int has_softcap,
                   float softcap, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, domap;
  if (!sm90::map_tiles(&qmap, q, B * H, Sq, D, BQ) ||
      !sm90::map_tiles(&domap, dout, B * H, Sq, D, BQ) ||
      !sm90::map_tiles(&kmap, k, B * KH, Skv, D, BKV) ||
      !sm90::map_tiles(&vmap, v, B * KH, Skv, D, BKV))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Smem<D>::total;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(B * KH, (Skv + BKV - 1) / BKV);
  flash_bwd_dkdv_kernel<D><<<grid, THREADS, smem, stream>>>(
      qmap, kmap, vmap, domap, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, KH, Sq, Skv, causal, q_offset, sm_scale,
      has_softcap, softcap);
  return cudaGetLastError();
}

}  // namespace dkdv

// ---- dQ: TMA, wgmma and warp specialisation ------------------------------

namespace dq {

constexpr int BQ = 128;        // query rows per block
constexpr int BKV = 64;        // kv rows per streamed tile
constexpr int STAGES = 3;      // K/V ring depth
constexpr int CONSUMERS = 2;   // warpgroups of 64 query rows
constexpr int THREADS = (CONSUMERS + 1) * 128;

constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the special-function unit (max relative error 2^-22; results
// below 2^-126 flush to 0).
DEV float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// What p and dS need besides the scores: positions, lengths and the
// logit transform (scale2 = sm_scale * log2(e)).
struct Rule {
  int row, col2, Sq, Skv, causal, q_offset;
  float sm_scale, scale2;
  int has_softcap;
  float softcap;
};

// p = exp(s - lse), forced to 0 where s <= NEG_INF / 2 (MASK: the causal
// mask to NEG_INF, rows and columns past the tensors), and dS = p (dP -
// delta) [(1 - tanh^2)] sm_scale, in place of the dP registers (register
// 4j + 2i + e is query row `row` + 8i, kv column j0 + 8j + col2 + e).
// In base 2 with the scales folded in: p = 2^(s * scale2 - lse2) with
// lse2 = lse * log2(e), and dS = p (dP * sm_scale - dls) with dls = delta
// * sm_scale, a multiply-add and one ex2 per element.
template <bool MASK, int R>
DEV void grads(const float (&s)[R], float (&dp)[R], const float (&lse2)[2],
               const float (&dls)[2], int j0, const Rule& u) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = u.row + 8 * i;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 4 * j + 2 * i + e;
        const int kpos = j0 + 8 * j + u.col2 + e;
        float x2, t = 0.f;                       // the logit times log2(e)
        if (u.has_softcap) {
          t = tanhf(s[r] * u.sm_scale / u.softcap);
          x2 = t * (u.softcap * LOG2E);
        } else {
          x2 = s[r] * u.scale2;
        }
        bool keep = x2 > NEG_INF * 0.5f * LOG2E;
        if (MASK)
          keep = keep && !(u.causal && kpos > u.q_offset + qi) &&
                 qi < u.Sq && kpos < u.Skv;
        const float p = keep ? ex2(x2 - lse2[i]) : 0.f;
        float ds = p * fmaf(dp[r], u.sm_scale, -dls[i]);
        if (u.has_softcap) ds *= 1.f - t * t;
        dp[r] = keep ? ds : 0.f;
      }
    }
  }
}

template <int D>
struct Smem {
  static constexpr uint32_t q_bytes = BQ * D * 2;
  static constexpr uint32_t kv_bytes = BKV * D * 2;
  static constexpr size_t dout = q_bytes;
  static constexpr size_t k = dout + q_bytes;
  static constexpr size_t v = k + STAGES * kv_bytes;
  static constexpr size_t bars = v + STAGES * kv_bytes;
  // q_full, full[STAGES], empty[STAGES]; 1 KB of slack to align the base.
  static constexpr size_t total = bars + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int KH, int Sq, int Skv, int causal, int q_offset,
                    float sm_scale, int has_softcap, float softcap) {
  using S = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + S::dout);
  bf16* Ks = reinterpret_cast<bf16*>(smem + S::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::v);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;                     // b * H + h
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - int(blockIdx.y)) * BQ;   // heaviest first
  const int bkv = (bh / H) * KH + (bh % H) / (H / KH);
  const int n_kv = (Skv + BKV - 1) / BKV;
  int n_tiles = n_kv;
  if (causal) {
    // Tiles starting past the last query row's position are in the future
    // of every row of this block; a block that sees no key loads nothing.
    const int last_pos = q_offset + q0 + BQ - 1;
    n_tiles = last_pos < 0 ? 0 : min(n_kv, last_pos / BKV + 1);
  }

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS * 4);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: Q and dO once, then (K, V) per kv tile ----------------
    sm90::regs_dealloc<24>();
    if (threadIdx.x == CONSUMERS * 128 && n_tiles > 0) {
      sm90::prefetch_map(&kmap);
      sm90::prefetch_map(&vmap);
      sm90::mbar_expect_tx(q_full, 2 * S::q_bytes);
      for (int half = 0; half < D / 64; ++half) {
        sm90::tma_load_3d(Qs + half * BQ * 64, &qmap, q_full, half * 64, q0,
                          bh);
        sm90::tma_load_3d(dOs + half * BQ * 64, &domap, q_full, half * 64,
                          q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) sm90::mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        sm90::mbar_expect_tx(&full[s], 2 * S::kv_bytes);
        bf16* kd = Ks + s * BKV * D;
        bf16* vd = Vs + s * BKV * D;
        for (int half = 0; half < D / 64; ++half) {
          sm90::tma_load_3d(kd + half * BKV * 64, &kmap, &full[s], half * 64,
                            t * BKV, bkv);
          sm90::tma_load_3d(vd + half * BKV * 64, &vmap, &full[s], half * 64,
                            t * BKV, bkv);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ------------------------------------
    sm90::regs_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row = q0 + wg * 64 + (tid / 32) * 16 + lane / 4;   // i = 0
    const Rule rule{row, 2 * (lane % 4), Sq, Skv, causal, q_offset, sm_scale,
                    sm_scale * LOG2E, has_softcap, softcap};
    // This thread's two rows of lse and delta, as lse * log2(e) and delta *
    // sm_scale (0 past Sq: masked below).
    float lrow[2], drow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = row + 8 * i < Sq;
      const size_t at = size_t(bh) * Sq + row + 8 * i;
      lrow[i] = ok ? lse[at] * LOG2E : 0.f;
      drow[i] = ok ? delta[at] * sm_scale : 0.f;
    }
    // Tiles starting after the last position among this warpgroup's rows
    // are wholly in their future: it only releases them.
    int n_mine = n_tiles;
    if (causal) {
      const int wg_last = q_offset + q0 + wg * 64 + 63;
      n_mine = wg_last < 0 ? 0 : min(n_tiles, wg_last / BKV + 1);
    }

    float acc[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;
    float sc[BKV / 2], dp[BKV / 2];
    uint32_t da[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      da[kk][0] = da[kk][1] = da[kk][2] = da[kk][3] = 0u;

    // Turns at the tensor cores, warpgroup 0 first (n_tiles + 1 each):
    // turn k issues tile k - 1's dQ product and tile k's S and dP, hands
    // the tensor cores to the other warpgroup and waits for its products;
    // then tile k's p and dS are computed on the CUDA cores while the other
    // warpgroup's products run. The products are issued on every turn
    // k <= n_mine, with no branch around them (a branch makes ptxas
    // serialize them, its C7520 note): turn 0's dQ product adds the zero
    // fragment, turn n_mine's S and dP go unread.
    const int mine = 1 + wg, theirs = 2 - wg;    // named barrier ids
    if (wg == 1) sm90::bar_arrive(1, 2 * 128);
    if (n_tiles > 0) sm90::mbar_wait(q_full, 0);
    const int n_issue = n_mine > 0 ? n_mine + 1 : 0;
    for (int k = 0; k < n_issue; ++k) {
      const int s = k % STAGES;
      if (k < n_tiles) sm90::mbar_wait(&full[s], (k / STAGES) & 1);
      sm90::bar_sync(mine, 2 * 128);
      sm90::wgmma_fence();
      // dQ += bf16(dS) K of tile k - 1: A from registers, K MN-major.
      const bf16* kp = Ks + (max(k - 1, 0) % STAGES) * BKV * D;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        sm90::wgmma_rs<D, 1>(
            acc, da[kk], sm90::smem_desc(kp + kk * 16 * 64, BKV * 128, 1024),
            1);
      // S = Q K^T and dP = dO V^T of tile k: this warpgroup's 64 rows
      // against the tile's 64 keys.
      const bf16* kt = Ks + s * BKV * D;
      const bf16* vt = Vs + s * BKV * D;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int half = kk / 4, step = (kk % 4) * 16;
        const int a_off = half * BQ * 64 + wg * 64 * 64 + step;
        const int b_off = half * BKV * 64 + step;
        sm90::wgmma_ss<BKV, 0>(sc, sm90::smem_desc(Qs + a_off, 16, 1024),
                               sm90::smem_desc(kt + b_off, 16, 1024), kk > 0);
        sm90::wgmma_ss<BKV, 0>(dp, sm90::smem_desc(dOs + a_off, 16, 1024),
                               sm90::smem_desc(vt + b_off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
      if (wg == 0 || k < n_tiles) sm90::bar_arrive(theirs, 2 * 128);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      sm90::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) sm90::fence_regs(da[kk]);
      if (k >= 1 && lane == 0) sm90::mbar_arrive(&empty[(k - 1) % STAGES]);

      if (k < n_mine) {
        // dS in registers; masks only where a key can lie in a query's
        // future or a row or column past the tensors.
        const int j0 = k * BKV;
        const bool edge =
            (causal && q_offset + q0 + wg * 64 < j0 + BKV - 1) ||
            q0 + wg * 64 + 64 > Sq || j0 + BKV > Skv;
        if (edge)
          grads<true, BKV / 2>(sc, dp, lrow, drow, j0, rule);
        else
          grads<false, BKV / 2>(sc, dp, lrow, drow, j0, rule);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
          for (int f = 0; f < 4; ++f)
            da[kk][f] = sm90::pack_bf16(dp[8 * kk + 2 * f],
                                        dp[8 * kk + 2 * f + 1]);
        }
      }
    }
    // The turns past this warpgroup's last tile: release the tiles.
    for (int k = n_issue; k <= n_tiles; ++k) {
      if (k < n_tiles) sm90::mbar_wait(&full[k % STAGES], (k / STAGES) & 1);
      sm90::bar_sync(mine, 2 * 128);
      if (wg == 0 || k < n_tiles) sm90::bar_arrive(theirs, 2 * 128);
      if (k >= 1 && lane == 0) sm90::mbar_arrive(&empty[(k - 1) % STAGES]);
    }

    // dQ, rounded once.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row + 8 * i;
      if (qi < Sq) {
        bf16* out = dq + (size_t(bh) * Sq + qi) * D + rule.col2;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int H, int KH, int Sq, int Skv,
                   int causal, int q_offset, float sm_scale, int has_softcap,
                   float softcap, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, domap;
  if (!sm90::map_tiles(&qmap, q, B * H, Sq, D, BQ) ||
      !sm90::map_tiles(&domap, dout, B * H, Sq, D, BQ) ||
      !sm90::map_tiles(&kmap, k, B * KH, Skv, D, BKV) ||
      !sm90::map_tiles(&vmap, v, B * KH, Skv, D, BKV))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Smem<D>::total;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      qmap, kmap, vmap, domap, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, KH, Sq,
      Skv, causal, q_offset, sm_scale, has_softcap, softcap);
  return cudaGetLastError();
}

}  // namespace dq

}  // namespace

extern "C" int flash_bwd_dkdv_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int KH,
                                   int Sq, int Skv, int D, int causal,
                                   int q_offset, float sm_scale,
                                   int has_softcap, float softcap,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dkdv::launch<64>(q, k, v, dout, lse, delta, dk, dv, B, H, KH, Sq,
                             Skv, causal, q_offset, sm_scale, has_softcap,
                             softcap, s);
    case 128:
      return dkdv::launch<128>(q, k, v, dout, lse, delta, dk, dv, B, H, KH,
                              Sq, Skv, causal, q_offset, sm_scale,
                              has_softcap, softcap, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq_out, int B, int H,
                                 int KH, int Sq, int Skv, int D, int causal,
                                 int q_offset, float sm_scale,
                                 int has_softcap, float softcap,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dq::launch<64>(q, k, v, dout, lse, delta, dq_out, B, H, KH, Sq,
                            Skv, causal, q_offset, sm_scale, has_softcap,
                            softcap, s);
    case 128:
      return dq::launch<128>(q, k, v, dout, lse, delta, dq_out, B, H, KH, Sq,
                             Skv, causal, q_offset, sm_scale, has_softcap,
                             softcap, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
