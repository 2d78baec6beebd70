// Fused output projection + softmax cross-entropy for Hopper (sm_90a),
// forward and backward, bf16 in, fp32 accumulation and statistics.
//
// Replaces: kubeflow_tpu/ops/fused_xent.py --
//   `_xent_fwd`'s `pl.pallas_call` (`_fwd_kernel`): vocab-tiled h @ W with
//     running max / sum-exp / picked target logit / lowest-index argmax, the
//     optional tanh softcap; emits nll, lse and correct per row;
//   `_xent_bwd`'s two `pl.pallas_call` sites (`_bwd_dh_kernel`: d_hidden =
//     sum_v dl W^T, and `_bwd_dw_kernel`: d_head = sum_t h^T dl), each
//     recomputing the logits tile and dl = (exp(s - lse) - onehot) * g
//     [* (1 - (s/c)^2) with softcap] (`_dlogits`).
// [T, V] logits never exist in device memory, forward or backward.
//
// Layouts: h [T, D] bf16 row-major; W [D, V] bf16 row-major (the JAX
// layout of `lm_head`; a tied head, `embed.T`, is made contiguous by the
// caller); targets int32 [T]; lse, g (the nll cotangent) fp32 [T]. D and V
// are multiples of 8 (16-byte rows for TMA and for the epilogues' 16-byte
// stores); T is free. The ragged edges -- rows past T, columns past D and
// V -- are zero-filled by TMA and masked here: a column >= V never enters
// max, sum-exp or argmax, and is never written. A target outside [0, V)
// picks nothing (nll = lse), as in the TPU kernel.
//
// Bound on an H100 SXM: operations. One pass of 2 T D V (4.30 TFLOP at
// T = 4096, D = 4096, V = 128256) takes ~4.35 ms at 989 bf16 TFLOP/s; the
// bytes (W once, 1.05 GB, ~0.31 ms) are far below. The forward is one pass,
// and so is each of the backward's three kernels: the dl recompute, the
// d_hidden product and the d_head product (4.351 ms each at that shape).
// The TPU backward is four (each of its two kernels recomputes the logits
// and does one product); this backward is three: per vocab chunk of
// `vchunk` columns (16384 from ops/fused_xent.py) it recomputes the logits
// once and writes that chunk's dl (bf16, [T, vchunk], 134 MB at T = 4096)
// to scratch, then runs the two products from it.
//
// Design. The forward (`xent_fwd`), the dl recompute (`xent_dl`), the
// d_hidden product (`xent_dh`) and the d_head product (`xent_dw`) share one
// warp-specialised wgmma core:
//  - a block of three warpgroups and one block per SM: a producer
//    (setmaxnreg 40; one of its threads issues TMA) and two consumers
//    (setmaxnreg 232) of 64 output rows each;
//  - output tiles of 128 x 256, K in steps of 64 through a 4-stage ring of
//    A (128 x 64, 16 KB) and B (64 x 256, 32 KB) with full and empty
//    mbarriers (192 KB); each consumer issues four m64n256k16 wgmmas per
//    step (SS, 128 fp32 accumulators per thread) and keeps one step in
//    flight;
//  - operands through 2-D tensor maps (sm90.cuh, 128-byte swizzle): h and
//    dl K-major as A of s = h W and dh = dl W^T; W MN-major (transpose bit)
//    as B of s = h W; W K-major as B of dh = dl W^T, its rows of D read
//    along the chunk's vocab. d_head = h^T dl reduces along T, so both of
//    its operands are MN-major (both transpose bits): A = h^T from h in
//    boxes of 64 D columns by 64 T rows, one per consumer, and B = dl from
//    the scratch, as W is read for the forward. W and dl are mapped per
//    chunk, so TMA zero-fills past V and past the chunk;
//  - the producer runs the ring across tile boundaries, so the next tile's
//    first steps load under this tile's epilogue.
//  - forward: the TPU grid walks the vocab in order and carries its
//    statistics in VMEM. Here T = 4096 gives only 32 row tiles, so each
//    block takes one row tile and one range of vocab tiles (the caller
//    sizes the ranges to fill the SMs at the occupancy that
//    `fused_xent_fwd_blocks_per_sm` reports), walks its tiles in order
//    and keeps the row statistics in the consumer threads' registers, on
//    the accumulator fragment (a row sits on the four threads of a quad);
//    exp runs in base 2 with log2(e) folded in. It writes the statistics
//    as partials, and a second kernel combines the ranges per row in index
//    order. The lowest column among a tile's equal maxima (a min over the
//    quad), and strict `>` across tiles and across ranges, keep
//    jnp.argmax's rule: the lowest index among equal maxima.
//  - backward, per chunk: `xent_dl` forms dl in fp32 on the fragment (lse,
//    g and the target loaded once per row), rounds it to bf16 where the TPU
//    kernels cast it, and writes it to the scratch through a per-warp
//    staging buffer in 16-byte rows; `xent_dh` adds dl W_c^T into an fp32
//    [T, D] accumulator (chunk 0 writes it without reading; the last chunk
//    writes bf16 dh through the staging buffer). Both walk their tiles as
//    a persistent grid, one block per SM, in groups of 16 row tiles, so
//    the blocks that run together share h or dl rows and W columns in L2.
//    `xent_dw` writes dW_c [D, vc] = h^T dl in tiles of 128 rows of D by
//    256 chunk columns on the same grid, the whole T sweep in one
//    accumulator, and casts it to bf16 through the staging buffer once.
//    One block owns each output tile and chunks run in order, so every sum
//    is deterministic; no split-K and no atomics anywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// -- the warp-specialised wgmma core ------------------------------------------

constexpr int TM = 128, TN = 256, TK = 64;     // output tile, K step
constexpr int RING = 4;                        // TMA ring depth
constexpr int CONSUMERS = 2;                   // warpgroups of 64 rows
constexpr int WG_THREADS = (CONSUMERS + 1) * 128;
constexpr int GROUP_M = 16;                    // row tiles per raster group
constexpr uint32_t A_BYTES = TM * TK * 2;      // 16 KB
constexpr uint32_t B_BYTES = TK * TN * 2;      // 32 KB
constexpr uint32_t BOX_BYTES = TK * 64 * 2;    // one MN-major 64 x 64 box
// A warp's bf16 staging block: 16 rows of 64 columns, rows padded by 16
// bytes so the fragment's writes and the 16-byte row reads are free of
// bank conflicts.
constexpr int OUT_LD = 72;
constexpr int OUT_WARP = 16 * OUT_LD;
constexpr size_t SM_A = 0;
constexpr size_t SM_B = SM_A + RING * A_BYTES;
constexpr size_t SM_OUT = SM_B + RING * B_BYTES;
constexpr size_t SM_BARS = SM_OUT + CONSUMERS * 4 * OUT_WARP * sizeof(bf16);
// full[RING], empty[RING]; 1 KB of slack to align the base for the swizzle.
constexpr size_t SMEM_WG = SM_BARS + 2 * RING * 8 + 1024;
constexpr float LOG2E = 1.4426950408889634f;

DEV unsigned char* align_1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

DEV void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS * 4);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
}

// Work tile `tile` of an n_m x n_n grid in grouped order: GROUP_M row
// tiles at a time, column by column, so the blocks that run at once share
// their A rows and B columns in L2.
DEV void tile_at(int tile, int n_m, int n_n, int& m, int& n) {
  const int per_group = GROUP_M * n_n;
  const int first = (tile / per_group) * GROUP_M;
  const int rows = min(GROUP_M, n_m - first);
  const int in = tile % per_group;
  m = first + in % rows;
  n = in / rows;
}

// Producer: K step kb of the output tile at (m0, n0) into ring step `it`.
// A_MN: A is [K, M] read MN-major, one box of 64 x 64 per consumer;
// otherwise [M, K] read K-major, one box of 128 rows. B_MN: B is [K, N]
// read MN-major, four boxes of 64 x 64; otherwise [N, K] read K-major, one
// box of 256 rows. Either way consumer c's 64 rows of A start c x 8 KB
// into the stage.
template <bool A_MN, bool B_MN>
DEV void load_step(unsigned char* smem, uint64_t* full, uint64_t* empty,
                   uint32_t it, const CUtensorMap* amap,
                   const CUtensorMap* bmap, int m0, int n0, int kb) {
  const int s = it % RING;
  if (it >= RING) sm90::mbar_wait(&empty[s], ((it / RING) - 1) & 1);
  sm90::mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
  unsigned char* a = smem + SM_A + s * A_BYTES;
  if (A_MN) {
#pragma unroll
    for (int c = 0; c < CONSUMERS; ++c)
      sm90::tma_load_2d(a + c * BOX_BYTES, amap, &full[s], m0 + 64 * c,
                        kb * TK);
  } else {
    sm90::tma_load_2d(a, amap, &full[s], kb * TK, m0);
  }
  unsigned char* b = smem + SM_B + s * B_BYTES;
  if (B_MN) {
#pragma unroll
    for (int q = 0; q < TN / 64; ++q)
      sm90::tma_load_2d(b + q * BOX_BYTES, bmap, &full[s], n0 + 64 * q,
                        kb * TK);
  } else {
    sm90::tma_load_2d(b, bmap, &full[s], kb * TK, n0);
  }
}

// Consumer warpgroup `wg`: acc (its 64 x 256 fp32 fragment) = A B over nk
// K steps from ring step `it` on. One step's products stay in flight while
// the next is issued; a step's slot is released once its products are done.
// No other instruction touches acc until the last wait.
template <bool A_MN, bool B_MN>
DEV void mainloop(float (&acc)[TN / 2], unsigned char* smem, uint64_t* full,
                  uint64_t* empty, int wg, int nk, uint32_t& it, int lane) {
  for (int kb = 0; kb < nk; ++kb, ++it) {
    const int s = it % RING;
    sm90::mbar_wait(&full[s], (it / RING) & 1);
    const bf16* a = reinterpret_cast<const bf16*>(smem + SM_A + s * A_BYTES)
                    + wg * 64 * 64;
    const bf16* b = reinterpret_cast<const bf16*>(smem + SM_B + s * B_BYTES);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint64_t da =
          A_MN ? sm90::smem_desc(a + kk * 16 * 64, BOX_BYTES, 1024)
               : sm90::smem_desc(a + kk * 16, 16, 1024);
      const uint64_t db =
          B_MN ? sm90::smem_desc(b + kk * 16 * 64, BOX_BYTES, 1024)
               : sm90::smem_desc(b + kk * 16, 16, 1024);
      sm90::wgmma_ss<TN, B_MN ? 1 : 0, A_MN ? 1 : 0>(acc, da, db,
                                                     kb > 0 || kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (kb > 0 && lane == 0) sm90::mbar_arrive(&empty[(it - 1) % RING]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  if (lane == 0) sm90::mbar_arrive(&empty[(it - 1) % RING]);
}

// A warp's staged 16 x 64 bf16 block `st` to out[row0 + r][col0 + c] (row
// stride ld) in 16-byte vectors, rows below `rows` and columns below
// `cols` only (cols is a multiple of 8).
DEV void flush_stage(const bf16* st, bf16* out, size_t ld, int row0,
                     int rows, int col0, int cols, int lane) {
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int v = lane + 32 * k;
    const int r = v / 8, col = col0 + 8 * (v % 8);
    if (row0 + r < rows && col < cols)
      *reinterpret_cast<uint4*>(out + size_t(row0 + r) * ld + col) =
          *reinterpret_cast<const uint4*>(st + r * OUT_LD + 8 * (v % 8));
  }
  __syncwarp();
}

DEV float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(~0u, v, 1));
  return fmaxf(v, __shfl_xor_sync(~0u, v, 2));
}
DEV float quad_sum(float v) {
  v += __shfl_xor_sync(~0u, v, 1);
  return v + __shfl_xor_sync(~0u, v, 2);
}
DEV int quad_min(int v) {
  v = min(v, __shfl_xor_sync(~0u, v, 1));
  return min(v, __shfl_xor_sync(~0u, v, 2));
}

DEV float capped(float s, int has_softcap, float softcap) {
  return has_softcap ? tanhf(s / softcap) * softcap : s;
}

// Forward partials: block (row tile, vocab range). Partials are laid out
// [range][T]: pm (max, which is also the best value), pl (sum-exp at pm),
// pp (picked), pi (best index).
__global__ void __launch_bounds__(WG_THREADS, 1)
xent_fwd_kernel(const __grid_constant__ CUtensorMap hmap,
                const __grid_constant__ CUtensorMap wmap,
                const int* __restrict__ tgt, float* __restrict__ pm,
                float* __restrict__ pl, float* __restrict__ pp,
                int* __restrict__ pi, int T, int D, int V, int n_tiles,
                int tiles_per_range, int has_softcap, float softcap) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM_BARS);
  uint64_t* empty = full + RING;
  const int m0 = blockIdx.x * TM;
  const int range = blockIdx.y;
  const int t_begin = range * tiles_per_range;
  const int t_end = min(n_tiles, t_begin + tiles_per_range);
  const int nk = (D + TK - 1) / TK;
  init_ring(full, empty);

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer --------------------------------------------------------
    sm90::regs_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      sm90::prefetch_map(&hmap);
      sm90::prefetch_map(&wmap);
      uint32_t it = 0;
      for (int tile = t_begin; tile < t_end; ++tile)
        for (int kb = 0; kb < nk; ++kb, ++it)
          load_step<false, true>(smem, full, empty, it, &hmap, &wmap, m0,
                                 tile * TN, kb);
    }
    return;
  }
  // ---- consumers: 64 rows each; a thread holds rows r0 and r0 + 8 --------
  sm90::regs_alloc<232>();
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r0 = m0 + wg * 64 + (tid / 32) * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  int tg[2], arg[2] = {0, 0};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, pk[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = r0 + 8 * i < T ? tgt[r0 + 8 * i] : -1;
    tg[i] = t >= 0 && t < V ? t : -1;          // outside [0, V): no pick
  }
  float acc[TN / 2];
#pragma unroll
  for (int r = 0; r < TN / 2; ++r) acc[r] = 0.f;
  uint32_t it = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * TN;
    mainloop<false, true>(acc, smem, full, empty, wg, nk, it, lane);
    if (has_softcap) {
#pragma unroll
      for (int r = 0; r < TN / 2; ++r) acc[r] = tanhf(acc[r] / softcap) * softcap;
    }
    if (n0 + TN > V) {                         // the ragged last tile
#pragma unroll
      for (int r = 0; r < TN / 2; ++r)
        if (n0 + 8 * (r / 4) + c2 + (r % 2) >= V) acc[r] = -INFINITY;
    }
    // Register 4 j + 2 i + e is row i, column n0 + 8 j + c2 + e.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
        tmax = fmaxf(tmax, fmaxf(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]));
      tmax = quad_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      const float mb = m_new * LOG2E;
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          se += exp2f(fmaf(acc[4 * j + 2 * i + e], LOG2E, -mb));
      l[i] = (m[i] == m_new ? l[i] : l[i] * exp2f(fmaf(m[i], LOG2E, -mb)))
             + se;
      // A new best value (strict: an earlier tile keeps a tie): its lowest
      // column. Warp-uniform, so the quad's shuffles run converged.
      if (__any_sync(~0u, tmax > m[i])) {
        int a = INT_MAX;
#pragma unroll
        for (int j = TN / 8 - 1; j >= 0; --j)
#pragma unroll
          for (int e = 1; e >= 0; --e)
            a = acc[4 * j + 2 * i + e] == tmax ? n0 + 8 * j + c2 + e : a;
        a = quad_min(a);
        if (tmax > m[i]) arg[i] = a;
      }
      m[i] = m_new;
      if (unsigned(tg[i] - n0) < unsigned(TN)) {   // the target's tile
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n0 + 8 * j + c2 + e == tg[i]) pk[i] = acc[4 * j + 2 * i + e];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    const float pick = quad_sum(pk[i]);        // one thread holds it
    const int row = r0 + 8 * i;
    if (lane % 4 == 0 && row < T) {
      const size_t o = size_t(range) * T + row;
      pm[o] = m[i];
      pl[o] = lsum;
      pp[o] = pick;
      pi[o] = arg[i];
    }
  }
}

// Combine the ranges of each row in index order.
__global__ void xent_combine_kernel(const float* __restrict__ pm,
                                    const float* __restrict__ pl,
                                    const float* __restrict__ pp,
                                    const int* __restrict__ pi,
                                    const int* __restrict__ tgt,
                                    float* __restrict__ nll,
                                    float* __restrict__ lse,
                                    float* __restrict__ correct, int T,
                                    int n_ranges) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= T) return;
  float m = -INFINITY;
  for (int r = 0; r < n_ranges; ++r) m = fmaxf(m, pm[size_t(r) * T + row]);
  float l = 0.f, picked = 0.f, best = -INFINITY;
  int arg = 0;
  for (int r = 0; r < n_ranges; ++r) {
    const size_t o = size_t(r) * T + row;
    l += pl[o] * expf(pm[o] - m);
    picked += pp[o];
    if (pm[o] > best) {              // strict: an earlier range keeps a tie
      best = pm[o];
      arg = pi[o];
    }
  }
  const float z = m + logf(l);
  lse[row] = z;
  nll[row] = z - picked;
  correct[row] = arg == tgt[row] ? 1.f : 0.f;
}

// This chunk's dl, rounded to bf16, into the scratch [T, ldc]: output
// tiles of 128 rows x 256 chunk columns (columns c0 + n0 .. of the vocab;
// those past `vc` are not written), walked as a persistent grid.
__global__ void __launch_bounds__(WG_THREADS, 1)
xent_dl_kernel(const __grid_constant__ CUtensorMap hmap,
               const __grid_constant__ CUtensorMap wmap,
               const int* __restrict__ tgt, const float* __restrict__ lse,
               const float* __restrict__ g, bf16* __restrict__ dl, int T,
               int D, int c0, int vc, int ldc, int has_softcap,
               float softcap) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM_BARS);
  uint64_t* empty = full + RING;
  const int n_m = (T + TM - 1) / TM, n_n = (vc + TN - 1) / TN;
  const int n_work = n_m * n_n;
  const int nk = (D + TK - 1) / TK;
  init_ring(full, empty);

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    sm90::regs_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      sm90::prefetch_map(&hmap);
      sm90::prefetch_map(&wmap);
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
        int mt, nt;
        tile_at(tile, n_m, n_n, mt, nt);
        for (int kb = 0; kb < nk; ++kb, ++it)
          load_step<false, true>(smem, full, empty, it, &hmap, &wmap,
                                 mt * TM, nt * TN, kb);
      }
    }
    return;
  }
  sm90::regs_alloc<232>();
  const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
  const int c2 = 2 * (lane % 4);
  bf16* st = reinterpret_cast<bf16*>(smem + SM_OUT) + (wg * 4 + warp) * OUT_WARP;
  float acc[TN / 2];
#pragma unroll
  for (int r = 0; r < TN / 2; ++r) acc[r] = 0.f;
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
    int mt, nt;
    tile_at(tile, n_m, n_n, mt, nt);
    const int n0 = nt * TN;
    const int w0 = mt * TM + wg * 64 + warp * 16;     // this warp's rows
    const int r0 = w0 + lane / 4;
    mainloop<false, true>(acc, smem, full, empty, wg, nk, it, lane);
    // Per row, once: lse in log2 units, the cotangent, the target's column
    // within this tile.
    float lse2[2], gr[2];
    int tl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      const bool ok = row < T;
      lse2[i] = ok ? lse[row] * LOG2E : 0.f;
      gr[i] = ok ? g[row] : 0.f;
      tl[i] = ok ? tgt[row] - c0 - n0 : -1;
    }
#pragma unroll
    for (int q = 0; q < TN / 64; ++q) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * q + jj;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s = capped(acc[4 * j + 2 * i + e], has_softcap,
                                   softcap);
            const float p = exp2f(fmaf(s, LOG2E, -lse2[i]));
            float d = (p - (8 * j + c2 + e == tl[i] ? 1.f : 0.f)) * gr[i];
            if (has_softcap) {
              const float c = s / softcap;
              d *= 1.f - c * c;
            }
            v[e] = d;
          }
          *reinterpret_cast<uint32_t*>(st + (lane / 4 + 8 * i) * OUT_LD +
                                       8 * jj + c2) =
              sm90::pack_bf16(v[0], v[1]);
        }
      }
      flush_stage(st, dl, size_t(ldc), w0, T, n0 + 64 * q, vc, lane);
    }
  }
}

// dh (+)= dl[T, vc] W[:, c0:c0+vc]^T: output tiles of 128 rows x 256
// columns of D, walked as a persistent grid. `first`: the fp32
// accumulator starts from 0 (written, not read); `last`: write bf16 dh
// instead of it.
__global__ void __launch_bounds__(WG_THREADS, 1)
xent_dh_kernel(const __grid_constant__ CUtensorMap dlmap,
               const __grid_constant__ CUtensorMap wmap,
               float* __restrict__ accum, bf16* __restrict__ dh, int T,
               int D, int vc, int first, int last) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM_BARS);
  uint64_t* empty = full + RING;
  const int n_m = (T + TM - 1) / TM, n_n = (D + TN - 1) / TN;
  const int n_work = n_m * n_n;
  const int nk = (vc + TK - 1) / TK;
  init_ring(full, empty);

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    sm90::regs_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      sm90::prefetch_map(&dlmap);
      sm90::prefetch_map(&wmap);
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
        int mt, nt;
        tile_at(tile, n_m, n_n, mt, nt);
        for (int kb = 0; kb < nk; ++kb, ++it)
          load_step<false, false>(smem, full, empty, it, &dlmap, &wmap,
                                  mt * TM, nt * TN, kb);
      }
    }
    return;
  }
  sm90::regs_alloc<232>();
  const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
  const int c2 = 2 * (lane % 4);
  bf16* st = reinterpret_cast<bf16*>(smem + SM_OUT) + (wg * 4 + warp) * OUT_WARP;
  float acc[TN / 2];
#pragma unroll
  for (int r = 0; r < TN / 2; ++r) acc[r] = 0.f;
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
    int mt, nt;
    tile_at(tile, n_m, n_n, mt, nt);
    const int n0 = nt * TN;
    const int w0 = mt * TM + wg * 64 + warp * 16;
    const int r0 = w0 + lane / 4;
    mainloop<false, false>(acc, smem, full, empty, wg, nk, it, lane);
    if (!last) {
      // fp32 pairs straight from the fragment: a quad writes 32 bytes.
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + 8 * i, col = n0 + 8 * j + c2;
          if (row < T && col < D) {
            float2* p = reinterpret_cast<float2*>(accum + size_t(row) * D +
                                                  col);
            float2 v = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
            if (!first) {
              const float2 o = *p;
              v.x += o.x;
              v.y += o.y;
            }
            *p = v;
          }
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < TN / 64; ++q) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * q + jj;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = r0 + 8 * i, col = n0 + 8 * j + c2;
            float2 v = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
            if (!first && row < T && col < D) {
              const float2 o = *reinterpret_cast<const float2*>(
                  accum + size_t(row) * D + col);
              v.x += o.x;
              v.y += o.y;
            }
            *reinterpret_cast<uint32_t*>(st + (lane / 4 + 8 * i) * OUT_LD +
                                         8 * jj + c2) =
                sm90::pack_bf16(v.x, v.y);
          }
        }
        flush_stage(st, dh, size_t(D), w0, T, n0 + 64 * q, D, lane);
      }
    }
  }
}

// dW[:, c0:c0+vc] = h^T dl_c over the whole T sweep (`dw` points at column
// c0; row stride V): output tiles of 128 rows of D x 256 chunk columns,
// walked as a persistent grid. Both operands are MN-major: A = h^T through
// `htmap` (h [T, D] in boxes of 64 D columns by 64 T rows) and B = dl_c
// through `dlmap` (the scratch in boxes of 64 x 64). TMA's zeros cover
// ragged T, D and chunk columns; rows past D and columns past vc are not
// written.
__global__ void __launch_bounds__(WG_THREADS, 1)
xent_dw_kernel(const __grid_constant__ CUtensorMap htmap,
               const __grid_constant__ CUtensorMap dlmap,
               bf16* __restrict__ dw, int T, int D, int V, int vc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM_BARS);
  uint64_t* empty = full + RING;
  const int n_m = (D + TM - 1) / TM, n_n = (vc + TN - 1) / TN;
  const int n_work = n_m * n_n;
  const int nk = (T + TK - 1) / TK;
  init_ring(full, empty);

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    sm90::regs_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      sm90::prefetch_map(&htmap);
      sm90::prefetch_map(&dlmap);
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
        int mt, nt;
        tile_at(tile, n_m, n_n, mt, nt);
        for (int kb = 0; kb < nk; ++kb, ++it)
          load_step<true, true>(smem, full, empty, it, &htmap, &dlmap,
                                mt * TM, nt * TN, kb);
      }
    }
    return;
  }
  sm90::regs_alloc<232>();
  const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
  const int c2 = 2 * (lane % 4);
  bf16* st = reinterpret_cast<bf16*>(smem + SM_OUT) + (wg * 4 + warp) * OUT_WARP;
  float acc[TN / 2];
#pragma unroll
  for (int r = 0; r < TN / 2; ++r) acc[r] = 0.f;
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
    int mt, nt;
    tile_at(tile, n_m, n_n, mt, nt);
    const int n0 = nt * TN;
    const int w0 = mt * TM + wg * 64 + warp * 16;
    mainloop<true, true>(acc, smem, full, empty, wg, nk, it, lane);
#pragma unroll
    for (int q = 0; q < TN / 64; ++q) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * q + jj;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(st + (lane / 4 + 8 * i) * OUT_LD +
                                       8 * jj + c2) =
              sm90::pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
      flush_stage(st, dw, size_t(V), w0, D, n0 + 64 * q, vc, lane);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = allow_smem(xent_fwd_kernel, SMEM_WG);
  if (err == cudaSuccess) err = allow_smem(xent_dl_kernel, SMEM_WG);
  if (err == cudaSuccess) err = allow_smem(xent_dh_kernel, SMEM_WG);
  if (err == cudaSuccess) err = allow_smem(xent_dw_kernel, SMEM_WG);
  if (err == cudaSuccess) done = true;
  return err;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// SMs of the current device: the persistent kernels' grid.
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return n;
}

}  // namespace

// Blocks of the forward kernel that fit on one SM at once, as the runtime
// computes it from the kernel's registers and shared memory: the caller
// plans its vocab ranges in waves of this many blocks per SM.
extern "C" int fused_xent_fwd_blocks_per_sm(int* blocks) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, xent_fwd_kernel, WG_THREADS, SMEM_WG));
}

// Forward: nll, lse, correct [T] fp32. The partial buffers hold n_ranges
// x T entries each, with n_ranges = cdiv(cdiv(V, 256), tiles_per_range).
extern "C" int fused_xent_fwd_bf16(const void* h, const void* w,
                                   const void* tgt, void* pm, void* pl,
                                   void* pp, void* pi, void* nll, void* lse,
                                   void* correct, int T, int D, int V,
                                   int tiles_per_range, int has_softcap,
                                   float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  CUtensorMap hmap, wmap;
  if (!sm90::map_2d(&hmap, h, T, D, D, TM) ||
      !sm90::map_2d(&wmap, w, D, V, V, TK))
    return int(cudaErrorInvalidValue);
  const int n_tiles = cdiv(V, TN);
  const int n_ranges = cdiv(n_tiles, tiles_per_range);
  dim3 grid(cdiv(T, TM), n_ranges);
  xent_fwd_kernel<<<grid, WG_THREADS, SMEM_WG, s>>>(
      hmap, wmap, static_cast<const int*>(tgt), static_cast<float*>(pm),
      static_cast<float*>(pl), static_cast<float*>(pp), static_cast<int*>(pi),
      T, D, V, n_tiles, tiles_per_range, has_softcap, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  xent_combine_kernel<<<cdiv(T, 256), 256, 0, s>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<const float*>(pp), static_cast<const int*>(pi),
      static_cast<const int*>(tgt), static_cast<float*>(nll),
      static_cast<float*>(lse), static_cast<float*>(correct), T, n_ranges);
  return int(cudaGetLastError());
}

// Backward over vocab chunks of `vchunk` columns: dh [T, D] (bf16, through
// the fp32 accumulator `acc` [T, D] when there is more than one chunk) and
// dw [D, V] (bf16), both from each chunk's one dl recompute. `scratch`
// holds [T, vchunk] bf16.
extern "C" int fused_xent_bwd_bf16(const void* h, const void* w,
                                   const void* tgt, const void* lse,
                                   const void* g, void* dh, void* dw,
                                   void* scratch, void* acc, int T, int D,
                                   int V, int vchunk, int has_softcap,
                                   float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* dlb = static_cast<bf16*>(scratch);
  // h K-major (A of s = h W) and MN-major (A = h^T of d_head).
  CUtensorMap hmap, htmap;
  if (!sm90::map_2d(&hmap, h, T, D, D, TM) ||
      !sm90::map_2d(&htmap, h, T, D, D, TK))
    return int(cudaErrorInvalidValue);
  const int sms = sm_count();
  const int n_m = cdiv(T, TM);
  const int n_chunks = cdiv(V, vchunk);
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * vchunk;
    const int vc = V - c0 < vchunk ? V - c0 : vchunk;
    // This chunk's columns of W, read MN-major (B of s = h W_c) and
    // K-major (B of dh = dl W_c^T); its dl K-major (A of dh) and MN-major
    // (B of d_head). Each map ends at the chunk's last column, so TMA fills
    // zeros past it.
    CUtensorMap wmn, wk, dlmap, dlmn;
    if (!sm90::map_2d(&wmn, wb + c0, D, vc, V, TK) ||
        !sm90::map_2d(&wk, wb + c0, D, vc, V, TN) ||
        !sm90::map_2d(&dlmap, dlb, T, vc, vchunk, TM) ||
        !sm90::map_2d(&dlmn, dlb, T, vc, vchunk, TK))
      return int(cudaErrorInvalidValue);
    const int dl_tiles = n_m * cdiv(vc, TN);
    xent_dl_kernel<<<dl_tiles < sms ? dl_tiles : sms, WG_THREADS, SMEM_WG,
                     s>>>(hmap, wmn, static_cast<const int*>(tgt),
                          static_cast<const float*>(lse),
                          static_cast<const float*>(g), dlb, T, D, c0, vc,
                          vchunk, has_softcap, softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    const int dh_tiles = n_m * cdiv(D, TN);
    xent_dh_kernel<<<dh_tiles < sms ? dh_tiles : sms, WG_THREADS, SMEM_WG,
                     s>>>(dlmap, wk, static_cast<float*>(acc),
                          static_cast<bf16*>(dh), T, D, vc, c == 0,
                          c == n_chunks - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    const int dw_tiles = cdiv(D, TM) * cdiv(vc, TN);
    xent_dw_kernel<<<dw_tiles < sms ? dw_tiles : sms, WG_THREADS, SMEM_WG,
                     s>>>(htmap, dlmn, static_cast<bf16*>(dw) + c0, T, D, V,
                          vc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaSuccess);
}
