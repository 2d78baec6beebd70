// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 statistics.
//
// Replaces: kubeflow_tpu/ops/flash_attention.py, `_flash_fwd` (the
// `pl.pallas_call` of `_fwd_kernel`): online-softmax attention with GQA,
// causal masking at a static `q_offset`, tanh logit softcap and `sm_scale`;
// rows that attend to nothing (l == 0) are written as 0, and the per-row
// log-sum-exp `lse = m + log(l)` is written beside the output. A row that
// sees no key (q_offset + row < 0) has every logit at the finite NEG_INF:
// it averages V over all Skv keys and its lse is NEG_INF, as in the JAX
// package's plain attention (`multi_head_attention`) and `flash_ref`. (The
// TPU kernel averages over the kv blocks its q block visits, which is all
// of them when one block holds the whole length.)
//
// Bound on an H100 SXM: operations. A causal prefill at S = 2048, H = 32,
// D = 128 does ~34 GFLOP of QK^T and PV against ~34 MB of Q/K/V/O traffic,
// ~1000 FLOP per byte -- well above the card's ~295 FLOP/byte ridge, so the
// tensor cores set the floor (~35 us at 989 bf16 TFLOP/s).
//
// Design (the warp-specialised shape of FlashAttention-3): one block per
// (batch x q head, 128-row q tile), three warpgroups.
//  - Producer (warpgroup 2, setmaxnreg 40; one of its threads): TMA loads
//    the Q tile once and the 128-row K and V tiles into a 2-stage ring,
//    each stage with a "full" mbarrier (TMA bytes) and an "empty" one (one
//    arrival per consumer warp).
//  - Consumers (warpgroups 0 and 1, setmaxnreg 232), 64 query rows each:
//    S = Q K^T by wgmma SS (m64n128k16, both K-major); the online softmax
//    on the accumulator fragment in registers (each thread holds two rows,
//    a row's max reduced over the 4 threads of a quad, its sum kept per
//    thread and reduced once at the end; exp2 with log2(e) folded into the
//    scale); P rounded to bf16 in registers and fed as the A operand of
//    wgmma RS for O += P V, V read MN-major (transpose bit). O stays in
//    registers; masks are applied only on the diagonal and ragged tiles.
//  - Shared memory per block: Q 32 KB + 2 x (K 32 KB + V 32 KB) at D = 128
//    (160 KB, one block per SM); 16 + 2 x 32 = 80 KB at D = 64, with the
//    same 128 x 128 tiles.
//  - Schedule: the grid's slow axis walks q tiles from the last (which sees
//    every kv tile under the causal mask) to the first, so the heaviest
//    blocks start first and the light ones fill the tail.
// Tiles wholly above the causal diagonal are never loaded, except by a
// block that holds rows that see no key. The tile layouts and descriptors
// are those of sm90.cuh.
//
// Layout: q [B, H, Sq, D], k/v [B, KH, Skv, D], o [B, H, Sq, D] (all bf16,
// contiguous, 16-byte aligned), lse [B, H, Sq] fp32. q-head h reads kv-head
// h / (H / KH). TMA reads each tensor as [planes, rows, D], so a ragged
// tile is filled with zeros, not the next head's rows, and masked here.

#include <cfloat>
#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;        // query rows per block
constexpr int BKV = 128;       // kv rows per tile
constexpr int STAGES = 2;      // K/V ring depth
constexpr int CONSUMERS = 2;   // warpgroups of 64 query rows
constexpr int THREADS = (CONSUMERS + 1) * 128;
// The masked-logit value of kubeflow_tpu/ops/attention.py (NEG_INF): a
// finite value, so a row masked in every column of a tile behaves exactly
// as the TPU kernel's (exp(NEG_INF - NEG_INF) = 1).
constexpr float NEG_INF = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr uint32_t q_bytes = BQ * D * 2;
  static constexpr uint32_t kv_bytes = BKV * D * 2;
  static constexpr size_t k = q_bytes;
  static constexpr size_t v = k + STAGES * kv_bytes;
  static constexpr size_t bars = v + STAGES * kv_bytes;
  // q_full, full[STAGES], empty[STAGES]; 1 KB of slack to align the base.
  static constexpr size_t total = bars + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 bf16* __restrict__ o, float* __restrict__ lse, int H, int KH,
                 int Sq, int Skv, int causal, int q_offset, float sm_scale,
                 int has_softcap, float softcap) {
  using S = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Qs = reinterpret_cast<bf16*>(smem);
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
    // of every row of this block.
    const int last_pos = q_offset + q0 + BQ - 1;
    n_tiles = last_pos < 0 ? 0 : min(n_kv, last_pos / BKV + 1);
    // A block whose first row sees no key sweeps every tile: such a row's
    // logits are all the finite NEG_INF, so it averages V over all Skv
    // keys, as the plain attention does; a row that sees keys gets exactly
    // 0 from the tiles past its diagonal.
    if (q_offset + q0 < 0) n_tiles = n_kv;
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
    // ---- producer --------------------------------------------------------
    sm90::regs_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      sm90::prefetch_map(&qmap);
      sm90::prefetch_map(&kmap);
      sm90::prefetch_map(&vmap);
      sm90::mbar_expect_tx(q_full, S::q_bytes);
      for (int half = 0; half < D / 64; ++half)
        sm90::tma_load_3d(Qs + half * BQ * 64, &qmap, q_full, half * 64, q0,
                          bh);
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
    sm90::regs_alloc<232>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row = q0 + wg * 64 + (tid / 32) * 16 + lane / 4;   // i = 0
    const int col2 = 2 * (lane % 4);
    // Logits in log2 units: x2 = s * sm_scale * log2(e) (softcap: the
    // capped natural logit times log2(e)).
    const float scale2 = has_softcap ? sm_scale / softcap : sm_scale * LOG2E;
    const float cap2 = softcap * LOG2E;

    float acc[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};

    sm90::mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int j0 = t * BKV;
      sm90::mbar_wait(&full[s], (t / STAGES) & 1);
      const bf16* kt = Ks + s * BKV * D;
      const bf16* vt = Vs + s * BKV * D;

      // S = Q K^T: this warpgroup's 64 rows against the tile's 128 keys.
      float sc[BKV / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int half = kk / 4, step = (kk % 4) * 16;
        const uint64_t da = sm90::smem_desc(
            Qs + half * BQ * 64 + wg * 64 * 64 + step, 16, 1024);
        const uint64_t db =
            sm90::smem_desc(kt + half * BKV * 64 + step, 16, 1024);
        sm90::wgmma_ss<BKV, 0>(sc, da, db, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      if (has_softcap) {
#pragma unroll
        for (int r = 0; r < BKV / 2; ++r) sc[r] = tanhf(sc[r] * scale2) * cap2;
      } else {
#pragma unroll
        for (int r = 0; r < BKV / 2; ++r) sc[r] *= scale2;
      }
      // Masks only where a column can lie in a row's future or past Skv.
      const bool diag = causal && j0 + BKV - 1 > q_offset + q0 + wg * 64;
      if (diag || j0 + BKV > Skv) {
#pragma unroll
        for (int r = 0; r < BKV / 2; ++r) {
          const int kpos = j0 + 8 * (r / 4) + col2 + (r % 2);
          const int qpos = q_offset + row + 8 * ((r / 2) % 2);
          if (causal && kpos > qpos) sc[r] = NEG_INF;
          if (kpos >= Skv) sc[r] = -INFINITY;    // ragged edge: no weight
        }
      }

      // Online softmax on the fragment: row i of this thread is registers
      // 4j + 2i + {0, 1}; the quad (lane ^ 1, lane ^ 2) shares the row.
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[i] = exp2f(m[i] - mx);
        m[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[4 * j + 2 * i + e] - mx);
            sc[4 * j + 2 * i + e] = p;
            sum += p;
          }
        }
        l[i] = l[i] * alpha[i] + sum;
      }
#pragma unroll
      for (int r = 0; r < D / 2; ++r) acc[r] *= alpha[(r / 2) % 2];

      // O += P V: P as bf16 A fragments straight from the score registers.
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int k = 0; k < BKV / 16; ++k) {
#pragma unroll
        for (int f = 0; f < 4; ++f)
          pa[k][f] = sm90::pack_bf16(sc[8 * k + 2 * f], sc[8 * k + 2 * f + 1]);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < BKV / 16; ++k) {
        const uint64_t db =
            sm90::smem_desc(vt + k * 16 * 64, BKV * 128, 1024);
        sm90::wgmma_rs<D, 1>(acc, pa[k], db, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
#pragma unroll
      for (int k = 0; k < BKV / 16; ++k) sm90::fence_regs(pa[k]);
      if (lane == 0) sm90::mbar_arrive(&empty[s]);   // stage s is free
    }

    // o = O / l (l == 0 -> 0), lse = m + log(l), m back in natural units.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float safe = sum == 0.f ? 1.f : sum;
      const int qi = row + 8 * i;
      if (qi < Sq) {
        bf16* orow = o + (size_t(bh) * Sq + qi) * D + col2;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i] / safe,
                                    acc[4 * j + 2 * i + 1] / safe);
        }
        if (lane % 4 == 0) {
          const float m_nat = m[i] == NEG_INF ? NEG_INF : m[i] * LN2;
          lse[size_t(bh) * Sq + qi] = m_nat + logf(safe);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int KH, int Sq, int Skv,
                   int causal, int q_offset, float sm_scale, int has_softcap,
                   float softcap, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!sm90::map_tiles(&qmap, q, B * H, Sq, D, BQ) ||
      !sm90::map_tiles(&kmap, k, B * KH, Skv, D, BKV) ||
      !sm90::map_tiles(&vmap, v, B * KH, Skv, D, BKV))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Smem<D>::total;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), static_cast<float*>(lse), H,
      KH, Sq, Skv, causal, q_offset, sm_scale, has_softcap, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int KH,
                              int Sq, int Skv, int D, int causal,
                              int q_offset, float sm_scale, int has_softcap,
                              float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, KH, Sq, Skv, causal, q_offset,
                        sm_scale, has_softcap, softcap, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, KH, Sq, Skv, causal,
                         q_offset, sm_scale, has_softcap, softcap, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
