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
// What the design does about it: every product runs on the tensor cores
// (WMMA bf16 16x16x16 fragments, fp32 accumulation), tiles wholly above the
// causal diagonal are skipped, and the score, probability and accumulator
// tiles stay in shared memory, so device memory sees one read of each
// needed input tile per sweep and one write of each output. This is the
// simple correct design, not yet a fast one:
//  - dK/dV: one block per (batch, kv head, 64-row kv tile). It loops over
//    the H / KH query heads of its group and over every 64-row q tile at or
//    after the diagonal -- the loop takes the place of the TPU grid's
//    sequential (group, q block) axes -- and keeps the fp32 dK and dV
//    accumulators in shared memory for the whole sweep. Summing the group
//    inside the block is what makes dK and dV come out at the KH size with
//    no atomics: the result is deterministic.
//  - dQ: one block per (batch, q head, 64-row q tile), looping over the kv
//    tiles up to the diagonal, as the forward does.
// Four warps per block; in each q tile warp w computes the scores of query
// rows 16w..16w+15, and in the dK/dV products it owns kv rows 16w..16w+15
// of the accumulators. The transposed products (p^T dO, dS^T q) load their
// A operand with `wmma::col_major` from the row-major tiles. Shared-memory
// rows are padded by 16 bytes (bf16 and fp32 tiles alike) against bank
// conflicts, as in flash_fwd.cu. A block of the dK/dV kernel takes ~187 KB
// of shared memory at D = 128 (one block per SM), the dQ kernel ~144 KB.
// cp.async/TMA double buffering, wgmma and register-resident accumulators
// are later work.
//
// Layout: q, dO, dQ [B, H, Sq, D]; k, v, dK, dV [B, KH, Skv, D] (bf16,
// contiguous); lse, delta [B, H, Sq] fp32. q-head h reads kv-head
// h / (H / KH). Ragged edges (Sq or Skv not a multiple of 64) are masked in
// the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BKV = 64;       // kv rows per tile
constexpr int WARPS = 4;      // each warp owns 16 rows of a 64-row tile
constexpr int THREADS = WARPS * 32;
// The masked-logit value of kubeflow_tpu/ops/attention.py (NEG_INF).
constexpr float NEG_INF = -0.7f * FLT_MAX;

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Row strides (elements) of the shared-memory tiles: multiples of 8 bf16 /
// 4 floats (WMMA's rule), padded by 16 bytes.
template <int D>
struct Lay {
  static constexpr int LDQ = D + 8;              // q, dO, k, v tiles (bf16)
  static constexpr int LDS = BKV + 4;            // scores, dP (fp32)
  static constexpr int LDP = BKV + 8;            // p, dS (bf16)
  static constexpr int LDA = D + 4;              // accumulators (fp32)
  static constexpr size_t tile = size_t(64) * LDQ * sizeof(bf16);
  static constexpr size_t sc = size_t(BQ) * LDS * sizeof(float);
  static constexpr size_t pb = size_t(BQ) * LDP * sizeof(bf16);
  static constexpr size_t acc = size_t(64) * LDA * sizeof(float);
  static constexpr size_t rows = 2 * BQ * sizeof(float);   // lse, delta
  // dK/dV: k, v, q, dO tiles; s, dP; p, dS; dK, dV accumulators; lse, delta.
  static constexpr size_t dkdv = 4 * tile + 2 * sc + 2 * pb + 2 * acc + rows;
  // dQ: q, dO, k, v tiles; s, dP; dS; dQ accumulator; lse, delta.
  static constexpr size_t dq = 4 * tile + 2 * sc + pb + acc + rows;
};

// Copy `rows` x D bf16 rows (row-major, contiguous) into shared memory rows
// of stride LDQ with 16-byte vectors; rows past `valid` are zero-filled.
template <int D>
__device__ void load_tile(bf16* dst, const bf16* src, int rows, int valid) {
  constexpr int LDQ = Lay<D>::LDQ;
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  const int total = rows * PER_ROW;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + size_t(r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = val;
  }
}

// lse and delta of q rows q0..q0+63 (0 past Sq: such rows get p = 0).
__device__ void load_rows(float* lse_s, float* delta_s, const float* lse,
                          const float* delta, int q0, int Sq) {
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const bool ok = q0 + i < Sq;
    lse_s[i] = ok ? lse[q0 + i] : 0.f;
    delta_s[i] = ok ? delta[q0 + i] : 0.f;
  }
}

// This warp's 16 rows of C[16 x 64] = A[16 x D] B^T, with A rows at
// `a` (stride LDQ) and B rows at `b` (64 rows, stride LDQ), into `c`
// (stride LDS).
template <int D>
__device__ void rows_times_tile_t(float* c, const bf16* a, const bf16* b) {
  constexpr int LDQ = Lay<D>::LDQ, LDS = Lay<D>::LDS;
#pragma unroll
  for (int jt = 0; jt < BKV / 16; ++jt) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBT fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDQ);
      wmma::load_matrix_sync(fb, b + jt * 16 * LDQ + kk * 16, LDQ);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + jt * 16, acc, LDS, wmma::mem_row_major);
  }
}

// Scores and their gradient for this warp's 16 query rows (tile rows
// row0..row0+15) against kv columns j0..j0+63: p (bf16, when `pb` is set)
// and dS (bf16). Each lane owns two columns.
__device__ void probs_and_ds(const float* sb, const float* dpb, bf16* pb,
                             bf16* dsb, const float* lse_s,
                             const float* delta_s, int row0, int q0, int j0,
                             int Sq, int Skv, int causal, int q_offset,
                             float sm_scale, int has_softcap, float softcap,
                             int lds, int ldp) {
  const int lane = threadIdx.x % 32;
  for (int r = row0; r < row0 + 16; ++r) {
    const int qi = q0 + r;
    const float l = lse_s[r];
    const float dl = delta_s[r];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      const int kpos = j0 + c;
      const float s_raw = sb[r * lds + c] * sm_scale;
      float s = s_raw;
      float t = 0.f;
      if (has_softcap) {
        t = tanhf(s_raw / softcap);
        s = t * softcap;
      }
      if (causal && kpos > q_offset + qi) s = NEG_INF;
      float p = expf(s - l);
      if (s <= NEG_INF * 0.5f || qi >= Sq || kpos >= Skv) p = 0.f;
      float ds = p * (dpb[r * lds + c] - dl);
      if (has_softcap) ds *= (1.f - t * t);
      ds *= sm_scale;
      if (pb != nullptr) pb[r * ldp + c] = __float2bfloat16(p);
      dsb[r * ldp + c] = __float2bfloat16(ds);
    }
  }
}

// acc[16 rows at row0, D] += X^T Y, X [64 x 64] bf16 (stride LDP) read
// transposed, Y [64 x D] bf16 (stride LDQ): this warp's 16 accumulator rows
// are columns row0..row0+15 of X.
template <int D>
__device__ void acc_xt_y(float* acc, const bf16* x, const bf16* y, int row0) {
  constexpr int LDQ = Lay<D>::LDQ, LDP = Lay<D>::LDP, LDA = Lay<D>::LDA;
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    FragC c;
    wmma::load_matrix_sync(c, acc + row0 * LDA + dt * 16, LDA,
                           wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      FragAT fa;
      FragB fb;
      wmma::load_matrix_sync(fa, x + kk * 16 * LDP + row0, LDP);
      wmma::load_matrix_sync(fb, y + kk * 16 * LDQ + dt * 16, LDQ);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(acc + row0 * LDA + dt * 16, c, LDA,
                            wmma::mem_row_major);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int KH, int Sq, int Skv,
                      int causal, int q_offset, float sm_scale,
                      int has_softcap, float softcap) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Lay<D>;
  constexpr int LDQ = L::LDQ, LDS = L::LDS, LDP = L::LDP, LDA = L::LDA;
  unsigned char* p = smem;
  bf16* Ks = reinterpret_cast<bf16*>(p);   p += L::tile;
  bf16* Vs = reinterpret_cast<bf16*>(p);   p += L::tile;
  bf16* Qs = reinterpret_cast<bf16*>(p);   p += L::tile;
  bf16* dOs = reinterpret_cast<bf16*>(p);  p += L::tile;
  float* Sb = reinterpret_cast<float*>(p); p += L::sc;
  float* dPb = reinterpret_cast<float*>(p); p += L::sc;
  bf16* Pb = reinterpret_cast<bf16*>(p);   p += L::pb;
  bf16* dSb = reinterpret_cast<bf16*>(p);  p += L::pb;
  float* dKa = reinterpret_cast<float*>(p); p += L::acc;
  float* dVa = reinterpret_cast<float*>(p); p += L::acc;
  float* lse_s = reinterpret_cast<float*>(p);
  float* delta_s = lse_s + BQ;

  const int j0 = blockIdx.x * BKV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int row0 = (threadIdx.x / 32) * 16;

  const size_t kv_base = (size_t(b) * KH + kvh) * Skv * D;
  load_tile<D>(Ks, k + kv_base + size_t(j0) * D, BKV, Skv - j0);
  load_tile<D>(Vs, v + kv_base + size_t(j0) * D, BKV, Skv - j0);
  for (int i = threadIdx.x; i < BKV * LDA; i += THREADS) {
    dKa[i] = 0.f;
    dVa[i] = 0.f;
  }

  const int n_q = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t q_base = (size_t(b) * H + h) * Sq;
    for (int t = 0; t < n_q; ++t) {
      const int q0 = t * BQ;
      // Causal skip: no query of this tile sits at or after the kv tile.
      if (causal && q_offset + q0 + BQ - 1 < j0) continue;
      __syncthreads();                  // previous tile's readers are done
      load_tile<D>(Qs, q + (q_base + q0) * D, BQ, Sq - q0);
      load_tile<D>(dOs, dout + (q_base + q0) * D, BQ, Sq - q0);
      load_rows(lse_s, delta_s, lse + q_base, delta + q_base, q0, Sq);
      __syncthreads();

      // This warp's 16 query rows: S = Q K^T, dP = dO V^T, then p and dS.
      rows_times_tile_t<D>(Sb + row0 * LDS, Qs + row0 * LDQ, Ks);
      rows_times_tile_t<D>(dPb + row0 * LDS, dOs + row0 * LDQ, Vs);
      __syncwarp();
      probs_and_ds(Sb, dPb, Pb, dSb, lse_s, delta_s, row0, q0, j0, Sq, Skv,
                   causal, q_offset, sm_scale, has_softcap, softcap, LDS,
                   LDP);
      __syncthreads();                  // every query row's p and dS

      // This warp's 16 kv rows: dV += P^T dO, dK += dS^T Q.
      acc_xt_y<D>(dVa, Pb, dOs, row0);
      acc_xt_y<D>(dKa, dSb, Qs, row0);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BKV * D; i += THREADS) {
    const int r = i / D;
    const int c = i % D;
    if (j0 + r < Skv) {
      const size_t o = kv_base + size_t(j0 + r) * D + c;
      dk[o] = __float2bfloat16(dKa[r * LDA + c]);
      dv[o] = __float2bfloat16(dVa[r * LDA + c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int KH, int Sq, int Skv, int causal, int q_offset,
                    float sm_scale, int has_softcap, float softcap) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Lay<D>;
  constexpr int LDQ = L::LDQ, LDS = L::LDS, LDP = L::LDP, LDA = L::LDA;
  unsigned char* p = smem;
  bf16* Qs = reinterpret_cast<bf16*>(p);   p += L::tile;
  bf16* dOs = reinterpret_cast<bf16*>(p);  p += L::tile;
  bf16* Ks = reinterpret_cast<bf16*>(p);   p += L::tile;
  bf16* Vs = reinterpret_cast<bf16*>(p);   p += L::tile;
  float* Sb = reinterpret_cast<float*>(p); p += L::sc;
  float* dPb = reinterpret_cast<float*>(p); p += L::sc;
  bf16* dSb = reinterpret_cast<bf16*>(p);  p += L::pb;
  float* dQa = reinterpret_cast<float*>(p); p += L::acc;
  float* lse_s = reinterpret_cast<float*>(p);
  float* delta_s = lse_s + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int row0 = (threadIdx.x / 32) * 16;

  const size_t q_base = (size_t(b) * H + h) * Sq;
  const size_t kv_base = (size_t(b) * KH + kvh) * Skv * D;
  load_tile<D>(Qs, q + (q_base + q0) * D, BQ, Sq - q0);
  load_tile<D>(dOs, dout + (q_base + q0) * D, BQ, Sq - q0);
  load_rows(lse_s, delta_s, lse + q_base, delta + q_base, q0, Sq);
  for (int i = threadIdx.x; i < BQ * LDA; i += THREADS) dQa[i] = 0.f;

  const int last_pos = q_offset + q0 + BQ - 1;
  const int n_kv = (Skv + BKV - 1) / BKV;
  for (int t = 0; t < n_kv; ++t) {
    const int j0 = t * BKV;
    if (causal && j0 > last_pos) break;  // this and later tiles: all future
    __syncthreads();                     // previous tile's readers are done
    load_tile<D>(Ks, k + kv_base + size_t(j0) * D, BKV, Skv - j0);
    load_tile<D>(Vs, v + kv_base + size_t(j0) * D, BKV, Skv - j0);
    __syncthreads();

    rows_times_tile_t<D>(Sb + row0 * LDS, Qs + row0 * LDQ, Ks);
    rows_times_tile_t<D>(dPb + row0 * LDS, dOs + row0 * LDQ, Vs);
    __syncwarp();
    probs_and_ds(Sb, dPb, nullptr, dSb, lse_s, delta_s, row0, q0, j0, Sq,
                 Skv, causal, q_offset, sm_scale, has_softcap, softcap, LDS,
                 LDP);
    __syncwarp();

    // dQ[this warp's rows] += dS[rows, 64] K[64, D].
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      FragC c;
      wmma::load_matrix_sync(c, dQa + row0 * LDA + dt * 16, LDA,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, dSb + row0 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(fb, Ks + kk * 16 * LDQ + dt * 16, LDQ);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(dQa + row0 * LDA + dt * 16, c, LDA,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D;
    const int c = i % D;
    if (q0 + r < Sq)
      dq[(q_base + q0 + r) * D + c] = __float2bfloat16(dQa[r * LDA + c]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int H, int KH, int Sq,
                        int Skv, int causal, int q_offset, float sm_scale,
                        int has_softcap, float softcap, cudaStream_t stream) {
  constexpr size_t smem = Lay<D>::dkdv;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + BKV - 1) / BKV, KH, B);
  flash_bwd_dkdv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, KH, Sq, Skv, causal,
      q_offset, sm_scale, has_softcap, softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int KH, int Sq, int Skv,
                      int causal, int q_offset, float sm_scale,
                      int has_softcap, float softcap, cudaStream_t stream) {
  constexpr size_t smem = Lay<D>::dq;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, KH, Sq, Skv, causal, q_offset, sm_scale,
      has_softcap, softcap);
  return cudaGetLastError();
}

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
      return launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, KH, Sq,
                             Skv, causal, q_offset, sm_scale, has_softcap,
                             softcap, s);
    case 128:
      return launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, KH,
                              Sq, Skv, causal, q_offset, sm_scale,
                              has_softcap, softcap, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int KH, int Sq, int Skv, int D, int causal,
                                 int q_offset, float sm_scale,
                                 int has_softcap, float softcap,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, KH, Sq, Skv,
                           causal, q_offset, sm_scale, has_softcap, softcap,
                           s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, KH, Sq, Skv,
                            causal, q_offset, sm_scale, has_softcap, softcap,
                            s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
