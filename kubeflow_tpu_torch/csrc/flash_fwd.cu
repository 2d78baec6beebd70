// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 statistics.
//
// Replaces: kubeflow_tpu/ops/flash_attention.py, `_flash_fwd` (the
// `pl.pallas_call` of `_fwd_kernel`): online-softmax attention with GQA,
// causal masking at a static `q_offset`, tanh logit softcap and `sm_scale`;
// rows that attend to nothing (l == 0) are written as 0, and the per-row
// log-sum-exp `lse = m + log(l)` is written beside the output.
//
// Bound on an H100 SXM: operations. A causal prefill at S = 2048, H = 32,
// D = 128 does ~34 GFLOP of QK^T and PV against ~34 MB of Q/K/V/O traffic,
// ~1000 FLOP per byte -- well above the card's ~295 FLOP/byte ridge, so the
// tensor cores set the floor (~35 us at 989 bf16 TFLOP/s).
//
// What the design does about it: both products run on the tensor cores
// (WMMA bf16 16x16x16 fragments, fp32 accumulation), kv tiles wholly above
// the causal diagonal are never loaded, and the fp32 score tile, the bf16
// probability tile and the fp32 output accumulator stay in shared memory,
// so the only device-memory traffic is one read of Q and of each needed
// K/V tile and one write of O and lse. This is the simple correct design:
// one block per (batch, q-head, 64-row q tile), four warps each owning 16
// query rows, a loop over 64-row kv tiles in place of the TPU's sequential
// kv grid axis. Shared-memory rows are padded (16 bytes for bf16 tiles,
// 16 bytes for fp32 tiles) so the WMMA fragment loads of 16 consecutive
// rows spread over the banks instead of hitting one bank group, and each
// warp keeps its Q fragments in registers for the whole kv loop. TMA, wgmma
// and warp specialisation are later work.
//
// Layout: q [B, H, Sq, D], k/v [B, KH, Skv, D], o [B, H, Sq, D] (all bf16,
// contiguous), lse [B, H, Sq] fp32. q-head h reads kv-head h / (H / KH).
// Ragged edges (Sq or Skv not a multiple of 64) are masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // kv rows per tile
constexpr int WARPS = 4;      // each warp owns BQ / WARPS = 16 query rows
constexpr int THREADS = WARPS * 32;
// The masked-logit value of kubeflow_tpu/ops/attention.py (NEG_INF): a
// finite value, so a row masked in every column of a tile behaves exactly
// as the TPU kernel's (exp(NEG_INF - NEG_INF) = 1).
constexpr float NEG_INF = -0.7f * FLT_MAX;

// Row strides (elements) of the shared-memory tiles. Each keeps WMMA's
// rules (a multiple of 8 bf16 / 4 floats; every fragment pointer 32-byte
// aligned) and is padded by 16 bytes against bank conflicts.
template <int D>
struct Smem {
  static constexpr int LDQ = D + 8;              // Q, K, V (bf16)
  static constexpr int LDS = BKV + 4;            // scores (fp32)
  static constexpr int LDP = BKV + 8;            // probabilities (bf16)
  static constexpr int LDO = D + 4;              // accumulator (fp32)
  static constexpr size_t q = size_t(BQ) * LDQ * sizeof(__nv_bfloat16);
  static constexpr size_t kv = size_t(BKV) * LDQ * sizeof(__nv_bfloat16);
  static constexpr size_t s = size_t(BQ) * LDS * sizeof(float);
  static constexpr size_t p = size_t(BQ) * LDP * sizeof(__nv_bfloat16);
  static constexpr size_t o = size_t(BQ) * LDO * sizeof(float);
  static constexpr size_t stats = 3 * BQ * sizeof(float);
  static constexpr size_t total = q + 2 * kv + s + p + o + stats;
};

// Copy `rows` x D bf16 rows (row-major, contiguous) into shared memory rows
// of stride LDQ with 16-byte vectors; rows past `valid` are zero-filled.
template <int D>
__device__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                          int rows, int valid) {
  constexpr int LDQ = Smem<D>::LDQ;
  constexpr int VEC = 8;                         // bf16 per 16-byte vector
  constexpr int PER_ROW = D / VEC;
  const int total = rows * PER_ROW;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(src + size_t(r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int KH, int Sq, int Skv, int causal, int q_offset,
                 float sm_scale, int has_softcap, float softcap) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = Smem<D>;
  constexpr int LDQ = S::LDQ, LDS = S::LDS, LDP = S::LDP, LDO = S::LDO;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + S::q);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S::q + S::kv);
  float* Sb = reinterpret_cast<float*>(smem + S::q + 2 * S::kv);
  __nv_bfloat16* Pb =
      reinterpret_cast<__nv_bfloat16*>(smem + S::q + 2 * S::kv + S::s);
  float* Ob = reinterpret_cast<float*>(smem + S::q + 2 * S::kv + S::s + S::p);
  float* m_s = reinterpret_cast<float*>(smem + S::q + 2 * S::kv + S::s +
                                        S::p + S::o);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;                    // this warp's first row

  const __nv_bfloat16* qg = q + (size_t(b) * H + h) * Sq * D;
  const __nv_bfloat16* kg = k + (size_t(b) * KH + kvh) * Skv * D;
  const __nv_bfloat16* vg = v + (size_t(b) * KH + kvh) * Skv * D;

  load_tile<D>(Qs, qg + size_t(q0) * D, BQ, Sq - q0);
  for (int i = threadIdx.x; i < BQ * LDO; i += THREADS) Ob[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  __syncthreads();

  // This warp's 16 query rows, as D/16 fragments held for the whole loop.
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + row0 * LDQ + kk * 16, LDQ);

  // Causal skip: tiles starting past the last query row's position are in
  // the future of every row of this block (and so are all later tiles).
  const int last_pos = q_offset + q0 + BQ - 1;
  const int n_tiles = (Skv + BKV - 1) / BKV;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * BKV;
    if (causal && j0 > last_pos) break;
    __syncthreads();                             // previous tile's readers done
    load_tile<D>(Ks, kg + size_t(j0) * D, BKV, Skv - j0);
    load_tile<D>(Vs, vg + size_t(j0) * D, BKV, Skv - j0);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (4 fragments across the 64 columns).
#pragma unroll
    for (int jt = 0; jt < BKV / 16; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fb, Ks + jt * 16 * LDQ + kk * 16, LDQ);
        wmma::mma_sync(acc, qf[kk], fb, acc);
      }
      wmma::store_matrix_sync(Sb + row0 * LDS + jt * 16, acc, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this warp's rows; each lane owns two columns.
    for (int r = row0; r < row0 + 16; ++r) {
      const int qpos = q_offset + q0 + r;
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        const int kpos = j0 + col;
        float x = Sb[r * LDS + col] * sm_scale;
        if (has_softcap) x = tanhf(x / softcap) * softcap;
        if (causal && kpos > qpos) x = NEG_INF;
        if (kpos >= Skv) x = -INFINITY;          // ragged edge: no weight
        s[c] = x;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s[0] - m_new);
      const float p1 = expf(s[1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Pb[r * LDP + lane] = __float2bfloat16(p0);
      Pb[r * LDP + lane + 32] = __float2bfloat16(p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
      __syncwarp();
    }

    // Rescale this warp's accumulator rows, then O += P V on the tensor cores.
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = row0 + i / D;
      Ob[r * LDO + i % D] *= a_s[r];
    }
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Ob + row0 * LDO + dt * 16, LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Pb + row0 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(fb, Vs + kk * 16 * LDQ + dt * 16, LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ob + row0 * LDO + dt * 16, acc, LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // Finalize this warp's rows: o = acc / l (l == 0 -> 0), lse = m + log(l).
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = row0 + i / D;
    const int c = i % D;
    const int qi = q0 + r;
    if (qi < Sq) {
      const float l = l_s[r];
      const float safe = (l == 0.f) ? 1.f : l;
      o[((size_t(b) * H + h) * Sq + qi) * D + c] =
          __float2bfloat16(Ob[r * LDO + c] / safe);
    }
  }
  if (lane < 16) {
    const int r = row0 + lane;
    const int qi = q0 + r;
    if (qi < Sq) {
      const float l = l_s[r];
      const float safe = (l == 0.f) ? 1.f : l;
      lse[(size_t(b) * H + h) * Sq + qi] = m_s[r] + logf(safe);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int KH, int Sq, int Skv,
                   int causal, int q_offset, float sm_scale, int has_softcap,
                   float softcap, cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::total;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, KH, Sq, Skv, causal, q_offset, sm_scale,
      has_softcap, softcap);
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
