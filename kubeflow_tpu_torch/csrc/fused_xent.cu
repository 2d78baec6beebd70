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
// are multiples of 8 (16-byte rows for cp.async); T is free. The ragged
// edges -- rows past T, vocab columns past V -- are masked here: a column
// >= V never enters max, sum-exp or argmax, and is never read or written.
// A target outside [0, V) picks nothing (nll = lse), as in the TPU kernel.
//
// Bound on an H100 SXM: operations. One pass of 2 T D V (4.30 TFLOP at
// T = 4096, D = 4096, V = 128256) takes ~4.35 ms at 989 bf16 TFLOP/s; the
// bytes (W once, 1.05 GB, ~0.31 ms) are far below. The forward is one pass.
// The TPU backward is four (each of its two kernels recomputes the logits
// and does one product); this backward is three: per vocab chunk of
// `vchunk` columns (8192 from ops/fused_xent.py) it recomputes the logits
// once and writes that chunk's dl (bf16, [T, vchunk], 67 MB at T = 4096) to
// scratch, then runs the two products from it.
//
// Design (simple and correct first): every product is one tiled GEMM core
// -- a 128 x 128 output tile per block of 8 warps, K in steps of 32, bf16
// WMMA 16x16x16 fragments with fp32 accumulators in registers (each warp a
// 64 x 32 sub-tile), operand tiles brought into shared memory by cp.async
// in a 4-stage pipeline so later steps' loads overlap this step's math; the
// fp32 output tile reuses the pipeline's 80 KB once the K loop ends, so two
// blocks fit on an SM (register use is capped to match); rows of the shared
// tiles are padded by 16 bytes against bank conflicts. Operand
// layouts are template switches: row-major or transposed A (h^T for d_head
// is read from h as stored) and row-major or transposed B (W^T for
// d_hidden is read from W as stored), so no transposed copy is made.
//  - forward: the TPU grid walks the vocab in order and carries its
//    statistics in VMEM. Here T = 4096 gives only 32 row tiles, so each
//    block takes one row tile and one range of vocab tiles (the caller
//    sizes the ranges to fill the SMs at the occupancy that
//    `fused_xent_fwd_blocks_per_sm` reports), walks its tiles in order
//    keeping the row statistics in
//    shared memory, and writes them as partials; a second kernel combines
//    the ranges per row in index order. Strict `>` within a range and across
//    ranges, and the lowest column among a tile's equal maxima, keep
//    jnp.argmax's rule: the lowest index among equal maxima.
//  - backward, per chunk: `xent_dl` recomputes a logits tile, forms dl in
//    fp32 and rounds it to bf16 (where the TPU kernels cast it), `xent_dh`
//    adds dl W_c^T into an fp32 [T, D] accumulator (one block owns each
//    output tile; chunks run in order, so the sum is deterministic; the last
//    chunk writes bf16 dh), `xent_dw` writes dW_c = h^T dl with an fp32
//    accumulator over the whole T sweep. No atomics anywhere.
// wgmma/TMA, a persistent schedule and fusing the two products are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int WM = 64, WN = 32;                  // one warp's sub-tile
constexpr int FM = WM / 16, FN = WN / 16;        // fragments per warp
constexpr int LD_ROW = BK + 8;                   // [128][32] tiles, padded
constexpr int LD_COL = BM + 8;                   // [32][128] tiles, padded
constexpr int STAGE_ELEMS = BM * LD_ROW;         // >= BK * LD_COL
constexpr int STAGES = 4;                        // cp.async pipeline depth
constexpr int LDC = BN + 4;                      // fp32 output tile
constexpr size_t STAGE_BYTES = size_t(STAGE_ELEMS) * sizeof(bf16);
constexpr size_t PIPE_BYTES = 2 * STAGES * STAGE_BYTES;
constexpr size_t C_BYTES = size_t(BM) * LDC * sizeof(float);
// The fp32 output tile reuses the pipeline's buffers once the K loop ends.
constexpr size_t SMEM_GEMM = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
// The forward also keeps 5 statistics and the target of each of its rows.
constexpr size_t SMEM_FWD = SMEM_GEMM + 6 * BM * sizeof(float);

static_assert(BK * LD_COL <= STAGE_ELEMS, "stage buffer too small");

using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;                   // 0: zero-fill, no read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage of operand tiles at k0. A element (m, k) is A[m*lda + k]
// (A_T false) or A[k*lda + m] (A_T true); B element (k, n) is B[k*ldb + n]
// (B_T false) or B[n*ldb + k] (B_T true). A and B point at the block's
// (m0, 0) and (0, n0). Out-of-range vectors are zero-filled.
template <bool A_T, bool B_T>
__device__ __forceinline__ void load_stage(bf16* As, bf16* Bs, const bf16* A,
                                           int lda, int m_valid,
                                           const bf16* B, int ldb,
                                           int n_valid, int K, int k0) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int v = threadIdx.x + THREADS * j;     // 512 vectors of 8 per tile
    if (!A_T) {
      const int r = v / 4, kv = (v % 4) * 8;
      const bool ok = r < m_valid && k0 + kv < K;
      cp_async16(As + r * LD_ROW + kv,
                 ok ? A + size_t(r) * lda + k0 + kv : A, ok);
    } else {
      const int kr = v / 16, mv = (v % 16) * 8;
      const bool ok = k0 + kr < K && mv < m_valid;
      cp_async16(As + kr * LD_COL + mv,
                 ok ? A + size_t(k0 + kr) * lda + mv : A, ok);
    }
    if (!B_T) {
      const int kr = v / 16, nv = (v % 16) * 8;
      const bool ok = k0 + kr < K && nv < n_valid;
      cp_async16(Bs + kr * LD_COL + nv,
                 ok ? B + size_t(k0 + kr) * ldb + nv : B, ok);
    } else {
      const int r = v / 4, kv = (v % 4) * 8;
      const bool ok = r < n_valid && k0 + kv < K;
      cp_async16(Bs + r * LD_ROW + kv,
                 ok ? B + size_t(r) * ldb + k0 + kv : B, ok);
    }
  }
}

// C[128 x 128] = A[128 x K] B[K x 128] into the fp32 tile Cs (stride LDC).
// `stages` holds STAGES A and STAGES B stage buffers; Cs may overlay them.
template <bool A_T, bool B_T>
__device__ void gemm_tile(float* Cs, bf16* stages, const bf16* A, int lda,
                          int m_valid, const bf16* B, int ldb, int n_valid,
                          int K) {
  using LayA = typename std::conditional<A_T, wmma::col_major,
                                         wmma::row_major>::type;
  using LayB = typename std::conditional<B_T, wmma::col_major,
                                         wmma::row_major>::type;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayA>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayB>;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;
  FragC acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int n_k = (K + BK - 1) / BK;
  __syncthreads();                 // earlier readers of the buffers are done
  // Keep STAGES - 1 steps in flight; every iteration commits one group
  // (maybe empty), so waiting for all but STAGES - 2 means step kt landed.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_k)
      load_stage<A_T, B_T>(stages + st * STAGE_ELEMS,
                           stages + (STAGES + st) * STAGE_ELEMS, A, lda,
                           m_valid, B, ldb, n_valid, K, st * BK);
    cp_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();               // step kt landed; step kt - 1 is read
    const int nk = kt + STAGES - 1;
    if (nk < n_k) {
      const int ns = nk % STAGES;  // the buffer step kt - 1 used
      load_stage<A_T, B_T>(stages + ns * STAGE_ELEMS,
                           stages + (STAGES + ns) * STAGE_ELEMS, A, lda,
                           m_valid, B, ldb, n_valid, K, nk * BK);
    }
    cp_commit();
    const int cur = kt % STAGES;
    const bf16* As = stages + cur * STAGE_ELEMS;
    const bf16* Bs = stages + (STAGES + cur) * STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA fa[FM];
      FragB fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int m = wm + i * 16;
        if (!A_T)
          wmma::load_matrix_sync(fa[i], As + m * LD_ROW + kk * 16, LD_ROW);
        else
          wmma::load_matrix_sync(fa[i], As + kk * 16 * LD_COL + m, LD_COL);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int n = wn + j * 16;
        if (!B_T)
          wmma::load_matrix_sync(fb[j], Bs + kk * 16 * LD_COL + n, LD_COL);
        else
          wmma::load_matrix_sync(fb[j], Bs + n * LD_ROW + kk * 16, LD_ROW);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_wait<0>();
  __syncthreads();                 // every warp is done with the buffers
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}
__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float capped(float s, int has_softcap,
                                        float softcap) {
  return has_softcap ? tanhf(s / softcap) * softcap : s;
}

// Forward partials: block (row tile, vocab range). Partials are laid out
// [range][T]: pm (max), pl (sum-exp at pm), pp (picked), pb (best value),
// pi (best index).
__global__ void __launch_bounds__(THREADS, 2)
xent_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                const int* __restrict__ tgt, float* __restrict__ pm,
                float* __restrict__ pl, float* __restrict__ pp,
                float* __restrict__ pb, int* __restrict__ pi, int T, int D,
                int V, int n_tiles, int tiles_per_range, int has_softcap,
                float softcap) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  float* m_run = reinterpret_cast<float*>(smem + SMEM_GEMM);
  float* l_run = m_run + BM;
  float* p_run = l_run + BM;
  float* b_run = p_run + BM;
  int* i_run = reinterpret_cast<int*>(b_run + BM);
  int* tg_s = i_run + BM;

  const int m0 = blockIdx.x * BM;
  const int range = blockIdx.y;
  const int t_begin = range * tiles_per_range;
  const int t_end = min(n_tiles, t_begin + tiles_per_range);
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
    p_run[r] = 0.f;
    b_run[r] = -INFINITY;
    i_run[r] = 0;
    tg_s[r] = m0 + r < T ? tgt[m0 + r] : -1;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * BN;
    gemm_tile<false, false>(Cs, stages, h + size_t(m0) * D, D, T - m0,
                            w + n0, V, V - n0, D);
    // This warp's 16 rows; each lane holds 4 columns.
    for (int rr = 0; rr < BM / WARPS; ++rr) {
      const int r = warp * (BM / WARPS) + rr;
      const int tg = tg_s[r];
      float s[BN / 32];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const int col = n0 + lane + 32 * j;
        s[j] = col < V ? capped(Cs[r * LDC + lane + 32 * j], has_softcap,
                                softcap)
                       : -INFINITY;
        tmax = fmaxf(tmax, s[j]);
      }
      tmax = warp_max(tmax);
      const float m_old = m_run[r];
      const float m_new = fmaxf(m_old, tmax);
      float se = 0.f, pick = 0.f;
      int arg = INT_MAX;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const int col = n0 + lane + 32 * j;
        se += expf(s[j] - m_new);
        if (col < V && s[j] == tmax) arg = min(arg, col);
        if (col < V && col == tg) pick = s[j];
      }
      se = warp_sum(se);
      pick = warp_sum(pick);
      arg = warp_min(arg);
      if (lane == 0) {
        l_run[r] = l_run[r] * expf(m_old - m_new) + se;
        m_run[r] = m_new;
        p_run[r] += pick;
        if (tmax > b_run[r]) {        // strict: an earlier tile keeps a tie
          b_run[r] = tmax;
          i_run[r] = arg;
        }
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    if (m0 + r < T) {
      const size_t o = size_t(range) * T + m0 + r;
      pm[o] = m_run[r];
      pl[o] = l_run[r];
      pp[o] = p_run[r];
      pb[o] = b_run[r];
      pi[o] = i_run[r];
    }
  }
}

// Combine the ranges of each row in index order.
__global__ void xent_combine_kernel(const float* __restrict__ pm,
                                    const float* __restrict__ pl,
                                    const float* __restrict__ pp,
                                    const float* __restrict__ pb,
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
    if (pb[o] > best) {              // strict: an earlier range keeps a tie
      best = pb[o];
      arg = pi[o];
    }
  }
  const float z = m + logf(l);
  lse[row] = z;
  nll[row] = z - picked;
  correct[row] = arg == tgt[row] ? 1.f : 0.f;
}

// One [128 x 128] tile of this chunk's dl, rounded to bf16, into the
// scratch [T, ldc] (columns c0 + n0 .. of the vocab; those past `vc` are
// not written).
__global__ void __launch_bounds__(THREADS, 2)
xent_dl_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
               const int* __restrict__ tgt, const float* __restrict__ lse,
               const float* __restrict__ g, bf16* __restrict__ dl, int T,
               int D, int V, int c0, int vc, int ldc, int has_softcap,
               float softcap) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;              // within the chunk
  gemm_tile<false, false>(Cs, stages, h + size_t(m0) * D, D, T - m0,
                          w + c0 + n0, V, vc - n0, D);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int row = m0 + r, cc = n0 + c;
    if (row >= T || cc >= vc) continue;
    const float s = capped(Cs[r * LDC + c], has_softcap, softcap);
    const float p = expf(s - lse[row]);
    float d = (p - (c0 + cc == tgt[row] ? 1.f : 0.f)) * g[row];
    if (has_softcap) {
      const float q = s / softcap;
      d *= 1.f - q * q;
    }
    dl[size_t(row) * ldc + cc] = __float2bfloat16(d);
  }
}

// dh tile (row tile, D tile) += dl[T, vc] W[:, c0:c0+vc]^T. `first`: the
// fp32 accumulator starts from 0; `last`: write bf16 dh instead of it.
__global__ void __launch_bounds__(THREADS, 2)
xent_dh_kernel(const bf16* __restrict__ dl, const bf16* __restrict__ w,
               float* __restrict__ acc, bf16* __restrict__ dh, int T, int D,
               int V, int c0, int vc, int ldc, int first, int last) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;              // a column block of D
  gemm_tile<false, true>(Cs, stages, dl + size_t(m0) * ldc, ldc, T - m0,
                         w + size_t(n0) * V + c0, V, D - n0, vc);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int row = m0 + r, col = n0 + c;
    if (row >= T || col >= D) continue;
    const size_t o = size_t(row) * D + col;
    const float v = Cs[r * LDC + c] + (first ? 0.f : acc[o]);
    if (last)
      dh[o] = __float2bfloat16(v);
    else
      acc[o] = v;
  }
}

// dW[:, c0:c0+vc] tile (D tile, chunk column tile) = h^T dl over all T.
__global__ void __launch_bounds__(THREADS, 2)
xent_dw_kernel(const bf16* __restrict__ h, const bf16* __restrict__ dl,
               bf16* __restrict__ dw, int T, int D, int V, int c0, int vc,
               int ldc) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.x * BM;              // a row block of D
  const int n0 = blockIdx.y * BN;              // within the chunk
  gemm_tile<true, false>(Cs, stages, h + m0, D, D - m0, dl + n0, ldc,
                         vc - n0, T);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    if (m0 + r >= D || n0 + c >= vc) continue;
    dw[size_t(m0 + r) * V + c0 + n0 + c] = __float2bfloat16(Cs[r * LDC + c]);
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
  cudaError_t err = allow_smem(xent_fwd_kernel, SMEM_FWD);
  if (err == cudaSuccess) err = allow_smem(xent_dl_kernel, SMEM_GEMM);
  if (err == cudaSuccess) err = allow_smem(xent_dh_kernel, SMEM_GEMM);
  if (err == cudaSuccess) err = allow_smem(xent_dw_kernel, SMEM_GEMM);
  if (err == cudaSuccess) done = true;
  return err;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Blocks of the forward kernel that fit on one SM at once, as the runtime
// computes it from the kernel's registers and shared memory: the caller
// plans its vocab ranges in waves of this many blocks per SM.
extern "C" int fused_xent_fwd_blocks_per_sm(int* blocks) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, xent_fwd_kernel, THREADS, SMEM_FWD));
}

// Forward: nll, lse, correct [T] fp32. The partial buffers hold n_ranges
// x T entries each, with n_ranges = cdiv(cdiv(V, 128), tiles_per_range).
extern "C" int fused_xent_fwd_bf16(const void* h, const void* w,
                                   const void* tgt, void* pm, void* pl,
                                   void* pp, void* pb, void* pi, void* nll,
                                   void* lse, void* correct, int T, int D,
                                   int V, int tiles_per_range,
                                   int has_softcap, float softcap,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  const int n_tiles = cdiv(V, BN);
  const int n_ranges = cdiv(n_tiles, tiles_per_range);
  dim3 grid(cdiv(T, BM), n_ranges);
  xent_fwd_kernel<<<grid, THREADS, SMEM_FWD, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(tgt), static_cast<float*>(pm),
      static_cast<float*>(pl), static_cast<float*>(pp),
      static_cast<float*>(pb), static_cast<int*>(pi), T, D, V, n_tiles,
      tiles_per_range, has_softcap, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  xent_combine_kernel<<<cdiv(T, 256), 256, 0, s>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<const float*>(pp), static_cast<const float*>(pb),
      static_cast<const int*>(pi), static_cast<const int*>(tgt),
      static_cast<float*>(nll), static_cast<float*>(lse),
      static_cast<float*>(correct), T, n_ranges);
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
  const bf16* hb = static_cast<const bf16*>(h);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* dlb = static_cast<bf16*>(scratch);
  const int n_chunks = cdiv(V, vchunk);
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * vchunk;
    const int vc = V - c0 < vchunk ? V - c0 : vchunk;
    xent_dl_kernel<<<dim3(cdiv(T, BM), cdiv(vc, BN)), THREADS, SMEM_GEMM,
                     s>>>(hb, wb, static_cast<const int*>(tgt),
                          static_cast<const float*>(lse),
                          static_cast<const float*>(g), dlb, T, D, V, c0, vc,
                          vchunk, has_softcap, softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    xent_dh_kernel<<<dim3(cdiv(T, BM), cdiv(D, BN)), THREADS, SMEM_GEMM,
                     s>>>(dlb, wb, static_cast<float*>(acc),
                          static_cast<bf16*>(dh), T, D, V, c0, vc, vchunk,
                          c == 0, c == n_chunks - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    xent_dw_kernel<<<dim3(cdiv(D, BM), cdiv(vc, BN)), THREADS, SMEM_GEMM,
                     s>>>(hb, dlb, static_cast<bf16*>(dw), T, D, V, c0, vc,
                          vchunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaSuccess);
}
