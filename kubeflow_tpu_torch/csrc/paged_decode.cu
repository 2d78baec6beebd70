// Paged one-token decode attention for Hopper (sm_90a): GQA over a page
// table, bf16 or int8 pages (int8 dequantized in registers), fp32 math.
//
// Replaces: kubeflow_tpu/ops/paged_attention.py, `paged_decode_attention`
// (the `pl.pallas_call` of `_kernel`). For every slot b it computes exact
// softmax attention of the slot's query heads over the KV positions
// 0..lengths[b] (inclusive) that live in the pages `table[b, :]` names.
// Page j of slot b counts only if j * page <= lengths[b] and
// table[b, j] >= 0; inside a counted page, positions past lengths[b] carry
// the reference's finite NEG_INF. Scores, the online softmax and the PV sum
// are fp32 throughout (the probabilities are never rounded before PV), an
// int8 page is dequantized as k * ks (per token and kv head), a slot with
// no counted page writes zeros, and the output is bf16 like q.
//
// Bound on an H100 SXM: bytes. At the serving shape (8 slots, 32 q heads
// over 8 kv heads of 128, 2048 positions) one call reads ~67 MB of bf16
// K/V (~34 MB int8 plus ~1 MB of scales) and does ~2 FLOP per byte read,
// far below the ~295 FLOP/byte ridge, so the floor is the read at
// 3.35 TB/s (~20 us bf16, ~10 us int8).
//
// What the design does about it: every K/V byte is read from device memory
// once, with 16-byte vector loads, and each (slot, kv head) block computes
// all g = H / KH query heads of its group against the rows it loaded, so
// the GQA group shares one read. One block per (kv head, slot) holds its g
// query rows (fp32), the tile's scores and the fp32 output accumulator in
// shared memory and walks the slot's counted pages in tiles of TR rows: a
// tile's K and V rows (strided by KH * D in the pool) land in shared memory
// through registers, all of a thread's loads issued before any store; then
// lanes split each K row (an LPR-lane group per row, shuffle-reduced dot
// products), one warp per query row updates the online softmax, and each
// thread accumulates P V for its (query row, column) entries. Tiles past
// lengths[b] are skipped, and rows past it are never loaded. The design
// under-fills the card at the serving shape (B * KH = 64 blocks on 132
// SMs) and does not overlap a tile's loads with the previous tile's math;
// a split over pages with a combine pass (flash-decoding), cp.async or TMA
// double buffering and tensor cores are later work.
//
// Layout: q [B, 1, H, D] bf16; pool_k/pool_v [P, page, KH, D] bf16 or int8;
// pool_ks/pool_vs [P, page, KH] fp32 (int8 only); table [B, mpp] int32
// (-1 = unmapped; ids >= P are treated as unmapped); lengths [B] int64;
// out [B, 1, H, D] bf16. All contiguous. Query head h = kvh * g + i.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// The masked-score value of kubeflow_tpu/ops/attention.py (NEG_INF).
constexpr float NEG_INF = -0.7f * FLT_MAX;

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;                  // elements per 16 bytes
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <>
struct Elem<int8_t> {
  static constexpr int VEC = 16;
  __device__ static void unpack(const uint4& u, float* f) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = float(c[i]);
  }
  __device__ static float one(const int8_t* p) { return float(*p); }
};

// Shared-memory carve-up for one block (bytes).
struct Layout {
  size_t kv, scale, q, s, acc, stats, total;
  __host__ __device__ Layout(int TR, int D, int esize, int g) {
    kv = size_t(TR) * D * esize;                 // one of K or V
    scale = size_t(TR) * sizeof(float);          // one of ks or vs
    q = size_t(g) * D * sizeof(float);
    s = size_t(g) * TR * sizeof(float);
    acc = size_t(g) * D * sizeof(float);
    stats = size_t(3) * g * sizeof(float);
    total = 2 * kv + 2 * scale + q + s + acc + stats;
  }
};

template <typename T, int D, int TR>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ pool_k, const T* __restrict__ pool_v,
                    const float* __restrict__ pool_ks,
                    const float* __restrict__ pool_vs,
                    const int* __restrict__ table,
                    const long long* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int H, int KH, int page,
                    int P, int mpp, float sm_scale) {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int VEC = Elem<T>::VEC;
  constexpr int VPR = D / VEC;                   // 16-byte vectors per row
  constexpr int LPR = VPR;                       // lanes per row (scores)
  constexpr int RPW = 32 / LPR;                  // rows per warp pass
  constexpr int NV = (TR * VPR + THREADS - 1) / THREADS;
  static_assert(TR % RPW == 0, "tile rows must split over the warp");

  extern __shared__ __align__(16) unsigned char smem[];
  const int g = H / KH;
  const Layout lay(TR, D, sizeof(T), g);
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + lay.kv);
  float* ks_s = reinterpret_cast<float*>(smem + 2 * lay.kv);
  float* vs_s = ks_s + TR;
  float* q_s = vs_s + TR;
  float* s_s = q_s + g * D;
  float* acc_s = s_s + g * TR;
  float* m_s = acc_s + g * D;
  float* l_s = m_s + g;
  float* a_s = l_s + g;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long len = lengths[b];
  const __nv_bfloat16* qg = q + (size_t(b) * H + size_t(kvh) * g) * D;

  for (int e = threadIdx.x; e < g * D; e += THREADS) {
    q_s[e] = __bfloat162float(qg[e]);
    acc_s[e] = 0.f;
  }
  for (int i = threadIdx.x; i < g; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  const size_t row_stride = size_t(KH) * D;      // elements between rows
  for (int j = 0; j < mpp; ++j) {
    const long long pos0 = (long long)j * page;
    if (pos0 > len) break;                       // later pages are past too
    const int pid = table[size_t(b) * mpp + j];
    if (pid < 0 || pid >= P) continue;           // unmapped: no weight
    for (int t0 = 0; t0 < page; t0 += TR) {
      const long long tpos = pos0 + t0;
      if (tpos > len) break;
      const long long left = len - tpos + 1;
      const int nvalid = left < TR ? int(left) : TR;
      const size_t base = (size_t(pid) * page + t0) * row_stride +
                          size_t(kvh) * D;
      __syncthreads();                           // previous tile's readers

      // K and V rows [0, nvalid) of this tile -> shared, 16-byte vectors;
      // every load of the thread is in flight before its first store.
      uint4 kr[NV], vr[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int idx = threadIdx.x + i * THREADS;
        const int r = idx / VPR, c = idx % VPR;
        if (idx < TR * VPR && r < nvalid) {
          const size_t off = base + size_t(r) * row_stride + size_t(c) * VEC;
          kr[i] = *reinterpret_cast<const uint4*>(pool_k + off);
          vr[i] = *reinterpret_cast<const uint4*>(pool_v + off);
        }
      }
      if (QUANT && threadIdx.x < nvalid) {
        const size_t soff = (size_t(pid) * page + t0 + threadIdx.x) * KH + kvh;
        ks_s[threadIdx.x] = pool_ks[soff];
        vs_s[threadIdx.x] = pool_vs[soff];
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int idx = threadIdx.x + i * THREADS;
        const int r = idx / VPR, c = idx % VPR;
        if (idx < TR * VPR && r < nvalid) {
          *reinterpret_cast<uint4*>(Ks + r * D + c * VEC) = kr[i];
          *reinterpret_cast<uint4*>(Vs + r * D + c * VEC) = vr[i];
        }
      }
      __syncthreads();

      // Scores: an LPR-lane group per K row, each lane a 16-byte slice of
      // the row against the same slice of every query row of the group.
      {
        const int sub = lane % LPR, subrow = lane / LPR;
        for (int r0 = warp * RPW; r0 < TR; r0 += WARPS * RPW) {
          const int r = r0 + subrow;
          const bool valid = r < nvalid;
          float kf[VEC];
          if (valid) {
            const uint4 u =
                *reinterpret_cast<const uint4*>(Ks + r * D + sub * VEC);
            Elem<T>::unpack(u, kf);
            if (QUANT) {
              const float sc = ks_s[r];
#pragma unroll
              for (int e = 0; e < VEC; ++e) kf[e] *= sc;
            }
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) kf[e] = 0.f;
          }
          for (int gi = 0; gi < g; ++gi) {
            const float* qr = q_s + gi * D + sub * VEC;
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < VEC; ++e) dot += qr[e] * kf[e];
#pragma unroll
            for (int off = LPR / 2; off > 0; off >>= 1)
              dot += __shfl_xor_sync(FULL, dot, off);
            if (sub == 0) s_s[gi * TR + r] = valid ? dot * sm_scale : NEG_INF;
          }
        }
      }
      __syncthreads();

      // Online softmax: one warp per query row of the group.
      for (int gi = warp; gi < g; gi += WARPS) {
        float* srow = s_s + gi * TR;
        float mx = NEG_INF;
        for (int c = lane; c < TR; c += 32) mx = fmaxf(mx, srow[c]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_prev = m_s[gi];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int c = lane; c < TR; c += 32) {
          const float p = expf(srow[c] - m_new);
          srow[c] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(FULL, sum, off);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[gi] = alpha;
          l_s[gi] = alpha * l_s[gi] + sum;
          m_s[gi] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P V over the tile's valid rows; each thread owns
      // (query row, column) entries, neighbouring threads neighbouring
      // columns.
      for (int e = threadIdx.x; e < g * D; e += THREADS) {
        const int gi = e / D, d = e % D;
        const float* prow = s_s + gi * TR;
        float acc = acc_s[e] * a_s[gi];
        for (int r = 0; r < nvalid; ++r) {
          float v = Elem<T>::one(Vs + r * D + d);
          if (QUANT) v *= vs_s[r];
          acc += prow[r] * v;
        }
        acc_s[e] = acc;
      }
    }
  }
  __syncthreads();

  __nv_bfloat16* og = out + (size_t(b) * H + size_t(kvh) * g) * D;
  for (int e = threadIdx.x; e < g * D; e += THREADS) {
    const float l = l_s[e / D];
    og[e] = __float2bfloat16(acc_s[e] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int D, int TR>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const void* pks, const void* pvs, const void* table,
                   const void* lengths, void* out, int B, int H, int KH,
                   int page, int P, int mpp, float sm_scale,
                   cudaStream_t stream) {
  const Layout lay(TR, D, sizeof(T), H / KH);
  static size_t configured = 48 * 1024;          // the default opt-in limit
  if (lay.total > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, D, TR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(lay.total));
    if (err != cudaSuccess) return err;
    configured = lay.total;
  }
  dim3 grid(KH, B);
  paged_decode_kernel<T, D, TR><<<grid, THREADS, lay.total, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const float*>(pks),
      static_cast<const float*>(pvs), static_cast<const int*>(table),
      static_cast<const long long*>(lengths),
      static_cast<__nv_bfloat16*>(out), H, KH, page, P, mpp, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_tile(const void* q, const void* pk, const void* pv,
                    const void* pks, const void* pvs, const void* table,
                    const void* lengths, void* out, int B, int H, int KH,
                    int page, int P, int mpp, float sm_scale,
                    cudaStream_t s) {
  if (page % 64 == 0)
    return launch<T, D, 64>(q, pk, pv, pks, pvs, table, lengths, out, B, H,
                            KH, page, P, mpp, sm_scale, s);
  if (page % 32 == 0)
    return launch<T, D, 32>(q, pk, pv, pks, pvs, table, lengths, out, B, H,
                            KH, page, P, mpp, sm_scale, s);
  return launch<T, D, 16>(q, pk, pv, pks, pvs, table, lengths, out, B, H, KH,
                          page, P, mpp, sm_scale, s);
}

}  // namespace

// Bytes of dynamic shared memory one block needs (the wrapper checks it
// against the card's per-block limit before launching).
extern "C" long long paged_decode_smem(int D, int page, int g, int quantized) {
  const int tr = page % 64 == 0 ? 64 : (page % 32 == 0 ? 32 : 16);
  return (long long)Layout(tr, D, quantized ? 1 : 2, g).total;
}

extern "C" int paged_decode(const void* q, const void* pool_k,
                            const void* pool_v, const void* pool_ks,
                            const void* pool_vs, const void* table,
                            const void* lengths, void* out, int B, int H,
                            int KH, int D, int page, int P, int mpp,
                            int quantized, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH != 0 || page <= 0 || page % 16 != 0)
    return int(cudaErrorInvalidValue);
  if (quantized) {
    if (D == 64)
      return by_tile<int8_t, 64>(q, pool_k, pool_v, pool_ks, pool_vs, table,
                                 lengths, out, B, H, KH, page, P, mpp,
                                 sm_scale, s);
    if (D == 128)
      return by_tile<int8_t, 128>(q, pool_k, pool_v, pool_ks, pool_vs, table,
                                  lengths, out, B, H, KH, page, P, mpp,
                                  sm_scale, s);
  } else {
    if (D == 64)
      return by_tile<__nv_bfloat16, 64>(q, pool_k, pool_v, pool_ks, pool_vs,
                                        table, lengths, out, B, H, KH, page,
                                        P, mpp, sm_scale, s);
    if (D == 128)
      return by_tile<__nv_bfloat16, 128>(q, pool_k, pool_v, pool_ks, pool_vs,
                                         table, lengths, out, B, H, KH, page,
                                         P, mpp, sm_scale, s);
  }
  return int(cudaErrorInvalidValue);
}
