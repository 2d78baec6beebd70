// Paged one-token decode attention for Hopper (sm_90a): GQA over a page
// table, bf16 or int8 pages (int8 dequantized in registers), fp32 math,
// split over each slot's pages (flash-decoding) with a combine kernel.
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
// 3.35 TB/s (~20 us bf16, ~10 us int8). Tensor cores are not needed.
//
// What the design does about it:
//  - Split over pages. The grid is (kv head, slot, split): split s takes
//    the contiguous page slots [s * pps, (s + 1) * pps), pps = ceil(mpp /
//    splits). The caller picks `splits` from shapes alone: enough blocks
//    to fill the block slots the card holds at once (the occupancy of
//    this kernel at these shapes), so 8 slots x 8 kv heads fill the card
//    instead of 64 of its 132 SMs. Each (slot, kv head, split) block computes all
//    g = H / KH query heads of its group against the rows it loads, so the
//    GQA group shares one read of every K/V byte.
//  - Overlap. A block walks the counted pages of its split in tiles of TR
//    rows through a 2-stage shared-memory ring filled by cp.async 16-byte
//    copies (int8 scales by 4-byte copies): tile n + 1 is in flight while
//    tile n computes. Rows past lengths[b] are never loaded, and tiles and
//    pages past it are skipped.
//  - Math per tile, 128 threads: lanes split each K row (an LPR-lane group
//    per row; a lane converts its slices of its rows once, then the rows'
//    dot products with each query row and their shuffle reductions run
//    side by side; an int8 row's scale is applied once to the dot), one
//    warp per query row updates the online softmax (an int8 tile's V
//    scales folded into p), and each thread accumulates P V for four
//    adjacent columns of a query row. int8 is converted to fp32 by byte
//    permutes and one subtraction, not the slower integer conversion.
//  - Output. With one split the block writes bf16 o / l directly.
//    Otherwise it writes an fp32 partial (unnormalised o, running max m and
//    sum l per query head) to scratch [B, H, splits, D] and [B, H, splits,
//    2]; a split with no counted page writes o = 0, l = 0, m = -inf.
//    `paged_decode_combine` then merges the splits of each (slot, head) in
//    split order (so the bits repeat): M = max m over live splits, o =
//    sum exp(m - M) o_s / sum exp(m - M) l_s, zeros where every l is 0.
//
// Layout: q [B, 1, H, D] bf16; pool_k/pool_v [P, page, KH, D] bf16 or int8;
// pool_ks/pool_vs [P, page, KH] fp32 (int8 only); table [B, mpp] int32
// (-1 = unmapped; ids >= P are treated as unmapped); lengths [B] int64;
// out [B, 1, H, D] bf16. All contiguous. Query head h = kvh * g + i.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
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
  // Four adjacent elements (8 bytes).
  __device__ static float4 four(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

// int8 to fp32 without the slow integer conversion: byte x + 128 becomes
// the low byte of the float 2^23 + (x + 128), from which 2^23 + 128 is
// subtracted exactly.
__device__ __forceinline__ float4 int8x4_to_float4(uint32_t u) {
  u ^= 0x80808080u;                              // x + 128, as unsigned
  constexpr uint32_t TWO23 = 0x4B000000u;        // 2^23 as a float
  constexpr float BIAS = 8388736.f;              // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, TWO23, 0x7540)) - BIAS,
                     __uint_as_float(__byte_perm(u, TWO23, 0x7541)) - BIAS,
                     __uint_as_float(__byte_perm(u, TWO23, 0x7542)) - BIAS,
                     __uint_as_float(__byte_perm(u, TWO23, 0x7543)) - BIAS);
}

template <>
struct Elem<int8_t> {
  static constexpr int VEC = 16;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = int8x4_to_float4(w[i]);
      f[4 * i] = x.x;
      f[4 * i + 1] = x.y;
      f[4 * i + 2] = x.z;
      f[4 * i + 3] = x.w;
    }
  }
  __device__ static float4 four(const int8_t* p) {
    return int8x4_to_float4(*reinterpret_cast<const uint32_t*>(p));
  }
};

// -- cp.async ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared-memory carve-up for one block (bytes): two ring stages, each the
// K and V rows of one tile and their int8 scales, then the block's state
// (q, the tile's scores, the output accumulator, m, l and the rescale of
// each query row).
struct Layout {
  size_t kv, scale, stage, q, s, acc, stats, total;
  __host__ __device__ Layout(int TR, int D, int esize, int g) {
    kv = size_t(TR) * D * esize;                 // one of K or V
    scale = size_t(TR) * sizeof(float);          // one of ks or vs
    stage = 2 * kv + 2 * scale;
    q = size_t(g) * D * sizeof(float);
    s = size_t(g) * TR * sizeof(float);
    acc = size_t(g) * D * sizeof(float);
    stats = size_t(3) * g * sizeof(float);
    total = 2 * stage + q + s + acc + stats;
  }
};

// One tile of a counted page: page slot j, first row t0 in the page, the
// pool page id (-1: no tile left) and the rows up to lengths[b].
struct Tile {
  int j, t0, pid, nvalid;
};

// The first counted tile at or after row t0 of page slot j, before j_end.
template <int TR>
__device__ Tile seek(const int* trow, int j, int t0, int j_end, int page,
                     int P, long long len) {
  for (; j < j_end; ++j, t0 = 0) {
    const long long pos0 = (long long)j * page;
    if (pos0 > len) break;                       // later pages are past too
    const int pid = trow[j];
    if (pid < 0 || pid >= P) continue;           // unmapped: no weight
    if (t0 < page && pos0 + t0 <= len) {
      const long long left = len - (pos0 + t0) + 1;
      return {j, t0, pid, left < TR ? int(left) : TR};
    }
  }
  return {j_end, 0, -1, 0};
}

template <typename T, int D, int TR>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const T* __restrict__ pool_k,
                          const T* __restrict__ pool_v,
                          const float* __restrict__ pool_ks,
                          const float* __restrict__ pool_vs,
                          const int* __restrict__ table,
                          const long long* __restrict__ lengths,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ o_part, float* __restrict__ ml,
                          int H, int KH, int page, int P, int mpp, int splits,
                          float sm_scale) {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int VEC = Elem<T>::VEC;
  constexpr int VPR = D / VEC;                   // 16-byte vectors per row
  constexpr int LPR = VPR;                       // lanes per row (scores)
  constexpr int RPW = 32 / LPR;                  // rows per warp pass
  constexpr int NV = (TR * VPR + THREADS - 1) / THREADS;
  // Score passes: rows (p * WARPS + warp) * RPW + lane / LPR of the tile.
  constexpr int PASSES = (TR + WARPS * RPW - 1) / (WARPS * RPW);
  static_assert(TR % RPW == 0, "tile rows must split over the warp");

  extern __shared__ __align__(16) unsigned char smem[];
  const int g = H / KH;
  const Layout lay(TR, D, sizeof(T), g);
  float* q_s = reinterpret_cast<float*>(smem + 2 * lay.stage);
  float* s_s = q_s + g * D;
  float* acc_s = s_s + g * TR;
  float* m_s = acc_s + g * D;
  float* l_s = m_s + g;
  float* a_s = l_s + g;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long len = lengths[b];
  const int pps = (mpp + splits - 1) / splits;   // page slots per split
  const int j_end = min(mpp, (split + 1) * pps);
  const int* trow = table + size_t(b) * mpp;
  const __nv_bfloat16* qg = q + (size_t(b) * H + size_t(kvh) * g) * D;

  for (int e = threadIdx.x; e < g * D; e += THREADS) {
    q_s[e] = __bfloat162float(qg[e]);
    acc_s[e] = 0.f;
  }
  for (int i = threadIdx.x; i < g; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  // Rows [0, nvalid) of a tile's K and V (and their scales) into stage st.
  const size_t row_stride = size_t(KH) * D;      // elements between rows
  auto issue = [&](const Tile& tl, int st) {
    unsigned char* base = smem + st * lay.stage;
    T* Kd = reinterpret_cast<T*>(base);
    T* Vd = reinterpret_cast<T*>(base + lay.kv);
    const size_t src = (size_t(tl.pid) * page + tl.t0) * row_stride +
                       size_t(kvh) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / VPR, c = idx % VPR;
      if (idx < TR * VPR && r < tl.nvalid) {
        const size_t off = src + size_t(r) * row_stride + size_t(c) * VEC;
        copy16(Kd + r * D + c * VEC, pool_k + off);
        copy16(Vd + r * D + c * VEC, pool_v + off);
      }
    }
    if (QUANT && threadIdx.x < tl.nvalid) {
      float* ks_d = reinterpret_cast<float*>(base + 2 * lay.kv);
      const size_t soff =
          (size_t(tl.pid) * page + tl.t0 + threadIdx.x) * KH + kvh;
      copy4(ks_d + threadIdx.x, pool_ks + soff);
      copy4(ks_d + TR + threadIdx.x, pool_vs + soff);
    }
  };

  Tile cur = seek<TR>(trow, split * pps, 0, j_end, page, P, len);
  if (cur.pid >= 0) issue(cur, 0);
  copy_commit();
  for (int n = 0; cur.pid >= 0; ++n) {
    const Tile nxt = seek<TR>(trow, cur.j, cur.t0 + TR, j_end, page, P, len);
    if (nxt.pid >= 0) issue(nxt, (n + 1) & 1);
    copy_commit();
    copy_wait<1>();                              // tile n has landed
    __syncthreads();

    const unsigned char* base = smem + (n & 1) * lay.stage;
    const T* Ks = reinterpret_cast<const T*>(base);
    const T* Vs = reinterpret_cast<const T*>(base + lay.kv);
    const float* ks_s = reinterpret_cast<const float*>(base + 2 * lay.kv);
    const float* vs_s = ks_s + TR;
    const int nvalid = cur.nvalid;

    // Scores: an LPR-lane group per K row, each lane a 16-byte slice of
    // the row against the same slice of every query row of the group. A
    // lane converts its slices of all its rows once, then takes the query
    // rows one by one, the rows' dot products and shuffle reductions
    // independent of each other.
    {
      const int sub = lane % LPR, subrow = lane / LPR;
      float kf[PASSES][VEC];
      float scale[PASSES];
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int r = (p * WARPS + warp) * RPW + subrow;
        if (r < nvalid) {
          Elem<T>::unpack(
              *reinterpret_cast<const uint4*>(Ks + r * D + sub * VEC), kf[p]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[p][e] = 0.f;
        }
        scale[p] = QUANT && r < nvalid ? ks_s[r] * sm_scale : sm_scale;
      }
      for (int gi = 0; gi < g; ++gi) {
        float qf[VEC];
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(q_s + gi * D + sub * VEC + e);
          qf[e] = x.x;
          qf[e + 1] = x.y;
          qf[e + 2] = x.z;
          qf[e + 3] = x.w;
        }
        float dot[PASSES];
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          dot[p] = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot[p] += qf[e] * kf[p][e];
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int p = 0; p < PASSES; ++p)
            dot[p] += __shfl_xor_sync(FULL, dot[p], off);
        }
        if (sub == 0) {
#pragma unroll
          for (int p = 0; p < PASSES; ++p) {
            const int r = (p * WARPS + warp) * RPW + subrow;
            if (r < TR)
              s_s[gi * TR + r] = r < nvalid ? dot[p] * scale[p] : NEG_INF;
          }
        }
      }
    }
    __syncthreads();

    // Online softmax: one warp per query row of the group. p stays fp32;
    // an int8 tile's V scale is folded into the weight PV reads.
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
        sum += p;
        srow[c] = QUANT && c < nvalid ? p * vs_s[c] : p;
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
    // four adjacent columns of a query row, neighbouring threads
    // neighbouring columns.
    for (int u = threadIdx.x; u < g * D / 4; u += THREADS) {
      const int gi = u / (D / 4), d = (u % (D / 4)) * 4;
      const float* prow = s_s + gi * TR;
      float* ap = acc_s + gi * D + d;
      const float alpha = a_s[gi];
      float4 a = *reinterpret_cast<const float4*>(ap);
      a.x *= alpha;
      a.y *= alpha;
      a.z *= alpha;
      a.w *= alpha;
      for (int r = 0; r < nvalid; ++r) {
        const float p = prow[r];
        const float4 v = Elem<T>::four(Vs + r * D + d);
        a.x += p * v.x;
        a.y += p * v.y;
        a.z += p * v.z;
        a.w += p * v.w;
      }
      *reinterpret_cast<float4*>(ap) = a;
    }
    __syncthreads();                             // stage n & 1 is free
    cur = nxt;
  }
  __syncthreads();

  if (splits == 1) {
    __nv_bfloat16* og = out + (size_t(b) * H + size_t(kvh) * g) * D;
    for (int e = threadIdx.x; e < g * D; e += THREADS) {
      const float l = l_s[e / D];
      og[e] = __float2bfloat16(acc_s[e] / (l == 0.f ? 1.f : l));
    }
    return;
  }
  // Partial of split `split` for each query head h = kvh * g + gi.
  for (int e = threadIdx.x; e < g * D; e += THREADS) {
    const size_t h = size_t(b) * H + size_t(kvh) * g + e / D;
    o_part[(h * splits + split) * D + e % D] = acc_s[e];
  }
  for (int gi = threadIdx.x; gi < g; gi += THREADS) {
    const size_t h = size_t(b) * H + size_t(kvh) * g + gi;
    const float l = l_s[gi];
    ml[(h * splits + split) * 2] = l > 0.f ? m_s[gi] : -INFINITY;
    ml[(h * splits + split) * 2 + 1] = l;
  }
}

// One block per (slot, query head): the splits merged in split order.
__global__ void __launch_bounds__(THREADS)
paged_decode_combine_kernel(const float* __restrict__ o_part,
                            const float* __restrict__ ml,
                            __nv_bfloat16* __restrict__ out, int splits,
                            int D) {
  const size_t bh = blockIdx.x;                  // b * H + h
  const float* mrow = ml + bh * splits * 2;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s)
    if (mrow[2 * s + 1] > 0.f) M = fmaxf(M, mrow[2 * s]);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float L = 0.f, O = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float l = mrow[2 * s + 1];
      if (l > 0.f) {                             // a dead split weighs nothing
        const float w = expf(mrow[2 * s] - M);
        L += w * l;
        O += w * o_part[(bh * splits + s) * D + d];
      }
    }
    out[bh * D + d] = __float2bfloat16(L > 0.f ? O / L : 0.f);
  }
}

int tile_rows(int page) {
  return page % 64 == 0 ? 64 : (page % 32 == 0 ? 32 : 16);
}

// Raises the kernel's dynamic shared-memory limit to `bytes` once.
template <typename T, int D, int TR>
cudaError_t allow_smem(size_t bytes) {
  static size_t configured = 48 * 1024;          // the default opt-in limit
  if (bytes <= configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_split_kernel<T, D, TR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess) configured = bytes;
  return err;
}

// One launch of the split kernel.
struct Launch {
  const void *q, *pk, *pv, *pks, *pvs, *table, *lengths;
  void *out, *o_part, *ml;
  int B, H, KH, page, P, mpp, splits;
  float sm_scale;
  cudaStream_t stream;

  template <typename T, int D, int TR>
  int run() const {
    const Layout lay(TR, D, sizeof(T), H / KH);
    cudaError_t err = allow_smem<T, D, TR>(lay.total);
    if (err != cudaSuccess) return int(err);
    dim3 grid(KH, B, splits);
    paged_decode_split_kernel<T, D, TR><<<grid, THREADS, lay.total, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(pk),
        static_cast<const T*>(pv), static_cast<const float*>(pks),
        static_cast<const float*>(pvs), static_cast<const int*>(table),
        static_cast<const long long*>(lengths),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(o_part),
        static_cast<float*>(ml), H, KH, page, P, mpp, splits, sm_scale);
    return int(cudaGetLastError());
  }
};

// How many split blocks of g query heads per kv head one SM holds at once
// (0 on error).
struct Resident {
  int g;

  template <typename T, int D, int TR>
  int run() const {
    const Layout lay(TR, D, sizeof(T), g);
    int blocks = 0;
    if (allow_smem<T, D, TR>(lay.total) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, paged_decode_split_kernel<T, D, TR>, THREADS,
            lay.total) != cudaSuccess)
      return 0;
    return blocks;
  }
};

// f.run<T, D, TR>() for the page type, head size and tile of a call;
// `invalid` for a head size without a kernel.
template <typename T, int D, typename F>
int by_tile(int page, const F& f) {
  switch (tile_rows(page)) {
    case 64: return f.template run<T, D, 64>();
    case 32: return f.template run<T, D, 32>();
    default: return f.template run<T, D, 16>();
  }
}

template <typename F>
int by_kind(int quantized, int D, int page, const F& f, int invalid) {
  if (D == 64)
    return quantized ? by_tile<int8_t, 64>(page, f)
                     : by_tile<__nv_bfloat16, 64>(page, f);
  if (D == 128)
    return quantized ? by_tile<int8_t, 128>(page, f)
                     : by_tile<__nv_bfloat16, 128>(page, f);
  return invalid;
}

}  // namespace

// Bytes of dynamic shared memory one split block needs, its 2-stage ring
// included (the wrapper checks it against the card's per-block limit
// before launching).
extern "C" long long paged_decode_smem(int D, int page, int g, int quantized) {
  return (long long)Layout(tile_rows(page), D, quantized ? 1 : 2, g).total;
}

// Split blocks one SM holds at once for these shapes (0 on error): the
// wrapper sizes the split from it.
extern "C" int paged_decode_blocks_per_sm(int D, int page, int g,
                                          int quantized) {
  if (g <= 0 || page <= 0 || page % 16 != 0) return 0;
  return by_kind(quantized, D, page, Resident{g}, 0);
}

// The split kernel: with splits == 1 it writes `out` (bf16) and reads
// neither scratch pointer; otherwise it writes the partials `o_part`
// [B, H, splits, D] and `ml` [B, H, splits, 2] (fp32) for
// `paged_decode_combine`.
extern "C" int paged_decode(const void* q, const void* pool_k,
                            const void* pool_v, const void* pool_ks,
                            const void* pool_vs, const void* table,
                            const void* lengths, void* out, void* o_part,
                            void* ml, int B, int H, int KH, int D, int page,
                            int P, int mpp, int splits, int quantized,
                            float sm_scale, void* stream) {
  if (KH <= 0 || H % KH != 0 || page <= 0 || page % 16 != 0 || splits < 1 ||
      (splits > 1 && (o_part == nullptr || ml == nullptr)) ||
      (splits == 1 && out == nullptr))
    return int(cudaErrorInvalidValue);
  const Launch f{q, pool_k, pool_v, pool_ks, pool_vs, table, lengths, out,
                 o_part, ml, B, H, KH, page, P, mpp, splits, sm_scale,
                 static_cast<cudaStream_t>(stream)};
  return by_kind(quantized, D, page, f, int(cudaErrorInvalidValue));
}

// The combine kernel: out [B * H, D] bf16 from the partials of
// `paged_decode`.
extern "C" int paged_decode_combine(const void* o_part, const void* ml,
                                    void* out, int BH, int D, int splits,
                                    void* stream) {
  if (BH < 0 || D <= 0 || splits < 1) return int(cudaErrorInvalidValue);
  if (BH == 0) return 0;
  paged_decode_combine_kernel<<<BH, THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(ml),
      static_cast<__nv_bfloat16*>(out), splits, D);
  return int(cudaGetLastError());
}
