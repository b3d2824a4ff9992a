// Fused BM25 score + top-K over a categorical pool, for sm_90a.
//
// Replaces the TPU kernels rat_tpu/ops/pallas/bm25_scan.py
// ::bm25_topk_fused_pallas_qmajor (pallas_call at :193) and
// ::bm25_topk_fused_pallas_cmajor (:271); the two grids return the same
// bits, so one kernel serves both. Plain version:
// rat_tpu_torch/ops/bm25_topk.py::bm25_topk_reference.
//
// Function: for each query b and pool row c (field-major pool
// dbT[F, C]),   score = sum_f (qry[b,f] == dbT[f,c]) ? idf[b,f] : 0,
// added in ascending f order in float32 (no fast math), so equal match
// sets give equal bits; rows c >= valid_len score 0. The K best rows
// are returned in the exact order (score desc, pool index asc), before
// the zero-score drop that the caller applies.
//
// What bounds it on the H100: instruction throughput. Each (query, row)
// pair costs F integer compares (on the half-rate integer pipe) and F
// predicated adds, some 5e9 pairs per call on the main path, against a
// pool of a few MB that stays in L2.
//
// Design, to spend as few instructions per pair as possible:
// - Register tiling. A thread owns QT queries (2, or 1 above F=8), a
//   CTA 128 x QT. The pool streams through shared memory in [F, kTile]
//   tiles; one broadcast int4 load brings 4 consecutive rows of one
//   field, which serve 4 x QT pairs. The adds are predicated add.rn.f32:
//   the same bits as s + (eq ? w : 0), since s starts at +0 and never
//   becomes -0.
// - One strict compare per group of 4 rows. A thread scans its rows in
//   increasing pool index, so every entry already in its list has a
//   lower index than the row at hand, or is a placeholder of index
//   INT_MAX. For a finite score s the lexicographic test "(s, c) beats
//   (tv, ti)", (score desc, index asc), then reduces to s > tv. The hot
//   loop takes the max of the group's 4 scores per query and branches,
//   once for all the thread's queries, to the insertion only when one
//   beats its K-th best; there each row is offered in index order. This
//   is why the bits equal the plain version's. The cross-part merge
//   keeps the full lexicographic compare.
// - The sorted lists live in shared memory and only the bar (the K-th
//   best score) in a register, so the hot loop holds few registers and
//   more CTAs fit; K is a run-time value up to 32.
// - Parts after the first start with a bar of 0 instead of -inf (for a
//   query whose IDF are all >= 0): zero-score rows past the first part
//   can never enter the top-K, and most rows score 0, so the lists skip
//   a warm-up of K insertions in every part.
// - The valid_len and part-end masks only on tiles that straddle them.
// - Double-buffered tiles: cp.async brings tile t+1 while tile t is
//   scanned (16-byte copies when the pool's rows are 16-byte aligned).
// - Hopper has no ordered grid, so the TPU kernel's running top-K across
//   grid steps has no counterpart: the pool is cut into P parts over
//   blockIdx.y, each part writes its own sorted list, and a second
//   kernel merges the P lists per query. The wrapper picks P from the
//   SM count and the CTAs that fit on an SM, so that query tiles x parts
//   fill whole waves (ops/bm25_topk.py::_geometry).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;   // pool rows per shared-memory tile
constexpr int kMaxF = 16;
constexpr int kMaxK = 32;
constexpr int kMergeThreads = 32;
constexpr int kMergeBatch = 8;   // part heads loaded together in the merge

// Queries per thread: 2 up to F=8, else 1, so that each thread's query
// ids and IDF (2 x QT x F registers) stay near 32 registers. (4 queries
// at F=3 ran slower on the H100: fewer CTAs fit, and more warps enter
// the insertion path.)
template <int F>
__host__ __device__ constexpr int queries_per_thread() {
  return F <= 8 ? 2 : 1;
}

__device__ __forceinline__ bool better(float s, int i, float s2, int i2) {
  return s > s2 || (s == s2 && i < i2);
}

// Sorted (desc) register list of the merge; top-K is its first K
// entries.
struct TopK {
  static constexpr int KMAX = kMaxK;
  float v[KMAX];
  int ix[KMAX];
  float tv;   // entry K-1, the bar a candidate must beat
  int ti;

  __device__ __forceinline__ void init(float start) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) { v[k] = start; ix[k] = INT_MAX; }
    tv = start;
    ti = INT_MAX;
  }

  // Insert (s, i), known to beat entry K-1, at the first slot p it
  // beats: slots from p on move down one. Branch-free selects, top slot
  // first, so each slot reads its unmoved neighbour.
  __device__ __forceinline__ void insert(float s, int i, int K) {
#pragma unroll
    for (int k = KMAX - 1; k > 0; --k) {
      const bool below = better(s, i, v[k - 1], ix[k - 1]);   // k > p
      const bool here = !below && better(s, i, v[k], ix[k]);  // k == p
      v[k] = below ? v[k - 1] : (here ? s : v[k]);
      ix[k] = below ? ix[k - 1] : (here ? i : ix[k]);
    }
    if (better(s, i, v[0], ix[0])) { v[0] = s; ix[0] = i; }
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k == K - 1) { tv = v[k]; ti = ix[k]; }
    }
  }

  __device__ __forceinline__ void store(float* out_v, int* out_i, int K) const {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) { out_v[k] = v[k]; out_i[k] = ix[k]; }
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

// Start copying pool rows [r0, r0 + kTile) of every field into buf
// [F][kTile]; rows at or past C are zero-filled. A thread copies rows
// 4 * tid .. 4 * tid + 3 of each field: one 16-byte copy when vec
// (C % 4 == 0 and dbT 16-byte aligned), else four 4-byte copies.
static_assert(kTile == 4 * kThreads, "a thread copies 4 rows of each field");
template <int F>
__device__ __forceinline__ void load_tile(int* buf, const int* __restrict__ dbT, int C,
                                          int r0, bool vec) {
  const int r = 4 * threadIdx.x;
  if (vec) {
    const bool ok = r0 + r < C;
    const int* src = dbT + (ok ? r0 + r : 0);
#pragma unroll
    for (int f = 0; f < F; ++f, src += C) cp_async16(buf + f * kTile + r, src, ok);
  } else {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const bool ok = r0 + r + k < C;
      const int* src = dbT + (ok ? r0 + r + k : 0);
#pragma unroll 1
      for (int f = 0; f < F; ++f, src += C) cp_async4(buf + f * kTile + r + k, src, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// s += w where a == b, as one predicated add (round to nearest).
__device__ __forceinline__ void add_if_eq(float& s, int a, int b, float w) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t@p add.rn.f32 %0, %0, %3;\n\t}"
      : "+f"(s) : "r"(a), "r"(b), "f"(w));
}

// Score of row r of the tile for one query (fields in ascending order).
template <int F>
__device__ __forceinline__ float row_score(const int* tile, int r, const int (&qv)[F],
                                           const float (&wv)[F]) {
  float s = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) add_if_eq(s, qv[f], tile[f * kTile + r], wv[f]);
  return s;
}

// A thread's sorted (desc) list for one query lives in shared memory,
// entry k at [k * kThreads], so that the scan keeps only the bar in a
// register. Insert (s, c), with s above the bar (entry K-1), after every
// entry with a score >= s: c exceeds every index in the list, so ties
// keep their order. Returns the new bar.
__device__ __forceinline__ float insert_after(float* v, int* ix, float s, int c, int K) {
  int k = K - 1;
#pragma unroll 1
  for (; k > 0; --k) {
    const float up = v[(k - 1) * kThreads];
    if (!(s > up)) break;
    v[k * kThreads] = up;
    ix[k * kThreads] = ix[(k - 1) * kThreads];
  }
  v[k * kThreads] = s;
  ix[k * kThreads] = c;
  return v[(K - 1) * kThreads];
}

// Scan one tile (rows r0 .. r0 + kTile) for the thread's QT queries.
// The hot loop scores a group of 4 rows per query and tests each
// query's group max against its bar, all queries in one branch. The
// rare path then offers each passing query the group's rows in index
// order. MASK (a tile that reaches valid_len or the part's end hi)
// always takes the rare path, which then scores rows past valid_len 0
// and skips rows past hi (the next part's).
template <int F, int QT, bool MASK>
__device__ __forceinline__ void scan_tile(const int* tile, int r0, int hi, int valid_len,
                                          const int (&qv)[QT][F], const float (&wv)[QT][F],
                                          float (&tv)[QT], float* lv, int* li, int K) {
#pragma unroll 1
  for (int g = 0; g < kTile; g += 4) {
    float s[QT][4];
#pragma unroll
    for (int i = 0; i < QT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int4 d = *reinterpret_cast<const int4*>(tile + f * kTile + g);
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        add_if_eq(s[i][0], qv[i][f], d.x, wv[i][f]);
        add_if_eq(s[i][1], qv[i][f], d.y, wv[i][f]);
        add_if_eq(s[i][2], qv[i][f], d.z, wv[i][f]);
        add_if_eq(s[i][3], qv[i][f], d.w, wv[i][f]);
      }
    }
    bool pass[QT];
    bool any = MASK;
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      pass[i] = MASK || fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])) > tv[i];
      any |= pass[i];
    }
    if (!any) continue;
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      if (!pass[i]) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = r0 + g + j;
        if (MASK && c >= hi) break;
        const float sc = MASK && c >= valid_len ? 0.f : row_score<F>(tile, g + j, qv[i], wv[i]);
        if (sc > tv[i])
          tv[i] = insert_after(lv + i * K * kThreads, li + i * K * kThreads, sc, c, K);
      }
    }
  }
}

// One CTA: QT x 128 queries against one part of the pool. Writes the
// part's sorted list of query q, entry k, at out + q * q_stride +
// k * k_stride + blockIdx.y * p_stride. Shared memory: two pool tiles
// [2][F][kTile], then the lists [QT][K][kThreads] of scores and indices.
// No __launch_bounds__: with it, ptxas spilled a few bytes in some of
// the F instantiations; without, none spills.
template <int F>
__global__ void bm25_scan_kernel(const int* __restrict__ qry, const float* __restrict__ qidf,
                                 const int* __restrict__ dbT, int B, int C, int valid_len,
                                 int K, int rows_per_part, int vec,
                                 float* __restrict__ out_v, int* __restrict__ out_i,
                                 size_t q_stride, size_t k_stride, size_t p_stride) {
  constexpr int QT = queries_per_thread<F>();
  extern __shared__ int4 smem4[];
  int* tiles = reinterpret_cast<int*>(smem4);
  float* lv = reinterpret_cast<float*>(tiles + 2 * F * kTile) + threadIdx.x;
  int* li = reinterpret_cast<int*>(lv - threadIdx.x + QT * K * kThreads) + threadIdx.x;

  const int q0 = blockIdx.x * kThreads * QT + threadIdx.x;
  int qv[QT][F];
  float wv[QT][F];
  float tv[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const int q = q0 + i * kThreads;
    const bool active = q < B;
    bool nonneg = true;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      qv[i][f] = active ? qry[(size_t)q * F + f] : 0;
      wv[i][f] = active ? qidf[(size_t)q * F + f] : 0.f;
      nonneg = nonneg && wv[i][f] >= 0.f;
    }
    // Parts after the first start from K (0, INT_MAX) entries when the
    // query's scores cannot go below 0: the first part's list holds K
    // rows of score >= 0 and lower index, which beat any later row of
    // score 0, so such rows need not enter; the placeholders lose to
    // those K rows in the merge.
    tv[i] = blockIdx.y > 0 && nonneg ? 0.f : -CUDART_INF_F;
    for (int k = 0; k < K; ++k) {
      lv[(i * K + k) * kThreads] = tv[i];
      li[(i * K + k) * kThreads] = INT_MAX;
    }
  }

  const int lo = blockIdx.y * rows_per_part;
  const int hi = min(C, lo + rows_per_part);
  const int unmasked_end = min(hi, valid_len);
  const int ntiles = (hi - lo + kTile - 1) / kTile;
  if (ntiles > 0) load_tile<F>(tiles, dbT, C, lo, vec);
  for (int t = 0; t < ntiles; ++t) {
    const int r0 = lo + t * kTile;
    if (t + 1 < ntiles) {
      load_tile<F>(tiles + ((t + 1) & 1) * F * kTile, dbT, C, r0 + kTile, vec);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int* tile = tiles + (t & 1) * F * kTile;
    if (r0 + kTile <= unmasked_end)
      scan_tile<F, QT, false>(tile, r0, hi, valid_len, qv, wv, tv, lv, li, K);
    else
      scan_tile<F, QT, true>(tile, r0, hi, valid_len, qv, wv, tv, lv, li, K);
    __syncthreads();   // the next iteration refills this buffer
  }
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const int q = q0 + i * kThreads;
    if (q < B) {
      const size_t o = q * q_stride + blockIdx.y * p_stride;
      for (int k = 0; k < K; ++k) {
        out_v[o + k * k_stride] = lv[(i * K + k) * kThreads];
        out_i[o + k * k_stride] = li[(i * K + k) * kThreads];
      }
    }
  }
}

// Merge the P sorted part lists of each query, parts in pool order.
// part_v / part_i are [P, K, B]. A part's list is sorted, so its first
// entry that does not beat the bar ends that part.
__global__ void __launch_bounds__(kMergeThreads)
bm25_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int P, int B, int K, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  const int q = blockIdx.x * kMergeThreads + threadIdx.x;
  if (q >= B) return;
  TopK top;
  top.init(-CUDART_INF_F);
  const size_t kb = (size_t)K * B;
  for (int p0 = 0; p0 < P; p0 += kMergeBatch) {
    float hv[kMergeBatch];
    int hx[kMergeBatch];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const bool ok = p0 + u < P;
      hv[u] = ok ? part_v[(p0 + u) * kb + q] : -CUDART_INF_F;
      hx[u] = ok ? part_i[(p0 + u) * kb + q] : INT_MAX;
    }
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      if (!better(hv[u], hx[u], top.tv, top.ti)) continue;
      top.insert(hv[u], hx[u], K);
      const size_t o = (p0 + u) * kb + q;
      for (int k = 1; k < K; ++k) {
        const float s = part_v[o + k * B];
        const int i = part_i[o + k * B];
        if (!better(s, i, top.tv, top.ti)) break;
        top.insert(s, i, K);
      }
    }
  }
  top.store(out_v + (size_t)q * K, out_i + (size_t)q * K, K);
}

template <int F>
struct Kernel {
  static constexpr int kQueriesPerCta = kThreads * queries_per_thread<F>();

  static int smem_bytes(int K) {
    return (2 * F * kTile + 2 * queries_per_thread<F>() * K * kThreads) * (int)sizeof(int);
  }

  static cudaError_t prepare(int K) {
    return cudaFuncSetAttribute(bm25_scan_kernel<F>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(K));
  }

  static cudaError_t ctas_per_sm(int K, int* n) {
    cudaError_t err = prepare(K);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, bm25_scan_kernel<F>, kThreads,
                                                         smem_bytes(K));
  }

  static cudaError_t launch(const int* qry, const float* qidf, const int* dbT, int B,
                            int C, int valid_len, int K, int P, int rows_per_part,
                            int vec, float* part_v, int* part_i, float* out_v,
                            int* out_i, cudaStream_t stream) {
    cudaError_t err = prepare(K);
    if (err != cudaSuccess) return err;
    const int q_tiles = (B + kQueriesPerCta - 1) / kQueriesPerCta;
    const int smem = smem_bytes(K);
    if (P == 1) {   // one part: its list is the answer, [B, K]
      bm25_scan_kernel<F><<<dim3(q_tiles, 1), kThreads, smem, stream>>>(
          qry, qidf, dbT, B, C, valid_len, K, rows_per_part, vec, out_v, out_i,
          (size_t)K, 1, 0);
      return cudaGetLastError();
    }
    bm25_scan_kernel<F><<<dim3(q_tiles, P), kThreads, smem, stream>>>(
        qry, qidf, dbT, B, C, valid_len, K, rows_per_part, vec, part_v, part_i, 1,
        (size_t)B, (size_t)K * B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bm25_merge_kernel<<<(B + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, stream>>>(
        part_v, part_i, P, B, K, out_v, out_i);
    return cudaGetLastError();
  }
};

// Call fn(Kernel<F>{}) for the compiled kernel of F fields.
template <typename Fn>
cudaError_t dispatch(int F, int K, Fn&& fn) {
  if (K < 1 || K > kMaxK) return cudaErrorInvalidValue;
  switch (F) {
#define BM25_CASE(NF) \
  case NF:            \
    return fn(Kernel<NF>{});
    BM25_CASE(1) BM25_CASE(2) BM25_CASE(3) BM25_CASE(4)
    BM25_CASE(5) BM25_CASE(6) BM25_CASE(7) BM25_CASE(8)
    BM25_CASE(9) BM25_CASE(10) BM25_CASE(11) BM25_CASE(12)
    BM25_CASE(13) BM25_CASE(14) BM25_CASE(15) BM25_CASE(16)
#undef BM25_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int bm25_topk_max_fields() { return kMaxF; }
int bm25_topk_max_k() { return kMaxK; }
int bm25_topk_tile_rows() { return kTile; }

// The scan kernel serving (F, K): queries per CTA, and the CTAs that fit
// on one SM with its registers and shared memory.
int bm25_topk_occupancy(int F, int K, int* queries_per_cta, int* ctas_per_sm) {
  return (int)dispatch(F, K, [&](auto kernel) {
    *queries_per_cta = decltype(kernel)::kQueriesPerCta;
    return decltype(kernel)::ctas_per_sm(K, ctas_per_sm);
  });
}

// qry [B, F] i32, qidf [B, F] f32, dbT [F, C] i32 (C >= K), all
// contiguous on the device. The pool is cut into P parts of
// rows_per_part rows (a multiple of the tile); part_v / part_i are
// [P, K, B] scratch (unused when P == 1). vec != 0 says that C % 4 == 0
// and dbT is 16-byte aligned. Writes out_v [B, K] f32 and out_i [B, K]
// i32.
int bm25_topk_launch(const void* qry, const void* qidf, const void* dbT,
                     int B, int F, int C, int valid_len, int K, int P,
                     int rows_per_part, int vec, void* part_v, void* part_i,
                     void* out_v, void* out_i, void* stream) {
  if (C < K || P < 1 || rows_per_part < 1 || rows_per_part % kTile != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return (int)dispatch(F, K, [&](auto kernel) {
    return decltype(kernel)::launch(
        static_cast<const int*>(qry), static_cast<const float*>(qidf),
        static_cast<const int*>(dbT), B, C, valid_len, K, P, rows_per_part, vec,
        static_cast<float*>(part_v), static_cast<int*>(part_i),
        static_cast<float*>(out_v), static_cast<int*>(out_i),
        static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
