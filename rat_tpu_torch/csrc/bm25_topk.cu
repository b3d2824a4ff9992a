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
// What bounds it on the H100: operations. Each (query, row) pair costs
// F integer compares and F adds, plus a compare against the running
// K-th best; the pool is read once per 128-query tile from L2/HBM, a
// few MB against billions of compare-adds (B=4096, C=1.4M, F=3 is
// 3.4e10 operations against 17 MB).
//
// Design: a CTA owns 128 queries, one per thread, each with its query
// ids and IDF in registers (F is a template parameter) and a sorted
// top-K list in registers (capacity KMAX, compile-time, so the
// insertion is fully unrolled). The CTA streams its share of the pool
// through shared memory in [F, TILE] tiles; every thread of a warp reads
// the same pool element, a broadcast. Hopper has no ordered grid, so
// the TPU kernel's running accumulator that lives across grid steps has
// no counterpart: the pool is split into P parts over blockIdx.y to
// fill the 132 SMs, each part writes its own sorted list, and a second
// kernel merges the P lists per query. Each thread scans its rows in
// increasing index order and the merge compares (score, index)
// lexicographically, so ties keep the lowest pool index.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;   // pool rows per shared-memory tile
constexpr int kMaxF = 16;
constexpr int kMaxK = 32;

__device__ __forceinline__ bool better(float s, int i, float s2, int i2) {
  return s > s2 || (s == s2 && i < i2);
}

// Sorted (desc) register list; top-K is its first K entries.
template <int KMAX>
struct TopK {
  float v[KMAX];
  int ix[KMAX];
  float tv;   // entry K-1, the bar a candidate must beat
  int ti;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) { v[k] = -CUDART_INF_F; ix[k] = INT_MAX; }
    tv = -CUDART_INF_F;
    ti = INT_MAX;
  }

  // Insert (s, i), known to beat entry K-1 (and so entry KMAX-1), at
  // the first slot p it beats: slots above p move down one. Branch-free
  // selects, top slot first, so each slot reads its unmoved neighbour.
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

  __device__ __forceinline__ void offer(float s, int i, int K) {
    if (better(s, i, tv, ti)) insert(s, i, K);
  }

  __device__ __forceinline__ void store(float* out_v, int* out_i, int K) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) { out_v[k] = v[k]; out_i[k] = ix[k]; }
    }
  }
};

template <int F, int KMAX>
__global__ void __launch_bounds__(kThreads)
bm25_scan_kernel(const int* __restrict__ qry, const float* __restrict__ qidf,
                 const int* __restrict__ dbT, int B, int C, int valid_len,
                 int K, int rows_per_part, float* __restrict__ part_v,
                 int* __restrict__ part_i) {
  __shared__ int tile[F * kTile];
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < B;
  int qv[F];
  float wv[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    qv[f] = active ? qry[(size_t)q * F + f] : 0;
    wv[f] = active ? qidf[(size_t)q * F + f] : 0.f;
  }
  TopK<KMAX> top;
  top.init();

  const int lo = blockIdx.y * rows_per_part;
  const int hi = min(C, lo + rows_per_part);
  for (int r0 = lo; r0 < hi; r0 += kTile) {
    const int n = min(kTile, hi - r0);
    __syncthreads();
    for (int it = threadIdx.x; it < F * kTile; it += kThreads) {
      const int f = it / kTile, r = it - f * kTile;
      tile[it] = r < n ? dbT[(size_t)f * C + r0 + r] : 0;
    }
    __syncthreads();
    if (active) {
#pragma unroll 1
      for (int r = 0; r < n; ++r) {
        float s = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f) s += (qv[f] == tile[f * kTile + r]) ? wv[f] : 0.f;
        const int c = r0 + r;
        if (c >= valid_len) s = 0.f;
        top.offer(s, c, K);
      }
    }
  }
  if (active) {
    const size_t o = ((size_t)blockIdx.y * B + q) * K;
    top.store(part_v + o, part_i + o, K);
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
bm25_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int P, int B, int K, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= B) return;
  TopK<KMAX> top;
  top.init();
  for (int p = 0; p < P; ++p) {
    const size_t o = ((size_t)p * B + q) * K;
    for (int k = 0; k < K; ++k) top.offer(part_v[o + k], part_i[o + k], K);
  }
  top.store(out_v + (size_t)q * K, out_i + (size_t)q * K, K);
}

template <int F, int KMAX>
cudaError_t launch(const int* qry, const float* qidf, const int* dbT, int B,
                   int C, int valid_len, int K, int P, int rows_per_part,
                   float* part_v, int* part_i, float* out_v, int* out_i,
                   cudaStream_t stream) {
  const int q_tiles = (B + kThreads - 1) / kThreads;
  float* sv = P == 1 ? out_v : part_v;
  int* si = P == 1 ? out_i : part_i;
  bm25_scan_kernel<F, KMAX><<<dim3(q_tiles, P), kThreads, 0, stream>>>(
      qry, qidf, dbT, B, C, valid_len, K, rows_per_part, sv, si);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || P == 1) return err;
  bm25_merge_kernel<KMAX><<<q_tiles, kThreads, 0, stream>>>(
      part_v, part_i, P, B, K, out_v, out_i);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t dispatch_f(int F, const int* qry, const float* qidf, const int* dbT,
                       int B, int C, int valid_len, int K, int P,
                       int rows_per_part, float* part_v, int* part_i,
                       float* out_v, int* out_i, cudaStream_t stream) {
  switch (F) {
#define BM25_CASE(NF)                                                        \
  case NF:                                                                   \
    return launch<NF, KMAX>(qry, qidf, dbT, B, C, valid_len, K, P,           \
                            rows_per_part, part_v, part_i, out_v, out_i,     \
                            stream);
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
int bm25_topk_threads() { return kThreads; }

// qry [B, F] i32, qidf [B, F] f32, dbT [F, C] i32 (C >= K), all
// contiguous on the device. The pool is cut into P parts of
// rows_per_part rows; part_v / part_i are [P, B, K] scratch (unused
// when P == 1). Writes out_v [B, K] f32 and out_i [B, K] i32.
int bm25_topk_launch(const void* qry, const void* qidf, const void* dbT,
                     int B, int F, int C, int valid_len, int K, int P,
                     int rows_per_part, void* part_v, void* part_i,
                     void* out_v, void* out_i, void* stream) {
  if (F < 1 || F > kMaxF || K < 1 || K > kMaxK || C < K || P < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const int*>(qry);
  auto w = static_cast<const float*>(qidf);
  auto db = static_cast<const int*>(dbT);
  auto pv = static_cast<float*>(part_v);
  auto pi = static_cast<int*>(part_i);
  auto ov = static_cast<float*>(out_v);
  auto oi = static_cast<int*>(out_i);
  if (K <= 8)
    return (int)dispatch_f<8>(F, q, w, db, B, C, valid_len, K, P,
                              rows_per_part, pv, pi, ov, oi, s);
  return (int)dispatch_f<kMaxK>(F, q, w, db, B, C, valid_len, K, P,
                                rows_per_part, pv, pi, ov, oi, s);
}

}  // extern "C"
