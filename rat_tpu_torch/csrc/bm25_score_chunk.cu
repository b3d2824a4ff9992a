// Dense BM25 scores of a query batch against one pool chunk, for sm_90a.
//
// Replaces the TPU kernel rat_tpu/ops/pallas/bm25_scan.py
// ::bm25_score_chunk_pallas (pallas_call at :60, body _score_kernel
// :33-45), the score-only kernel with no top-K. Plain version:
// rat_tpu_torch/ops/bm25_score_chunk.py::bm25_score_chunk_reference.
//
// Function: for query b and row c of the row-major chunk db[C, F],
//   out[b, c] = sum_f (qry[b,f] == db[c,f]) ? idf[b,f] : 0,
// added in ascending f order in float32 (no fast math), so the kernel
// and the plain version give the same bits. Any B and C: the ragged
// edge is masked here, where the Pallas kernel needs the caller to pad.
//
// What bounds it on the H100: bytes. The kernel must write the B x C
// float32 matrix; at the engine's chunk shape (4096 queries x 50,000
// rows, F=3) that is 819 MB, about 0.245 ms at 3.35 TB/s, against
// 1.2e9 compares and adds (about 0.018 ms at 67 TFLOP/s). The inputs
// are a few hundred KB.
//
// Design: so that the stores run at the memory's rate, a CTA of 256
// threads takes a tile of 32 queries x 512 chunk rows, and every store
// instruction of a warp writes 32 consecutive columns of one query row
// (128 bytes, coalesced). The CTA first stages the tile's qry/idf rows
// and its db rows (one contiguous segment of db) in shared memory with
// coalesced loads. Each thread then takes 2 chunk rows, holds their F
// ids in registers, and walks the 32 queries, whose ids and IDF every
// thread of the warp reads at the same shared address (a broadcast).
// F is a template parameter (1..16), so the field loop unrolls.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 2;
constexpr int kCols = kThreads * kRowsPerThread;   // chunk rows per CTA
constexpr int kQueries = 32;                       // queries per CTA
constexpr int kMaxF = 16;
constexpr int kMaxGridY = 65535;

template <int F>
__global__ void __launch_bounds__(kThreads)
bm25_score_chunk_kernel(const int* __restrict__ qry, const float* __restrict__ qidf,
                        const int* __restrict__ db, int B, int C,
                        float* __restrict__ out) {
  __shared__ int s_db[kCols * F];
  __shared__ int s_q[kQueries * F];
  __shared__ float s_w[kQueries * F];
  const int c0 = blockIdx.x * kCols;
  const int q0 = blockIdx.y * kQueries;
  const int ncol = min(kCols, C - c0);
  const int nq = min(kQueries, B - q0);
  for (int it = threadIdx.x; it < ncol * F; it += kThreads)
    s_db[it] = db[(size_t)c0 * F + it];
  for (int it = threadIdx.x; it < nq * F; it += kThreads) {
    s_q[it] = qry[(size_t)q0 * F + it];
    s_w[it] = qidf[(size_t)q0 * F + it];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = k * kThreads + threadIdx.x;
    if (r < ncol) {
      int dv[F];
#pragma unroll
      for (int f = 0; f < F; ++f) dv[f] = s_db[r * F + f];
      float* o = out + (size_t)q0 * C + c0 + r;
#pragma unroll 4
      for (int q = 0; q < nq; ++q) {
        float s = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f)
          s += (s_q[q * F + f] == dv[f]) ? s_w[q * F + f] : 0.f;
        o[(size_t)q * C] = s;
      }
    }
  }
}

template <int F>
cudaError_t launch(const int* qry, const float* qidf, const int* db, int B,
                   int C, float* out, cudaStream_t stream) {
  const dim3 grid((C + kCols - 1) / kCols, (B + kQueries - 1) / kQueries);
  bm25_score_chunk_kernel<F><<<grid, kThreads, 0, stream>>>(qry, qidf, db, B,
                                                            C, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bm25_score_chunk_max_fields() { return kMaxF; }

// qry [B, F] i32, qidf [B, F] f32, db [C, F] i32 (row-major), all
// contiguous on the device. Writes out [B, C] f32.
int bm25_score_chunk_launch(const void* qry, const void* qidf, const void* db,
                            int B, int F, int C, void* out, void* stream) {
  if (F < 1 || F > kMaxF || B < 0 || C < 0 ||
      (B + kQueries - 1) / kQueries > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const int*>(qry);
  auto w = static_cast<const float*>(qidf);
  auto d = static_cast<const int*>(db);
  auto o = static_cast<float*>(out);
  switch (F) {
#define SCORE_CASE(NF) \
  case NF:             \
    return (int)launch<NF>(q, w, d, B, C, o, s);
    SCORE_CASE(1) SCORE_CASE(2) SCORE_CASE(3) SCORE_CASE(4)
    SCORE_CASE(5) SCORE_CASE(6) SCORE_CASE(7) SCORE_CASE(8)
    SCORE_CASE(9) SCORE_CASE(10) SCORE_CASE(11) SCORE_CASE(12)
    SCORE_CASE(13) SCORE_CASE(14) SCORE_CASE(15) SCORE_CASE(16)
#undef SCORE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
