// The backward of an embedding lookup, out = table[rows], for sm_90a:
// the dense table gradient, float32 or float64,
//   dtable[r, :] = sum of grad[i, :] over the positions i with rows[i] == r,
// every untouched row zero, with no float atomics, so that every run,
// eager or replayed from a CUDA graph, gives the same bits. Plain
// version: rat_tpu_torch/ops/embedding_grad.py::table_grad_reference
// (index_put_ with accumulate, what autograd runs for table[rows]).
//
// Replaces no TPU kernel: the JAX package's lookups are gathers, whose
// transpose XLA writes as a scatter-add. This kernel was written for the
// H100, where PyTorch's backward of advanced indexing sorts the ids and
// gives each distinct id one warp that adds the id's rows one after
// another, so it takes as long as the longest run of one id: a padding
// row or a small field's value recurs tens of thousands of times a batch.
//
// What bounds it on the H100: bytes. It reads each gradient row once
// (N x d x 4 bytes) and writes each table row once; at KKBox's shape
// (417,792 ids, d = 40, 91,557 rows) that is 81 MB, about 0.025 ms at
// 3.35 TB/s. The additions are a few million.
//
// Design:
//   1. prepare_kernel: the ids as 32-bit keys (a negative row counts
//      from the end, as table[rows] reads it) and their positions;
//      CUB's radix sort, stable, over the bits the table's rows need,
//      orders them by id with the positions of one id ascending.
//   2. segment_sum_kernel: the sorted entries cut into segments of kSeg.
//      A group of lanes sums one segment's gradient rows in order, each
//      lane a vector of V columns (V = 4, 2 or 1 floats, 2 or 1 doubles,
//      as d and the pointers' alignment allow; lanes = d / V rounded up to a power of two, at
//      most 32, with tiles of columns beyond that). A run of one id that
//      begins and ends inside the segment is complete and written to its
//      row. A run that began in an earlier segment leaves its part in
//      head[segment]; a run that begins here and goes on past the
//      segment's end leaves its part in tail[segment].
//   3. chain_sum_kernel: for each run that crosses a segment boundary,
//      the segment where it began adds its tail and the heads of the
//      segments it runs through, in ascending order, into its row.
// So no run is summed by more than one lane group at a time for more
// than kSeg entries, the longest run costs its length / kSeg loads in
// the second pass, and the order of every sum is fixed by the sort.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kSeg = 64;          // sorted entries a lane group sums
constexpr int kBatch = 8;         // entries whose loads are in flight together
constexpr int kThreads = 256;
constexpr size_t kAlign = 256;    // of each buffer in the workspace
constexpr unsigned kNone = 0xffffffffu;   // no id: before the first entry, after the last

static_assert(kSeg % kBatch == 0, "a segment is whole batches");

size_t align_up(size_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

__device__ __forceinline__ void vzero(float& a) { a = 0.f; }
__device__ __forceinline__ void vzero(float2& a) { a = make_float2(0.f, 0.f); }
__device__ __forceinline__ void vzero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void vzero(double& a) { a = 0.0; }
__device__ __forceinline__ void vzero(double2& a) { a = make_double2(0.0, 0.0); }
__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float2& a, float2 b) {
  a.x += b.x;
  a.y += b.y;
}
__device__ __forceinline__ void vadd(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void vadd(double& a, double b) { a += b; }
__device__ __forceinline__ void vadd(double2& a, double2 b) {
  a.x += b.x;
  a.y += b.y;
}

__global__ void prepare_kernel(const long long* __restrict__ rows, int n, long long num_rows,
                               unsigned* __restrict__ keys, int* __restrict__ pos) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const long long r = rows[i];
    keys[i] = static_cast<unsigned>(r < 0 ? r + num_rows : r);
    pos[i] = i;
  }
}

// Where a thread works: segment ``seg`` (entries [start, stop)), vector
// column ``col`` of the row; false for a lane past the row's end or a
// group past the last segment.
struct Place {
  long long seg;
  int start, stop, col;
};

__device__ __forceinline__ bool place(int n, int dv, int lanes, int tiles, Place& p) {
  const long long thread = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long group = thread / lanes;
  p.seg = group / tiles;
  p.col = static_cast<int>(group % tiles) * lanes + static_cast<int>(thread % lanes);
  if (p.seg * kSeg >= n || p.col >= dv) return false;
  p.start = static_cast<int>(p.seg * kSeg);
  p.stop = min(p.start + kSeg, n);
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const unsigned* __restrict__ ids, const int* __restrict__ pos,
                   const T* __restrict__ grad, int n, int dv, int lanes, int tiles,
                   T* __restrict__ out, T* __restrict__ head, T* __restrict__ tail) {
  Place p;
  if (!place(n, dv, lanes, tiles, p)) return;
  const unsigned before = p.start > 0 ? ids[p.start - 1] : kNone;
  const unsigned after = p.stop < n ? ids[p.stop] : kNone;
  unsigned cur = ids[p.start];
  bool continued = before == cur;     // the current run began in an earlier segment
  T acc;
  vzero(acc);
  for (int i0 = p.start; i0 < p.stop; i0 += kBatch) {
    unsigned id[kBatch];
    T g[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = min(i0 + k, p.stop - 1);
      id[k] = ids[i];
      g[k] = grad[static_cast<size_t>(pos[i]) * dv + p.col];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (i0 + k < p.stop) {
        if (id[k] != cur) {       // the run of ``cur`` ended inside the segment
          (continued ? head + p.seg * dv : out + static_cast<size_t>(cur) * dv)[p.col] = acc;
          vzero(acc);
          cur = id[k];
          continued = false;
        }
        vadd(acc, g[k]);
      }
    }
  }
  T* dst = continued ? head + p.seg * dv
           : after == cur ? tail + p.seg * dv
                          : out + static_cast<size_t>(cur) * dv;
  dst[p.col] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_sum_kernel(const unsigned* __restrict__ ids, int n, int dv, int lanes, int tiles,
                 const T* __restrict__ head, const T* __restrict__ tail, T* __restrict__ out) {
  Place p;
  if (!place(n, dv, lanes, tiles, p) || p.stop == n) return;
  const unsigned y = ids[p.stop - 1];
  // the last run goes on past the segment, and began in it (else an
  // earlier segment owns it and this one's part is a head)
  if (ids[p.stop] != y || (p.start > 0 && ids[p.start - 1] == y)) return;
  int lo = p.stop + 1, hi = n;        // the first entry after the run
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (ids[mid] == y)
      lo = mid + 1;
    else
      hi = mid;
  }
  const long long last = (lo - 1) / kSeg;   // the segment of the run's last entry
  T acc = tail[p.seg * dv + p.col];
#pragma unroll 8
  for (long long s = p.seg + 1; s <= last; ++s) vadd(acc, head[s * dv + p.col]);
  out[static_cast<size_t>(y) * dv + p.col] = acc;
}

// The workspace of one call: the keys and positions before and after the
// sort, the heads and tails of the segments, CUB's temporary storage.
struct Plan {
  int bits;
  long long nseg;
  size_t keys_in, pos_in, keys_out, pos_out, head, tail, temp, temp_bytes, total;
};

cudaError_t make_plan(int n, long long num_rows, int d, int elem, Plan& p) {
  p.bits = 1;
  while ((1LL << p.bits) < num_rows) ++p.bits;
  p.nseg = (n + kSeg - 1) / kSeg;
  p.temp_bytes = 0;
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, p.temp_bytes, static_cast<const unsigned*>(nullptr),
      static_cast<unsigned*>(nullptr), static_cast<const int*>(nullptr),
      static_cast<int*>(nullptr), n, 0, p.bits);
  if (err != cudaSuccess) return err;
  const size_t ids = align_up(static_cast<size_t>(n) * 4);
  const size_t parts = align_up(static_cast<size_t>(p.nseg) * d * elem);
  p.keys_in = 0;
  p.pos_in = p.keys_in + ids;
  p.keys_out = p.pos_in + ids;
  p.pos_out = p.keys_out + ids;
  p.head = p.pos_out + ids;
  p.tail = p.head + parts;
  p.temp = p.tail + parts;
  p.total = p.temp + align_up(p.temp_bytes);
  return cudaSuccess;
}

// S the element type, T its vector of V elements a lane loads
template <typename S, typename T>
cudaError_t sum_runs(const unsigned* ids, const int* pos, const void* grad, int n, int d,
                     char* work, const Plan& p, void* out, cudaStream_t stream) {
  constexpr int V = sizeof(T) / sizeof(S);
  const int dv = d / V;
  int lanes = 1;
  while (lanes < dv && lanes < 32) lanes *= 2;
  const int tiles = (dv + lanes - 1) / lanes;
  const long long threads = p.nseg * tiles * lanes;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  T* head = reinterpret_cast<T*>(work + p.head);
  T* tail = reinterpret_cast<T*>(work + p.tail);
  segment_sum_kernel<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      ids, pos, static_cast<const T*>(grad), n, dv, lanes, tiles, static_cast<T*>(out), head,
      tail);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chain_sum_kernel<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      ids, n, dv, lanes, tiles, head, tail, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device workspace a call with n ids, num_rows table rows,
// width d and elements of elem bytes (4: float32, 8: float64) needs; a
// negative cudaError_t where the shape or element is refused.
long long embedding_grad_workspace_bytes(int n, long long num_rows, int d, int elem) {
  if (n < 0 || d < 0 || num_rows < 0 || num_rows > INT_MAX || (elem != 4 && elem != 8))
    return -static_cast<long long>(cudaErrorInvalidValue);
  Plan p;
  cudaError_t err = make_plan(n, num_rows, d, elem, p);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return static_cast<long long>(p.total);
}

// rows [n] int64 (ids in [-num_rows, num_rows)), grad [n, d] of elem
// bytes each (4: float32, 8: float64), contiguous on the device;
// workspace as embedding_grad_workspace_bytes says, 256-byte aligned.
// Writes out [num_rows, d] in grad's type: every row, zeros where no id
// falls. Launches on ``stream``; does not synchronise.
int embedding_grad_launch(const void* rows, const void* grad, void* out, void* workspace,
                          long long workspace_bytes, int n, long long num_rows, int d,
                          int elem, void* stream) {
  if (n < 0 || d < 0 || num_rows < 0 || num_rows > INT_MAX || (elem != 4 && elem != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(num_rows) * d * elem, s);
  if (err != cudaSuccess || n == 0 || d == 0 || num_rows == 0) return static_cast<int>(err);
  Plan p;
  err = make_plan(n, num_rows, d, elem, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto base = reinterpret_cast<uintptr_t>(workspace);
  if (base % kAlign != 0 || workspace_bytes < static_cast<long long>(p.total))
    return static_cast<int>(cudaErrorInvalidValue);
  char* work = static_cast<char*>(workspace);
  auto keys_in = reinterpret_cast<unsigned*>(work + p.keys_in);
  auto keys_out = reinterpret_cast<unsigned*>(work + p.keys_out);
  auto pos_in = reinterpret_cast<int*>(work + p.pos_in);
  auto pos_out = reinterpret_cast<int*>(work + p.pos_out);
  const int blocks = std::min((n + 255) / 256, 4096);
  prepare_kernel<<<blocks, 256, 0, s>>>(static_cast<const long long*>(rows), n, num_rows,
                                        keys_in, pos_in);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t temp_bytes = p.temp_bytes;
  err = cub::DeviceRadixSort::SortPairs(work + p.temp, temp_bytes, keys_in, keys_out, pos_in,
                                        pos_out, n, 0, p.bits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto g = reinterpret_cast<uintptr_t>(grad), o = reinterpret_cast<uintptr_t>(out);
  if (elem == 8) {
    if (d % 2 == 0 && g % 16 == 0 && o % 16 == 0)
      return static_cast<int>(
          sum_runs<double, double2>(keys_out, pos_out, grad, n, d, work, p, out, s));
    return static_cast<int>(
        sum_runs<double, double>(keys_out, pos_out, grad, n, d, work, p, out, s));
  }
  if (d % 4 == 0 && g % 16 == 0 && o % 16 == 0)
    return static_cast<int>(
        sum_runs<float, float4>(keys_out, pos_out, grad, n, d, work, p, out, s));
  if (d % 2 == 0 && g % 8 == 0 && o % 8 == 0)
    return static_cast<int>(
        sum_runs<float, float2>(keys_out, pos_out, grad, n, d, work, p, out, s));
  return static_cast<int>(
      sum_runs<float, float>(keys_out, pos_out, grad, n, d, work, p, out, s));
}

}  // extern "C"
