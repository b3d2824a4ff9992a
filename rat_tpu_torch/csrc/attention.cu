// Softmax attention over short sequences, forward and backward, for
// sm_90a, straight from the packed QKV projection.
//
// Replaces no TPU kernel: the JAX package leaves this attention to XLA
// (rat_tpu's nn layers call jnp.matmul and jax.nn.softmax). It was
// written for the H100, where the plain version's two batched products
// run as hundreds of thousands of independent 14 x 10 x 14 and 6 x 10 x 6
// cuBLAS products that fit no tile of its kernels, with head transposes,
// the saved softmax and, in the backward, the cat of chunk's gradient
// around them. Plain version: rat_tpu_torch/ops/attention.py
// ::attention_reference (its backward: autograd of it, and the formulas
// below in ::attention_grad_reference).
//
// Function, for n sequences of S tokens, H heads of width DH, I = H * DH:
//   qkv [n, S, 3 I] float32: q at columns [0, I), k at [I, 2 I), v at
//   [2 I, 3 I), head h the slice [h DH, (h + 1) DH) of each;
//   forward:  P = softmax((q k^T) * scale) per head, row by row,
//             out [n, S, I] = P v, head h at columns [h DH, (h + 1) DH);
//   backward: from dout [n, S, I], recomputing P from qkv,
//             dV = P^T dO, dP = dO V^T, D = rowsum(P o dP),
//             dS = P o (dP - D), dQ = scale dS K, dK = scale dS^T Q,
//             written packed as dqkv [n, S, 3 I].
//
// What bounds it on the H100: bytes. At KKBox's intra shape (24,576
// sequences of 14 tokens, 8 heads of 10) the forward reads the packed
// QKV (330 MB) and writes 110 MB, 0.13 ms at 3.35 TB/s, against 1.5
// GFLOP (0.02 ms at 67 TFLOP/s); the backward reads QKV and dO and writes
// dQKV, about 0.23 ms.
//
// Design: each thread block owns G whole sequences (G chosen so the block
// has ~256 threads), and each thread one (sequence, head, query row).
// - The block copies its sequences' packed rows, one contiguous span of
//   G S 3I floats, into shared memory with asynchronous 16-byte copies
//   (cp.async), every one of them in flight at once, and writes its
//   outputs back from shared memory with 16-byte stores, so every global
//   access is coalesced and each byte moves once.
// - Widths are compile-time: DH = 10, the head width of every
//   configuration of the repository. A thread keeps its row's S scores
//   in registers (S <= MAXS, a compile-time bound of 8, 16 or 32),
//   takes the max, exponentiates with expf in float32 and divides by
//   the sum, as the plain softmax does, and accumulates its DH outputs
//   in registers.
// - The backward saves nothing from the forward but qkv. Its first pass
//   (thread = query row i) recomputes P's row, dP's row, D_i, dS's row
//   and dQ_i, and leaves the rows of P and dS in shared memory (S x S
//   per head, rows padded to an odd stride); its second pass (thread =
//   key row j) reads column j of both and sums dK_j and dV_j over the
//   query rows in ascending order. Every sum is one thread's, in a fixed
//   order, with no atomics: two runs give the same bits, eager or
//   replayed from a CUDA graph.
// - All arithmetic is float32 FMAs and expf (no fast math, no TF32 or
//   half types).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <mutex>
#include <type_traits>

namespace {

constexpr int kThreads = 256;      // threads a block may have
constexpr int kFwdBlocks = 4;      // blocks of kThreads an SM should hold: 64 registers
constexpr int kBwdBlocks = 3;      // 85 registers
constexpr int kDimHead = 10;       // the head width compiled: every configuration's
constexpr int kMaxPairs = 512;     // (head, token) pairs of one sequence
constexpr size_t kMaxSmem = 232448;   // bytes a block may use on the H100
constexpr int kMaxDevices = 64;

// Sequences per block: enough (head, row) items for ~kThreads.
int seqs_per_block(int S, int H) { return kThreads / (S * H) > 1 ? kThreads / (S * H) : 1; }

// Threads of a block of G sequences: an item each, at most kThreads
// (a thread then takes items tid, tid + kThreads, ...).
int block_threads(int S, int H, int G) {
  const int items = (G * S * H + 31) / 32 * 32;
  return items < kThreads ? items : kThreads;
}

template <int DH>
__device__ __forceinline__ void load_row(float (&r)[DH], const float* p) {
#pragma unroll
  for (int c = 0; c < DH; c += 2) {
    const float2 t = *reinterpret_cast<const float2*>(p + c);
    r[c] = t.x;
    r[c + 1] = t.y;
  }
}

template <int DH>
__device__ __forceinline__ void store_row(float* p, const float (&r)[DH]) {
#pragma unroll
  for (int c = 0; c < DH; c += 2) *reinterpret_cast<float2*>(p + c) = make_float2(r[c], r[c + 1]);
}

// a . b over DH columns, in column order
template <int DH>
__device__ __forceinline__ float dot(const float (&a)[DH], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DH; c += 2) {
    const float2 t = *reinterpret_cast<const float2*>(b + c);
    s = fmaf(a[c], t.x, s);
    s = fmaf(a[c + 1], t.y, s);
  }
  return s;
}

template <int DH>
__device__ __forceinline__ float dot(const float (&a)[DH], const float (&b)[DH]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DH; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// acc += w * row (DH floats in shared memory)
template <int DH>
__device__ __forceinline__ void axpy(float (&acc)[DH], float w, const float* row) {
#pragma unroll
  for (int c = 0; c < DH; c += 2) {
    const float2 t = *reinterpret_cast<const float2*>(row + c);
    acc[c] = fmaf(w, t.x, acc[c]);
    acc[c + 1] = fmaf(w, t.y, acc[c + 1]);
  }
}

template <int DH>
__device__ __forceinline__ void axpy(float (&acc)[DH], float w, const float (&row)[DH]) {
#pragma unroll
  for (int c = 0; c < DH; ++c) acc[c] = fmaf(w, row[c], acc[c]);
}

// Starts the copy of count floats from global src to shared dst as
// asynchronous copies (cp.async, 16 bytes each where vec), all in flight
// at once; wait_copies() waits for them.
__device__ __forceinline__ void copy_in(float* dst, const float* __restrict__ src, int count,
                                        int vec) {
  if (vec) {
    for (int k = threadIdx.x; k < count / 4; k += blockDim.x)
      __pipeline_memcpy_async(dst + 4 * k, src + 4 * k, 16);
  } else {
    for (int k = threadIdx.x; k < count; k += blockDim.x)
      __pipeline_memcpy_async(dst + k, src + k, 4);
  }
}

// Waits for this thread's copies, then for the block's.
__device__ __forceinline__ void wait_copies() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// count floats from shared src to global dst (16-byte stores where vec)
__device__ __forceinline__ void copy_out(float* __restrict__ dst, const float* src, int count,
                                         int vec) {
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < count / 4; k += blockDim.x) d4[k] = s4[k];
  } else {
    for (int k = threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
  }
}

// One query row's scores p[j] = exp(s_j - m) for j < S, s_j = (q . k_j)
// * scale, k_j at krow + j * W; returns m, and l (the sum) through l.
template <int DH, int MAXS>
__device__ __forceinline__ float row_scores(float (&p)[MAXS], const float (&q)[DH],
                                            const float* krow, int W, int S, float scale,
                                            float& l) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAXS; ++j) {
    if (j < S) {
      p[j] = dot<DH>(q, krow + j * W) * scale;
      m = fmaxf(m, p[j]);
    }
  }
  l = 0.f;
#pragma unroll
  for (int j = 0; j < MAXS; ++j) {
    if (j < S) {
      p[j] = expf(p[j] - m);
      l += p[j];
    }
  }
  return m;
}

template <int DH, int MAXS>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
attention_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ out, int n, int S,
                     int H, int G, float scale, int vec_in, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  const int I = H * DH, W = 3 * I, per = H * S;
  const long long seq0 = static_cast<long long>(blockIdx.x) * G;
  const int g_here = n - seq0 < G ? static_cast<int>(n - seq0) : G;
  float* s_in = smem;                                          // [G][S][W]
  float* s_out = smem + static_cast<size_t>(G) * S * W;        // [G][S][I]
  copy_in(s_in, qkv + seq0 * S * W, g_here * S * W, vec_in);
  wait_copies();
  for (int item = threadIdx.x; item < g_here * per; item += blockDim.x) {
    const int g = item / per, r = item - g * per, h = r / S, i = r - h * S;
    const float* base = s_in + static_cast<size_t>(g) * S * W + h * DH;
    float q[DH];
    load_row<DH>(q, base + i * W);
    float p[MAXS], l;
    row_scores<DH, MAXS>(p, q, base + I, W, S, scale, l);
    float o[DH];
#pragma unroll
    for (int c = 0; c < DH; ++c) o[c] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S) axpy<DH>(o, p[j] / l, base + j * W + 2 * I);
    store_row<DH>(s_out + (static_cast<size_t>(g) * S + i) * I + h * DH, o);
  }
  __syncthreads();
  copy_out(out + seq0 * S * I, s_out, g_here * S * I, vec_out);
}

template <int DH, int MAXS>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
attention_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                     float* __restrict__ dqkv, int n, int S, int H, int G, float scale,
                     int vec_qkv, int vec_dout, int vec_dqkv) {
  extern __shared__ __align__(16) float smem[];
  const int I = H * DH, W = 3 * I, per = H * S;
  const long long seq0 = static_cast<long long>(blockIdx.x) * G;
  const int g_here = n - seq0 < G ? static_cast<int>(n - seq0) : G;
  const int items = g_here * per;
  const int ps = S | 1;   // a stored row of P or dS: an odd stride, no bank conflicts
  float* s_qkv = smem;                                         // [G][S][W], then dqkv
  float* s_do = s_qkv + static_cast<size_t>(G) * S * W;        // [G][S][I]
  float* s_dq = s_do + static_cast<size_t>(G) * S * I;         // [G][S][I]
  float* s_p = s_dq + static_cast<size_t>(G) * S * I;          // [G][H][S][ps] each
  float* s_ds = s_p + static_cast<size_t>(G) * per * ps;
  copy_in(s_qkv, qkv + seq0 * S * W, g_here * S * W, vec_qkv);
  copy_in(s_do, dout + seq0 * S * I, g_here * S * I, vec_dout);
  wait_copies();
  // pass 1, query row i: P's row, dP's row, D_i, dS's row and dQ_i; the
  // rows of P and dS stay in shared memory
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int g = item / per, r = item - g * per, h = r / S, i = r - h * S;
    const float* base = s_qkv + static_cast<size_t>(g) * S * W + h * DH;   // row 0, head h
    float q[DH], d_o[DH];
    load_row<DH>(q, base + i * W);
    load_row<DH>(d_o, s_do + (static_cast<size_t>(g) * S + i) * I + h * DH);
    float p[MAXS], dp[MAXS], l;
    row_scores<DH, MAXS>(p, q, base + I, W, S, scale, l);
    float D = 0.f;
#pragma unroll
    for (int j = 0; j < MAXS; ++j) {
      if (j < S) {
        p[j] = p[j] / l;
        dp[j] = dot<DH>(d_o, base + j * W + 2 * I);
        D = fmaf(p[j], dp[j], D);
      }
    }
    float dq[DH];
#pragma unroll
    for (int c = 0; c < DH; ++c) dq[c] = 0.f;
    float* p_row = s_p + static_cast<size_t>(item) * ps;
    float* ds_row = s_ds + static_cast<size_t>(item) * ps;
#pragma unroll
    for (int j = 0; j < MAXS; ++j) {
      if (j < S) {
        const float ds = p[j] * (dp[j] - D);
        p_row[j] = p[j];
        ds_row[j] = ds;
        axpy<DH>(dq, ds, base + j * W + I);
      }
    }
#pragma unroll
    for (int c = 0; c < DH; ++c) dq[c] *= scale;
    store_row<DH>(s_dq + (static_cast<size_t>(g) * S + i) * I + h * DH, dq);
  }
  __syncthreads();
  // pass 2, key row j: column j of P and dS, summed over the query rows
  // in order; dK_j and dV_j take k_j's and v_j's places, which no other
  // item reads
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int g = item / per, r = item - g * per, h = r / S, j = r - h * S;
    float* base = s_qkv + static_cast<size_t>(g) * S * W + h * DH;
    const float* dbase = s_do + static_cast<size_t>(g) * S * I + h * DH;
    const float* p_col = s_p + static_cast<size_t>(item - j) * ps + j;
    const float* ds_col = s_ds + static_cast<size_t>(item - j) * ps + j;
    float dk[DH], dv[DH];
#pragma unroll
    for (int c = 0; c < DH; ++c) dk[c] = dv[c] = 0.f;
    for (int a = 0; a < S; ++a) {
      axpy<DH>(dv, p_col[a * ps], dbase + a * I);
      axpy<DH>(dk, ds_col[a * ps], base + a * W);
    }
#pragma unroll
    for (int c = 0; c < DH; ++c) dk[c] *= scale;
    store_row<DH>(base + j * W + I, dk);
    store_row<DH>(base + j * W + 2 * I, dv);
  }
  __syncthreads();   // every read of q is done: dQ takes its place
  for (int e = threadIdx.x; e < g_here * S * I; e += blockDim.x) {
    const int row = e / I;
    s_qkv[static_cast<size_t>(row) * W + (e - row * I)] = s_dq[e];
  }
  __syncthreads();
  copy_out(dqkv + seq0 * S * W, s_qkv, g_here * S * W, vec_dqkv);
}

size_t fwd_smem(int S, int H, int DH, int G) {
  return sizeof(float) * static_cast<size_t>(G) * S * 4 * H * DH;
}

size_t bwd_smem(int S, int H, int DH, int G) {
  return sizeof(float) * static_cast<size_t>(G) * S * H * (5 * DH + 2 * (S | 1));
}

// Raises the kernel's dynamic shared-memory limit to the device's
// opt-in maximum, once per device, where a launch needs more than the
// default 48 KB; no other runtime call is made per launch, so a launch
// is legal inside a CUDA graph's capture.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (done[dev]) return cudaSuccess;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <int DH, int MAXS>
cudaError_t launch_fwd(const float* qkv, float* out, int n, int S, int H, float scale,
                       int vec_in, int vec_out, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int G = seqs_per_block(S, H);
  const size_t bytes = fwd_smem(S, H, DH, G);
  cudaError_t err = allow_smem(attention_fwd_kernel<DH, MAXS>, bytes, done);
  if (err != cudaSuccess) return err;
  const int threads = block_threads(S, H, G);
  const int blocks = (n + G - 1) / G;
  attention_fwd_kernel<DH, MAXS><<<blocks, threads, bytes, stream>>>(qkv, out, n, S, H, G, scale,
                                                                      vec_in, vec_out);
  return cudaGetLastError();
}

template <int DH, int MAXS>
cudaError_t launch_bwd(const float* qkv, const float* dout, float* dqkv, int n, int S, int H,
                       float scale, int vec_qkv, int vec_dout, int vec_dqkv,
                       cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  const int G = seqs_per_block(S, H);
  const size_t bytes = bwd_smem(S, H, DH, G);
  cudaError_t err = allow_smem(attention_bwd_kernel<DH, MAXS>, bytes, done);
  if (err != cudaSuccess) return err;
  const int threads = block_threads(S, H, G);
  const int blocks = (n + G - 1) / G;
  attention_bwd_kernel<DH, MAXS><<<blocks, threads, bytes, stream>>>(
      qkv, dout, dqkv, n, S, H, G, scale, vec_qkv, vec_dout, vec_dqkv);
  return cudaGetLastError();
}

// Calls f with MAXS, the least of the compiled bounds 8, 16 and 32
// that holds S, as a std::integral_constant.
template <typename F>
void with_maxs(int S, F&& f) {
  if (S <= 8) {
    f(std::integral_constant<int, 8>());
  } else if (S <= 16) {
    f(std::integral_constant<int, 16>());
  } else {
    f(std::integral_constant<int, 32>());
  }
}

bool takes(int n, int S, int H, int dh) {
  return n >= 0 && S >= 1 && S <= 32 && H >= 1 && S * H <= kMaxPairs && dh == kDimHead &&
         bwd_smem(S, H, dh, 1) <= kMaxSmem;
}

}  // namespace

extern "C" {

// qkv [n, S, 3 H dh] float32, contiguous on the device; writes out
// [n, S, H dh]. vec_*: 1 where the pointer is 16-byte aligned and S x
// its row width is a multiple of 4 (the 16-byte copies). Launches on
// ``stream``; does not synchronise. Returns a cudaError_t.
int attention_fwd_launch(const void* qkv, void* out, int n, int S, int H, int dh, float scale,
                         int vec_in, int vec_out, void* stream) {
  if (!takes(n, S, H, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaSuccess;
  with_maxs(S, [&](auto M) {
    err = launch_fwd<kDimHead, decltype(M)::value>(
        static_cast<const float*>(qkv), static_cast<float*>(out), n, S, H, scale, vec_in,
        vec_out, static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(err);
}

// qkv [n, S, 3 H dh] and dout [n, S, H dh] float32, contiguous on the
// device; writes dqkv [n, S, 3 H dh]. vec_* as above. Returns a
// cudaError_t.
int attention_bwd_launch(const void* qkv, const void* dout, void* dqkv, int n, int S, int H,
                         int dh, float scale, int vec_qkv, int vec_dout, int vec_dqkv,
                         void* stream) {
  if (!takes(n, S, H, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaSuccess;
  with_maxs(S, [&](auto M) {
    err = launch_bwd<kDimHead, decltype(M)::value>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), n, S, H, scale, vec_qkv, vec_dout, vec_dqkv,
        static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(err);
}

}  // extern "C"
