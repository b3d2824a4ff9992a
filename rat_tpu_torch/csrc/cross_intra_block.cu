// One fused RAT_m2 cross/intra encoder block (forward), for sm_90a.
//
// Replaces the TPU kernel rat_tpu/ops/pallas/cross_intra_block.py
// ::_fused_forward (pallas_call at :206, body _kernel :114, math
// _block_math :83-100). Plain version:
// rat_tpu_torch/ops/cross_intra_block.py::cross_intra_block_reference.
//
// Function, on x [B, t, s, d] float32 (token n = ti * s + si):
//   1. x += Attn_s(LN1(x)) : attention over the s tokens of each (b, ti)
//   2. x += Attn_t(LN2(x)) : attention over the t samples at each (b, si)
//   3. x += W2 gelu(W1 x + b1) + b2 : no pre-norm
// Attn: fused QKV without bias, softmax(q k^T * dim_head^-0.5) v per head,
// then the out-projection with bias, which is skipped (project_out = 0)
// when heads == 1 and dim_head == d. LayerNorm eps 1e-5, GELU with the
// exact erff. Weights are in nn.Linear layout [out, in].
//
// What bounds it on the H100: operations. At the ML-Tag shape (t=6,
// s=4, d=10, h=2, dh=10) a block is about 1.3e5 float32 FLOPs per sample
// against 2 * 960 bytes of activations in and out, some 70 FLOPs per
// byte, and the weights (a few KB) stay in L1/L2. Its widths (d=10,
// dh=10) are far below a tensor-core tile, so this first version uses
// the FP32 pipes.
//
// Design: one CTA holds a few whole samples in shared memory and runs
// the whole block on them, so activations touch device memory once in
// and once out. Per sample it keeps x, an accumulator for the attention
// output and a scratch area that holds either one head's q/k/v with the
// LayerNorm output, the head output and the softmax row weights, or the
// FF hidden layer. Only one head's q/k/v is resident at a time, so wide
// head counts (Tmall: h=32, 3*h*dh = 960 floats per token) fit. Shapes
// are run-time values; the launch refuses a sample that needs more than
// the 227 KB of shared memory a block may have. Threads stride over the
// (sample, token, feature) items of each phase, with a barrier between
// phases.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmemBytes = 232448;   // 227 KB opt-in per block
constexpr int kTargetSmemBytes = 48 * 1024;
constexpr int kMaxSamplesPerBlock = 8;

struct Weights {
  const float *ln1_w, *ln1_b, *w_qkv1, *w_out1, *b_out1;
  const float *ln2_w, *ln2_b, *w_qkv2, *w_out2, *b_out2;
  const float *ff_w1, *ff_b1, *ff_w2, *ff_b2;
};

struct Dims {
  int t, s, d, heads, dh, hidden, project_out;
  int n, inner, L, per_sample;   // derived
  float scale;                   // dim_head ** -0.5, rounded once from double
};

__host__ __device__ inline int scratch_floats(const Dims& D) {
  const int attn = D.n * D.d + D.n * 3 * D.dh + D.n * D.dh + D.n * D.L;
  const int ff = D.n * D.hidden;
  return attn > ff ? attn : ff;
}

Dims make_dims(int t, int s, int d, int heads, int dh, int hidden, int project_out) {
  Dims D{t, s, d, heads, dh, hidden, project_out, 0, 0, 0, 0, 0.f};
  D.n = t * s;
  D.scale = (float)(1.0 / sqrt((double)dh));
  D.inner = heads * dh;
  D.L = t > s ? t : s;
  D.per_sample = 2 * D.n * D.d + scratch_floats(D);
  return D;
}

// Attention sub-block with its residual, on every sample of the CTA.
// over_t = false: intra (sequence over s); true: cross (over t).
__device__ void attention(float* smem, int nsamp, const Dims& D,
                          const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                          const float* __restrict__ w_qkv, const float* __restrict__ w_out,
                          const float* __restrict__ b_out, bool over_t) {
  const int n = D.n, d = D.d, dh = D.dh, L = over_t ? D.t : D.s;
  const int ps = D.per_sample;
  const int qkv_w = 3 * dh;
  // scratch layout: xn [n, d] | qkv [n, 3dh] | o [n, dh] | p [n, L]
  const int off_xn = 2 * n * d, off_qkv = off_xn + n * d;
  const int off_o = off_qkv + n * qkv_w, off_p = off_o + n * dh;

  for (int it = threadIdx.x; it < nsamp * n; it += blockDim.x) {
    const int j = it / n, tok = it - j * n;
    const float* x = smem + j * ps + tok * d;
    float* xn = smem + j * ps + off_xn + tok * d;
    float mu = 0.f;
    for (int e = 0; e < d; ++e) mu += x[e];
    mu /= d;
    float var = 0.f;
    for (int e = 0; e < d; ++e) { const float c = x[e] - mu; var += c * c; }
    var /= d;
    const float r = 1.0f / sqrtf(var + 1e-5f);
    for (int e = 0; e < d; ++e) xn[e] = (x[e] - mu) * r * ln_w[e] + ln_b[e];
  }
  for (int it = threadIdx.x; it < nsamp * n * d; it += blockDim.x) {
    const int j = it / (n * d);
    smem[j * ps + n * d + (it - j * n * d)] = 0.f;
  }
  __syncthreads();

  for (int h = 0; h < D.heads; ++h) {
    // q, k, v of head h: rows part * inner + h * dh + c of to_qkv
    for (int it = threadIdx.x; it < nsamp * n * qkv_w; it += blockDim.x) {
      const int j = it / (n * qkv_w), rem = it - j * n * qkv_w;
      const int tok = rem / qkv_w, c = rem - tok * qkv_w;
      const int part = c / dh;
      const float* w = w_qkv + (size_t)(part * D.inner + h * dh + (c - part * dh)) * d;
      const float* xn = smem + j * ps + off_xn + tok * d;
      float acc = 0.f;
      for (int e = 0; e < d; ++e) acc += xn[e] * w[e];
      smem[j * ps + off_qkv + rem] = acc;
    }
    __syncthreads();
    // one thread per query token: scores, softmax, weighted sum of v
    for (int it = threadIdx.x; it < nsamp * n; it += blockDim.x) {
      const int j = it / n, tok = it - j * n;
      const int ti = tok / D.s, si = tok - ti * D.s;
      const float* base = smem + j * ps + off_qkv;
      const float* q = base + tok * qkv_w;
      float* p = smem + j * ps + off_p + tok * L;
      float m = -CUDART_INF_F;
      for (int l = 0; l < L; ++l) {
        const int kt = over_t ? l * D.s + si : ti * D.s + l;
        const float* k = base + kt * qkv_w + dh;
        float dot = 0.f;
        for (int c = 0; c < dh; ++c) dot += q[c] * k[c];
        dot *= D.scale;
        p[l] = dot;
        m = fmaxf(m, dot);
      }
      float den = 0.f;
      for (int l = 0; l < L; ++l) { p[l] = expf(p[l] - m); den += p[l]; }
      for (int l = 0; l < L; ++l) p[l] = p[l] / den;
      float* o = smem + j * ps + off_o + tok * dh;
      for (int c = 0; c < dh; ++c) {
        float acc = 0.f;
        for (int l = 0; l < L; ++l) {
          const int kt = over_t ? l * D.s + si : ti * D.s + l;
          acc += p[l] * base[kt * qkv_w + 2 * dh + c];
        }
        o[c] = acc;
      }
    }
    __syncthreads();
    // out-projection of head h, accumulated over heads
    for (int it = threadIdx.x; it < nsamp * n * d; it += blockDim.x) {
      const int j = it / (n * d), rem = it - j * n * d;
      const int tok = rem / d, e = rem - tok * d;
      const float* o = smem + j * ps + off_o + tok * dh;
      float* acc = smem + j * ps + n * d + rem;
      if (D.project_out) {
        const float* w = w_out + (size_t)e * D.inner + h * dh;
        float sum = 0.f;
        for (int c = 0; c < dh; ++c) sum += o[c] * w[c];
        *acc += sum;
      } else {
        *acc = o[e];   // heads == 1 and dh == d
      }
    }
    __syncthreads();
  }
  for (int it = threadIdx.x; it < nsamp * n * d; it += blockDim.x) {
    const int j = it / (n * d), rem = it - j * n * d;
    const int e = rem % d;
    float* x = smem + j * ps + rem;
    const float a = smem[j * ps + n * d + rem];
    *x = (D.project_out ? a + b_out[e] : a) + *x;
  }
  __syncthreads();
}

__device__ void feed_forward(float* smem, int nsamp, const Dims& D, const Weights& W) {
  const int n = D.n, d = D.d, hid = D.hidden, ps = D.per_sample;
  const int off_h = 2 * n * d;
  for (int it = threadIdx.x; it < nsamp * n * hid; it += blockDim.x) {
    const int j = it / (n * hid), rem = it - j * n * hid;
    const int tok = rem / hid, k = rem - tok * hid;
    const float* x = smem + j * ps + tok * d;
    const float* w = W.ff_w1 + (size_t)k * d;
    float acc = 0.f;
    for (int e = 0; e < d; ++e) acc += x[e] * w[e];
    acc += W.ff_b1[k];
    smem[j * ps + off_h + rem] = 0.5f * acc * (1.0f + erff(acc / 1.41421356237309515f));
  }
  __syncthreads();
  for (int it = threadIdx.x; it < nsamp * n * d; it += blockDim.x) {
    const int j = it / (n * d), rem = it - j * n * d;
    const int tok = rem / d, e = rem - tok * d;
    const float* hrow = smem + j * ps + off_h + tok * hid;
    const float* w = W.ff_w2 + (size_t)e * hid;
    float acc = 0.f;
    for (int k = 0; k < hid; ++k) acc += hrow[k] * w[k];
    float* x = smem + j * ps + rem;
    *x = (acc + W.ff_b2[e]) + *x;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
cross_intra_block_kernel(const float* __restrict__ x_in, float* __restrict__ x_out,
                         int B, int spb, Dims D, Weights W) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * spb;
  const int nsamp = min(spb, B - b0);
  const int nd = D.n * D.d;
  const float* src = x_in + (size_t)b0 * nd;
  for (int it = threadIdx.x; it < nsamp * nd; it += blockDim.x) {
    const int j = it / nd;
    smem[j * D.per_sample + (it - j * nd)] = src[it];
  }
  __syncthreads();
  attention(smem, nsamp, D, W.ln1_w, W.ln1_b, W.w_qkv1, W.w_out1, W.b_out1, false);
  attention(smem, nsamp, D, W.ln2_w, W.ln2_b, W.w_qkv2, W.w_out2, W.b_out2, true);
  feed_forward(smem, nsamp, D, W);
  float* dst = x_out + (size_t)b0 * nd;
  for (int it = threadIdx.x; it < nsamp * nd; it += blockDim.x) {
    const int j = it / nd;
    dst[it] = smem[j * D.per_sample + (it - j * nd)];
  }
}

}  // namespace

extern "C" {

int cross_intra_block_max_smem_bytes() { return kMaxSmemBytes; }

// Shared memory one sample needs, in bytes.
long long cross_intra_block_smem_per_sample(int t, int s, int d, int heads,
                                            int dh, int hidden) {
  return 4LL * make_dims(t, s, d, heads, dh, hidden, 1).per_sample;
}

// x_in, x_out [B, t, s, d] f32 contiguous on the device (distinct
// buffers); weights: 14 device pointers in the order ln1_w, ln1_b,
// w_qkv1, w_out1, b_out1, ln2_w, ln2_b, w_qkv2, w_out2, b_out2, ff_w1,
// ff_b1, ff_w2, ff_b2 (w_out*/b_out* may be null when !project_out).
int cross_intra_block_launch(const void* x_in, void* x_out, int B, int t, int s,
                             int d, int heads, int dh, int hidden,
                             int project_out, const void* const* weights,
                             void* stream) {
  if (B == 0) return 0;
  const Dims D = make_dims(t, s, d, heads, dh, hidden, project_out);
  const long long per_sample_bytes = 4LL * D.per_sample;
  if (per_sample_bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  int spb = (int)(kTargetSmemBytes / per_sample_bytes);
  spb = spb < 1 ? 1 : (spb > kMaxSamplesPerBlock ? kMaxSamplesPerBlock : spb);
  const int smem = (int)(spb * per_sample_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      cross_intra_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  const Weights W{w[0], w[1], w[2], w[3], w[4], w[5], w[6],
                  w[7], w[8], w[9], w[10], w[11], w[12], w[13]};
  const int grid = (B + spb - 1) / spb;
  cross_intra_block_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_in), static_cast<float*>(x_out), B, spb, D, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
