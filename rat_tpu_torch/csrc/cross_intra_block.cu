// One fused RAT_m2 cross/intra encoder block (forward), for sm_90a, and
// its backward (k1_grad_kernel, further down, with its own notes).
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
// against 2 * 960 bytes of activations in and out, and the weights
// (10 KB) are read by every sample. Its widths are far below a
// tensor-core tile, and the port keeps TF32 off, so it runs on the FP32
// pipes.
//
// Design: a warp owns whole samples and a lane owns tokens (lane,
// lane + 32, ...), so that no phase inside a sample needs more than a
// __syncwarp and the CTA has no barrier in its sample loop.
// - At the widths of the repository's configs, (d, dim_head) = (10, 10)
//   and (40, 10), the widths are compile-time and a token's row lives in
//   its lane's registers while the lane works on it: LayerNorm needs no
//   cross-lane reduction, the lane's q and its head output stay in
//   registers, and the FF consumes each hidden unit as it is made
//   (hidden layer never stored).
// - At any other width the same work runs with run-time widths and
//   every row in the warp's shared memory (cross_intra_block_rows_kernel):
//   a lane reads and writes only its own tokens' x, LayerNorm, q (then
//   head output), attention-weight and FF rows, and the warp shares one
//   head's k and v.
// - Shared by the warp's lanes: the sample's x and LayerNorm output, and
//   one head's k and v; rows are padded to an odd number of floats, so
//   lanes that read different tokens' rows hit different banks.
// - Weights: staged once per CTA into shared memory, rows padded to a
//   multiple of 4 floats (read as float4 broadcasts at the compiled
//   widths: every lane reads the same address), when they fit a 64 KB
//   budget (ML-Tag: 10 KB); else read from global memory, where the
//   same broadcast loads hit L1.
// - Persistent CTAs: the grid is the number of CTAs that fit on the card
//   (at most one per 8 samples), and each warp walks over samples, so
//   the weights are staged once per CTA.
// - The grid of a block shape is found once per device (the SM count,
//   the shared-memory attribute and the occupancy query) and cached, so
//   that a launch makes no other runtime call than the kernel's: legal
//   inside a CUDA graph's capture, and cheap on the host.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cmath>
#include <mutex>
#include <vector>

namespace {

constexpr int kWarps = 8;   // warps per CTA, at most
constexpr int kMaxSmemBytes = 232448;   // 227 KB opt-in per block
constexpr int kWeightSmemBytes = 64 * 1024;

struct Weights {
  const float *ln1_w, *ln1_b, *w_qkv1, *w_out1, *b_out1;
  const float *ln2_w, *ln2_b, *w_qkv2, *w_out2, *b_out2;
  const float *ff_w1, *ff_b1, *ff_w2, *ff_b2;
};

struct Dims {
  int t, s, d, heads, dh, hidden, project_out, n, inner;
  float scale;   // dim_head ** -0.5, rounded once from double
};

Dims make_dims(int t, int s, int d, int heads, int dh, int hidden, int project_out) {
  return Dims{t, s, d, heads, dh, hidden, project_out, t * s, heads * dh,
              (float)(1.0 / sqrt((double)dh))};
}

__host__ __device__ constexpr int pad4(int v) { return (v + 3) & ~3; }

// Where the kernel reads each weight. Row r of a matrix starts at
// base + r * row stride; its elements are contiguous (staged: padded to
// a multiple of 4 floats, 16-byte aligned) except w2, whose hidden unit
// k has its d outputs at w2 + k * w2_ks + e * w2_es.
struct Layout {
  const float *ln_w[2], *ln_b[2], *qkv[2], *wo[2], *bo[2];
  const float *w1, *b1, *w2, *b2;
  int qkv_rs, wo_hs, wo_es, w1_rs, w2_ks, w2_es;
};

// Floats of the staged weights (rows padded to 4).
__host__ __device__ inline int staged_floats(const Dims& Dm) {
  const int d4 = pad4(Dm.d);
  int n = 4 * d4 + 2 * 3 * Dm.inner * d4 + pad4(Dm.hidden) + 2 * Dm.hidden * d4 + d4;
  if (Dm.project_out) n += 2 * Dm.heads * Dm.d * pad4(Dm.dh) + 2 * d4;
  return n;
}

// Floats of one warp's sample area: x and LayerNorm rows [n][d | 1], and
// one head's k and v rows [n][dh | 1]; with `rows`, also a row [n][dh | 1]
// for q and then the head output, and one [n][max(t, s) | 1] for a
// token's attention weights (cross_intra_block_rows_kernel).
__host__ __device__ inline int score_stride(const Dims& Dm) {
  return (Dm.t > Dm.s ? Dm.t : Dm.s) | 1;
}

__host__ __device__ inline int warp_floats(const Dims& Dm, bool rows) {
  const int dp = Dm.d | 1, dhp = Dm.dh | 1;
  return Dm.n * (rows ? 2 * dp + 3 * dhp + score_stride(Dm) : 2 * dp + 2 * dhp);
}

// The layout functions take the widths (D, DH) as template arguments
// where they are compiled, so that the row strides fold into the
// compiled kernel's addresses, and 0 for run-time widths.
template <int D, int DH>
__device__ __forceinline__ Layout global_layout(const Dims& Dm, const Weights& W) {
  const int d = D ? D : Dm.d, dh = DH ? DH : Dm.dh;
  Layout L;
  L.ln_w[0] = W.ln1_w; L.ln_b[0] = W.ln1_b; L.ln_w[1] = W.ln2_w; L.ln_b[1] = W.ln2_b;
  L.qkv[0] = W.w_qkv1; L.qkv[1] = W.w_qkv2;
  L.wo[0] = W.w_out1; L.wo[1] = W.w_out2; L.bo[0] = W.b_out1; L.bo[1] = W.b_out2;
  L.w1 = W.ff_w1; L.b1 = W.ff_b1; L.w2 = W.ff_w2; L.b2 = W.ff_b2;
  L.qkv_rs = d;
  L.wo_hs = dh; L.wo_es = Dm.inner;      // w_out [d, inner]
  L.w1_rs = d;
  L.w2_ks = 1; L.w2_es = Dm.hidden;      // w2 [d, hidden]
  return L;
}

// Copy rows x cols of src (row stride src_rs, element stride src_es)
// into dst with row stride dst_rs.
__device__ void stage(float* dst, int dst_rs, const float* src, int rows, int cols,
                      int src_rs, int src_es) {
  for (int it = threadIdx.x; it < rows * cols; it += blockDim.x) {
    const int r = it / cols, c = it - r * cols;
    dst[r * dst_rs + c] = src[(size_t)r * src_rs + (size_t)c * src_es];
  }
}

// Stage every weight into smem (padded rows); returns their layout.
template <int D, int DH>
__device__ __forceinline__ Layout stage_weights(float* smem, const Dims& Dm,
                                                const Weights& W) {
  const int d = D ? D : Dm.d, dh = DH ? DH : Dm.dh, d4 = pad4(d), dh4 = pad4(dh);
  const Layout G = global_layout<D, DH>(Dm, W);
  Layout L = G;
  float* p = smem;
  for (int a = 0; a < 2; ++a) {
    stage(p, d4, G.ln_w[a], 1, d, 0, 1); L.ln_w[a] = p; p += d4;
    stage(p, d4, G.ln_b[a], 1, d, 0, 1); L.ln_b[a] = p; p += d4;
    stage(p, d4, G.qkv[a], 3 * Dm.inner, d, d, 1); L.qkv[a] = p; p += 3 * Dm.inner * d4;
    if (Dm.project_out) {
      // head h, output e: w_out[e, h * dh + c] -> p[(h * d + e) * dh4 + c]
      for (int h = 0; h < Dm.heads; ++h)
        stage(p + h * d * dh4, dh4, G.wo[a] + h * dh, d, dh, Dm.inner, 1);
      L.wo[a] = p; p += Dm.heads * d * dh4;
      stage(p, d4, G.bo[a], 1, d, 0, 1); L.bo[a] = p; p += d4;
    }
  }
  stage(p, d4, G.w1, Dm.hidden, d, d, 1); L.w1 = p; p += Dm.hidden * d4;
  stage(p, pad4(Dm.hidden), G.b1, 1, Dm.hidden, 0, 1); L.b1 = p; p += pad4(Dm.hidden);
  // w2 transposed: hidden unit k's d outputs contiguous
  stage(p, d4, G.w2, Dm.hidden, d, 1, Dm.hidden); L.w2 = p; p += Dm.hidden * d4;
  stage(p, d4, G.b2, 1, d, 0, 1); L.b2 = p;
  L.qkv_rs = d4;
  L.wo_hs = d * dh4; L.wo_es = dh4;
  L.w1_rs = d4;
  L.w2_ks = d4; L.w2_es = 1;
  return L;
}

// The weights' layout for the CTA: staged into smem by all its threads
// (the area after them is returned in *area), or in global memory.
template <int D, int DH>
__device__ __forceinline__ Layout weights_layout(float* smem, bool staged, const Dims& Dm,
                                                 const Weights& W, float** area) {
  *area = smem;
  if (!staged) return global_layout<D, DH>(Dm, W);
  const Layout L = stage_weights<D, DH>(smem, Dm, W);
  *area = smem + staged_floats(Dm);
  __syncthreads();
  return L;
}

// N consecutive weights from p (element stride es when not V4).
template <int N, bool V4>
__device__ __forceinline__ void load_row(const float* p, int es, float (&r)[N]) {
  if constexpr (V4) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x;
      if (i + 1 < N) r[i + 1] = v.y;
      if (i + 2 < N) r[i + 2] = v.z;
      if (i + 3 < N) r[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = __ldg(p + i * es);
  }
}

template <int N>
__device__ __forceinline__ float dot(const float (&a)[N], const float (&b)[N]) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) acc = fmaf(a[i], b[i], acc);
  return acc;
}

// Weight row r of a [rows, N] matrix dotted with a.
template <int N, bool WS>
__device__ __forceinline__ float dot_row(const float (&a)[N], const float* w, int r, int rs) {
  float row[N];
  load_row<N, WS>(w + r * rs, 1, row);
  return dot(a, row);
}

// Attention sub-block (a = 0: over s, intra; a = 1: over t, cross) with
// its residual, on the warp's sample: xs [n][DP], xns [n][DP], ks and
// vs [n][DHP] in shared memory.
template <int D, int DH, bool WS>
__device__ __forceinline__ void attention(float* xs, float* xns, float* ks, float* vs,
                                          const Dims& Dm, const Layout& L, int a,
                                          int lane) {
  constexpr int DP = D | 1, DHP = DH | 1;
  // rows of weights in flight per loop: all at d=10, a few at d=40,
  // where a row alone is 40 registers
  constexpr int kRowUnroll = D > 16 ? 2 : DH;
  const int n = Dm.n, len = a ? Dm.t : Dm.s;
  const float* ln_w = L.ln_w[a];
  const float* ln_b = L.ln_b[a];
  const float* qkv = L.qkv[a];
  for (int tok = lane; tok < n; tok += 32) {
    float x[D];
#pragma unroll
    for (int e = 0; e < D; ++e) x[e] = xs[tok * DP + e];
    float mu = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) mu += x[e];
    mu /= D;
    float var = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) { const float c = x[e] - mu; var += c * c; }
    var /= D;
    const float r = 1.0f / sqrtf(var + 1e-5f);
#pragma unroll
    for (int e = 0; e < D; ++e) xns[tok * DP + e] = (x[e] - mu) * r * ln_w[e] + ln_b[e];
  }
  for (int h = 0; h < Dm.heads; ++h) {
    // k and v of head h for the lane's tokens: rows part * inner + h * DH + c
    for (int tok = lane; tok < n; tok += 32) {
      float xn[D];
#pragma unroll
      for (int e = 0; e < D; ++e) xn[e] = xns[tok * DP + e];
#pragma unroll (kRowUnroll)
      for (int c = 0; c < DH; ++c) {
        ks[tok * DHP + c] = dot_row<D, WS>(xn, qkv, Dm.inner + h * DH + c, L.qkv_rs);
        vs[tok * DHP + c] = dot_row<D, WS>(xn, qkv, 2 * Dm.inner + h * DH + c, L.qkv_rs);
      }
    }
    __syncwarp();
    for (int tok = lane; tok < n; tok += 32) {
      float xn[D], q[DH], o[DH];
#pragma unroll
      for (int e = 0; e < D; ++e) xn[e] = xns[tok * DP + e];
#pragma unroll (kRowUnroll)
      for (int c = 0; c < DH; ++c) q[c] = dot_row<D, WS>(xn, qkv, h * DH + c, L.qkv_rs);
      const int ti = tok / Dm.s, si = tok - ti * Dm.s;
      const int k0 = a ? si : ti * Dm.s, kstep = a ? Dm.s : 1;
      float m = -CUDART_INF_F;
      for (int l = 0; l < len; ++l) {
        const float* k = ks + (k0 + l * kstep) * DHP;
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < DH; ++c) d = fmaf(q[c], k[c], d);
        m = fmaxf(m, d * Dm.scale);
      }
#pragma unroll
      for (int c = 0; c < DH; ++c) o[c] = 0.f;
      float den = 0.f;
      for (int l = 0; l < len; ++l) {
        const int kt = k0 + l * kstep;
        const float* k = ks + kt * DHP;
        const float* v = vs + kt * DHP;
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < DH; ++c) d = fmaf(q[c], k[c], d);
        const float p = expf(d * Dm.scale - m);
        den += p;
#pragma unroll
        for (int c = 0; c < DH; ++c) o[c] = fmaf(p, v[c], o[c]);
      }
#pragma unroll
      for (int c = 0; c < DH; ++c) o[c] /= den;
      float* xr = xs + tok * DP;
      if (Dm.project_out) {
        const float* wo = L.wo[a] + h * L.wo_hs;
#pragma unroll (kRowUnroll)
        for (int e = 0; e < D; ++e) xr[e] += dot_row<DH, WS>(o, wo, e, L.wo_es);
      } else if constexpr (D == DH) {   // heads == 1 and dim_head == d
#pragma unroll
        for (int e = 0; e < D; ++e) xr[e] += o[e];
      }
    }
    __syncwarp();   // the next head overwrites ks, vs
  }
  if (Dm.project_out) {
    for (int tok = lane; tok < n; tok += 32) {
#pragma unroll
      for (int e = 0; e < D; ++e) xs[tok * DP + e] += L.bo[a][e];
    }
  }
}

// x += W2 gelu(W1 x + b1) + b2 on the lane's tokens.
template <int D, bool WS>
__device__ __forceinline__ void feed_forward(float* xs, const Dims& Dm, const Layout& L,
                                             int lane) {
  constexpr int DP = D | 1;
  for (int tok = lane; tok < Dm.n; tok += 32) {
    float x[D], acc[D];
#pragma unroll
    for (int e = 0; e < D; ++e) { x[e] = xs[tok * DP + e]; acc[e] = 0.f; }
#pragma unroll (D > 16 ? 1 : 2)
    for (int k = 0; k < Dm.hidden; ++k) {
      const float u = dot_row<D, WS>(x, L.w1, k, L.w1_rs) + L.b1[k];
      const float g = 0.5f * u * (1.0f + erff(u / 1.41421356237309515f));
      float w[D];
      load_row<D, WS>(L.w2 + k * L.w2_ks, L.w2_es, w);
#pragma unroll
      for (int e = 0; e < D; ++e) acc[e] = fmaf(g, w[e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < D; ++e) xs[tok * DP + e] = (acc[e] + L.b2[e]) + x[e];
  }
}

// The block at the compiled widths (d, dim_head) = (D, DH).
template <int D, int DH, bool WS>
__global__ void __launch_bounds__(kWarps * 32)
cross_intra_block_kernel(const float* __restrict__ x_in, float* __restrict__ x_out,
                         int B, Dims Dm, Weights W) {
  constexpr int DP = D | 1, DHP = DH | 1;
  extern __shared__ float4 smem4[];
  float* area;
  const Layout L = weights_layout<D, DH>(reinterpret_cast<float*>(smem4), WS, Dm, W, &area);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = Dm.n, nd = n * D;
  float* xs = area + warp * n * (2 * DP + 2 * DHP);
  float* xns = xs + n * DP;
  float* ks = xns + n * DP;
  float* vs = ks + n * DHP;
  for (int b = blockIdx.x * warps + warp; b < B; b += gridDim.x * warps) {
    const float* src = x_in + (size_t)b * nd;
    for (int it = lane; it < nd; it += 32) {
      const int tok = it / D;
      xs[tok * DP + it - tok * D] = __ldg(src + it);
    }
    __syncwarp();
    attention<D, DH, WS>(xs, xns, ks, vs, Dm, L, 0, lane);
    attention<D, DH, WS>(xs, xns, ks, vs, Dm, L, 1, lane);
    feed_forward<D, WS>(xs, Dm, L, lane);
    __syncwarp();
    float* dst = x_out + (size_t)b * nd;
    for (int it = lane; it < nd; it += 32) {
      const int tok = it / D;
      dst[it] = xs[tok * DP + it - tok * D];
    }
    __syncwarp();   // the next sample overwrites xs
  }
}

// attention() at run-time widths, every row in the warp's smem: xs,
// xns [n][dp]; ks, vs and qos (a lane's q, then its head output)
// [n][dhp]; scs, a lane's scores, then its attention weights [n][lp].
// Every sum runs in the order it runs in attention().
__device__ __forceinline__ void attention_rows(float* xs, float* xns, float* qos, float* ks,
                                               float* vs, float* scs, const Dims& Dm,
                                               const Layout& L, int a, int lane) {
  const int d = Dm.d, dh = Dm.dh, dp = d | 1, dhp = dh | 1, lp = score_stride(Dm);
  const int n = Dm.n, len = a ? Dm.t : Dm.s;
  for (int tok = lane; tok < n; tok += 32) {
    const float* x = xs + tok * dp;
    float* xn = xns + tok * dp;
    float mu = 0.f;
    for (int e = 0; e < d; ++e) mu += x[e];
    mu /= d;
    float var = 0.f;
    for (int e = 0; e < d; ++e) { const float c = x[e] - mu; var += c * c; }
    var /= d;
    const float r = 1.0f / sqrtf(var + 1e-5f);
    for (int e = 0; e < d; ++e) xn[e] = (x[e] - mu) * r * L.ln_w[a][e] + L.ln_b[a][e];
  }
  for (int h = 0; h < Dm.heads; ++h) {
    for (int tok = lane; tok < n; tok += 32) {
      const float* xn = xns + tok * dp;
      for (int c = 0; c < dh; ++c) {
        const float* wq = L.qkv[a] + (h * dh + c) * L.qkv_rs;
        const float* wk = wq + Dm.inner * L.qkv_rs;
        const float* wv = wk + Dm.inner * L.qkv_rs;
        float q = 0.f, k = 0.f, v = 0.f;
        for (int e = 0; e < d; ++e) {
          q = fmaf(xn[e], wq[e], q);
          k = fmaf(xn[e], wk[e], k);
          v = fmaf(xn[e], wv[e], v);
        }
        qos[tok * dhp + c] = q;
        ks[tok * dhp + c] = k;
        vs[tok * dhp + c] = v;
      }
    }
    __syncwarp();
    for (int tok = lane; tok < n; tok += 32) {
      float* qo = qos + tok * dhp;
      float* sc = scs + tok * lp;
      const int ti = tok / Dm.s, si = tok - ti * Dm.s;
      const int k0 = a ? si : ti * Dm.s, kstep = a ? Dm.s : 1;
      float m = -CUDART_INF_F;
      for (int l = 0; l < len; ++l) {
        const float* k = ks + (k0 + l * kstep) * dhp;
        float dt = 0.f;
        for (int c = 0; c < dh; ++c) dt = fmaf(qo[c], k[c], dt);
        sc[l] = dt * Dm.scale;
        m = fmaxf(m, sc[l]);
      }
      float den = 0.f;
      for (int l = 0; l < len; ++l) {
        sc[l] = expf(sc[l] - m);
        den += sc[l];
      }
      for (int c = 0; c < dh; ++c) {   // q is spent: the row takes the output
        float o = 0.f;
        for (int l = 0; l < len; ++l) o = fmaf(sc[l], vs[(k0 + l * kstep) * dhp + c], o);
        qo[c] = o / den;
      }
      float* xr = xs + tok * dp;
      if (Dm.project_out) {
        const float* wo = L.wo[a] + h * L.wo_hs;
        for (int e = 0; e < d; ++e) {
          float acc = 0.f;
          for (int c = 0; c < dh; ++c) acc = fmaf(qo[c], wo[e * L.wo_es + c], acc);
          xr[e] += acc;
        }
      } else {   // heads == 1 and dim_head == d
        for (int e = 0; e < d; ++e) xr[e] += qo[e];
      }
    }
    __syncwarp();   // the next head overwrites ks, vs
  }
  if (Dm.project_out) {
    for (int tok = lane; tok < n; tok += 32)
      for (int e = 0; e < d; ++e) xs[tok * dp + e] += L.bo[a][e];
  }
}

// feed_forward() at run-time widths, the accumulator rows in accs.
// Hidden units go in groups of kGroup held in registers, so that each
// element of a row is loaded (and stored) once per group, not per unit;
// every sum runs in the order it runs in feed_forward().
constexpr int kGroup = 8;

__device__ __forceinline__ void feed_forward_rows(float* xs, float* accs, const Dims& Dm,
                                                  const Layout& L, int lane) {
  const int d = Dm.d, dp = d | 1;
  for (int tok = lane; tok < Dm.n; tok += 32) {
    float* x = xs + tok * dp;
    float* acc = accs + tok * dp;
    for (int e = 0; e < d; ++e) acc[e] = 0.f;
    for (int k0 = 0; k0 < Dm.hidden; k0 += kGroup) {
      const int units = Dm.hidden - k0 < kGroup ? Dm.hidden - k0 : kGroup;
      float g[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) g[j] = 0.f;
      for (int e = 0; e < d; ++e) {
        const float xe = x[e];
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (j < units) g[j] = fmaf(xe, L.w1[(k0 + j) * L.w1_rs + e], g[j]);
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float u = g[j] + L.b1[j < units ? k0 + j : k0];
        g[j] = 0.5f * u * (1.0f + erff(u / 1.41421356237309515f));
      }
      for (int e = 0; e < d; ++e) {
        float a = acc[e];
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (j < units) a = fmaf(g[j], L.w2[(k0 + j) * L.w2_ks + e * L.w2_es], a);
        acc[e] = a;
      }
    }
    for (int e = 0; e < d; ++e) x[e] = (acc[e] + L.b2[e]) + x[e];
  }
}

// The block at any other width. The minimum of one CTA per SM is
// stated: with the thread count alone ptxas held this kernel to 64
// registers and spilled.
__global__ void __launch_bounds__(kWarps * 32, 1)
cross_intra_block_rows_kernel(const float* __restrict__ x_in, float* __restrict__ x_out,
                              int B, Dims Dm, Weights W, bool staged) {
  extern __shared__ float4 smem4[];
  float* area;
  const Layout L = weights_layout<0, 0>(reinterpret_cast<float*>(smem4), staged, Dm, W,
                                        &area);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = Dm.d, dp = d | 1, dhp = Dm.dh | 1, n = Dm.n, nd = n * d;
  float* xs = area + warp * warp_floats(Dm, true);
  float* xns = xs + n * dp;
  float* qos = xns + n * dp;
  float* ks = qos + n * dhp;
  float* vs = ks + n * dhp;
  float* scs = vs + n * dhp;
  for (int b = blockIdx.x * warps + warp; b < B; b += gridDim.x * warps) {
    const float* src = x_in + (size_t)b * nd;
    for (int it = lane; it < nd; it += 32) {
      const int tok = it / d;
      xs[tok * dp + it - tok * d] = __ldg(src + it);
    }
    __syncwarp();
    attention_rows(xs, xns, qos, ks, vs, scs, Dm, L, 0, lane);
    attention_rows(xs, xns, qos, ks, vs, scs, Dm, L, 1, lane);
    feed_forward_rows(xs, xns, Dm, L, lane);
    __syncwarp();
    float* dst = x_out + (size_t)b * nd;
    for (int it = lane; it < nd; it += 32) {
      const int tok = it / d;
      dst[it] = xs[tok * dp + it - tok * d];
    }
    __syncwarp();   // the next sample overwrites xs
  }
}

// ---------------------------------------------------------------------------
// K1's backward: k1_grad_kernel, then k1_grad_sum_kernel.
//
// Replaces no TPU kernel: the JAX package's custom_vjp (_fused_bwd) takes
// jax.vjp of the plain block, and so did the port, as autograd of
// cross_intra_block_reference: ~150 launches of d = 10 operations per
// train step on the H100. Given x, grad_out and the 14 weights it writes
// dx and the weights' gradients, summed over the batch, in PARAM_ORDER and
// the weights' own layouts ([out, in]) in one flat vector of P floats.
//
// What bounds it: operations and latency, as in the forward. Per sample it
// does about three forwards' arithmetic (the forward once, each attention
// once more, and their gradients) plus P x n multiply-adds for the weight
// gradients, all below a tensor-core tile at the widths it is compiled for.
//
// Design:
// - A warp owns whole samples and a lane owns tokens, as in the forward;
//   nothing inside a sample needs more than a __syncwarp.
// - Per sample the warp recomputes the forward in its shared-memory area,
//   keeping the residual stream after each sub-block (x0, x1, x2). Then it
//   goes back through the FF (exact GELU: gelu'(u) = Phi(u) + u phi(u)),
//   the cross attention with LN2, and the intra attention with LN1. Each
//   attention is recomputed head by head from the stream it read, so that
//   one head's q, k, v, o and weights are in the area at a time.
// - A query's lane forms dO, the softmax's gradient and dq; a key's lane
//   sums dk and dv over its queries and writes them over its k and v.
// - Weight gradients: each warp adds each sample's into its accumulators
//   in shared memory (one float per weight element), a lane owning an
//   element or a short run of a row and summing the sample's tokens in
//   order. At the end the CTA adds its warps' accumulators in warp order
//   into its row of partials [grid, P], and k1_grad_sum_kernel adds the
//   rows in row order. No atomics: the result is the same bit for bit from
//   run to run and in a CUDA graph's replay, for a given batch size (which
//   sets the grid).
// - Compiled at (d, dim_head) = (10, 10), with the weights staged in
//   shared memory. At a shape whose widths, weights or per-warp area do
//   not fit, k1_grad_grid returns 0 and the wrapper takes autograd of the
//   plain block.

// Offsets of the 14 weight gradients in the flat vector of P floats;
// w_out* and b_out* take no room without project_out.
struct GradOffsets {
  int ln_w[2], ln_b[2], qkv[2], wo[2], bo[2], w1, b1, w2, b2, total;
};

__host__ __device__ inline GradOffsets grad_offsets(const Dims& Dm) {
  GradOffsets o;
  int p = 0;
  for (int a = 0; a < 2; ++a) {
    o.ln_w[a] = p; p += Dm.d;
    o.ln_b[a] = p; p += Dm.d;
    o.qkv[a] = p; p += 3 * Dm.inner * Dm.d;
    o.wo[a] = p; if (Dm.project_out) p += Dm.d * Dm.inner;
    o.bo[a] = p; if (Dm.project_out) p += Dm.d;
  }
  o.w1 = p; p += Dm.hidden * Dm.d;
  o.b1 = p; p += Dm.hidden;
  o.w2 = p; p += Dm.d * Dm.hidden;
  o.b2 = p; p += Dm.d;
  o.total = p;
  return o;
}

// One warp's area. Kept through a sample: the residual stream x0, x1, x2
// and the gradient dx [n][d | 1]; a token's LayerNorm mean and 1/std [n];
// the weight-gradient accumulators [P]. Then a scratch area that the FF's
// backward and each attention's use in turn:
// - attention: xn, dxn [n][d | 1]; q, dq, k, v, o, dO [n][dh | 1] (dq, k
//   and v adjacent, one stride apart); ps, ds [n][max(t, s) | 1], a
//   query's attention weights and their gradients;
// - FF: gu, du [n][hidden | 1] (gelu(u) and the gradient of u), dt
//   [n][d | 1] (the FF's part of dx).
struct GradArea {
  float *x0, *x1, *x2, *dx, *mu, *rs, *acc;
  float *xn, *dxn, *q, *dq, *k, *v, *o, *dO, *ps, *ds;
  float *gu, *du, *dt;
};

__host__ __device__ inline int grad_warp_floats(const Dims& Dm) {
  const int n = Dm.n, dp = Dm.d | 1, dhp = Dm.dh | 1, hp = Dm.hidden | 1;
  const int attn = 2 * n * dp + 6 * n * dhp + 2 * n * score_stride(Dm);
  const int ff = 2 * n * hp + n * dp;
  return 4 * n * dp + 2 * n + grad_offsets(Dm).total + (attn > ff ? attn : ff);
}

__device__ inline GradArea grad_area(float* p, const Dims& Dm) {
  const int n = Dm.n, dp = Dm.d | 1, dhp = Dm.dh | 1, hp = Dm.hidden | 1;
  GradArea A;
  A.x0 = p; p += n * dp;
  A.x1 = p; p += n * dp;
  A.x2 = p; p += n * dp;
  A.dx = p; p += n * dp;
  A.mu = p; p += n;
  A.rs = p; p += n;
  A.acc = p; p += grad_offsets(Dm).total;
  float* scratch = p;
  A.xn = p; p += n * dp;
  A.dxn = p; p += n * dp;
  A.q = p; p += n * dhp;
  A.dq = p; p += n * dhp;
  A.k = p; p += n * dhp;
  A.v = p; p += n * dhp;
  A.o = p; p += n * dhp;
  A.dO = p; p += n * dhp;
  A.ps = p; p += n * score_stride(Dm);
  A.ds = p;
  p = scratch;
  A.gu = p; p += n * hp;
  A.du = p; p += n * hp;
  A.dt = p;
  return A;
}

// The attention group of token tok in sub-block a (0: the s tokens of its
// row ti; 1: the t tokens of its column si): the first member, the step
// between members, their number, and tok's place among them.
struct Group {
  int first, step, len, pos;
};

__device__ __forceinline__ Group group_of(int tok, const Dims& Dm, int a) {
  const int ti = tok / Dm.s, si = tok - ti * Dm.s;
  return a ? Group{si, Dm.s, Dm.t, ti} : Group{ti * Dm.s, 1, Dm.s, si};
}

// acc[(r / rdiv) * acc_ps + (r % rdiv) * ars + c * acs] += the sum over the
// sample's tokens of a[(r / rdiv) * a_ps + (r % rdiv) + tok * as] *
// b[tok * bs + c], for r < R and c < C. A lane owns (r, a run of CH
// columns) and sums the tokens in order. rdiv and the part strides let one
// pass cover rows that lie in several buffers (dq, dk, dv).
template <int CH>
__device__ __forceinline__ void grad_outer(float* acc, int ars, int acs, int rdiv, int acc_ps,
                                           const float* a, int as, int a_ps, const float* b,
                                           int bs, int R, int C, int n, int lane) {
  const int runs = (C + CH - 1) / CH;
  for (int it = lane; it < R * runs; it += 32) {
    const int r = it / runs, c0 = (it - r * runs) * CH;
    const int part = r / rdiv, rr = r - part * rdiv;
    const float* ar = a + part * a_ps + rr;
    float s[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) s[j] = 0.f;
    for (int tok = 0; tok < n; ++tok) {
      const float av = ar[tok * as];
      const float* br = b + tok * bs + c0;
#pragma unroll
      for (int j = 0; j < CH; ++j)
        if (c0 + j < C) s[j] = fmaf(av, br[j], s[j]);
    }
    float* dst = acc + part * acc_ps + rr * ars;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (c0 + j < C) dst[(c0 + j) * acs] += s[j];
  }
}

// acc[r] += the sum over the sample's tokens of a[tok * as + r], times
// b[tok * bs + r] where b is given, for r < R.
__device__ __forceinline__ void grad_rows(float* acc, const float* a, int as, const float* b,
                                          int bs, int R, int n, int lane) {
  for (int r = lane; r < R; r += 32) {
    float s = 0.f;
    if (b) {
      for (int tok = 0; tok < n; ++tok) s = fmaf(a[tok * as + r], b[tok * bs + r], s);
    } else {
      for (int tok = 0; tok < n; ++tok) s += a[tok * as + r];
    }
    acc[r] += s;
  }
}

// LayerNorm of the lane's tokens' rows of xs into xns, with each token's
// mean and 1/std.
template <int D>
__device__ __forceinline__ void layer_norm_rows(const float* xs, float* xns, float* mus,
                                                float* rss, const float* ln_w,
                                                const float* ln_b, int n, int lane) {
  constexpr int DP = D | 1;
  for (int tok = lane; tok < n; tok += 32) {
    float x[D];
#pragma unroll
    for (int e = 0; e < D; ++e) x[e] = xs[tok * DP + e];
    float mu = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) mu += x[e];
    mu /= D;
    float var = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) { const float c = x[e] - mu; var += c * c; }
    var /= D;
    const float r = 1.0f / sqrtf(var + 1e-5f);
#pragma unroll
    for (int e = 0; e < D; ++e) xns[tok * DP + e] = (x[e] - mu) * r * ln_w[e] + ln_b[e];
    mus[tok] = mu;
    rss[tok] = r;
  }
}

// Head h of sub-block a from the LayerNorm rows in A.xn: every token's q,
// k and v, then each query's attention weights (ps) and output (o).
template <int D, int DH>
__device__ __forceinline__ void head_forward(const GradArea& A, const Dims& Dm, const Layout& L,
                                             int a, int h, int lane) {
  constexpr int DP = D | 1, DHP = DH | 1;
  const int n = Dm.n, lp = score_stride(Dm);
  const float* qkv = L.qkv[a];
  __syncwarp();   // the previous head's rows are read no more
  for (int tok = lane; tok < n; tok += 32) {
    float xn[D];
#pragma unroll
    for (int e = 0; e < D; ++e) xn[e] = A.xn[tok * DP + e];
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      A.q[tok * DHP + c] = dot_row<D, true>(xn, qkv, h * DH + c, L.qkv_rs);
      A.k[tok * DHP + c] = dot_row<D, true>(xn, qkv, Dm.inner + h * DH + c, L.qkv_rs);
      A.v[tok * DHP + c] = dot_row<D, true>(xn, qkv, 2 * Dm.inner + h * DH + c, L.qkv_rs);
    }
  }
  __syncwarp();
  for (int tok = lane; tok < n; tok += 32) {
    const Group g = group_of(tok, Dm, a);
    float q[DH], o[DH];
#pragma unroll
    for (int c = 0; c < DH; ++c) { q[c] = A.q[tok * DHP + c]; o[c] = 0.f; }
    float* p = A.ps + tok * lp;
    float m = -CUDART_INF_F;
    for (int l = 0; l < g.len; ++l) {
      const float* k = A.k + (g.first + l * g.step) * DHP;
      float dt = 0.f;
#pragma unroll
      for (int c = 0; c < DH; ++c) dt = fmaf(q[c], k[c], dt);
      p[l] = dt * Dm.scale;
      m = fmaxf(m, p[l]);
    }
    float den = 0.f;
    for (int l = 0; l < g.len; ++l) {
      p[l] = expf(p[l] - m);
      den += p[l];
    }
    for (int l = 0; l < g.len; ++l) {
      p[l] /= den;
      const float* v = A.v + (g.first + l * g.step) * DHP;
#pragma unroll
      for (int c = 0; c < DH; ++c) o[c] = fmaf(p[l], v[c], o[c]);
    }
#pragma unroll
    for (int c = 0; c < DH; ++c) A.o[tok * DHP + c] = o[c];
  }
  __syncwarp();
}

// Sub-block a forward: xout = xin + Attn(LN(xin)).
template <int D, int DH>
__device__ __forceinline__ void attention_forward(const GradArea& A, const float* xin,
                                                  float* xout, const Dims& Dm, const Layout& L,
                                                  int a, int lane) {
  constexpr int DP = D | 1, DHP = DH | 1;
  const int n = Dm.n;
  layer_norm_rows<D>(xin, A.xn, A.mu, A.rs, L.ln_w[a], L.ln_b[a], n, lane);
  for (int tok = lane; tok < n; tok += 32) {
#pragma unroll
    for (int e = 0; e < D; ++e) xout[tok * DP + e] = xin[tok * DP + e];
  }
  for (int h = 0; h < Dm.heads; ++h) {
    head_forward<D, DH>(A, Dm, L, a, h, lane);
    for (int tok = lane; tok < n; tok += 32) {
      float o[DH];
#pragma unroll
      for (int c = 0; c < DH; ++c) o[c] = A.o[tok * DHP + c];
      float* xr = xout + tok * DP;
      if (Dm.project_out) {
        const float* wo = L.wo[a] + h * L.wo_hs;
#pragma unroll
        for (int e = 0; e < D; ++e) xr[e] += dot_row<DH, true>(o, wo, e, L.wo_es);
      } else if constexpr (D == DH) {   // heads == 1 and dim_head == d
#pragma unroll
        for (int e = 0; e < D; ++e) xr[e] += o[e];
      }
    }
  }
  if (Dm.project_out) {
    for (int tok = lane; tok < n; tok += 32) {
#pragma unroll
      for (int e = 0; e < D; ++e) xout[tok * DP + e] += L.bo[a][e];
    }
  }
  __syncwarp();
}

// The FF's backward: A.dx holds the gradient of the block's output (G);
// leaves there the gradient of x2, G + (gelu'(u) * (G W2)) W1, and adds
// the FF's weight gradients to acc.
template <int D>
__device__ __forceinline__ void feed_forward_backward(const GradArea& A, const Dims& Dm,
                                                      const Layout& L, const GradOffsets& off,
                                                      int lane) {
  constexpr int DP = D | 1;
  const int n = Dm.n, hp = Dm.hidden | 1;
  for (int tok = lane; tok < n; tok += 32) {
    float x[D], g[D], dxa[D];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      x[e] = A.x2[tok * DP + e];
      g[e] = A.dx[tok * DP + e];
      dxa[e] = 0.f;
    }
    float* gu = A.gu + tok * hp;
    float* du = A.du + tok * hp;
#pragma unroll (D > 16 ? 1 : 2)
    for (int k = 0; k < Dm.hidden; ++k) {
      float w1[D], w2[D];
      load_row<D, true>(L.w1 + k * L.w1_rs, 1, w1);
      load_row<D, true>(L.w2 + k * L.w2_ks, L.w2_es, w2);
      const float u = dot(x, w1) + L.b1[k];
      const float cdf = 0.5f * (1.0f + erff(u / 1.41421356237309515f));
      const float pdf = 0.398942280401432678f * expf(-0.5f * u * u);
      const float d = dot(g, w2) * (cdf + u * pdf);
      gu[k] = u * cdf;
      du[k] = d;
#pragma unroll
      for (int e = 0; e < D; ++e) dxa[e] = fmaf(d, w1[e], dxa[e]);
    }
#pragma unroll
    for (int e = 0; e < D; ++e) A.dt[tok * DP + e] = dxa[e];
  }
  __syncwarp();
  float* acc = A.acc;
  // W2 [d, hidden]: (e, k) += G[e] gelu(u)[k]; W1 [hidden, d]: (k, e) += du[k] x2[e]
  grad_outer<(D + 1) / 2>(acc + off.w2, 1, Dm.hidden, Dm.hidden, 0, A.gu, hp, 0, A.dx, DP,
                          Dm.hidden, D, n, lane);
  grad_rows(acc + off.b2, A.dx, DP, nullptr, 0, D, n, lane);
  grad_outer<(D + 1) / 2>(acc + off.w1, D, 1, Dm.hidden, 0, A.du, hp, 0, A.x2, DP, Dm.hidden, D,
                          n, lane);
  grad_rows(acc + off.b1, A.du, hp, nullptr, 0, Dm.hidden, n, lane);
  __syncwarp();
  for (int tok = lane; tok < n; tok += 32) {
#pragma unroll
    for (int e = 0; e < D; ++e) A.dx[tok * DP + e] += A.dt[tok * DP + e];
  }
  __syncwarp();
}

// Sub-block a's backward, xout = xin + Attn(LN(xin)): A.dx holds the
// gradient of xout and is left holding that of xin; the sub-block's weight
// gradients are added to acc.
template <int D, int DH>
__device__ __forceinline__ void attention_backward(const GradArea& A, const float* xin,
                                                   const Dims& Dm, const Layout& L,
                                                   const GradOffsets& off, int a, int lane) {
  constexpr int DP = D | 1, DHP = DH | 1;
  const int n = Dm.n, lp = score_stride(Dm);
  float* acc = A.acc;
  layer_norm_rows<D>(xin, A.xn, A.mu, A.rs, L.ln_w[a], L.ln_b[a], n, lane);
  for (int tok = lane; tok < n; tok += 32) {
#pragma unroll
    for (int e = 0; e < D; ++e) A.dxn[tok * DP + e] = 0.f;
  }
  for (int h = 0; h < Dm.heads; ++h) {
    head_forward<D, DH>(A, Dm, L, a, h, lane);
    // a query's lane: dO, the softmax's gradient (ds) and dq
    for (int tok = lane; tok < n; tok += 32) {
      float dO[DH], dq[DH];
#pragma unroll
      for (int c = 0; c < DH; ++c) { dO[c] = 0.f; dq[c] = 0.f; }
      const float* dy = A.dx + tok * DP;
      if (Dm.project_out) {
        const float* wo = L.wo[a] + h * L.wo_hs;
#pragma unroll
        for (int e = 0; e < D; ++e) {
          float w[DH];
          load_row<DH, true>(wo + e * L.wo_es, 1, w);
          const float ge = dy[e];
#pragma unroll
          for (int c = 0; c < DH; ++c) dO[c] = fmaf(ge, w[c], dO[c]);
        }
      } else if constexpr (D == DH) {
#pragma unroll
        for (int c = 0; c < DH; ++c) dO[c] = dy[c];
      }
#pragma unroll
      for (int c = 0; c < DH; ++c) A.dO[tok * DHP + c] = dO[c];
      const Group g = group_of(tok, Dm, a);
      const float* p = A.ps + tok * lp;
      float* ds = A.ds + tok * lp;
      float rowsum = 0.f;
      for (int l = 0; l < g.len; ++l) {
        const float* v = A.v + (g.first + l * g.step) * DHP;
        float dp = 0.f;
#pragma unroll
        for (int c = 0; c < DH; ++c) dp = fmaf(dO[c], v[c], dp);
        ds[l] = dp;
        rowsum = fmaf(p[l], dp, rowsum);
      }
      for (int l = 0; l < g.len; ++l) {
        const float sl = p[l] * (ds[l] - rowsum);
        ds[l] = sl;
        const float* k = A.k + (g.first + l * g.step) * DHP;
#pragma unroll
        for (int c = 0; c < DH; ++c) dq[c] = fmaf(sl, k[c], dq[c]);
      }
#pragma unroll
      for (int c = 0; c < DH; ++c) A.dq[tok * DHP + c] = dq[c] * Dm.scale;
    }
    __syncwarp();
    // a key's lane: dk and dv over its queries (its group), over its k, v
    for (int tok = lane; tok < n; tok += 32) {
      const Group g = group_of(tok, Dm, a);
      float dk[DH], dv[DH];
#pragma unroll
      for (int c = 0; c < DH; ++c) { dk[c] = 0.f; dv[c] = 0.f; }
      for (int l = 0; l < g.len; ++l) {
        const int i = g.first + l * g.step;
        const float sl = A.ds[i * lp + g.pos], pl = A.ps[i * lp + g.pos];
        const float* q = A.q + i * DHP;
        const float* dO = A.dO + i * DHP;
#pragma unroll
        for (int c = 0; c < DH; ++c) {
          dk[c] = fmaf(sl, q[c], dk[c]);
          dv[c] = fmaf(pl, dO[c], dv[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < DH; ++c) {
        A.k[tok * DHP + c] = dk[c] * Dm.scale;
        A.v[tok * DHP + c] = dv[c];
      }
    }
    __syncwarp();
    // w_qkv rows (part * inner + h * dh + c) += [dq | dk | dv][c] xn;
    // w_out (e, h * dh + c) += dy[e] o[c]
    grad_outer<D>(acc + off.qkv[a] + h * DH * D, D, 1, DH, Dm.inner * D, A.dq, DHP, n * DHP,
                  A.xn, DP, 3 * DH, D, n, lane);
    if (Dm.project_out)
      grad_outer<(DH + 2) / 3>(acc + off.wo[a] + h * DH, Dm.inner, 1, D, 0, A.dx, DP, 0, A.o,
                               DHP, D, DH, n, lane);
    // a token's lane: dxn += dq Wq + dk Wk + dv Wv over head h's rows
    for (int tok = lane; tok < n; tok += 32) {
      float xa[D];
#pragma unroll
      for (int e = 0; e < D; ++e) xa[e] = A.dxn[tok * DP + e];
#pragma unroll (D > 16 ? 1 : 2)
      for (int c = 0; c < DH; ++c) {
        const float gq = A.dq[tok * DHP + c], gk = A.k[tok * DHP + c], gv = A.v[tok * DHP + c];
        float wq[D], wk[D], wv[D];
        load_row<D, true>(L.qkv[a] + (h * DH + c) * L.qkv_rs, 1, wq);
        load_row<D, true>(L.qkv[a] + (Dm.inner + h * DH + c) * L.qkv_rs, 1, wk);
        load_row<D, true>(L.qkv[a] + (2 * Dm.inner + h * DH + c) * L.qkv_rs, 1, wv);
#pragma unroll
        for (int e = 0; e < D; ++e) xa[e] = fmaf(gv, wv[e], fmaf(gk, wk[e], fmaf(gq, wq[e], xa[e])));
      }
#pragma unroll
      for (int e = 0; e < D; ++e) A.dxn[tok * DP + e] = xa[e];
    }
  }
  __syncwarp();   // xn is read no more
  if (Dm.project_out) grad_rows(acc + off.bo[a], A.dx, DP, nullptr, 0, D, n, lane);
  // LayerNorm's backward; xn's rows take x-hat
  for (int tok = lane; tok < n; tok += 32) {
    const float mu = A.mu[tok], r = A.rs[tok];
#pragma unroll
    for (int e = 0; e < D; ++e) A.xn[tok * DP + e] = (xin[tok * DP + e] - mu) * r;
  }
  __syncwarp();
  grad_rows(acc + off.ln_w[a], A.dxn, DP, A.xn, DP, D, n, lane);
  grad_rows(acc + off.ln_b[a], A.dxn, DP, nullptr, 0, D, n, lane);
  __syncwarp();   // dx is read no more by other lanes
  const float* ln_w = L.ln_w[a];
  for (int tok = lane; tok < n; tok += 32) {
    float xh[D], dh[D];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) {
      xh[e] = A.xn[tok * DP + e];
      dh[e] = A.dxn[tok * DP + e] * ln_w[e];
      m1 += dh[e];
      m2 = fmaf(dh[e], xh[e], m2);
    }
    m1 /= D;
    m2 /= D;
    const float r = A.rs[tok];
#pragma unroll
    for (int e = 0; e < D; ++e) A.dx[tok * DP + e] += r * (dh[e] - m1 - xh[e] * m2);
  }
  __syncwarp();
}

// dx of one sample per warp pass, and the CTA's row of weight-gradient
// partials. Compiled widths (d, dim_head) = (D, DH), weights staged.
template <int D, int DH>
__global__ void __launch_bounds__(kWarps * 32, 1)
k1_grad_kernel(const float* __restrict__ x_in, const float* __restrict__ g_in,
               float* __restrict__ dx_out, float* __restrict__ partials, int B, Dims Dm,
               Weights W) {
  constexpr int DP = D | 1;
  extern __shared__ float4 smem4[];
  float* area;
  const Layout L = weights_layout<D, DH>(reinterpret_cast<float*>(smem4), true, Dm, W, &area);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = Dm.n, nd = n * D, wf = grad_warp_floats(Dm);
  const GradOffsets off = grad_offsets(Dm);
  const GradArea A = grad_area(area + warp * wf, Dm);
  for (int p = lane; p < off.total; p += 32) A.acc[p] = 0.f;
  for (int b = blockIdx.x * warps + warp; b < B; b += gridDim.x * warps) {
    const float* src = x_in + (size_t)b * nd;
    const float* gsrc = g_in + (size_t)b * nd;
    for (int it = lane; it < nd; it += 32) {
      const int tok = it / D, at = tok * DP + it - tok * D;
      A.x0[at] = __ldg(src + it);
      A.dx[at] = __ldg(gsrc + it);
    }
    __syncwarp();
    attention_forward<D, DH>(A, A.x0, A.x1, Dm, L, 0, lane);
    attention_forward<D, DH>(A, A.x1, A.x2, Dm, L, 1, lane);
    feed_forward_backward<D>(A, Dm, L, off, lane);
    attention_backward<D, DH>(A, A.x1, Dm, L, off, 1, lane);
    attention_backward<D, DH>(A, A.x0, Dm, L, off, 0, lane);
    float* dst = dx_out + (size_t)b * nd;
    for (int it = lane; it < nd; it += 32) {
      const int tok = it / D;
      dst[it] = A.dx[tok * DP + it - tok * D];
    }
    __syncwarp();   // the next sample overwrites x0 and dx
  }
  __syncthreads();
  // the CTA's partials: its warps' accumulators added in warp order
  const int acc_at = (int)(A.acc - (area + warp * wf));
  for (int p = threadIdx.x; p < off.total; p += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += area[w * wf + acc_at + p];
    partials[(size_t)blockIdx.x * off.total + p] = s;
  }
}

// grads[p] = the sum of partials[r][p] over rows r = 0, 1, ..., in order.
__global__ void k1_grad_sum_kernel(const float* __restrict__ partials, int rows, int P,
                                   float* __restrict__ grads) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += partials[(size_t)r * P + p];
  grads[p] = s;
}

// The launch plan of one shape: which kernel, weights staged or not,
// warps per CTA, shared memory per CTA.
struct Plan {
  bool compiled, staged;
  int warps, smem;
};

bool compiled_width(int d, int dh) { return dh == 10 && (d == 10 || d == 40); }

bool plan(const Dims& Dm, Plan* p) {
  p->compiled = compiled_width(Dm.d, Dm.dh);
  const long long warp_bytes = 4LL * warp_floats(Dm, !p->compiled);
  const long long wbytes = 4LL * staged_floats(Dm);
  p->staged = wbytes <= kWeightSmemBytes && wbytes + warp_bytes <= kMaxSmemBytes;
  const long long room = kMaxSmemBytes - (p->staged ? wbytes : 0);
  const long long warps = room / warp_bytes;
  if (warps < 1) return false;
  p->warps = warps < kWarps ? (int)warps : kWarps;
  p->smem = (int)((p->staged ? wbytes : 0) + p->warps * warp_bytes);
  return true;
}

// fn(kernel, extra) for the plan's kernel, extra being the trailing
// arguments it takes after (x_in, x_out, B, Dm, W).
template <typename Fn>
cudaError_t with_kernel(const Dims& Dm, const Plan& p, Fn&& fn) {
  if (!p.compiled) return fn(cross_intra_block_rows_kernel, p.staged);
  if (Dm.d == 10) return p.staged ? fn(cross_intra_block_kernel<10, 10, true>)
                                  : fn(cross_intra_block_kernel<10, 10, false>);
  return p.staged ? fn(cross_intra_block_kernel<40, 10, true>)
                  : fn(cross_intra_block_kernel<40, 10, false>);
}

// The kernel's dynamic shared memory may reach the opt-in maximum (every
// plan fits under it, so shapes that share a kernel never lower each
// other's limit); the occupancy is that of the plan's own bytes.
template <typename K>
cudaError_t ctas_per_sm(K kernel, const Plan& p, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, 32 * p.warps, p.smem);
}

// The most CTAs of a block shape that are resident on a device at once.
struct GridCap {
  int dev, t, s, d, heads, dh, hidden, project_out, ctas;
};

std::mutex grid_caps_mutex;
std::vector<GridCap> grid_caps;        // the forward's
std::vector<GridCap> grad_grid_caps;   // the backward's (k1_grad_kernel)

// *ctas for the shape on the current device: queried at the shape's
// first launch there, read from the cache after.
template <typename K>
cudaError_t resident_ctas(K kernel, std::vector<GridCap>& caps, const Dims& Dm, const Plan& p,
                          int* ctas) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const GridCap key{dev, Dm.t, Dm.s, Dm.d, Dm.heads, Dm.dh, Dm.hidden, Dm.project_out, 0};
  std::lock_guard<std::mutex> lock(grid_caps_mutex);
  for (const GridCap& c : caps) {
    if (c.dev == key.dev && c.t == key.t && c.s == key.s && c.d == key.d &&
        c.heads == key.heads && c.dh == key.dh && c.hidden == key.hidden &&
        c.project_out == key.project_out) {
      *ctas = c.ctas;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = ctas_per_sm(kernel, p, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  GridCap entry = key;
  entry.ctas = per_sm * sms;
  caps.push_back(entry);
  *ctas = entry.ctas;
  return cudaSuccess;
}


// The backward's launch plan: compiled widths, the weights staged, and as
// many warps' areas beside them as fit (at least one, at most kWarps).
bool grad_width(int d, int dh) { return d == 10 && dh == 10; }

bool grad_plan(const Dims& Dm, Plan* p) {
  if (!grad_width(Dm.d, Dm.dh) || (!Dm.project_out && (Dm.heads != 1 || Dm.dh != Dm.d)))
    return false;
  const long long warp_bytes = 4LL * grad_warp_floats(Dm);
  const long long wbytes = 4LL * staged_floats(Dm);
  if (wbytes > kWeightSmemBytes) return false;
  const long long warps = (kMaxSmemBytes - wbytes) / warp_bytes;
  if (warps < 1) return false;
  p->compiled = p->staged = true;
  p->warps = warps < kWarps ? (int)warps : kWarps;
  p->smem = (int)(wbytes + p->warps * warp_bytes);
  return true;
}

// The backward's grid for B samples: at most one CTA per p.warps samples,
// at most what is resident on the device at once.
cudaError_t grad_grid(const Dims& Dm, const Plan& p, int B, int* grid) {
  int ctas = 0;
  const cudaError_t err = resident_ctas(k1_grad_kernel<10, 10>, grad_grid_caps, Dm, p, &ctas);
  if (err != cudaSuccess) return err;
  const int need = (B + p.warps - 1) / p.warps;
  *grid = need < ctas ? need : ctas;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int cross_intra_block_max_smem_bytes() { return kMaxSmemBytes; }

// Shared memory one sample (one warp's area) needs, in bytes.
long long cross_intra_block_smem_per_sample(int t, int s, int d, int dh) {
  return 4LL * warp_floats(make_dims(t, s, d, 1, dh, 0, 1), !compiled_width(d, dh));
}

// The launch plan of a block shape: warps per CTA, whether the weights
// are staged in shared memory, and the CTAs that fit on one SM.
int cross_intra_block_occupancy(int t, int s, int d, int heads, int dh, int hidden,
                                int project_out, int* warps, int* staged, int* per_sm) {
  const Dims Dm = make_dims(t, s, d, heads, dh, hidden, project_out);
  Plan p;
  if (!plan(Dm, &p)) return (int)cudaErrorInvalidValue;
  *warps = p.warps;
  *staged = p.staged;
  return (int)with_kernel(Dm, p, [&](auto kernel, auto...) {
    return ctas_per_sm(kernel, p, per_sm);
  });
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
  if (!project_out && (heads != 1 || dh != d)) return (int)cudaErrorInvalidValue;
  const Dims Dm = make_dims(t, s, d, heads, dh, hidden, project_out);
  Plan p;
  if (!plan(Dm, &p)) return (int)cudaErrorInvalidValue;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  const Weights W{w[0], w[1], w[2], w[3], w[4], w[5], w[6],
                  w[7], w[8], w[9], w[10], w[11], w[12], w[13]};
  return (int)with_kernel(Dm, p, [&](auto kernel, auto... extra) {
    int ctas = 0;
    cudaError_t e = resident_ctas(kernel, grid_caps, Dm, p, &ctas);
    if (e != cudaSuccess) return e;
    const int need = (B + p.warps - 1) / p.warps;
    const int grid = need < ctas ? need : ctas;
    kernel<<<grid, 32 * p.warps, p.smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x_in), static_cast<float*>(x_out), B, Dm, W, extra...);
    return cudaGetLastError();
  });
}

// The CTAs K1's backward launches for B samples of a block shape (the rows
// of the partials the caller allocates); 0 where the shape does not take
// the kernel (its widths, its weights or one warp's area do not fit), or
// minus a cudaError_t.
int k1_grad_grid(int B, int t, int s, int d, int heads, int dh, int hidden, int project_out) {
  const Dims Dm = make_dims(t, s, d, heads, dh, hidden, project_out);
  Plan p;
  if (B <= 0 || !grad_plan(Dm, &p)) return 0;
  int grid = 0;
  const cudaError_t err = grad_grid(Dm, p, B, &grid);
  return err == cudaSuccess ? grid : -(int)err;
}

// Floats of one warp's area in K1's backward, and the warps per CTA.
int k1_grad_occupancy(int t, int s, int d, int heads, int dh, int hidden, int project_out,
                      int* warp_floats, int* warps, int* per_sm) {
  const Dims Dm = make_dims(t, s, d, heads, dh, hidden, project_out);
  Plan p;
  if (!grad_plan(Dm, &p)) return (int)cudaErrorInvalidValue;
  *warp_floats = grad_warp_floats(Dm);
  *warps = p.warps;
  return (int)ctas_per_sm(k1_grad_kernel<10, 10>, p, per_sm);
}

// K1's backward. x, grad_out, dx [B, t, s, d] f32 contiguous on the device;
// weights as in cross_intra_block_launch; partials [grid, P] and grads [P]
// f32 scratch and output, P the floats of the 14 gradients in the
// weights' order and layouts (w_out*/b_out* left out without project_out),
// grid what k1_grad_grid returned.
int k1_grad_launch(const void* x, const void* grad_out, void* dx, void* partials, void* grads,
                   int B, int t, int s, int d, int heads, int dh, int hidden, int project_out,
                   const void* const* weights, long long P, int grid, void* stream) {
  const Dims Dm = make_dims(t, s, d, heads, dh, hidden, project_out);
  Plan p;
  if (B <= 0 || !grad_plan(Dm, &p) || grad_offsets(Dm).total != P)
    return (int)cudaErrorInvalidValue;
  int want = 0;
  cudaError_t err = grad_grid(Dm, p, B, &want);
  if (err != cudaSuccess) return (int)err;
  if (grid != want) return (int)cudaErrorInvalidValue;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  const Weights W{w[0], w[1], w[2], w[3], w[4], w[5], w[6],
                  w[7], w[8], w[9], w[10], w[11], w[12], w[13]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k1_grad_kernel<10, 10><<<grid, 32 * p.warps, p.smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(grad_out), static_cast<float*>(dx),
      static_cast<float*>(partials), B, Dm, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k1_grad_sum_kernel<<<(int)((P + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partials), grid, (int)P, static_cast<float*>(grads));
  return (int)cudaGetLastError();
}

}  // extern "C"
