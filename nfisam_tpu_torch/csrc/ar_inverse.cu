// Masked autoregressive inverse of one NSF-AR flow, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flow_inverse_masked_pallas`
// (nfisam_tpu/flows/ar_inverse_pallas.py: body `_ar_inverse_kernel`,
// spline `_rqs_inverse_row`).  For each dim i in order, every sample runs
//   h1 = tanh(W1[i][:, :i] x[:i] + b1[i]),  h2 = tanh(W2[i] h1 + b2[i]),
//   P  = W3[i] h2 + b3[i]                     (3K spline parameters)
// then the rational-quadratic spline inverse of z[:, i] under P, and writes
// the result where invert_mask[i] (a pinned prefix column keeps its value).
// No log-det: conditional sampling discards it.
//
// What bounds it on an H100: neither bytes nor FLOPs.  At the main-path
// shape (n = 1000-2000 samples, d = 16, h = 8, K = 9) the whole call reads
// ~0.2 MB and does ~20 MFLOP, microseconds of either at the card's rates.
// Its time is the length of the dependency chain: d sequential dim steps,
// each a ~0.5K-float weight stage into shared memory, a barrier, three tiny
// dense layers and a K-bin spline, all per thread.  The design keeps that
// chain on chip: one thread per sample, blocks of 64 samples (so n = 1000
// already spreads over 16 SMs), the block's (64, d) state tile in shared
// memory with an odd row stride (conflict-free), and dim i's weight slice
// staged once per block per step and read as broadcasts.  Columns the mask
// pins are skipped entirely (the prefix tile already holds them).
//
// Numerics follow the JAX spec exactly where intuition differs: softplus is
// max(x,0)+log1p(exp(-|x|)); endpoint knots are pinned to +-B; the bin is
// searched on the height knots with >=; the discriminant is clamped at 0
// and theta clipped to [0,1] (NaN-propagating, as jnp.clip); Euclidean
// dims pass through unchanged outside [-B, B]; circular dims wrap with the
// floored modulo (fmodf then a sign fix-up, bit-identical to jnp.mod and
// torch.remainder) and take the wrap-around derivative P[3K-1] at the
// front.  No fast-math: expf, tanhf and log1pf are the IEEE versions.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr float kMinBinWidth = 1e-3f;
constexpr float kMinBinHeight = 1e-3f;
constexpr float kMinDerivative = 1e-3f;
constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float clip01(float t) {
  // NaN passes through, as jnp.clip does
  return t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
}

// Softmax bins with a size floor, as knots on [-bound, bound]; the end
// knots are pinned exactly.
template <int K>
__device__ __forceinline__ void knots(const float* raw, float min_size,
                                      float bound, float* cum) {
  float m = raw[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fmaxf(m, raw[k]);
  float e[K];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e[k] = expf(raw[k] - m);
    s += e[k];
  }
  cum[0] = -bound;
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    const float size = min_size + (1.f - min_size * K) * (e[k] / s);
    cum[k + 1] = cum[k] + size * (2.f * bound);
  }
  cum[K] = bound;
}

template <int K>
__device__ __forceinline__ float rqs_inverse(float z, const float* P,
                                             float bound, bool circular,
                                             float boundary_raw) {
  float cumw[K + 1], cumh[K + 1], der[K + 1];
  knots<K>(P, kMinBinWidth, bound, cumw);
  knots<K>(P + K, kMinBinHeight, bound, cumh);
  if (circular) {
    der[0] = kMinDerivative + softplus(P[3 * K - 1]);
#pragma unroll
    for (int k = 0; k < K; ++k)
      der[k + 1] = kMinDerivative + softplus(P[2 * K + k]);
  } else {
    der[0] = der[K] = kMinDerivative + softplus(boundary_raw);
#pragma unroll
    for (int k = 0; k < K - 1; ++k)
      der[k + 1] = kMinDerivative + softplus(P[2 * K + k]);
  }

  float zin;
  bool inside;
  if (circular) {
    const float period = 2.f * bound;
    float r = fmodf(z + bound, period);
    if (r != 0.f && r < 0.f) r += period;
    zin = r - bound;
    inside = true;
  } else {
    inside = (z >= -bound) && (z <= bound);
    zin = fminf(fmaxf(z, -bound), bound);
  }

  // bin on the HEIGHT knots (inverse direction)
  int idx = 0;
#pragma unroll
  for (int k = 1; k < K; ++k) idx += (zin >= cumh[k]) ? 1 : 0;

  float in_cumw = cumw[0], in_w = cumw[1] - cumw[0];
  float in_cumh = cumh[0], in_h = cumh[1] - cumh[0];
  float d0 = der[0], d1 = der[1];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (idx == k) {
      in_cumw = cumw[k];
      in_w = cumw[k + 1] - cumw[k];
      in_cumh = cumh[k];
      in_h = cumh[k + 1] - cumh[k];
      d0 = der[k];
      d1 = der[k + 1];
    }
  }
  const float delta = in_h / in_w;
  const float s = d0 + d1 - 2.f * delta;
  const float y_rel = zin - in_cumh;
  const float a = in_h * (delta - d0) + y_rel * s;
  const float b = in_h * d0 - y_rel * s;
  const float c = -delta * y_rel;
  const float disc = fmaxf(b * b - 4.f * a * c, 0.f);
  const float theta = clip01((2.f * c) / (-b - sqrtf(disc)));
  const float out = theta * in_w + in_cumw;
  return inside ? out : z;
}

__device__ __forceinline__ void stage(float* dst, const float* src, int count,
                                      int tid) {
  for (int e = tid; e < count; e += kBlock) dst[e] = src[e];
}

template <int D, int H, int K>
__global__ void __launch_bounds__(kBlock) ar_inverse_kernel(
    const float* __restrict__ z, const float* __restrict__ xp,
    const uint8_t* __restrict__ invert, const uint8_t* __restrict__ circular,
    const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ W3, const float* __restrict__ b3,
    float* __restrict__ out, int n, float tail_bound, float boundary_raw) {
  constexpr int P = 3 * K;
  constexpr int XS = D + 1;  // odd row stride: column reads hit 32 banks
  __shared__ float xs[kBlock * XS];
  __shared__ float sW1[H * D], sb1[H], sW2[H * H], sb2[H], sW3[P * H], sb3[P];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBlock;
  const int rows = min(kBlock, n - row0);
  const float* xp_tile = xp + (size_t)row0 * D;
  // prefix tile: pinned values where not inverted, zero where inverted
  for (int e = tid; e < rows * D; e += kBlock) {
    const int r = e / D, c = e - r * D;
    xs[r * XS + c] = invert[c] ? 0.f : xp_tile[e];
  }
  const bool active = tid < rows;
  float* x = xs + tid * XS;
  const float* z_row = z + (size_t)(row0 + tid) * D;

  for (int i = 0; i < D; ++i) {
    if (!invert[i]) continue;  // uniform over the block: the column is pinned
    __syncthreads();           // previous step's reads of the slice are done
    stage(sW1, W1 + (long)i * H * D, H * D, tid);
    stage(sb1, b1 + i * H, H, tid);
    stage(sW2, W2 + (long)i * H * H, H * H, tid);
    stage(sb2, b2 + i * H, H, tid);
    stage(sW3, W3 + (long)i * P * H, P * H, tid);
    stage(sb3, b3 + i * P, P, tid);
    __syncthreads();
    if (active) {
      float h1[H], h2[H], Pv[P];
#pragma unroll
      for (int k = 0; k < H; ++k) {
        float acc = 0.f;
        for (int j = 0; j < i; ++j) acc += sW1[k * D + j] * x[j];
        h1[k] = tanhf(acc + sb1[k]);
      }
#pragma unroll
      for (int k = 0; k < H; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < H; ++j) acc += sW2[k * H + j] * h1[j];
        h2[k] = tanhf(acc + sb2[k]);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < H; ++j) acc += sW3[p * H + j] * h2[j];
        Pv[p] = acc + sb3[p];
      }
      const bool circ = circular[i] != 0;
      x[i] = rqs_inverse<K>(z_row[i], Pv, circ ? kPi : tail_bound, circ,
                            boundary_raw);
    }
  }
  __syncthreads();
  float* out_tile = out + (size_t)row0 * D;
  for (int e = tid; e < rows * D; e += kBlock) {
    const int r = e / D, c = e - r * D;
    out_tile[e] = xs[r * XS + c];
  }
}

}  // namespace

#define NFISAM_AR_LAUNCH(D_, H_, K_)                                        \
  if (d == D_ && h == H_ && K == K_) {                                      \
    ar_inverse_kernel<D_, H_, K_><<<grid, kBlock, 0, s>>>(                  \
        z, xp, invert, circular, W1, b1, W2, b2, W3, b3, out, n,            \
        tail_bound, boundary_raw);                                          \
    return (int)cudaGetLastError();                                         \
  }

#define NFISAM_AR_LAUNCH_K(D_, H_) \
  NFISAM_AR_LAUNCH(D_, H_, 7)      \
  NFISAM_AR_LAUNCH(D_, H_, 9)      \
  NFISAM_AR_LAUNCH(D_, H_, 12)

// Plain C entry point, loaded with ctypes.  All arrays are contiguous
// float32 (uint8 for the two masks) on the device; returns the launch's
// cudaError_t (0 on success, cudaErrorInvalidValue for a shape that has no
// instantiation).
extern "C" int nfisam_ar_inverse_f32(
    const float* z, const float* xp, const uint8_t* invert,
    const uint8_t* circular, const float* W1, const float* b1,
    const float* W2, const float* b2, const float* W3, const float* b3,
    float* out, int n, int d, int h, int K, float tail_bound,
    float boundary_raw, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((unsigned)((n + kBlock - 1) / kBlock));
  cudaStream_t s = (cudaStream_t)stream;
  NFISAM_AR_LAUNCH_K(16, 8)
  NFISAM_AR_LAUNCH_K(32, 16)
  NFISAM_AR_LAUNCH_K(64, 32)
  return (int)cudaErrorInvalidValue;
}
