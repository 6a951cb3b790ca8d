// Masked autoregressive inverse of one NSF-AR flow at any (d, h, K), for
// Hopper (sm_90a): the shapes `ar_inverse.cu` has no instantiation for.
//
// Replaces the Pallas TPU kernel `flow_inverse_masked_pallas`
// (nfisam_tpu/flows/ar_inverse_pallas.py) where the port's specialised
// kernel does not reach: the Pallas kernel takes any static (d, h, K) and
// pads d to the sublane, so the JAX package's options (`--hidden`,
// `scale_hidden_with_dim=False`, `pad_dim_multiple`, any `num_knots`)
// reach shapes such as (12, 8, 9), (16, 16, 9) or (5, 8, 8).  It computes
// what `ar_inverse.cu` computes, for each inverted dim i in order:
//   h1 = tanh(W1[i][:, :i] x[:i] + b1[i]),  h2 = tanh(W2[i] h1 + b2[i]),
//   P  = W3[i] h2 + b3[i]                     (3K spline parameters)
// then the rational-quadratic spline inverse of z[:, i] under P; a pinned
// column keeps its prefix value.  No log-det.
//
// Design: simple and right first, speed later.  d, h and K are run-time
// arguments.  One warp a sample, four samples a block.  The sample's x row,
// its two hidden vectors, its 3K spline parameters and the 2(K+1) knots
// live in shared memory (d + 2h + 5K + 2 floats a warp); the weights are
// read through the read-only cache (`__ldg`).  Each layer spreads its
// outputs over the lanes (lane l computes units l, l + 32, ...), each a
// sequential dot product, with a `__syncwarp` between layers; lane 0 then
// runs the spline alone.  What bounds it on an H100 is, as for the
// specialised kernel, the chain of dependent steps of each sample: the
// sequential dims, and in each the serial spline of ~10K operations in one
// lane.  A redesign (ROADMAP B1c) waits for a path that spends time here.
//
// Numerics are the specialised kernel's and the plain version's: no fast
// math (expf, tanhf, log1pf, the divisions and sqrtf are IEEE);
// softplus = max(x,0) + log1p(exp(-|x|)); the softmax divides by its sum;
// the knots are 2B * cumsum + (-B) without contraction, endpoint knots
// pinned to +-B; the bin is searched on the height knots with >=; the
// discriminant is clamped at 0 and theta clipped to [0, 1] passing NaN;
// Euclidean dims pass through outside [-B, B]; circular dims wrap with the
// floored modulo and take the wrap-around derivative P[3K-1] at the front.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                    // samples a block, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kSmemLimit = 232448;           // dynamic shared memory a block may use
constexpr float kMinBinWidth = 1e-3f;
constexpr float kMinBinHeight = 1e-3f;
constexpr float kMinDerivative = 1e-3f;
constexpr float kPi = 3.14159265358979323846f;

// floats of shared memory one sample uses: x | h1 | h2 | P | cw | ch
__host__ __device__ inline int scratch_floats(int d, int h, int K) {
  return d + 2 * h + 3 * K + 2 * (K + 1);
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float clip01(float t) {
  // NaN passes through, as jnp.clip and torch.clamp do
  return t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
}

// The K + 1 knots of a softmax-with-floor partition of [-bound, bound]
// from the K raw sizes: end knots pinned, the inner ones the running sum
// of the floored sizes, scaled and shifted without contraction.
__device__ void knots(const float* raw, int K, float bound, float min_size,
                      float scale, float* cum) {
  float m = raw[0];
  for (int k = 1; k < K; ++k) m = fmaxf(m, raw[k]);
  float sum = 0.f;
  for (int k = 0; k < K; ++k) sum += expf(raw[k] - m);
  float run = 0.f;
  cum[0] = -bound;
  for (int k = 0; k < K - 1; ++k) {
    run += __fadd_rn(min_size, __fmul_rn(scale, expf(raw[k] - m) / sum));
    cum[k + 1] = __fadd_rn(__fmul_rn(2.f * bound, run), -bound);
  }
  cum[K] = bound;
}

// The derivative at knot k (0..K) of dim's spline: the boundary
// derivative at both ends of a Euclidean dim, the wrap-around P[3K-1] at
// both ends of a circular one.
__device__ __forceinline__ float knot_derivative(const float* P, int K, int k,
                                                 bool circular,
                                                 float bnd_deriv) {
  if (circular) return kMinDerivative + softplus(P[2 * K + (k == 0 ? K - 1 : k - 1)]);
  if (k == 0 || k == K) return bnd_deriv;
  return kMinDerivative + softplus(P[2 * K + k - 1]);
}

// The spline inverse of zi under P: a circular dim wraps onto [-pi, pi], a
// Euclidean one passes through outside [-bound, bound].
__device__ float spline_inverse(float zi, const float* P, int K,
                                bool circular, float tail_bound,
                                float bnd_deriv, float* cw, float* ch) {
  const float bound = circular ? kPi : tail_bound;
  float zin;
  bool inside;
  if (circular) {
    const float period = 2.f * bound;
    float r = fmodf(zi + bound, period);
    if (r != 0.f && r < 0.f) r += period;
    zin = r - bound;
    inside = true;
  } else {
    inside = (zi >= -bound) && (zi <= bound);
    zin = fminf(fmaxf(zi, -bound), bound);
  }
  // 1 - min_size * K in double, then rounded, as the plain version's
  // Python scalar is
  const float scale_w = (float)(1.0 - 1e-3 * K);
  const float scale_h = (float)(1.0 - 1e-3 * K);
  knots(P, K, bound, kMinBinWidth, scale_w, cw);
  knots(P + K, K, bound, kMinBinHeight, scale_h, ch);
  // bin on the HEIGHT knots (inverse direction): #{k in 1..K-1: zin >= ch[k]}
  int idx = 0;
  for (int k = 1; k < K; ++k) idx += zin >= ch[k] ? 1 : 0;
  const float d_lo = knot_derivative(P, K, idx, circular, bnd_deriv);
  const float d_up = knot_derivative(P, K, idx + 1, circular, bnd_deriv);
  const float in_w = cw[idx + 1] - cw[idx], in_h = ch[idx + 1] - ch[idx];
  const float delta = in_h / in_w;
  const float s = d_lo + d_up - 2.f * delta;
  const float y_rel = zin - ch[idx];
  const float a = in_h * (delta - d_lo) + y_rel * s;
  const float b = in_h * d_lo - y_rel * s;
  const float cq = -delta * y_rel;
  const float disc = fmaxf(b * b - 4.f * a * cq, 0.f);
  const float theta = clip01((2.f * cq) / (-b - sqrtf(disc)));
  const float root = theta * in_w + cw[idx];
  return inside ? root : zi;
}

__global__ void __launch_bounds__(kThreads) ar_inverse_generic_kernel(
    const float* __restrict__ z, const float* __restrict__ xp,
    const uint8_t* __restrict__ invert, const uint8_t* __restrict__ circular,
    const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ W3, const float* __restrict__ b3,
    float* __restrict__ out, int n, int d, int h, int K, float tail_bound,
    float boundary_raw) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarps + warp;
  if (row >= n) return;   // a whole warp: nothing below syncs the block
  const int P3 = 3 * K;
  float* x = smem + (size_t)warp * scratch_floats(d, h, K);
  float* h1 = x + d;
  float* h2 = h1 + h;
  float* P = h2 + h;
  float* cw = P + P3;
  float* ch = cw + K + 1;
  const float bnd_deriv = kMinDerivative + softplus(boundary_raw);

  // pinned columns hold their prefix values from the start, inverted ones
  // 0 until their step writes them (only columns < i reach dim i)
  for (int j = lane; j < d; j += 32)
    x[j] = invert[j] ? 0.f : xp[row * d + j];
  __syncwarp();

  for (int i = 0; i < d; ++i) {
    if (!invert[i]) continue;   // the same branch in every lane
    for (int k = lane; k < h; k += 32) {
      const float* w = W1 + ((size_t)i * h + k) * d;
      float acc = 0.f;
      for (int j = 0; j < i; ++j) acc = fmaf(__ldg(w + j), x[j], acc);
      h1[k] = tanhf(acc + __ldg(b1 + (size_t)i * h + k));
    }
    __syncwarp();
    for (int k = lane; k < h; k += 32) {
      const float* w = W2 + ((size_t)i * h + k) * h;
      float acc = 0.f;
      for (int j = 0; j < h; ++j) acc = fmaf(__ldg(w + j), h1[j], acc);
      h2[k] = tanhf(acc + __ldg(b2 + (size_t)i * h + k));
    }
    __syncwarp();
    for (int q = lane; q < P3; q += 32) {
      const float* w = W3 + ((size_t)i * P3 + q) * h;
      float acc = 0.f;
      for (int j = 0; j < h; ++j) acc = fmaf(__ldg(w + j), h2[j], acc);
      P[q] = acc + __ldg(b3 + (size_t)i * P3 + q);
    }
    __syncwarp();
    if (lane == 0)
      x[i] = spline_inverse(z[row * d + i], P, K, circular[i] != 0,
                            tail_bound, bnd_deriv, cw, ch);
    __syncwarp();
  }
  for (int j = lane; j < d; j += 32) out[row * d + j] = x[j];
}

int smem_bytes(int d, int h, int K) {
  return (int)(sizeof(float) * kWarps * (size_t)scratch_floats(d, h, K));
}

bool valid_shape(int d, int h, int K) {
  return d >= 1 && h >= 1 && K >= 2 && smem_bytes(d, h, K) <= kSmemLimit;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All arrays are contiguous
// float32 (uint8 for the two masks) on the device; d >= 1, h >= 1, K >= 2
// at run time.  Returns the launch's cudaError_t (0 on success,
// cudaErrorInvalidValue for a shape out of that range or whose four rows
// of scratch do not fit a block's shared memory).
extern "C" int nfisam_ar_inverse_generic_f32(
    const float* z, const float* xp, const uint8_t* invert,
    const uint8_t* circular, const float* W1, const float* b1,
    const float* W2, const float* b2, const float* W3, const float* b3,
    float* out, int n, int d, int h, int K, float tail_bound,
    float boundary_raw, void* stream) {
  if (!valid_shape(d, h, K)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int bytes = smem_bytes(d, h, K);
  // above 48 KB dynamic shared memory needs the attribute (the current
  // device's, so it is set on every launch)
  const cudaError_t attr = cudaFuncSetAttribute(
      ar_inverse_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((n + kWarps - 1) / kWarps));
  ar_inverse_generic_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      z, xp, invert, circular, W1, b1, W2, b2, W3, b3, out, n, d, h, K,
      tail_bound, boundary_raw);
  return (int)cudaGetLastError();
}

// Build facts at (d, h, K), in `ar_inverse.cu`'s order: registers a
// thread, local memory a thread in bytes, dynamic shared memory a block in
// bytes, threads a block, samples a block, weight ring slots (0: the
// weights are not staged).  Returns a cudaError_t.
extern "C" int nfisam_ar_inverse_generic_info(int d, int h, int K,
                                              int* info_out) {
  if (!valid_shape(d, h, K)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, ar_inverse_generic_kernel);
  if (err != cudaSuccess) return (int)err;
  info_out[0] = attr.numRegs;
  info_out[1] = (int)attr.localSizeBytes;
  info_out[2] = smem_bytes(d, h, K);
  info_out[3] = kThreads;
  info_out[4] = kWarps;
  info_out[5] = 0;
  return 0;
}
