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
// shape (n = 1000-2000 samples, d = 16, h = 8, K = 9) a call reads ~0.2 MB
// and does ~15-30 MFLOP, a fraction of a microsecond of either.  Its time
// is the dependency chain of the sequential dim steps: every step of a
// sample waits for the previous step's x[i].  Done by one thread (the
// first port), a step is ~900 dependent operations: 8 dot products over
// the prefix, two 8-wide layers, a 27x8 layer, 16 tanh, two K-bin
// softmaxes with serial sums and knot cumsums, K+1 softplus, the root.  At
// n = 1000 the whole card then holds ~1000 threads, one or two warps on a
// few SMs, and nothing hides a latency.  The design shortens the chain and
// keeps everything else off it:
//
// - A group of 16 lanes (a half-warp) per sample, 8 samples a block of 128
//   threads: n = 1000 fills 125 SMs with one warp on each scheduler.  The
//   hidden units are spread over the lanes (lane l owns unit(s) l*h/16; at
//   h = 8 two lanes share one), and each layer is a shuffle round: h1 and
//   h2 reach every lane by one round of h independent shuffles, and lane k
//   computes the raw width, height and derivative of spline bin k.
// - Layer 1 leaves the chain.  The x row lives in registers (column j in
//   lane j % 16; pinned columns hold their prefix values from the start,
//   inverted ones 0 until reached).  While step i runs, the group already
//   sums layer 1 of the next inverted dim over every column known (each
//   lane its columns into every unit, then a xor-shuffle reduce-scatter to
//   the owners); step i then adds only W1[.][:, i] x[i], one FMA.
// - The spline in every lane.  The raw widths and heights go to every lane
//   by one round of K shuffles (for the max), lane k takes the exponential
//   of bin k, those go to every lane by a second round (for the sum), and
//   each lane forms the floored sizes, the running sums (the knots, end
//   knots pinned), the bin count and the bin's root in registers; the bin's
//   two derivatives come from their lanes by two shuffles.  Two rounds of
//   independent shuffles replace butterflies and a scan, ten shuffle
//   latencies deep: a shuffle's latency is what a step spends most of, and
//   registers are plentiful.  The two partitions run in lockstep.
// - The weights arrive in shared memory by TMA bulk copies (cp.async.bulk)
//   issued by one thread, one mbarrier per slot: b1, b2, b3 whole, and a
//   ring of S per-dim slices [W1[i] | W2[i] | W3[i]] for the inverted dims
//   only.  S = d when the whole flow fits (d = 16: 25-34 KB, d = 32: up to
//   181 KB), so each block loads the flow once, overlapped with the load of
//   its z and prefix rows, and each step waits only for its own slice; at
//   d = 64 (17 KB a slice) S = 3 slots are refilled behind the compute,
//   released through an "empty" mbarrier per slot.  No __syncthreads in the
//   dim loop.  The masks are read once into bit sets.
// A step at d = 16 is then ~0.9 us on an H100 (~1800 cycles of ~700
// instructions, most waiting on a shuffle, a shared-memory load or the
// previous instruction), against ~5.6 us for one thread per sample.
//
// Tensor cores are not used: the kernel follows the float32 spec to atol
// 1e-5 + rtol 1e-5; TF32 keeps 10 mantissa bits and its error compounds
// over 16-64 sequential dims, and 3xTF32 would buy nothing at d = 16 (~0.4K
// multiply-adds a sample-step), where the chain and not the FMA rate bounds
// the kernel.
//
// Numerics follow the JAX spec exactly where intuition differs: softplus is
// max(x,0)+log1p(exp(-|x|)); endpoint knots are pinned to +-B; the bin is
// searched on the height knots with >=; the discriminant is clamped at 0
// and theta clipped to [0,1] (NaN-propagating, as jnp.clip); Euclidean
// dims pass through unchanged outside [-B, B]; circular dims wrap with the
// floored modulo (fmodf then a sign fix-up, bit-identical to jnp.mod and
// torch.remainder) and take the wrap-around derivative P[3K-1] at the
// front.  No fast-math: expf, tanhf, log1pf, the divisions and sqrtf are
// the IEEE versions.  What differs by rounding only: the sums run as trees,
// layer 1 adds the newest column last, and the softmax multiplies by the
// reciprocal of its sum (within an ulp of dividing by it).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;                   // lanes per sample
constexpr int kSamples = 8;                  // samples per block
constexpr int kThreads = kGroup * kSamples;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;           // dynamic shared memory a block may use
constexpr int kRingSlots = 3;                // slots when the whole flow does not fit
constexpr float kMinBinWidth = 1e-3f;
constexpr float kMinBinHeight = 1e-3f;
constexpr float kMinDerivative = 1e-3f;
constexpr float kPi = 3.14159265358979323846f;

// One instantiation's shapes and its shared-memory layout:
// [full[S] | empty[S] | bias barrier] [b1 | b2 | b3] [slot 0 | ... | slot S-1]
template <int D_, int H_, int K_>
struct Shape {
  static constexpr int D = D_, H = H_, K = K_, P = 3 * K_;
  static constexpr int kW1 = H * D, kW2 = H * H, kW3 = P * H;
  static constexpr int kSlot = kW1 + kW2 + kW3;   // floats in one dim's slice
  static constexpr int kBias = 2 * D * H + D * P;
  static constexpr int barrier_bytes(int s) { return ((2 * s + 1) * 8 + 15) / 16 * 16; }
  static constexpr int bytes(int s) {
    return barrier_bytes(s) + 4 * (kBias + s * kSlot);
  }
  static constexpr int S = bytes(D) <= kSmemLimit ? D : kRingSlots;
  static constexpr int kBarrierBytes = barrier_bytes(S);
  static constexpr int kBytes = bytes(S);
  static_assert(D % kGroup == 0 && H % 4 == 0 && K < kGroup, "unsupported shape");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// global -> shared bulk copy (16-byte aligned, a multiple of 16 bytes),
// completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float clip01(float t) {
  // NaN passes through, as jnp.clip does
  return t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
}

// w (H floats, 16-byte aligned, in shared memory) . h, in two accumulators
template <int H>
__device__ __forceinline__ float dot(const float* w, const float (&h)[H]) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int j = 0; j < H / 4; ++j) {
    const float4 q = w4[j];
    a0 = fmaf(q.x, h[4 * j], a0);
    a1 = fmaf(q.y, h[4 * j + 1], a1);
    a0 = fmaf(q.z, h[4 * j + 2], a0);
    a1 = fmaf(q.w, h[4 * j + 3], a1);
  }
  return a0 + a1;
}

// Reduce-scatter over the group: on entry v[0, LEN) are this lane's
// partial sums of LEN hidden units; each xor stage M halves them, the lanes
// with bit M set keeping the upper half.  On exit v[0, UPL) hold the full
// sums of the lane's own units (a template, so that every loop has a
// constant trip count and v stays in registers).
template <int LEN, int M, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  if constexpr (M > 0) {
    if constexpr (LEN > 1) {
      constexpr int HL = LEN / 2;
      const bool upper = lane & M;
#pragma unroll
      for (int q = 0; q < HL; ++q) {
        const float lo = v[q], hi = v[q + HL];
        v[q] = (upper ? hi : lo) +
               __shfl_xor_sync(kFull, upper ? lo : hi, M, kGroup);
      }
      reduce_scatter<HL, M / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], M, kGroup);
      reduce_scatter<1, M / 2>(v, lane);
    }
  }
}

// This lane's share of layer 1 of dim `nx` over the columns known now
// (those < nx; an inverted column not reached yet is 0): its columns into
// every unit, then a reduce-scatter of the H sums to their owner lanes.
template <int D, int H, int C, int UPL>
__device__ __forceinline__ void layer1_partial(const float* w1,
                                               const float (&xr)[C], int lane,
                                               int nx, float (&pre)[UPL]) {
  float xm[C];
#pragma unroll
  for (int c = 0; c < C; ++c) xm[c] = lane + kGroup * c < nx ? xr[c] : 0.f;
  float v[H];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c == 0 || kGroup * c < nx)   // later columns are all masked
        acc = fmaf(w1[k * D + lane + kGroup * c], xm[c], acc);
    v[k] = acc;
  }
  reduce_scatter<H, kGroup / 2>(v, lane);
#pragma unroll
  for (int q = 0; q < UPL; ++q) pre[q] = v[q];
}

// The value `own[j % UPL]` of the lane owning hidden unit j, for every j:
// unit j lives in lane j * 16 / H (and its neighbour when H = 8).
template <int H, int UPL>
__device__ __forceinline__ void gather_units(const float (&own)[UPL],
                                             float (&all)[H]) {
#pragma unroll
  for (int j = 0; j < H; ++j)
    all[j] = __shfl_sync(kFull, own[j % UPL], (j * kGroup) / H, kGroup);
}

// max and sum of a register array, as a balanced tree
template <int N>
__device__ __forceinline__ float tree_max(const float* a) {
  if constexpr (N == 1) return a[0];
  else return fmaxf(tree_max<N / 2>(a), tree_max<N - N / 2>(a + N / 2));
}
template <int N>
__device__ __forceinline__ float tree_sum(const float* a) {
  if constexpr (N == 1) return a[0];
  else return tree_sum<N / 2>(a) + tree_sum<N - N / 2>(a + N / 2);
}

// All K+1 knots of the two softmax-with-floor partitions of [-bound,
// bound], widths from rw and heights from rh (bin k's in lane k), in every
// lane: the max over a round of shuffles, lane k's exponential, the sum
// over a second round, then the floored sizes and their running sums, end
// knots pinned.  The partitions run in lockstep; the heights, which the bin
// search waits for, divide first.
template <int K>
__device__ __forceinline__ void knots(float rw, float rh, float bound,
                                      float (&cw)[K + 1], float (&ch)[K + 1]) {
  float ew[K], eh[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ew[k] = __shfl_sync(kFull, rw, k, kGroup);
    eh[k] = __shfl_sync(kFull, rh, k, kGroup);
  }
  const float own_w = expf(rw - tree_max<K>(ew));
  const float own_h = expf(rh - tree_max<K>(eh));
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ew[k] = __shfl_sync(kFull, own_w, k, kGroup);
    eh[k] = __shfl_sync(kFull, own_h, k, kGroup);
  }
  // one division and K products: within an ulp of K divisions, and a
  // fifth faster for the whole kernel
  const float inv_h = 1.f / tree_sum<K>(eh);
  const float inv_w = 1.f / tree_sum<K>(ew);
  constexpr float kScaleW = 1.f - kMinBinWidth * K;
  constexpr float kScaleH = 1.f - kMinBinHeight * K;
  float sw = 0.f, sh = 0.f;
  cw[0] = ch[0] = -bound;
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    sw += kMinBinWidth + kScaleW * (ew[k] * inv_w);
    sh += kMinBinHeight + kScaleH * (eh[k] * inv_h);
    cw[k + 1] = __fadd_rn(__fmul_rn(2.f * bound, sw), -bound);
    ch[k + 1] = __fadd_rn(__fmul_rn(2.f * bound, sh), -bound);
  }
  cw[K] = ch[K] = bound;
}

template <class Sh>
__global__ void __launch_bounds__(kThreads) ar_inverse_kernel(
    const float* __restrict__ z, const float* __restrict__ xp,
    const uint8_t* __restrict__ invert, const uint8_t* __restrict__ circular,
    const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ W3, const float* __restrict__ b3,
    float* __restrict__ out, int n, float tail_bound, float boundary_raw) {
  constexpr int D = Sh::D, H = Sh::H, K = Sh::K, P = Sh::P, S = Sh::S;
  constexpr int C = D / kGroup;                     // x columns per lane
  constexpr int UPL = H > kGroup ? H / kGroup : 1;  // hidden units per lane
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  uint64_t* bias_bar = empty + S;
  float* sb1 = reinterpret_cast<float*>(smem + Sh::kBarrierBytes);
  float* sb2 = sb1 + D * H;
  float* sb3 = sb2 + D * H;
  float* slots = sb3 + D * P;

  const int lane = threadIdx.x & (kGroup - 1);
  const long row = (long)blockIdx.x * kSamples + threadIdx.x / kGroup;
  const bool valid = row < n;   // a group past n runs on zeros and stores nothing

  // the masks as bit sets, column j at bit j
  uint64_t inv = 0, circ = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = lane + kGroup * c;
    const unsigned bi = __ballot_sync(kFull, invert[col] != 0);
    const unsigned bc = __ballot_sync(kFull, circular[col] != 0);
    inv |= (uint64_t)(bi & 0xffffu) << (kGroup * c);
    circ |= (uint64_t)(bc & 0xffffu) << (kGroup * c);
  }

  // thread 0 copies; dim `dim`'s slice goes to slot t % S (t counts
  // inverted dims)
  uint64_t pending = inv;   // inverted dims whose slice is not issued yet
  auto fill = [&](int t, int dim) {
    float* slot = slots + (t % S) * Sh::kSlot;
    uint64_t* bar = &full[t % S];
    mbar_expect_tx(bar, 4 * Sh::kSlot);
    bulk_load(slot, W1 + (size_t)dim * Sh::kW1, 4 * Sh::kW1, bar);
    bulk_load(slot + Sh::kW1, W2 + (size_t)dim * Sh::kW2, 4 * Sh::kW2, bar);
    bulk_load(slot + Sh::kW1 + Sh::kW2, W3 + (size_t)dim * Sh::kW3,
              4 * Sh::kW3, bar);
  };
  if (threadIdx.x == 0) {
    for (int q = 0; q < S; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], kWarps);
    }
    mbar_init(bias_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bias_bar, 4 * Sh::kBias);
    bulk_load(sb1, b1, 4 * D * H, bias_bar);
    bulk_load(sb2, b2, 4 * D * H, bias_bar);
    bulk_load(sb3, b3, 4 * D * P, bias_bar);
    for (int t = 0; t < S && pending; ++t) {
      fill(t, __ffsll((long long)pending) - 1);
      pending &= pending - 1;
    }
  }

  // the sample's row, column lane + 16c in register c: pinned columns hold
  // their prefix values from the start (as in the spec), inverted ones 0
  // until their step writes them
  float xr[C], zr[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = lane + kGroup * c;
    const long e = row * D + col;
    zr[c] = valid ? z[e] : 0.f;
    xr[c] = (valid && !((inv >> col) & 1)) ? xp[e] : 0.f;
  }
  const float bnd_deriv = kMinDerivative + softplus(boundary_raw);
  const int u0 = (lane * H) / kGroup;   // first hidden unit this lane owns
  const int kk = lane < K ? lane : K - 1;
  const int T = __popcll(inv);   // inverted dims
  __syncthreads();   // the barriers are initialised
  mbar_wait(bias_bar, 0);

  // step t inverts dim i; layer 1 of dim i was summed over every known
  // column but the previous step's during that step (pre), so only that
  // column's term is left on the chain
  uint64_t todo = inv;
  int i = T ? __ffsll((long long)todo) - 1 : 0;
  float pre[UPL];
  if (T) {
    mbar_wait(&full[0], 0);
    layer1_partial<D, H>(slots, xr, lane, i, pre);
  }
  int prev = 0;       // the previous step's dim, and its value
  float xprev = 0.f;  // (0 before the first step: no term)
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    todo &= todo - 1;
    const int nx = todo ? __ffsll((long long)todo) - 1 : D;   // next dim
    const int slot = t % S;
    if (t + 1 < T) mbar_wait(&full[(t + 1) % S], ((t + 1) / S) & 1);
    const float* w1 = slots + slot * Sh::kSlot;
    const float* w2 = w1 + Sh::kW1;
    const float* w3 = w2 + Sh::kW2;
    const float* w1_next = t + 1 < T ? slots + ((t + 1) % S) * Sh::kSlot : w1;

    // z of dim i, wrapped or clamped
    const int ci = i / kGroup;
    const bool mine = lane == (i & (kGroup - 1));   // lane holding column i
    const bool is_circ = (circ >> i) & 1;
    const float bound = is_circ ? kPi : tail_bound;
    float zsrc = zr[0];
#pragma unroll
    for (int c = 1; c < C; ++c)
      if (c == ci) zsrc = zr[c];
    const float zi = __shfl_sync(kFull, zsrc, i & (kGroup - 1), kGroup);
    float zin;
    bool inside;
    if (is_circ) {
      const float period = 2.f * bound;
      float r = fmodf(zi + bound, period);
      if (r != 0.f && r < 0.f) r += period;
      zin = r - bound;
      inside = true;
    } else {
      inside = (zi >= -bound) && (zi <= bound);
      zin = fminf(fmaxf(zi, -bound), bound);
    }

    // layer 1: the previous column's term; then the next dim's sum over
    // the columns known now, which no instruction of this step waits for
    float own[UPL], h1[H], h2[H];
#pragma unroll
    for (int q = 0; q < UPL; ++q)
      own[q] = tanhf(fmaf(w1[(u0 + q) * D + prev], xprev, pre[q]) +
                     sb1[i * H + u0 + q]);
    layer1_partial<D, H>(w1_next, xr, lane, nx, pre);
    gather_units<H, UPL>(own, h1);
    // layer 2: each lane its own unit(s)
#pragma unroll
    for (int q = 0; q < UPL; ++q)
      own[q] = tanhf(dot<H>(w2 + (u0 + q) * H, h1) + sb2[i * H + u0 + q]);
    gather_units<H, UPL>(own, h2);
    // layer 3: lane k the width, height and derivative of bin k
    const float pw = dot<H>(w3 + kk * H, h2) + sb3[i * P + kk];
    const float ph = dot<H>(w3 + (K + kk) * H, h2) + sb3[i * P + K + kk];
    const float pd = dot<H>(w3 + (2 * K + kk) * H, h2) + sb3[i * P + 2 * K + kk];

    // the spline inverse of z[:, i]: lane k holds bin k's derivatives,
    // every lane all the knots, the bin and its root
    const float dr = kMinDerivative + softplus(pd);
    const float d_up_k = (lane >= K - 1 && !is_circ) ? bnd_deriv : dr;
    const float wrap = __shfl_sync(kFull, dr, K - 1, kGroup);   // P[3K-1]'s
    const float d_below = __shfl_up_sync(kFull, d_up_k, 1, kGroup);
    const float d_lo_k = lane == 0 ? (is_circ ? wrap : bnd_deriv) : d_below;
    float cw[K + 1], ch[K + 1];
    knots<K>(pw, ph, bound, cw, ch);

    // bin on the HEIGHT knots (inverse direction): #{k in 1..K-1: zin >= cumh[k]}
    int idx = 0;
#pragma unroll
    for (int k = 1; k < K; ++k) idx += zin >= ch[k] ? 1 : 0;
    float cw_lo = cw[0], cw_up = cw[1], ch_lo = ch[0], ch_up = ch[1];
#pragma unroll
    for (int k = 1; k < K; ++k)
      if (idx == k) {
        cw_lo = cw[k];
        cw_up = cw[k + 1];
        ch_lo = ch[k];
        ch_up = ch[k + 1];
      }
    const float d_lo = __shfl_sync(kFull, d_lo_k, idx, kGroup);
    const float d_up = __shfl_sync(kFull, d_up_k, idx, kGroup);

    const float in_w = cw_up - cw_lo, in_h = ch_up - ch_lo;
    const float delta = in_h / in_w;
    const float s = d_lo + d_up - 2.f * delta;
    const float y_rel = zin - ch_lo;
    const float a = in_h * (delta - d_lo) + y_rel * s;
    const float b = in_h * d_lo - y_rel * s;
    const float cq = -delta * y_rel;
    const float disc = fmaxf(b * b - 4.f * a * cq, 0.f);
    const float theta = clip01((2.f * cq) / (-b - sqrtf(disc)));
    const float root = theta * in_w + cw_lo;
    const float xi = inside ? root : zi;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c == ci && mine) xr[c] = xi;
    prev = i;
    xprev = xi;
    i = nx;

    if constexpr (S < D) {
      // release the slot; thread 0 refills it with the next inverted dim
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[slot]);
      if (threadIdx.x == 0 && pending) {
        mbar_wait(&empty[slot], (t / S) & 1);
        fill(t + S, __ffsll((long long)pending) - 1);
        pending &= pending - 1;
      }
    }
  }

  if (valid) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[row * D + lane + kGroup * c] = xr[c];
  }
}

// Calls f(Shape<d, h, K>{}) for the instantiation of (d, h, K).
template <class F>
int dispatch(int d, int h, int K, F&& f) {
#define NFISAM_AR_CASE(D_, H_, K_) \
  if (d == D_ && h == H_ && K == K_) return f(Shape<D_, H_, K_>{});
#define NFISAM_AR_CASE_K(D_, H_) \
  NFISAM_AR_CASE(D_, H_, 5)      \
  NFISAM_AR_CASE(D_, H_, 6)      \
  NFISAM_AR_CASE(D_, H_, 7)      \
  NFISAM_AR_CASE(D_, H_, 8)      \
  NFISAM_AR_CASE(D_, H_, 9)      \
  NFISAM_AR_CASE(D_, H_, 10)     \
  NFISAM_AR_CASE(D_, H_, 12)
  NFISAM_AR_CASE_K(16, 8)
  NFISAM_AR_CASE_K(32, 16)
  NFISAM_AR_CASE_K(64, 32)
#undef NFISAM_AR_CASE_K
#undef NFISAM_AR_CASE
  return (int)cudaErrorInvalidValue;
}

template <class Sh>
int launch(const float* z, const float* xp, const uint8_t* invert,
           const uint8_t* circular, const float* W1, const float* b1,
           const float* W2, const float* b2, const float* W3,
           const float* b3, float* out, int n, float tail_bound,
           float boundary_raw, cudaStream_t stream) {
  // dynamic shared memory above 48 KB needs it; the attribute is the
  // current device's, so it is set on every launch (it costs ~a microsecond)
  const cudaError_t attr = cudaFuncSetAttribute(
      ar_inverse_kernel<Sh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((n + kSamples - 1) / kSamples));
  ar_inverse_kernel<Sh><<<grid, kThreads, Sh::kBytes, stream>>>(
      z, xp, invert, circular, W1, b1, W2, b2, W3, b3, out, n, tail_bound,
      boundary_raw);
  return (int)cudaGetLastError();
}

template <class Sh>
int info(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, ar_inverse_kernel<Sh>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = Sh::kBytes;
  out[3] = kThreads;
  out[4] = kSamples;
  out[5] = Sh::S;
  return 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All arrays are contiguous
// float32 (uint8 for the two masks) on the device, the six weight arrays
// 16-byte aligned (the bulk copies need it); returns the launch's
// cudaError_t (0 on success, cudaErrorInvalidValue for a shape that has no
// instantiation).
extern "C" int nfisam_ar_inverse_f32(
    const float* z, const float* xp, const uint8_t* invert,
    const uint8_t* circular, const float* W1, const float* b1,
    const float* W2, const float* b2, const float* W3, const float* b3,
    float* out, int n, int d, int h, int K, float tail_bound,
    float boundary_raw, void* stream) {
  if (n <= 0) return 0;
  return dispatch(d, h, K, [&](auto shape) {
    return launch<decltype(shape)>(z, xp, invert, circular, W1, b1, W2, b2,
                                   W3, b3, out, n, tail_bound, boundary_raw,
                                   (cudaStream_t)stream);
  });
}

// Build facts of the (d, h, K) instantiation: info[0] registers a thread,
// info[1] local memory a thread in bytes (spills), info[2] dynamic shared
// memory a block in bytes, info[3] threads a block, info[4] samples a
// block, info[5] weight ring slots.  Returns a cudaError_t.
extern "C" int nfisam_ar_inverse_info(int d, int h, int K, int* info_out) {
  return dispatch(d, h, K,
                  [&](auto shape) { return info<decltype(shape)>(info_out); });
}
