// Masked autoregressive inverse of one NSF-AR flow at any (d, h, K), for
// Hopper (sm_90a): the shapes `ar_inverse.cu` has no instantiation for.
//
// Replaces the Pallas TPU kernel `flow_inverse_masked_pallas`
// (nfisam_tpu/flows/ar_inverse_pallas.py: body `_ar_inverse_kernel`,
// spline `_rqs_inverse_row`) where the port's specialised kernel does not
// reach: the Pallas kernel takes any static (d, h, K), so the JAX
// package's options (`--hidden`, `scale_hidden_with_dim=False`,
// `pad_dim_multiple`, any `num_knots`) and every clique above 128
// augmented dims (the 256 bucket: d=256, h=128) reach shapes such as
// (12, 8, 9), (16, 16, 9), (5, 8, 8) or (256, 128, 9).  It computes what
// `ar_inverse.cu` computes, for each inverted dim i in order:
//   h1 = tanh(W1[i][:, :i] x[:i] + b1[i]),  h2 = tanh(W2[i] h1 + b2[i]),
//   P  = W3[i] h2 + b3[i]                     (3K spline parameters)
// then the rational-quadratic spline inverse of z[:, i] under P; a pinned
// column keeps its prefix value.  No log-det.
//
// What bounds it on an H100: as for the specialised kernel, neither bytes
// nor FLOPs (at (16, 16, 9), n = 1000: ~0.26 MB and ~28 MFLOP, 0.0004 ms
// of either) but each sample's chain of dependent steps: the dims in
// order, and in each three layers and the spline.  One block alone takes
// as long as 125 (n = 8 and n = 1000 time the same), so a step's latency
// is the kernel's time.  d, h and K are run-time values, so nothing can be
// unrolled over them; the design spreads every part of a step over the
// lanes, so that a step's chain is a few shuffle rounds, not O(h) or
// O(K) serial operations:
//
// - A group of G lanes a sample (G = 8, 16 or 32, the smallest power of
//   two >= max(h, K), at least 8), 8 samples a block where their scratch
//   fits (else 4, 2, 1, with G raised so that a block is whole warps).
//   Hidden unit u lives in lane u mod G, spline bin k in lane k mod G, x
//   column j in lane j mod G; h or K above G loop over chunks of G.
//   Nine instantiations: G x {weights staged with d, h, K <= G ("one":
//   every loop a single iteration, so a step is straight-line code the
//   compiler schedules as one block), staged, read through L2}.
// - Layers 1 and 2 over the INPUTS: lane l sums its input columns (l,
//   l + G, ...) into G accumulators, one an output row of a chunk of G
//   rows, and a xor-shuffle reduce-scatter (log2 G rounds) leaves row
//   m*G + l's sum in lane l, where the next layer's input sits; the
//   weights are read by consecutive lanes at consecutive addresses (no
//   bank conflict, coalesced through L2) and the inputs never leave their
//   lane (h > G: the lane's own entries of a per-sample vector).  Layer 2
//   writes h2 to a per-sample vector; one __syncwarp.
// - Layer 3 over the OUTPUTS where the weights are staged: lane k reads
//   h2 from the vector and sums bin k's width, height and derivative rows
//   (two accumulators each), walking the columns from its own rotation
//   (by lane, odd in the row stride) so that the group's rows fall in
//   distinct banks; the three parameters land in the spline's registers,
//   with no reduce-scatter.  Through L2 it stays over the inputs (a warp
//   load is one row's line) and reaches lane k by a per-sample vector.
// - Layer 1 off the chain: while dim i's step runs, the group sums the
//   next inverted dim's layer 1 over every column known (those < next,
//   column i still 0); the next step then adds only W1[next][:, i] x[i].
// - The spline across the lanes: the two max and the two sums by
//   butterflies, the knots by an inclusive shuffle scan (a carried sum
//   across chunks when K > G), the bin by one __ballot_sync over
//   zin >= knot and a __popc, the bin's two knots and derivatives by six
//   shuffles from lanes idx - 1 and idx (K > G: from the per-sample
//   vector).  Every lane then computes the same root; the lane owning
//   column i stores it.
// - The weights in shared memory when they fit: per dim a slice
//   [W1[i] | W2[i] | W3[i] | b1[i] | b2[i] | b3[i]], each array copied by
//   one TMA bulk copy (cp.async.bulk, one mbarrier a slot) of the 16-byte
//   granules it touches, so any 4-byte-aligned run-time size and offset
//   copies (the few bytes before and after an array in its first and last
//   granule land in padding and are never read; a granule never crosses a
//   page).  Three cases (`info` slots): the whole flow (one slot a dim,
//   loaded once, overlapped with the row loads; each step waits only for
//   its own slice), a ring of 2-4 slots refilled behind the compute
//   (thread 0 refills a slot once every warp has released it), or, where
//   two slices do not fit (d=256, h=128: ~207 KB a slice), the weights
//   read through L1/L2 with __ldg.  The list of inverted dims is built
//   once a block, by ballots.
// - 0 B of local memory: no register array is indexed at run time (the
//   accumulators are indexed only in loops unrolled over G); run-time
//   length vectors live in shared memory; __launch_bounds__(256, 1) lets
//   ptxas use up to 255 registers (G=32 through L2 takes ~235).
//
// What is left (PERF.md): a step at (16, 16, 9) is ~1,440 instructions,
// about twice the specialised kernel's, most of them address and index
// arithmetic that run-time shapes force; the spline's twelve dependent
// shuffle rounds are the longest part of the chain.
//
// Tensor cores are not used, for the reason `ar_inverse.cu` gives (TF32
// error compounds over the sequential dims).
//
// Numerics are the specialised kernel's and the plain version's: no fast
// math (expf, tanhf, log1pf, the divisions and sqrtf are IEEE);
// softplus = max(x,0) + log1p(exp(-|x|)); the softmax divides by its sum;
// the knots are 2B * cumsum + (-B) without contraction, endpoint knots
// pinned to +-B; the bin is searched on the height knots with >=; the
// discriminant is clamped at 0 and theta clipped to [0, 1] passing NaN;
// Euclidean dims pass through outside [-B, B]; circular dims wrap with the
// floored modulo and take the wrap-around derivative P[3K-1] at both
// ends.  What differs by rounding only: layers 1 and 2 sum G per-lane
// partial sums (lane l's over its columns in order) as a tree; layer 3
// sums two accumulators over a rotation of the columns (staged), or as
// layers 1 and 2 (through L2); the softmax sums are butterflies; the
// knots' running sums are a Kogge-Stone scan (plus a carry per chunk of G
// bins).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;           // dynamic shared memory a block may use
constexpr int kMaxThreads = 256;
constexpr int kRingSlots = 4;                // slots when the whole flow does not fit
constexpr float kMinBinWidth = 1e-3f;
constexpr float kMinBinHeight = 1e-3f;
constexpr float kMinDerivative = 1e-3f;
constexpr float kPi = 3.14159265358979323846f;
constexpr unsigned kNegInfBits = 0xff800000u;

// ---------------------------------------------------------------------------
// The launch plan (reported by `nfisam_ar_inverse_generic_info`)
// ---------------------------------------------------------------------------
struct Plan {
  int G;         // lanes a sample
  int samples;   // samples a block
  int slots;     // weight slots: d (the whole flow), 2..kRingSlots (a ring), 0 (L2)
  int stride;    // floats of one sample's scratch
  int slice;     // floats of one dim's staged slice
  int bytes;     // dynamic shared memory a block
  bool one;      // d, h and K at most G: one chunk of everything
};

__host__ __device__ inline long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// floats that hold n floats bulk-copied from any 4-byte-aligned address:
// the 16-byte granules they touch
__host__ __device__ inline long long region(long long n) {
  return round_up(n + 3, 4);
}

// Shared memory: [full[S] | empty[S]] [inverted dims (d) | T] [sample 0 |
// ... | sample samples-1] [slot 0 | ... | slot S-1].  A sample's scratch:
// x (d) | h2 (h) | pre, h1 (h each, when h > G) | P (3K); its stride is G
// mod 32 above a multiple of 32, so the groups of a warp hit distinct
// banks.
__host__ __device__ inline long long sample_floats(int d, int h, int K,
                                                   int G) {
  return round_up((long long)d + (h > G ? 3LL * h : h) + 3LL * K, 32) +
         G % 32;
}

__host__ __device__ inline long long slice_floats(int d, int h, int K) {
  return region((long long)h * d) + region((long long)h * h) +
         region(3LL * K * h) + 2 * region(h) + region(3LL * K);
}

inline long long plan_bytes(int d, int samples, long long stride, int slots,
                            long long slice) {
  return round_up(16LL * slots, 16) + round_up(4LL * (d + 1), 16) +
         4LL * samples * stride + 4LL * slots * slice;
}

// The plan of (d, h, K): false for a shape out of range (d >= 1, h >= 1,
// K >= 2, one sample's scratch in a block).  Every shape whose four
// samples of the first port's scratch fit takes a plan.
bool make_plan(int d, int h, int K, Plan* p) {
  if (d < 1 || h < 1 || K < 2) return false;
  const int m = h > K ? h : K;
  const int G0 = m <= 8 ? 8 : (m <= 16 ? 16 : 32);
  const long long slice = slice_floats(d, h, K);
  for (int samples = 8; samples >= 1; samples /= 2) {
    const int G = G0 * samples >= 32 ? G0 : 32 / samples;   // whole warps
    const long long stride = sample_floats(d, h, K, G);
    if (plan_bytes(d, samples, stride, 0, slice) > kSmemLimit) continue;
    int slots = 0;
    if (plan_bytes(d, samples, stride, d, slice) <= kSmemLimit) {
      slots = d;
    } else {
      for (int s = d - 1 < kRingSlots ? d - 1 : kRingSlots; s >= 2; --s)
        if (plan_bytes(d, samples, stride, s, slice) <= kSmemLimit) {
          slots = s;
          break;
        }
    }
    p->G = G;
    p->samples = samples;
    p->slots = slots;
    p->stride = (int)stride;
    p->slice = (int)slice;
    p->bytes = (int)plan_bytes(d, samples, stride, slots, slice);
    p->one = slots > 0 && d <= G && h <= G && K <= G;
    return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers and bulk copies
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
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
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float clip01(float t) {
  // NaN passes through, as jnp.clip and torch.clamp do
  return t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
}

// a weight: from shared memory when staged, else through the read-only path
template <bool STAGED>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (STAGED) return *p;
  else return __ldg(p);
}

// floats between a 16-byte granule's start and the array at p
__device__ __forceinline__ int granule_shift(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// bytes of the 16-byte granules that n floats at p touch
__device__ __forceinline__ unsigned granule_bytes(const float* p, size_t n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return (unsigned)(((a + 4 * n + 15) & ~(uintptr_t)15) - (a & ~(uintptr_t)15));
}

// bulk-copies the granules n floats at src touch to dst (16-byte aligned)
__device__ __forceinline__ void copy_granules(float* dst, const float* src,
                                              size_t n, uint64_t* bar) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src) & ~(uintptr_t)15;
  bulk_load(dst, reinterpret_cast<const void*>(lo), granule_bytes(src, n),
            bar);
}

// Reduce-scatter over a group of G lanes: on entry v[0, LEN) are this
// lane's partial sums of LEN rows; each xor stage M halves them, the
// lanes with bit M set keeping the upper half.  On exit v[0] holds row
// `lane`'s full sum (LEN = G).
template <int G, int LEN, int M>
__device__ __forceinline__ void reduce_scatter(float (&v)[G], int lane) {
  if constexpr (M > 0) {
    constexpr int HL = LEN / 2;
    const bool upper = lane & M;
#pragma unroll
    for (int q = 0; q < HL; ++q) {
      const float lo = v[q], hi = v[q + HL];
      v[q] = (upper ? hi : lo) + __shfl_xor_sync(kFull, upper ? lo : hi, M, G);
    }
    reduce_scatter<G, HL, M / 2>(v, lane);
  }
}

// One layer over the group, lanes over the inputs: rows `rows` of w (row
// stride `stride`) times the input vector of `cols` entries, whose entry j
// is in(c, j) in lane j mod G (chunk c = j / G).  Calls out(m, row, sum)
// in lane l for row m*G + l of every chunk m (row >= rows in lanes past
// the last row; their sum is a clamped row's).  ONE: rows and cols are at
// most G, so every loop is a single iteration the compiler sees through.
template <int G, bool STAGED, bool ONE, class In, class Out>
__device__ __forceinline__ void dense(const float* w, int stride, int rows,
                                      int cols, int lane, In in, Out out) {
  const int nr = ONE ? 1 : (rows + G - 1) / G;
  const int nc = ONE ? 1 : (cols + G - 1) / G;
  for (int m = 0; m < nr; ++m) {
    float v[G];
#pragma unroll
    for (int u = 0; u < G; ++u) v[u] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int j = c * G + lane;
      const bool live = j < cols;
      const float a = live ? in(c, j) : 0.f;
      const float* wc = w + (live ? j : 0);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int r = m * G + u < rows ? m * G + u : rows - 1;
        v[u] = fmaf(ld<STAGED>(wc + r * stride), a, v[u]);
      }
    }
    reduce_scatter<G, G, G / 2>(v, lane);
    out(m, m * G + lane, v[0]);
  }
}

// Layer 3 over the outputs: bin k's width, height and derivative
// parameters, the dot products of W3 rows k, K + k and 2K + k with h2
// (every lane reads the per-sample vector), each in two accumulators.
// Each lane walks the columns from its own `start` (a rotation by lane,
// odd in the row stride), so that the group's rows fall in distinct banks.
template <int G, bool STAGED, bool ONE>
__device__ __forceinline__ void spline_params(const float* w3, const float* b3,
                                              const float* h2, int h, int K,
                                              int k, int start, float& pw,
                                              float& ph, float& pd) {
  const int kk = k < K ? k : K - 1;
  const float* rw = w3 + kk * h;
  const float* rh = w3 + (K + kk) * h;
  const float* rd = w3 + (2 * K + kk) * h;
  float w0 = 0.f, w1 = 0.f, h0 = 0.f, h1 = 0.f, d0 = 0.f, d1 = 0.f;
  int j = start;
  auto term = [&](float& aw, float& ah, float& ad) {
    const float x = h2[j];
    aw = fmaf(ld<STAGED>(rw + j), x, aw);
    ah = fmaf(ld<STAGED>(rh + j), x, ah);
    ad = fmaf(ld<STAGED>(rd + j), x, ad);
    j = j + 1 == h ? 0 : j + 1;
  };
  if constexpr (ONE) {
#pragma unroll
    for (int s = 0; s < G; s += 2) {
      if (s < h) term(w0, h0, d0);
      if (s + 1 < h) term(w1, h1, d1);
    }
  } else {
    int s = 0;
    for (; s + 1 < h; s += 2) {
      term(w0, h0, d0);
      term(w1, h1, d1);
    }
    if (s < h) term(w0, h0, d0);
  }
  pw = (w0 + w1) + ld<STAGED>(b3 + kk);
  ph = (h0 + h1) + ld<STAGED>(b3 + K + kk);
  pd = (d0 + d1) + ld<STAGED>(b3 + 2 * K + kk);
}

// max, sum and inclusive prefix sum over the group, two values in lockstep
template <int G>
__device__ __forceinline__ void group_max2(float& a, float& b) {
#pragma unroll
  for (int m = G / 2; m > 0; m /= 2) {
    a = fmaxf(a, __shfl_xor_sync(kFull, a, m, G));
    b = fmaxf(b, __shfl_xor_sync(kFull, b, m, G));
  }
}

template <int G>
__device__ __forceinline__ void group_sum2(float& a, float& b) {
#pragma unroll
  for (int m = G / 2; m > 0; m /= 2) {
    a += __shfl_xor_sync(kFull, a, m, G);
    b += __shfl_xor_sync(kFull, b, m, G);
  }
}

template <int G>
__device__ __forceinline__ void group_scan2(float& a, float& b, int lane) {
#pragma unroll
  for (int off = 1; off < G; off *= 2) {
    const float ta = __shfl_up_sync(kFull, a, off, G);
    const float tb = __shfl_up_sync(kFull, b, off, G);
    if (lane >= off) {
      a += ta;
      b += tb;
    }
  }
}

// the count of lanes of this lane's group whose pred holds
template <int G>
__device__ __forceinline__ int group_count(bool pred) {
  const unsigned bits = __ballot_sync(kFull, pred);
  if constexpr (G == 32) return __popc(bits);
  else {
    const int base = (threadIdx.x & 31) & ~(G - 1);
    return __popc((bits >> base) & ((1u << G) - 1));
  }
}

// the knot of a floored-softmax partition of [-bound, bound] after a bin
// whose running sum of floored sizes is `cum`
__device__ __forceinline__ float knot(float cum, float bound) {
  return __fadd_rn(__fmul_rn(2.f * bound, cum), -bound);
}

__device__ __forceinline__ float floored(float e, float sum, float min_size,
                                         float scale) {
  return __fadd_rn(min_size, __fmul_rn(scale, e / sum));
}

// one dim's weights: a slot in shared memory, or the global arrays
struct Slice {
  const float *w1, *w2, *w3, *b1, *b2, *b3;
};

// G lanes a sample; STAGED: the weights in shared memory (else through
// L2); ONE: d, h and K are at most G (one chunk of everything)
template <int G, bool STAGED, bool ONE>
__global__ void __launch_bounds__(kMaxThreads, 1) ar_inverse_generic_kernel(
    const float* __restrict__ z, const float* __restrict__ xp,
    const uint8_t* __restrict__ invert, const uint8_t* __restrict__ circular,
    const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ W3, const float* __restrict__ b3,
    float* __restrict__ out, int n, int d, int h, int K, float tail_bound,
    float boundary_raw, int samples, int S, int stride, int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P3 = 3 * K;
  // offsets of a dim's arrays in its slot, and in the global arrays
  const int o_w2 = (int)region((long long)h * d);
  const int o_w3 = o_w2 + (int)region((long long)h * h);
  const int o_b1 = o_w3 + (int)region((long long)P3 * h);
  const int o_b2 = o_b1 + (int)region(h);
  const int o_b3 = o_b2 + (int)region(h);
  const size_t n_w1 = (size_t)h * d, n_w2 = (size_t)h * h,
               n_w3 = (size_t)P3 * h;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  int* dims = reinterpret_cast<int*>(smem + round_up(16LL * S, 16));
  float* scratch = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(dims) + round_up(4LL * (d + 1), 16));
  float* slots = scratch + (size_t)samples * stride;

  const int lane = threadIdx.x & (G - 1);
  const int group = threadIdx.x / G;
  const long row = (long)blockIdx.x * samples + group;
  const bool valid = row < n;   // a group past n runs on zeros, stores nothing
  const int NH = ONE ? 1 : (h + G - 1) / G;
  const int NK = ONE ? 1 : (K + G - 1) / G;
  float* xs = scratch + (size_t)group * stride;   // the sample's x row
  float* h2_s = xs + d;                           // h2, read by every lane
  float* pre_s = h2_s + h;                        // h > G: chunks >= 1
  float* h1_s = pre_s + h;
  float* P = h2_s + (NH > 1 ? 3 * h : h);         // 3K parameters

  // thread 0 copies dim `dim`'s slice to slot `q`
  auto fill = [&](int q, int dim) {
    float* slot = slots + (size_t)q * slice;
    uint64_t* bar = &full[q];
    const float* g1 = W1 + dim * n_w1;
    const float* g2 = W2 + dim * n_w2;
    const float* g3 = W3 + dim * n_w3;
    const float* gb1 = b1 + (size_t)dim * h;
    const float* gb2 = b2 + (size_t)dim * h;
    const float* gb3 = b3 + (size_t)dim * P3;
    mbar_expect_tx(bar, granule_bytes(g1, n_w1) + granule_bytes(g2, n_w2) +
                            granule_bytes(g3, n_w3) + granule_bytes(gb1, h) +
                            granule_bytes(gb2, h) + granule_bytes(gb3, P3));
    copy_granules(slot, g1, n_w1, bar);
    copy_granules(slot + o_w2, g2, n_w2, bar);
    copy_granules(slot + o_w3, g3, n_w3, bar);
    copy_granules(slot + o_b1, gb1, h, bar);
    copy_granules(slot + o_b2, gb2, h, bar);
    copy_granules(slot + o_b3, gb3, P3, bar);
  };
  // dim `dim`'s weights, staged in slot q or in global memory
  auto view = [&](int q, int dim) {
    Slice v;
    const float* g1 = W1 + dim * n_w1;
    const float* g2 = W2 + dim * n_w2;
    const float* g3 = W3 + dim * n_w3;
    const float* gb1 = b1 + (size_t)dim * h;
    const float* gb2 = b2 + (size_t)dim * h;
    const float* gb3 = b3 + (size_t)dim * P3;
    if constexpr (STAGED) {
      const float* slot = slots + (size_t)q * slice;
      v.w1 = slot + granule_shift(g1);
      v.w2 = slot + o_w2 + granule_shift(g2);
      v.w3 = slot + o_w3 + granule_shift(g3);
      v.b1 = slot + o_b1 + granule_shift(gb1);
      v.b2 = slot + o_b2 + granule_shift(gb2);
      v.b3 = slot + o_b3 + granule_shift(gb3);
    } else {
      v = Slice{g1, g2, g3, gb1, gb2, gb3};
    }
    return v;
  };

  // warp 0: the inverted dims in order (dims[d] = their count T); thread 0
  // then initialises the barriers and issues the first S slices
  if (threadIdx.x < 32) {
    int count = 0;
    for (int base = 0; base < d; base += 32) {
      const int j = base + (int)threadIdx.x;
      const bool inv = j < d && invert[j] != 0;
      const unsigned bits = __ballot_sync(kFull, inv);
      if (inv) dims[count + __popc(bits & ((1u << threadIdx.x) - 1))] = j;
      count += __popc(bits);
    }
    if (threadIdx.x == 0) dims[d] = count;
    __syncwarp();
    if constexpr (STAGED) {
      if (threadIdx.x == 0) {
        const int warps = (int)(blockDim.x / 32);
        for (int q = 0; q < S; ++q) {
          mbar_init(&full[q], 1);
          mbar_init(&empty[q], warps);
        }
        mbar_init_fence();
        for (int t = 0; t < S && t < count; ++t) fill(t, dims[t]);
      }
    }
  }

  // the sample's row, column j in lane j mod G: pinned columns hold their
  // prefix values from the start (only columns < i reach dim i), inverted
  // ones 0 until their step writes them
  for (int j = lane; j < d; j += G)
    xs[j] = (valid && !invert[j]) ? xp[row * d + j] : 0.f;
  const float bnd_deriv = kMinDerivative + softplus(boundary_raw);
  // 1 - min_size * K in double, then rounded, as the plain version's
  // Python scalar is
  const float scale = (float)(1.0 - 1e-3 * K);
  // this lane's first column of layer 3's rows: a rotation by lane, odd in
  // the row stride h
  const int start = ((h & 1 ? 2 : 1) * lane) % h;
  __syncthreads();   // the dims and the barriers

  const int T = dims[d];
  int i = T ? dims[0] : 0;
  // layer 1 of dim i over the columns known (< i): pre (chunk 0 in a
  // register, chunks >= 1 in pre_s)
  float pre0 = 0.f;
  auto partial = [&](const float* w1, int L) {
    dense<G, STAGED, ONE>(
        w1, d, h, L, lane, [&](int, int j) { return xs[j]; },
        [&](int m, int u, float v) {
          if (m == 0) pre0 = v;
          else if (u < h) pre_s[u] = v;
        });
  };
  // slot q of step t holds dim i; its mbarrier phase is `phase`
  int q = 0;
  unsigned phase = 0;
  Slice cur = view(0, i);
  float zi_next = 0.f;
  bool circ_next = false;
  if (T) {
    if constexpr (STAGED) mbar_wait(&full[0], 0);
    partial(cur.w1, i);
    zi_next = valid ? z[row * d + i] : 0.f;
    circ_next = circular[i] != 0;
  }
  int prev = 0;       // the previous step's dim, and its value
  float xprev = 0.f;  // (0 before the first step: no term)
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    __syncwarp();   // the previous step's reads of h2 and P are done
    const int nx = t + 1 < T ? dims[t + 1] : d;   // next dim (d after the last)
    const int q_next = q + 1 == S ? 0 : q + 1;
    const unsigned phase_next = q + 1 == S ? phase ^ 1u : phase;
    if constexpr (STAGED) {
      if (t + 1 < T) mbar_wait(&full[q_next], phase_next);
    }
    const Slice nxt = t + 1 < T ? view(q_next, nx) : cur;
    const float zi = zi_next;
    const bool is_circ = circ_next;
    {   // the next step's z and flag, a step early (i's after the last)
      const int nz = nx < d ? nx : i;
      zi_next = valid ? z[row * d + nz] : 0.f;
      circ_next = circular[nz] != 0;
    }
    const float bound = is_circ ? kPi : tail_bound;
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

    // layer 1: the previous column's term on the partial sum, unit u in
    // lane u mod G
    float h1r = 0.f;
    for (int m = 0; m < NH; ++m) {
      const int u = m * G + lane;
      if (u < h) {
        const float pu = m == 0 ? pre0 : pre_s[u];
        const float a = tanhf(
            fmaf(ld<STAGED>(cur.w1 + u * d + prev), xprev, pu) +
            ld<STAGED>(cur.b1 + u));
        if (m == 0) h1r = a;
        else h1_s[u] = a;
      }
    }
    // the next dim's layer 1 over the columns known now (< nx; column i
    // is still 0), which nothing of this step waits for (after the last
    // step, an unused sum over every column: no branch around it, so the
    // compiler can interleave it with the chain)
    partial(nxt.w1, nx);
    // layer 2, its units to the per-sample vector
    dense<G, STAGED, ONE>(
        cur.w2, h, h, h, lane,
        [&](int c, int j) { return c == 0 ? h1r : h1_s[j]; },
        [&](int, int u, float v) {
          if (u < h) h2_s[u] = tanhf(v + ld<STAGED>(cur.b2 + u));
        });
    __syncwarp();
    // layer 3: lane k bin k's parameters (K > G: to P, bins in chunks)
    float pw = 0.f, ph = 0.f, pd = 0.f;
    if constexpr (STAGED) {
      if (NK == 1) {
        spline_params<G, STAGED, ONE>(cur.w3, cur.b3, h2_s, h, K, lane,
                                      start, pw, ph, pd);
      } else {
        for (int c = 0; c < NK; ++c) {
          const int k = c * G + lane;
          spline_params<G, STAGED, ONE>(cur.w3, cur.b3, h2_s, h, K, k,
                                        start, pw, ph, pd);
          if (k < K) {
            P[k] = pw;
            P[K + k] = ph;
            P[2 * K + k] = pd;
          }
        }
      }
    } else {
      // through L2, lanes over the inputs (each warp load one row's
      // line), then to lane k by P
      dense<G, STAGED, ONE>(
          cur.w3, h, P3, h, lane, [&](int, int j) { return h2_s[j]; },
          [&](int, int q, float v) {
            if (q < P3) P[q] = v + ld<STAGED>(cur.b3 + q);
          });
      __syncwarp();
      if (NK == 1) {
        const int k = lane < K ? lane : K - 1;
        pw = P[k];
        ph = P[K + k];
        pd = P[2 * K + k];
      }
    }

    // the spline inverse of z[:, i]: lane k holds bin k's knots (k + 1 of
    // each partition) and the derivative at knot k + 1
    float cw_lo, cw_up, ch_lo, ch_up, d_lo, d_up;
    if (NK == 1) {
      const bool live = lane < K;
      const float ninf = __uint_as_float(kNegInfBits);
      float mw = live ? pw : ninf, mh = live ? ph : ninf;
      group_max2<G>(mw, mh);
      const float ew = live ? expf(pw - mw) : 0.f;
      const float eh = live ? expf(ph - mh) : 0.f;
      const float dr = kMinDerivative + softplus(pd);
      float sw = ew, sh = eh;
      group_sum2<G>(sw, sh);
      const bool inner = lane < K - 1;   // bins 0..K-2 end at knots 1..K-1
      float cw = inner ? floored(ew, sw, kMinBinWidth, scale) : 0.f;
      float ch = inner ? floored(eh, sh, kMinBinHeight, scale) : 0.f;
      group_scan2<G>(cw, ch, lane);
      const float kw = lane == K - 1 ? bound : knot(cw, bound);
      const float kh = lane == K - 1 ? bound : knot(ch, bound);
      const float du = (lane == K - 1 && !is_circ) ? bnd_deriv : dr;
      const float wrap = __shfl_sync(kFull, dr, K - 1, G);   // P[3K-1]'s
      // bin on the HEIGHT knots (inverse direction): #{k in 1..K-1: zin >= ch[k]}
      const int idx = group_count<G>(inner && zin >= kh);
      const int lo = idx > 0 ? idx - 1 : 0;
      cw_lo = __shfl_sync(kFull, kw, lo, G);
      ch_lo = __shfl_sync(kFull, kh, lo, G);
      d_lo = __shfl_sync(kFull, du, lo, G);
      cw_up = __shfl_sync(kFull, kw, idx, G);
      ch_up = __shfl_sync(kFull, kh, idx, G);
      d_up = __shfl_sync(kFull, du, idx, G);
      if (idx == 0) {
        cw_lo = ch_lo = -bound;
        d_lo = is_circ ? wrap : bnd_deriv;
      }
    } else {
      // K > G: bins in chunks of G, each lane its own bins k = c*G + lane
      // of P, in place: widths -> exponentials -> knots, heights the
      // same, derivatives -> the derivative at knot k + 1
      float mw = __uint_as_float(kNegInfBits), mh = mw;
      for (int c = 0; c < NK; ++c) {
        const int k = c * G + lane;
        if (k < K) {
          mw = fmaxf(mw, P[k]);
          mh = fmaxf(mh, P[K + k]);
        }
      }
      group_max2<G>(mw, mh);
      float sw = 0.f, sh = 0.f;
      for (int c = 0; c < NK; ++c) {
        const int k = c * G + lane;
        if (k < K) {
          const float ew = expf(P[k] - mw), eh = expf(P[K + k] - mh);
          P[k] = ew;
          P[K + k] = eh;
          sw += ew;
          sh += eh;
        }
      }
      group_sum2<G>(sw, sh);
      float carry_w = 0.f, carry_h = 0.f;
      int idx = 0;
      for (int c = 0; c < NK; ++c) {
        const int k = c * G + lane;
        const bool inner = k < K - 1;
        float cw = inner ? floored(P[k], sw, kMinBinWidth, scale) : 0.f;
        float ch = inner ? floored(P[K + k], sh, kMinBinHeight, scale) : 0.f;
        group_scan2<G>(cw, ch, lane);
        cw += carry_w;
        ch += carry_h;
        const float kh = k == K - 1 ? bound : knot(ch, bound);
        idx += group_count<G>(inner && zin >= kh);
        if (k < K) {
          P[k] = k == K - 1 ? bound : knot(cw, bound);
          P[K + k] = kh;
          const float dr = kMinDerivative + softplus(P[2 * K + k]);
          P[2 * K + k] = (k == K - 1 && !is_circ) ? bnd_deriv : dr;
        }
        carry_w = __shfl_sync(kFull, cw, G - 1, G);
        carry_h = __shfl_sync(kFull, ch, G - 1, G);
      }
      __syncwarp();
      const int lo = idx > 0 ? idx - 1 : 0;
      cw_lo = P[lo];
      ch_lo = P[K + lo];
      d_lo = P[2 * K + lo];
      cw_up = P[idx];
      ch_up = P[K + idx];
      d_up = P[2 * K + idx];
      if (idx == 0) {
        cw_lo = ch_lo = -bound;
        d_lo = is_circ ? P[3 * K - 1] : bnd_deriv;
      }
    }

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
    if (lane == (i & (G - 1))) xs[i] = xi;
    prev = i;
    xprev = xi;
    i = nx;
    cur = nxt;

    if constexpr (STAGED) {
      if (S < d) {
        // release the slot; thread 0 refills it with inverted dim t + S
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[q]);
        if (threadIdx.x == 0 && t + S < T) {
          mbar_wait(&empty[q], phase);
          fill(q, dims[t + S]);
        }
      }
    }
    q = q_next;
    phase = phase_next;
  }

  if (valid) {
    for (int j = lane; j < d; j += G) out[row * d + j] = xs[j];
  }
}

using KernelFn = void (*)(const float*, const float*, const uint8_t*,
                          const uint8_t*, const float*, const float*,
                          const float*, const float*, const float*,
                          const float*, float*, int, int, int, int, float,
                          float, int, int, int, int);

// the instantiation of a plan: G lanes a sample; the weights staged, with
// one chunk of everything or not, or read through L2
KernelFn pick(const Plan& p) {
  if (p.slots && p.one) {
    if (p.G == 8) return ar_inverse_generic_kernel<8, true, true>;
    if (p.G == 16) return ar_inverse_generic_kernel<16, true, true>;
    return ar_inverse_generic_kernel<32, true, true>;
  }
  if (p.slots) {
    if (p.G == 8) return ar_inverse_generic_kernel<8, true, false>;
    if (p.G == 16) return ar_inverse_generic_kernel<16, true, false>;
    return ar_inverse_generic_kernel<32, true, false>;
  }
  if (p.G == 8) return ar_inverse_generic_kernel<8, false, false>;
  if (p.G == 16) return ar_inverse_generic_kernel<16, false, false>;
  return ar_inverse_generic_kernel<32, false, false>;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All arrays are contiguous
// float32 (uint8 for the two masks) on the device, at any 4-byte
// alignment; d >= 1, h >= 1, K >= 2 at run time.  Returns the launch's
// cudaError_t (0 on success, cudaErrorInvalidValue for a shape out of
// that range or whose one sample's scratch does not fit a block).
extern "C" int nfisam_ar_inverse_generic_f32(
    const float* z, const float* xp, const uint8_t* invert,
    const uint8_t* circular, const float* W1, const float* b1,
    const float* W2, const float* b2, const float* W3, const float* b3,
    float* out, int n, int d, int h, int K, float tail_bound,
    float boundary_raw, void* stream) {
  Plan p;
  if (!make_plan(d, h, K, &p)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const KernelFn kernel = pick(p);
  // above 48 KB dynamic shared memory needs the attribute (the current
  // device's, so it is set on every launch)
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((n + p.samples - 1) / p.samples));
  kernel<<<grid, p.samples * p.G, p.bytes, (cudaStream_t)stream>>>(
      z, xp, invert, circular, W1, b1, W2, b2, W3, b3, out, n, d, h, K,
      tail_bound, boundary_raw, p.samples, p.slots, p.stride, p.slice);
  return (int)cudaGetLastError();
}

// Build facts at (d, h, K), in `ar_inverse.cu`'s order: registers a
// thread, local memory a thread in bytes, dynamic shared memory a block in
// bytes, threads a block, samples a block, weight slots (d: the whole
// flow staged; 2-4: a ring; 0: the weights read through L2).  Returns a
// cudaError_t.
extern "C" int nfisam_ar_inverse_generic_info(int d, int h, int K,
                                              int* info_out) {
  Plan p;
  if (!make_plan(d, h, K, &p)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(pick(p)));
  if (err != cudaSuccess) return (int)err;
  info_out[0] = attr.numRegs;
  info_out[1] = (int)attr.localSizeBytes;
  info_out[2] = p.bytes;
  info_out[3] = p.samples * p.G;
  info_out[4] = p.samples;
  info_out[5] = p.slots;
  return 0;
}
