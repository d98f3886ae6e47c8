// BLS12-381 base-field arithmetic on Hopper (sm_90a): (a*b), (a+b) and
// (a-b) mod p over limb planes.
//
// Replaces the three kernel bodies of
// lambda_ethereum_consensus_tpu/ops/bigint_pallas.py, launched through
// `_plane_call` (:161-193, pallas_call at :185):
//   fq_mul_mod  <- `_mul_mod_kernel` (:127-142)
//   fq_add_mod  <- `_add_mod_kernel` (:108-113)
//   fq_sub_mod  <- `_sub_mod_kernel` (:116-124)
// Same function on the same layout: an Fq element is 32 little-endian limbs
// of 12 bits in int32, canonical (limbs < 2^12, value < p), stored limb-major
// as an (32, M) plane array, so limb i of element t sits at a[i*M + t].
// Every output is the canonical residue, so any exact method gives the
// reference's bits.
//
// What bounds them on this card depends on the lane count M.
// - Large launches (2^20 lanes): bytes. Each element reads 2 x 128 bytes and
//   writes 128, 384 bytes in all, 0.1202 ms per 2^20 elements at 3.35 TB/s;
//   the multiply's integer work (about 400 32x32->64-bit products a lane)
//   stays under that.
// - The lane counts the BLS paths launch with (2,000-25,000): latency. With
//   one thread per element in 256-thread blocks a 4,072-lane multiply fills
//   16 of 132 SMs and waits out one thread's chain of about 2,100 dependent
//   instructions (5.5 us, against a 0.47 us byte bound); an add or a sub
//   waits out two serial 33-limb sweeps (2.4-2.5 us at 4,072-6,144 lanes).
//   An empty kernel on the same grid takes 0.8-1.3 us, the floor under
//   all of them. Tensor cores, TMA and clusters do not serve a 381-bit carry
//   chain over 384 bytes a lane; shared memory would only serve a transpose
//   of the limb-major planes, which the loads below do not need.
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 9, recorded in PERF.md.)
//
// What the design does about it:
// - the multiply works in twelve 32-bit words: the 768-bit product in
//   `mul.wide` rows with 64-bit carries, Barrett (HAC 14.42) in base 2^32
//   with k = 12 and mu = floor(2^768 / p) (13 words), one conditional
//   subtraction of p (the remainder is below 2p, see mul_mod_words);
// - it has two bodies, picked by the wrapper from the lane count
//   (ops/bigint_pallas.py `MUL_GROUP_THRESHOLD`): below it a group of
//   kMulGroup threads of a warp per element, from it on one thread per
//   element (the same code with a group of one). Rank t of a group loads
//   only its limbs (words [t W, t W + W), W = 12 / kMulGroup), gathers y
//   with 12 shuffles, and takes rows [t C, t C + C) of each of Barrett's
//   three products (x*y, q1*mu, q3*p mod b^13), so its chain of multiplies
//   is kMulGroup times shorter; the group sums its shares in log2(kMulGroup)
//   rounds of __shfl_xor_sync, exchanging only the words a share spans.
//   Every rank then holds the whole remainder, so the final subtraction's
//   borrow is the group's by construction; each rank stores its own limbs.
//   A group of 2 beat groups of 1 and 4 at 4,072-8,192 lanes (2.9 us at
//   4,072);
//   from about 9,000 lanes the one-thread body is faster;
// - add and sub share one body (add_sub_thread) and spread an element over
//   kAddGroup and kSubGroup threads, rank t holding limbs [t L, t L + L),
//   L = 32 / G: each rank sweeps its L limbs, the carries between the
//   ranks' blocks come from one __ballot_sync of generate and one of
//   propagate bits (group_carries), and a second sweep adds them. The add
//   forms a + b, then a + b - p with borrows, and keeps a + b when a borrow
//   leaves the top (a + b < p); the sub forms a - b with borrows, then
//   a - b + p with carries, and keeps a - b when no borrow left the top
//   (a >= b). No 33rd limb is needed. Resolving each rank's chain with one
//   integer add of its generate and pass bit words instead of the sweeps
//   lost (585 instructions a thread against 444; 1.87 against 1.74 us at
//   4,072 lanes in a one-off comparison, PERF.md): at these lane counts
//   load latency and instruction issue bound the body, not the sweep's
//   chain. In chip_smoke.py's sweep a group of 2 beats groups of 1 and 4
//   from 6,144 lanes on; a group of 4 is up to 0.19 us faster at 2,048
//   lanes and 0.35-0.57 us slower at 16,288. 128-thread blocks keep 77-82 %
//   of the byte bound at 2^20 lanes (64: 74-77 %) and are within 0.08 us
//   of 64 below, so the sub runs one geometry at every lane count; its
//   launcher also takes groups of 1 and 4 for that sweep;
// - blocks of 64 or 128 threads (the wrapper's choice) spread the paths'
//   launches over the card's SMs;
// - an operand whose batch axes are all broadcast (the (32, 1) constants of
//   the tower and the ladders) is read with a lane stride of 0, so it is
//   never materialised.
//
// Interface: plain C, loaded with ctypes. Each launcher takes the launch
// geometry from the wrapper (threads per element, threads per block,
// blocks), checks it, runs on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() so the wrapper can refuse
// a launch that did not run. `fq_empty` launches an empty kernel with the
// same arguments and grid, to time what a bare launch costs.
//
// Without nvcc (a host C++ compiler), everything above the kernels compiles
// as plain C++, so the arithmetic and the thread-to-limb mapping can be
// driven on the CPU with an emulated group (see tests/test_torch_fq_layout.py).

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FQ_FN __device__ __forceinline__
#define FQ_LDG(p) __ldg(p)
#else
#define FQ_FN inline
#define FQ_LDG(p) (*(p))
#define __constant__
#endif

// clang-format off
// p in 12-bit limbs and in 32-bit words, and mu = floor(2^768 / p).
__constant__ int32_t kP12[32] = {
    0xAAB, 0xFFA, 0xFFF, 0xFFF, 0x9FE, 0xFFB, 0x3FF, 0xB15, 0xFFE, 0xABF,
    0x41E, 0xF62, 0x6B0, 0xA0F, 0x0D2, 0x673, 0x2BF, 0x851, 0x4F3, 0x4B8,
    0x477, 0xD76, 0xBAC, 0x434, 0x7B6, 0x1BA, 0xA4B, 0xE69, 0x97F, 0xEA3,
    0x111, 0x1A0,
};
__constant__ uint32_t kPw[12] = {
    0xFFFFAAAB, 0xB9FEFFFF, 0xB153FFFF, 0x1EABFFFE, 0xF6B0F624, 0x6730D2A0,
    0xF38512BF, 0x64774B84, 0x434BACD7, 0x4B1BA7B6, 0x397FE69A, 0x1A0111EA,
};
__constant__ uint32_t kMu[13] = {
    0x6591BA2E, 0x13E207F5, 0x58F1C07B, 0x997167A0, 0x286779D3, 0xDF4771E0,
    0xF6A0A94B, 0x1B82741F, 0xC7A6BA29, 0x28101B0C, 0xCC9E45CE, 0xD835D2F3,
    0x00000009,
};
// clang-format on

namespace {

constexpr int kMaxThreads = 256;  // launch bound of every kernel
constexpr int kMulGroup = 2;      // threads per element of the multiply's group body
constexpr int kAddGroup = 2;      // threads per element of the add
constexpr int kSubGroup = 2;      // threads per element of the sub, as the wrapper launches it
static_assert(kSubGroup == 1 || kSubGroup == 2 || kSubGroup == 4,
              "the sub's launcher takes groups of 1, 2 and 4");
constexpr int kLimbs = 32;
constexpr int kLimbBits = 12;
constexpr int32_t kMask = (1 << kLimbBits) - 1;
constexpr int kWords = 12;  // 12 x 32 = 384 bits

// A group of one: the one-thread bodies exchange nothing.
struct OneLane {
  FQ_FN uint32_t shfl(uint32_t v, int) const { return v; }
  FQ_FN uint32_t shfl_xor(uint32_t v, int) const { return v; }
  FQ_FN uint32_t ballot(bool p) const { return p ? 1u : 0u; }
};

// Rank t of a group of G holds limbs [t L, t L + L), L = 32 / G, which for
// G in {1, 2, 4} are exactly words [t W, t W + W), W = 12 / G, at the same
// bit offsets for every rank.
template <int G>
FQ_FN void load_share(const int32_t* __restrict__ src, int64_t limb_stride, int t,
                      uint32_t w[kWords / G]) {
  constexpr int L = kLimbs / G;
  src += static_cast<int64_t>(t) * L * limb_stride;
#pragma unroll
  for (int k = 0; k < kWords / G; ++k) w[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t limb = static_cast<uint32_t>(FQ_LDG(src + i * limb_stride));
    const int bit = kLimbBits * i;
    const int k = bit >> 5;
    const int off = bit & 31;
    w[k] |= limb << off;
    if (off > 32 - kLimbBits) w[k + 1] |= limb >> (32 - off);
  }
}

// Rank t's words of r (all 12 held by every rank) -> its limbs, at dst[i * m].
template <int G>
FQ_FN void store_share(int32_t* __restrict__ dst, int64_t m, int t, const uint32_t r[kWords]) {
  constexpr int W = kWords / G;
  constexpr int L = kLimbs / G;
  uint32_t w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    w[k] = r[k];  // r[t W + k], without indexing registers by t
#pragma unroll
    for (int u = 1; u < G; ++u) w[k] = t == u ? r[u * W + k] : w[k];
  }
  dst += static_cast<int64_t>(t) * L * m;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int bit = kLimbBits * i;
    const int k = bit >> 5;
    const int off = bit & 31;
    uint32_t v = w[k] >> off;
    if (off > 32 - kLimbBits) v |= w[k + 1] << (32 - off);
    dst[i * m] = static_cast<int32_t>(v & kMask);
  }
}

// Rank t's rows of a * b (NA x NB words), rows [t C, t C + C) below NA,
// summed as sum_r a[t C + r] * b * 2^(32 r) and kept mod 2^(32 NS): the
// rank's share of the product, in a frame 32 t C bits up. Each row is one
// `mul.wide` carry chain.
template <int G, int C, int NA, int NB, int NS>
FQ_FN void rows_of_rank(int t, const uint32_t* a, const uint32_t* b, uint32_t s[NS]) {
#pragma unroll
  for (int k = 0; k < NS; ++k) s[k] = 0;
#pragma unroll
  for (int r = 0; r < C; ++r) {
    uint32_t w = a[r];  // a[t C + r], without indexing registers by t
#pragma unroll
    for (int u = 1; u < G; ++u) {
      if (u * C + r < NA) w = t == u ? a[u * C + r] : w;
      else if (t == u) w = 0;
    }
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (r + j < NS) {
        const uint64_t v = static_cast<uint64_t>(w) * b[j] + s[r + j] + carry;
        s[r + j] = static_cast<uint32_t>(v);
        carry = v >> 32;
      }
    }
    if (r + NB < NS) s[r + NB] = static_cast<uint32_t>(carry);
  }
}

// The sum of the group's shares (rows_of_rank<G, C, ., NB, NS>), in every
// rank. Before the round of distance d a rank holds the sum of its block of
// d ranks (d C rows, below 2^(32 (d C + NB))) in the frame of the block's
// lowest rank; the round adds the partner block's sum, 32 d C bits up, into
// the frame of the lower block. NS words are kept: the sums are below
// 2^(32 NS) in every frame, or wanted mod 2^(32 NS) only.
template <int G, int C, int NB, int NS, class Lanes>
FQ_FN void group_sum(const Lanes& lanes, int t, uint32_t s[NS]) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const int width = d * C + NB < NS ? d * C + NB : NS;  // words a block's sum spans
    const bool high = (t & d) != 0;
    uint32_t lo[NS], hi[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      if (k < width) {
        const uint32_t other = lanes.shfl_xor(s[k], d);
        lo[k] = high ? other : s[k];
        hi[k] = high ? s[k] : other;
      } else {
        lo[k] = hi[k] = 0;
      }
    }
    uint64_t carry = 0;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const uint64_t v = static_cast<uint64_t>(lo[k]) + (k >= d * C ? hi[k - d * C] : 0u) + carry;
      s[k] = static_cast<uint32_t>(v);
      carry = v >> 32;
    }
  }
}

// d = r - q (12 words); returns the borrow out.
FQ_FN uint32_t sub_words(const uint32_t r[kWords], const uint32_t* q, uint32_t d[kWords]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint64_t v = static_cast<uint64_t>(r[k]) - q[k] - borrow;
    d[k] = static_cast<uint32_t>(v);
    borrow = static_cast<uint32_t>(v >> 63);
  }
  return borrow;
}

// (x * y) mod p, computed by a group of G threads (rank t): the rank holds
// its words of x (x_own) and all of y; every rank gets the canonical r.
template <int G, class Lanes>
FQ_FN void mul_mod_words(const Lanes& lanes, int t, const uint32_t* x_own,
                         const uint32_t y[kWords], uint32_t r[kWords]) {
  constexpr int W = kWords / G;      // rows of x per rank
  constexpr int Q = (13 + G - 1) / G;  // rows of q1 and of q3 per rank

  // z = x * y, 24 words
  uint32_t z[2 * kWords];
  rows_of_rank<1, W, W, kWords, 2 * kWords>(0, x_own, y, z);
  group_sum<G, W, kWords, 2 * kWords>(lanes, t, z);

  // Barrett, base b = 2^32, k = 12: q1 = z >> b^(k-1) (13 words),
  // q3 = (q1 * mu) >> b^(k+1) (13 words).
  uint32_t q2[26];
  rows_of_rank<G, Q, 13, 13, 26>(t, z + kWords - 1, kMu, q2);
  group_sum<G, Q, 13, 26>(lanes, t, q2);
  const uint32_t* q3 = q2 + 13;

  // r2 = (q3 * p) mod b^13: only the products that land in the low 13 words.
  uint32_t r2[13];
  rows_of_rank<G, Q, 13, kWords, 13>(t, q3, kPw, r2);
  group_sum<G, Q, kWords, 13>(lanes, t, r2);

  // rr = (z mod b^13) - r2 mod b^13 is the true r = z - q3 p. With
  // z = x y < p^2, q1 = z / b^11 + f1 and mu = b^24 / p + f2 (f1, f2 in
  // [0, 1)), q1 mu / b^13 falls short of z / p by less than
  // (q1 + mu + 1) / b^13 < 2^-5, so q3 >= floor(z / p) - 1 and r < 2p:
  // one conditional subtraction of p makes it canonical.
  uint32_t rr[kWords], d[kWords];
  sub_words(z, r2, rr);
  const uint32_t below_p = sub_words(rr, kPw, d);
#pragma unroll
  for (int k = 0; k < kWords; ++k) r[k] = below_p ? rr[k] : d[k];
}

// Thread `gid` of a multiply launch with G threads per element: element
// gid / G, rank gid % G. The ranks of a last group past the end (and the
// threads past it) read the last element, so every lane of the warp takes
// part in the exchanges, and store nothing.
template <int G, class Lanes>
FQ_FN void mul_thread(const Lanes& lanes, int64_t gid, const int32_t* __restrict__ a,
                      int64_t als, int64_t aes, const int32_t* __restrict__ b, int64_t bls,
                      int64_t bes, int32_t* __restrict__ out, int64_t m) {
  constexpr int W = kWords / G;
  const int t = static_cast<int>(gid % G);
  const int64_t e = gid / G;
  const bool live = e < m;
  const int64_t src = live ? e : m - 1;
  uint32_t x[W], y_own[W], y[kWords], r[kWords];
  load_share<G>(a + src * aes, als, t, x);
  load_share<G>(b + src * bes, bls, t, y_own);
#pragma unroll
  for (int j = 0; j < kWords; ++j) y[j] = lanes.shfl(y_own[j % W], j / W);
  mul_mod_words<G>(lanes, t, x, y, r);
  if (live) store_share<G>(out + e, m, t, r);
}

// The carries into a group's blocks of limbs, from each rank's generate bit
// (its block carries out by itself) and propagate bit (it passes a carry in
// on): the binary sum (g | p) + g carries exactly where the blocks do, so
// bit t of the result is the carry into rank t, and bit G the carry out of
// the group.
template <class Lanes>
FQ_FN uint32_t group_carries(const Lanes& lanes, bool generate, bool propagate) {
  const uint32_t g = lanes.ballot(generate);
  const uint32_t x = g | lanes.ballot(propagate);
  return (x + g) ^ x ^ g;
}

// r = x + y (kNeg false) or x - y (kNeg true) mod 2^384 over rank t's
// L = 32 / G limbs, with the carries (borrows) resolved across the group;
// returns the group's carry word of group_carries (bit G: the carry or
// borrow out of the top). The rank sweeps its limbs with carry in 0, noting
// whether its block carries out by itself and whether it would pass a carry
// in on (all limbs 0xFFF; for a borrow, all 0); one pair of ballots gives
// each rank its carry in, and a second sweep adds it.
template <bool kNeg, int G, class Lanes>
FQ_FN uint32_t add_limbs(const Lanes& lanes, int t, const int32_t* x, const int32_t* y,
                         int32_t* r) {
  constexpr int L = kLimbs / G;
  int32_t c = 0;
  bool pass = true;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (kNeg) {
      const int32_t s = x[i] - y[i] - c;
      c = s < 0 ? 1 : 0;
      r[i] = s + (c << kLimbBits);
      pass = pass && r[i] == 0;
    } else {
      const int32_t s = x[i] + y[i] + c;
      r[i] = s & kMask;
      c = s >> kLimbBits;
      pass = pass && r[i] == kMask;
    }
  }
  const uint32_t carries = group_carries(lanes, c != 0, pass);
  c = static_cast<int32_t>((carries >> t) & 1u);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (kNeg) {
      const int32_t s = r[i] - c;
      c = s < 0 ? 1 : 0;
      r[i] = s + (c << kLimbBits);
    } else {
      const int32_t s = r[i] + c;
      r[i] = s & kMask;
      c = s >> kLimbBits;
    }
  }
  return carries;
}

// Thread `gid` of an add (kSub false) or sub (kSub true) launch with G
// threads per element: element gid / G, rank t = gid % G, which loads and
// stores its L = 32 / G limbs. The add forms v = a + b (below 2p < 2^384)
// and d = v - p, and keeps v when the borrow out of the top says v < p; the
// sub forms v = a - b mod 2^384 and d = v + p mod 2^384, and keeps v when no
// borrow left the top (a >= b). Either way the whole group takes one
// decision. The ranks of a last group past the end (and the threads past
// it) read the last element, so every lane of the warp takes part in the
// ballots, and store nothing.
template <bool kSub, int G, class Lanes>
FQ_FN void add_sub_thread(const Lanes& lanes, int64_t gid, const int32_t* __restrict__ a,
                          int64_t als, int64_t aes, const int32_t* __restrict__ b, int64_t bls,
                          int64_t bes, int32_t* __restrict__ out, int64_t m) {
  constexpr int L = kLimbs / G;
  const int t = static_cast<int>(gid % G);
  const int64_t e = gid / G;
  const bool live = e < m;
  const int64_t src = live ? e : m - 1;
  const int64_t first = static_cast<int64_t>(t) * L;
  a += src * aes + first * als;
  b += src * bes + first * bls;
  int32_t x[L], y[L], pk[L];  // this rank's limbs of a, b and p
#pragma unroll
  for (int i = 0; i < L; ++i) {
    x[i] = FQ_LDG(a + i * als);
    y[i] = FQ_LDG(b + i * bls);
    pk[i] = kP12[i];  // kP12[t L + i], without indexing by t
#pragma unroll
    for (int u = 1; u < G; ++u) pk[i] = t == u ? kP12[u * L + i] : pk[i];
  }
  int32_t v[L], d[L];
  const uint32_t first_out = add_limbs<kSub, G>(lanes, t, x, y, v);
  const uint32_t second_out = add_limbs<!kSub, G>(lanes, t, v, pk, d);
  const bool keep = kSub ? ((first_out >> G) & 1u) == 0 : ((second_out >> G) & 1u) != 0;
  if (!live) return;
  out += e + first * m;
#pragma unroll
  for (int i = 0; i < L; ++i) out[i * m] = keep ? v[i] : d[i];
}

template <int G, class Lanes>
FQ_FN void add_thread(const Lanes& lanes, int64_t gid, const int32_t* __restrict__ a,
                      int64_t als, int64_t aes, const int32_t* __restrict__ b, int64_t bls,
                      int64_t bes, int32_t* __restrict__ out, int64_t m) {
  add_sub_thread<false, G>(lanes, gid, a, als, aes, b, bls, bes, out, m);
}

template <int G, class Lanes>
FQ_FN void sub_thread(const Lanes& lanes, int64_t gid, const int32_t* __restrict__ a,
                      int64_t als, int64_t aes, const int32_t* __restrict__ b, int64_t bls,
                      int64_t bes, int32_t* __restrict__ out, int64_t m) {
  add_sub_thread<true, G>(lanes, gid, a, als, aes, b, bls, bes, out, m);
}

}  // namespace

#ifdef __CUDACC__

namespace {

// The lanes of a group of G are aligned within a warp (G divides 32), and
// every lane of the warp runs the body, so full-warp exchanges stay exact.
template <int G>
struct WarpLanes {
  __device__ __forceinline__ uint32_t shfl(uint32_t v, int rank) const {
    return __shfl_sync(0xffffffffu, v, rank, G);
  }
  __device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int d) const {
    return __shfl_xor_sync(0xffffffffu, v, d, G);
  }
  // bit r: rank r's predicate
  __device__ __forceinline__ uint32_t ballot(bool p) const {
    const unsigned base = threadIdx.x & 31u & ~static_cast<unsigned>(G - 1);
    return (__ballot_sync(0xffffffffu, p) >> base) & ((1u << G) - 1u);
  }
};

__device__ __forceinline__ int64_t global_thread() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

#define FQ_ARGS                                                                     \
  const int32_t *__restrict__ a, int64_t als, int64_t aes, const int32_t *__restrict__ b, \
      int64_t bls, int64_t bes, int32_t *__restrict__ out, int64_t m

__global__ void __launch_bounds__(kMaxThreads) fq_mul_mod_kernel(FQ_ARGS) {
  mul_thread<1>(OneLane{}, global_thread(), a, als, aes, b, bls, bes, out, m);
}

__global__ void __launch_bounds__(kMaxThreads) fq_mul_mod_group_kernel(FQ_ARGS) {
  mul_thread<kMulGroup>(WarpLanes<kMulGroup>{}, global_thread(), a, als, aes, b, bls, bes, out,
                        m);
}

__global__ void __launch_bounds__(kMaxThreads) fq_add_mod_kernel(FQ_ARGS) {
  add_thread<kAddGroup>(WarpLanes<kAddGroup>{}, global_thread(), a, als, aes, b, bls, bes, out,
                        m);
}

// One kernel per group size the sub takes (1, 2 or 4 threads per element).
template <int G>
__global__ void __launch_bounds__(kMaxThreads) fq_sub_mod_kernel(FQ_ARGS) {
  if constexpr (G == 1) {
    sub_thread<1>(OneLane{}, global_thread(), a, als, aes, b, bls, bes, out, m);
  } else {
    sub_thread<G>(WarpLanes<G>{}, global_thread(), a, als, aes, b, bls, bes, out, m);
  }
}

__global__ void __launch_bounds__(kMaxThreads) fq_empty_kernel(FQ_ARGS) {}

#undef FQ_ARGS

using KernelFn = void (*)(const int32_t*, int64_t, int64_t, const int32_t*, int64_t, int64_t,
                          int32_t*, int64_t);

int launch(KernelFn kernel, const void* a, int64_t als, int64_t aes, const void* b, int64_t bls,
           int64_t bes, void* out, int64_t m, int group, int threads, int64_t blocks, int device,
           void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  if (kernel == nullptr || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      blocks < 1 || blocks > 0x7FFFFFFF || blocks * threads < m * group)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), als, aes, static_cast<const int32_t*>(b), bls, bes,
      static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- launchers
// a, b: int32 limb planes on `device`; limb i of element t is at
// a[i * als + t * aes] (aes = 0 broadcasts one element over the batch).
// out: (32, m) int32, contiguous. group: threads per element (1 or
// kMulGroup for the multiply, kAddGroup for the add, 1, 2 or 4 for the sub,
// which the wrapper runs at kSubGroup); threads: per block, a multiple of 32
// up to kMaxThreads; blocks * threads must cover m * group. stream: a
// cudaStream_t of that device. Returns cudaErrorInvalidValue for a
// geometry the kernel does not take, else cudaGetLastError() (or the error
// of selecting the device).
#define FQ_LAUNCHER(NAME, KERNEL)                                                           \
  extern "C" int NAME(const void* a, int64_t als, int64_t aes, const void* b, int64_t bls,  \
                      int64_t bes, void* out, int64_t m, int group, int threads,            \
                      int64_t blocks, int device, void* stream) {                           \
    return launch(KERNEL, a, als, aes, b, bls, bes, out, m, group, threads, blocks, device, \
                  stream);                                                                  \
  }

FQ_LAUNCHER(fq_mul_mod, group == 1           ? fq_mul_mod_kernel
                        : group == kMulGroup ? fq_mul_mod_group_kernel
                                             : nullptr)
FQ_LAUNCHER(fq_add_mod, group == kAddGroup ? fq_add_mod_kernel : nullptr)
FQ_LAUNCHER(fq_sub_mod, group == 1   ? fq_sub_mod_kernel<1>
                        : group == 2 ? fq_sub_mod_kernel<2>
                        : group == 4 ? fq_sub_mod_kernel<4>
                                     : nullptr)
FQ_LAUNCHER(fq_empty, fq_empty_kernel)

#undef FQ_LAUNCHER

#endif  // __CUDACC__
