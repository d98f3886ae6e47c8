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
// as an (32, M) plane array, so limb i of element t sits at a[i*M + t] and a
// warp's loads of one limb are 128 contiguous bytes. Every output is the
// canonical residue, so any exact method gives the reference's bits.
//
// What bounds them on this card: bytes. Each element reads 2 x 128 bytes and
// writes 128, 384 bytes in all, about 0.115 ms per 1 M elements at 3.35 TB/s.
// The multiply's integer work (about 400 32x32->64-bit multiplies a lane on
// the FMA pipe, 64 lanes per SM per clock) stays under that.
//
// What the design does about it:
// - one thread per element, no shared memory, straight-line code out of
//   registers; loads and stores are coalesced across the warp;
// - the multiply does not run the reference's 12-bit schoolbook (1,024 limb
//   products and a 64-limb carry sweep, the shape of the TPU's int32 vector
//   unit). It repacks the 32 limbs into twelve 32-bit words in registers,
//   forms the 768-bit product with 144 `mul.wide` steps and 64-bit carries,
//   reduces it by Barrett (HAC 14.42) in base 2^32 with k = 12 and
//   mu = floor(2^768 / p) (13 words), subtracts p at most twice, and unpacks;
// - add and sub keep the 12-bit limbs: one 33-limb carry sweep (arithmetic
//   shifts for the signed sweep of a - b + p) and one conditional subtract
//   of p, as the reference does;
// - an operand whose batch axes are all broadcast (the (32, 1) constants of
//   the tower and the ladders) is read with a lane stride of 0, so it is
//   never materialised.
//
// Interface: plain C, loaded with ctypes. Each launcher runs on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the wrapper can refuse a launch that did not run.

#include <cstdint>
#include <cuda_runtime.h>

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

constexpr int kThreads = 256;
constexpr int kLimbs = 32;
constexpr int kLimbBits = 12;
constexpr int32_t kMask = (1 << kLimbBits) - 1;
constexpr int kWords = 12;  // 12 x 32 = 384 bits

// 32 limbs of 12 bits -> 12 words of 32 bits.
__device__ __forceinline__ void load_words(const int32_t* __restrict__ src,
                                           int64_t limb_stride, uint32_t w[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t limb = static_cast<uint32_t>(__ldg(src + i * limb_stride));
    const int bit = kLimbBits * i;
    const int k = bit >> 5;
    const int off = bit & 31;
    w[k] |= limb << off;
    if (off > 32 - kLimbBits) w[k + 1] |= limb >> (32 - off);
  }
}

// 12 words -> 32 limbs of 12 bits, stored at dst[i * m].
__device__ __forceinline__ void store_words(int32_t* __restrict__ dst, int64_t m,
                                            const uint32_t w[kWords]) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int bit = kLimbBits * i;
    const int k = bit >> 5;
    const int off = bit & 31;
    uint32_t v = w[k] >> off;
    if (off > 32 - kLimbBits) v |= w[k + 1] << (32 - off);
    dst[i * m] = static_cast<int32_t>(v & kMask);
  }
}

// r = r - p if r >= p (r has 13 words, the top one possibly nonzero).
__device__ __forceinline__ void sub_p_if_ge(uint32_t r[13]) {
  uint32_t d[13];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 13; ++k) {
    const uint64_t pk = k < kWords ? kPw[k] : 0u;
    const uint64_t t = static_cast<uint64_t>(r[k]) - pk - borrow;
    d[k] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  const uint32_t keep = 0u - borrow;  // all ones where r < p
#pragma unroll
  for (int k = 0; k < 13; ++k) r[k] = (r[k] & keep) | (d[k] & ~keep);
}

// (x * y) mod p for canonical x, y in words; r canonical.
__device__ __forceinline__ void mul_mod_words(const uint32_t x[kWords],
                                              const uint32_t y[kWords],
                                              uint32_t r[kWords]) {
  // z = x * y, 24 words, schoolbook by rows: each step is one mul.wide plus
  // two 32-bit adds into a 64-bit value that cannot overflow.
  uint32_t z[2 * kWords];
#pragma unroll
  for (int k = 0; k < 2 * kWords; ++k) z[k] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint64_t t = static_cast<uint64_t>(x[i]) * y[j] + z[i + j] + carry;
      z[i + j] = static_cast<uint32_t>(t);
      carry = t >> 32;
    }
    z[i + kWords] = static_cast<uint32_t>(carry);
  }

  // Barrett, base b = 2^32, k = 12: q1 = z >> b^(k-1) (13 words),
  // q3 = (q1 * mu) >> b^(k+1) (13 words).
  uint32_t q2[26];
#pragma unroll
  for (int k = 0; k < 26; ++k) q2[k] = 0;
#pragma unroll
  for (int i = 0; i < 13; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 13; ++j) {
      const uint64_t t =
          static_cast<uint64_t>(z[kWords - 1 + i]) * kMu[j] + q2[i + j] + carry;
      q2[i + j] = static_cast<uint32_t>(t);
      carry = t >> 32;
    }
    q2[i + 13] = static_cast<uint32_t>(carry);
  }
  const uint32_t* q3 = q2 + 13;

  // r2 = (q3 * p) mod b^13: only the products that land in the low 13 words.
  uint32_t r2[13];
#pragma unroll
  for (int k = 0; k < 13; ++k) r2[k] = 0;
#pragma unroll
  for (int i = 0; i < 13; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      if (i + j < 13) {
        const uint64_t t = static_cast<uint64_t>(q3[i]) * kPw[j] + r2[i + j] + carry;
        r2[i + j] = static_cast<uint32_t>(t);
        carry = t >> 32;
      }
    }
    if (i == 0) r2[kWords] = static_cast<uint32_t>(carry);
  }

  // r = (z mod b^13) - r2 mod b^13; the true r lies in [0, 3p).
  uint32_t rr[13];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 13; ++k) {
    const uint64_t t = static_cast<uint64_t>(z[k]) - r2[k] - borrow;
    rr[k] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  sub_p_if_ge(rr);
  sub_p_if_ge(rr);
#pragma unroll
  for (int k = 0; k < kWords; ++k) r[k] = rr[k];
}

// One element of each kernel. a/b point at the element's limb 0, with the
// given limb strides; out points at the element's limb 0 of an (32, m) array.
__device__ __forceinline__ void mul_one(const int32_t* __restrict__ a, int64_t als,
                                        const int32_t* __restrict__ b, int64_t bls,
                                        int32_t* __restrict__ out, int64_t m) {
  uint32_t x[kWords], y[kWords], r[kWords];
  load_words(a, als, x);
  load_words(b, bls, y);
  mul_mod_words(x, y, r);
  store_words(out, m, r);
}

// v (33 limbs, canonical) -> v - p if v >= p, written as 32 limbs.
__device__ __forceinline__ void store_sub_p_if_ge(int32_t* __restrict__ out, int64_t m,
                                                  const int32_t v[kLimbs + 1]) {
  int32_t d[kLimbs + 1];
  int32_t borrow = 0;
#pragma unroll
  for (int i = 0; i <= kLimbs; ++i) {
    const int32_t t = v[i] - (i < kLimbs ? kP12[i] : 0) - borrow;
    borrow = t < 0 ? 1 : 0;
    d[i] = t + (borrow << kLimbBits);
  }
  // borrow out of the top limb: v < p, keep v
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) out[i * m] = borrow ? v[i] : d[i];
}

__device__ __forceinline__ void add_one(const int32_t* __restrict__ a, int64_t als,
                                        const int32_t* __restrict__ b, int64_t bls,
                                        int32_t* __restrict__ out, int64_t m) {
  int32_t v[kLimbs + 1];
  int32_t carry = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int32_t t = __ldg(a + i * als) + __ldg(b + i * bls) + carry;
    v[i] = t & kMask;
    carry = t >> kLimbBits;
  }
  v[kLimbs] = carry;
  store_sub_p_if_ge(out, m, v);
}

__device__ __forceinline__ void sub_one(const int32_t* __restrict__ a, int64_t als,
                                        const int32_t* __restrict__ b, int64_t bls,
                                        int32_t* __restrict__ out, int64_t m) {
  // a - b + p, in (0, 2p): per-limb values may be negative; the arithmetic
  // shift floors, so each carry is in {-1, 0, 1} and & kMask re-canonicalises.
  int32_t v[kLimbs + 1];
  int32_t carry = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int32_t t = __ldg(a + i * als) - __ldg(b + i * bls) + kP12[i] + carry;
    v[i] = t & kMask;
    carry = t >> kLimbBits;
  }
  v[kLimbs] = carry;
  store_sub_p_if_ge(out, m, v);
}

#define FQ_KERNEL(NAME, ONE)                                                          \
  __global__ void __launch_bounds__(kThreads)                                          \
      NAME(const int32_t* __restrict__ a, int64_t als, int64_t aes,                   \
           const int32_t* __restrict__ b, int64_t bls, int64_t bes,                   \
           int32_t* __restrict__ out, int64_t m) {                                    \
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;      \
    if (t >= m) return;                                                                \
    ONE(a + t * aes, als, b + t * bes, bls, out + t, m);                               \
  }

FQ_KERNEL(fq_mul_mod_kernel, mul_one)
FQ_KERNEL(fq_add_mod_kernel, add_one)
FQ_KERNEL(fq_sub_mod_kernel, sub_one)

#undef FQ_KERNEL

using KernelFn = void (*)(const int32_t*, int64_t, int64_t, const int32_t*, int64_t,
                          int64_t, int32_t*, int64_t);

int launch(KernelFn kernel, const void* a, int64_t als, int64_t aes, const void* b,
           int64_t bls, int64_t bes, void* out, int64_t m, int device, void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), als, aes, static_cast<const int32_t*>(b), bls, bes,
      static_cast<int32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- launchers
// a, b: int32 limb planes on `device`; limb i of element t is at
// a[i * als + t * aes] (aes = 0 broadcasts one element over the batch).
// out: (32, m) int32, contiguous. stream: a cudaStream_t of that device.
// Returns cudaGetLastError() (or the error of selecting the device).
extern "C" int fq_mul_mod(const void* a, int64_t als, int64_t aes, const void* b,
                          int64_t bls, int64_t bes, void* out, int64_t m, int device,
                          void* stream) {
  return launch(fq_mul_mod_kernel, a, als, aes, b, bls, bes, out, m, device, stream);
}

extern "C" int fq_add_mod(const void* a, int64_t als, int64_t aes, const void* b,
                          int64_t bls, int64_t bes, void* out, int64_t m, int device,
                          void* stream) {
  return launch(fq_add_mod_kernel, a, als, aes, b, bls, bes, out, m, device, stream);
}

extern "C" int fq_sub_mod(const void* a, int64_t als, int64_t aes, const void* b,
                          int64_t bls, int64_t bes, void* out, int64_t m, int device,
                          void* stream) {
  return launch(fq_sub_mod_kernel, a, als, aes, b, bls, bes, out, m, device, stream);
}
