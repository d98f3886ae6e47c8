// SHA-256 of N independent 64-byte Merkle nodes on Hopper (sm_90a).
//
// Replaces: lambda_ethereum_consensus_tpu/ops/sha256.py:191 `_sha256_kernel`,
// launched by `hash_blocks_pallas` (:198-222). Same function: each row of an
// (N, 64) uint8 array is one whole SHA-256 message, and its 32-byte digest is
// row i of the (N, 32) uint8 output. A 64-byte message is exactly two
// compressions: one over the data block and one over the constant padding
// block (0x80, zeros, bit length 512), whose message schedule is precomputed
// (kPadSchedule below, `_PAD_SCHEDULE` in the Python module).
//
// What bounds it on this card: the integer issue rate, not memory. Each hash
// reads 64 bytes and writes 32, but runs 128 rounds of rotates, adds and
// bitwise selects plus 48 schedule steps: 2,409 SASS instructions as built
// for sm_90a, 2,124 of them on the INT32 ALU pipe (64 lanes per SM). On an
// H100 SXM that is ~0.13 ns of issue per hash across the card against
// ~0.03 ns for its 96 bytes at 3.35 TB/s.
//
// What the design does about it:
// - one thread per node and no shared memory: SHA-256 has no cross-message
//   traffic, so every thread runs its own straight-line chain of 128 rounds
//   out of registers, and enough threads are in flight to hide latency;
// - the rounds are fully unrolled, so K and the padding schedule are read
//   from constant memory at fixed offsets and the rolling 16-word schedule
//   stays in registers (46 registers, no spills);
// - rotates are single funnel shifts (`__funnelshift_r`), the byte swap to
//   big-endian words is one `__byte_perm`, and the compiler folds Ch and Maj
//   into three-input logic ops (LOP3);
// - the second compression has no schedule work at all: its 64 words are the
//   constant padding schedule.
// The TPU layout (16 word planes of (rows, 128) uint32, the (8, 128) tile
// quantum) does not carry over: rows are read in place, 4 x 16-byte loads per
// thread, and no marshalling pass exists.
//
// Interface: plain C, loaded with ctypes. The kernel launches on the caller's
// stream, allocates nothing and does not synchronise; the launcher returns
// cudaGetLastError() so the wrapper can refuse a launch that did not run.

#include <cstdint>
#include <cuda_runtime.h>

// clang-format off
__constant__ uint32_t kK[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
};

// Message schedule of the padding block of a 64-byte message.
__constant__ uint32_t kPadSchedule[64] = {
    0x80000000, 0x00000000, 0x00000000, 0x00000000, 0x00000000, 0x00000000,
    0x00000000, 0x00000000, 0x00000000, 0x00000000, 0x00000000, 0x00000000,
    0x00000000, 0x00000000, 0x00000000, 0x00000200, 0x80000000, 0x01400000,
    0x00205000, 0x00005088, 0x22000800, 0x22550014, 0x05089742, 0xA0000020,
    0x5A880000, 0x005C9400, 0x0016D49D, 0xFA801F00, 0xD33225D0, 0x11675959,
    0xF6E6BFDA, 0xB30C1549, 0x08B2B050, 0x9D7C4C27, 0x0CE2A393, 0x88E6E1EA,
    0xA52B4335, 0x67A16F49, 0xD732016F, 0x4EEB2E91, 0x5DBF55E5, 0x8EEE2335,
    0xE2BC5EC2, 0xA83F4394, 0x45AD78F7, 0x36F3D0CD, 0xD99C05E8, 0xB0511DC7,
    0x69BC7AC4, 0xBD11375B, 0xE3BA71E5, 0x3B209FF2, 0x18FEEE17, 0xE25AD9E7,
    0x13375046, 0x0515089D, 0x4F0D0F04, 0x2627484E, 0x310128D2, 0xC668B434,
    0x420841CC, 0x62D311B8, 0xE59BA771, 0x85A7A484,
};
__constant__ uint32_t kIV[8] = {
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
};
// clang-format on

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// One round; `kw` is K[t] + W[t].
__device__ __forceinline__ void round_step(uint32_t s[8], uint32_t kw) {
  const uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  const uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
  const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t t1 = h + s1 + ch + kw;
  const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  s[7] = g;
  s[6] = f;
  s[5] = e;
  s[4] = d + t1;
  s[3] = c;
  s[2] = b;
  s[1] = a;
  s[0] = t1 + s0 + maj;
}

__global__ void __launch_bounds__(kThreads)
    sha256_nodes_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                        int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;

  uint32_t w[16];
  const uint4* src = in + i * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = __ldg(src + q);
    w[4 * q + 0] = bswap(v.x);
    w[4 * q + 1] = bswap(v.y);
    w[4 * q + 2] = bswap(v.z);
    w[4 * q + 3] = bswap(v.w);
  }

  uint32_t s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = kIV[j];

  // First compression: the data block, schedule extended in a rolling window.
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15];
      const uint32_t w2 = w[(t - 2) & 15];
      const uint32_t g0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t g1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[t & 15] += g0 + w[(t - 7) & 15] + g1;
    }
    round_step(s, kK[t] + w[t & 15]);
  }
  uint32_t mid[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mid[j] = s[j] + kIV[j];
    s[j] = mid[j];
  }

  // Second compression: the constant padding block.
#pragma unroll
  for (int t = 0; t < 64; ++t) round_step(s, kK[t] + kPadSchedule[t]);

  uint4* dst = out + i * 2;
  dst[0] = make_uint4(bswap(s[0] + mid[0]), bswap(s[1] + mid[1]),
                      bswap(s[2] + mid[2]), bswap(s[3] + mid[3]));
  dst[1] = make_uint4(bswap(s[4] + mid[4]), bswap(s[5] + mid[5]),
                      bswap(s[6] + mid[6]), bswap(s[7] + mid[7]));
}

}  // namespace

// in: (n, 64) uint8, out: (n, 32) uint8, both contiguous, 16-byte aligned and
// on `device`; stream: a cudaStream_t of that device. Returns
// cudaGetLastError() (or the error of selecting the device).
extern "C" int sha256_nodes(const void* in, void* out, int64_t n, int device,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  sha256_nodes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
