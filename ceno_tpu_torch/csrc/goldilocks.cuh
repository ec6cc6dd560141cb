// Goldilocks field p = 2^64 - 2^32 + 1 for the port's CUDA kernels
// (csrc/gl_commit.cu): canonical elements (< p) in uint64_t.
//
// The reference (ceno_tpu/fields/goldilocks.py) keeps two uint32 limbs
// because the TPU has no 64-bit integer path; Hopper multiplies 64 x 64 bits
// directly. A product is the 128-bit a * b (the low word, and __umul64hi for
// the high one) folded with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), the
// reduction of fields/gl_host.py::_reduce128. The plain torch versions are
// ceno_tpu_torch/fields/goldilocks.py, which reach the same canonical words
// without any product of 2^63 or more.

#pragma once

#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

// a + b for canonical a, b: a sum that wraps past 2^64 (a carry) or lands in
// [p, 2^64) is made canonical by adding EPS mod 2^64 (a carry: s + 2^64 =
// s + EPS mod p, and s + EPS < p; s >= p: s - p = s + EPS mod 2^64).
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  return (s < a || s >= P) ? s + EPS : s;
}

// a - b: a borrow leaves the difference 2^64 too large, 2^64 = EPS mod p,
// and the wrapped difference is >= 2^32, so subtracting EPS cannot borrow.
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d - EPS : d;
}

// (hi 2^64 + lo) mod p, canonical: hi = hh 2^32 + hl gives
// lo - hh + hl (2^32 - 1).
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  const uint64_t hh = hi >> 32, hl = hi & EPS;
  uint64_t t = lo - hh;
  if (lo < hh) t -= EPS;         // the borrow's 2^64, cannot borrow again
  const uint64_t u = hl * EPS;   // < 2^64
  uint64_t r = t + u;
  if (r < u) r += EPS;           // the carry's 2^64, cannot carry again
  return r >= P ? r - P : r;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t dbl(uint64_t a) { return add(a, a); }

// a^e by square and multiply.
__device__ __forceinline__ uint64_t pow(uint64_t a, uint64_t e) {
  uint64_t r = 1;
  while (e) {
    if (e & 1) r = mul(r, a);
    e >>= 1;
    if (e) a = mul(a, a);
  }
  return r;
}

}  // namespace gl
