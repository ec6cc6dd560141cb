// BabyBear field arithmetic in Montgomery form, shared by the port's CUDA
// kernels (csrc/poseidon2_merkle.cu, csrc/sumcheck.cu).
//
// A device word holds a BabyBear element x as x * 2^32 mod p (Montgomery
// form), the layout of ceno_tpu_torch/fields/babybear.py and of the
// reference's ceno_tpu/fields/babybear.py. Each function states the ranges of
// its operands and result; everything a kernel stores is canonical, in
// [0, p). The design notes of add, mmul and the lazy [0, 2p) ranges are in
// csrc/poseidon2_merkle.cu; tests/test_torch_p2_kernel_arith.py models each
// step in Python integers.
//
// The ext4 functions compute in F_p[x]/(x^4 - 11) with the coefficients
// (c0, c1, c2, c3), as ceno_tpu/fields/ext4.py does: the 16 schoolbook
// products, each canonical, the x^4 = 11 wrap as three products by 11 in
// Montgomery form. Field values are unique, so they equal the reference's
// bit for bit whatever the order of the operations.
//
// Each header defines its names in an unnamed namespace: every library built
// from csrc/ is one translation unit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P = 2013265921u;          // 0x78000001
constexpr uint32_t PINV = 2013265919u;       // -p^-1 mod 2^32 (babybear.PINV)
constexpr uint32_t PINV_POS = 2281701377u;   // p^-1 mod 2^32
static_assert(P * PINV_POS == 1u && PINV + PINV_POS == 0u, "Montgomery inverse");
constexpr uint32_t MONTY_ONE = 268435454u;   // 1 in Montgomery form (2^32 mod p)
constexpr uint32_t MONTY_W = 939524073u;     // 11 in Montgomery form: x^4 = 11

// a + b mod p; a, b in [0, p) -> [0, p)
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;
  return min(s, s - P);
}

__device__ __forceinline__ uint32_t dbl(uint32_t a) { return add(a, a); }

// [0, 2p) -> [0, p)
__device__ __forceinline__ uint32_t reduce(uint32_t a) { return min(a, a - P); }

// a * b / 2^32 mod p in (0, 2p), for a * b < p * 2^32.
__device__ __forceinline__ uint32_t mmul_lazy(uint32_t a, uint32_t b) {
  uint64_t t = static_cast<uint64_t>(a) * b;
  uint32_t m = static_cast<uint32_t>(t) * PINV_POS;
  return static_cast<uint32_t>(t >> 32) - __umulhi(m, P) + P;
}

// a * b / 2^32 mod p in [0, p), for a * b < p * 2^32.
__device__ __forceinline__ uint32_t mmul(uint32_t a, uint32_t b) {
  uint64_t t = static_cast<uint64_t>(a) * b;
  uint32_t m = static_cast<uint32_t>(t) * PINV_POS;
  uint32_t r = static_cast<uint32_t>(t >> 32) - __umulhi(m, P);  // (-p, p)
  return min(r, r + P);
}

// a - b mod p; a, b in [0, p) -> [0, p) (when a < b, d wraps above d + p)
__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  uint32_t d = a - b;
  return min(d, d + P);
}

// An ext4 element, coefficients canonical Montgomery words.
struct Ext {
  uint32_t c0, c1, c2, c3;
};

__device__ __forceinline__ Ext ext_add(Ext a, Ext b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1), add(a.c2, b.c2), add(a.c3, b.c3)};
}

__device__ __forceinline__ Ext ext_sub(Ext a, Ext b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1), sub(a.c2, b.c2), sub(a.c3, b.c3)};
}

// a * b with x^4 = 11; canonical in and out.
__device__ __forceinline__ Ext ext_mul(Ext a, Ext b) {
  const uint32_t w0 = add(add(mmul(a.c1, b.c3), mmul(a.c2, b.c2)), mmul(a.c3, b.c1));
  const uint32_t w1 = add(mmul(a.c2, b.c3), mmul(a.c3, b.c2));
  const uint32_t w2 = mmul(a.c3, b.c3);
  return {
      add(mmul(a.c0, b.c0), mmul(w0, MONTY_W)),
      add(add(mmul(a.c0, b.c1), mmul(a.c1, b.c0)), mmul(w1, MONTY_W)),
      add(add(add(mmul(a.c0, b.c2), mmul(a.c1, b.c1)), mmul(a.c2, b.c0)), mmul(w2, MONTY_W)),
      add(add(mmul(a.c0, b.c3), mmul(a.c1, b.c2)), add(mmul(a.c2, b.c1), mmul(a.c3, b.c0))),
  };
}

// a * b for a base-field b; canonical in and out.
__device__ __forceinline__ Ext ext_mul_base(Ext a, uint32_t b) {
  return {mmul(a.c0, b), mmul(a.c1, b), mmul(a.c2, b), mmul(a.c3, b)};
}

}  // namespace
