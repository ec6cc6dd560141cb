// Poseidon2 over BabyBear (width 16) on the host: one canonical state,
// permuted in place (bb_permute), the rounds of hash/poseidon2.py. The host
// transcript and the witness builders permute one state at a time, hundreds
// of thousands of times; the tables come from the caller (hash/poseidon2.py),
// so none is written here. Words are canonical (below p < 2^31), so every
// sum of 16 words and every product fits in 64 bits before its reduction.

#include <cstdint>

namespace {

constexpr uint64_t P = 2013265921;  // 15 * 2^27 + 1

inline uint64_t sbox(uint64_t x) {
  uint64_t x2 = x * x % P, x4 = x2 * x2 % P;
  return x4 * x2 % P * x % P;
}

// circ(2*M4, M4, M4, M4): y_i = M4 (x_i + sum_j x_j) on each 4-block
inline void external(uint64_t v[16]) {
  uint64_t t[4];
  for (int j = 0; j < 4; ++j) t[j] = v[j] + v[4 + j] + v[8 + j] + v[12 + j];
  for (int b = 0; b < 16; b += 4) {
    uint64_t x0 = v[b] + t[0], x1 = v[b + 1] + t[1], x2 = v[b + 2] + t[2], x3 = v[b + 3] + t[3];
    uint64_t s = x0 + x1 + x2 + x3;
    v[b] = (s + x0 + 2 * x1) % P;
    v[b + 1] = (s + x1 + 2 * x2) % P;
    v[b + 2] = (s + x2 + 2 * x3) % P;
    v[b + 3] = (s + x3 + 2 * x0) % P;
  }
}

}  // namespace

extern "C" {

// rc_ext: the 8 external rounds' 16 constants, round-major; rc_int: the 13
// internal rounds'; diag: the internal matrix's diagonal.
void bb_permute(uint64_t* v, const uint64_t* rc_ext, const uint64_t* rc_int,
                const uint64_t* diag) {
  external(v);
  for (int r = 0; r < 4; ++r) {
    for (int i = 0; i < 16; ++i) v[i] = sbox((v[i] + rc_ext[16 * r + i]) % P);
    external(v);
  }
  for (int r = 0; r < 13; ++r) {
    v[0] = sbox((v[0] + rc_int[r]) % P);
    uint64_t s = 0;
    for (int i = 0; i < 16; ++i) s += v[i];
    for (int i = 0; i < 16; ++i) v[i] = (v[i] * diag[i] + s) % P;
  }
  for (int r = 4; r < 8; ++r) {
    for (int i = 0; i < 16; ++i) v[i] = sbox((v[i] + rc_ext[16 * r + i]) % P);
    external(v);
  }
}

}  // extern "C"
