// Poseidon2-GL (width 8) on the host: one state (gl_permute), and the
// Goldilocks transcript's proof-of-work search (gl_grind).
//
// gl_permute permutes one canonical state in place: the rounds of
// gl/poseidon2.py, the transcript's and the verifiers' single-state path.
// gl_grind scans nonces below `limit`: each is added to word `pos` of the
// sponge state `pre`, the state is permuted, and the smallest nonce whose
// first output word falls below `threshold` is returned (UINT64_MAX if
// none): the nonce the reference's chunked numpy scan finds. `threads`
// threads take chunks of 1024 nonces in turn; a thread stops once its next
// chunk starts past the best hit so far, so every chunk below the result
// is scanned whole.
// The round constants come from the caller (gl/poseidon2.py's tables), so
// none is written here. Words are canonical Goldilocks elements in uint64;
// products reduce with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), as
// fields/gl_host.py does.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t P = 0xFFFFFFFF00000001ULL;
constexpr uint64_t EPS = 0xFFFFFFFFULL;  // 2^64 mod p

// a + b mod p for a < 2^64, b < p (a carry past 2^64 adds EPS)
inline uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;
  return s >= P ? s - P : s;
}

inline uint64_t mul(uint64_t a, uint64_t b) {
  unsigned __int128 prod = (unsigned __int128)a * b;
  uint64_t lo = (uint64_t)prod, hi = (uint64_t)(prod >> 64);
  uint64_t hi_lo = hi & EPS, hi_hi = hi >> 32;
  uint64_t t = add(lo, (hi_lo << 32) - hi_lo);
  return t >= hi_hi ? t - hi_hi : t + (P - hi_hi);
}

inline uint64_t sbox(uint64_t x) {
  uint64_t x2 = mul(x, x), x4 = mul(x2, x2);
  return mul(mul(x4, x2), x);
}

// circ(2*M4, M4): y_i = M4 (x_i + sum_j x_j) on each 4-block
inline void external(uint64_t v[8]) {
  uint64_t t[4];
  for (int i = 0; i < 4; ++i) t[i] = add(v[i], v[i + 4]);
  for (int b = 0; b < 8; b += 4) {
    uint64_t x0 = add(v[b], t[0]), x1 = add(v[b + 1], t[1]);
    uint64_t x2 = add(v[b + 2], t[2]), x3 = add(v[b + 3], t[3]);
    uint64_t s = add(add(x0, x1), add(x2, x3));
    v[b] = add(s, add(x0, add(x1, x1)));
    v[b + 1] = add(s, add(x1, add(x2, x2)));
    v[b + 2] = add(s, add(x2, add(x3, x3)));
    v[b + 3] = add(s, add(x3, add(x0, x0)));
  }
}

void permute(uint64_t v[8], const uint64_t* rc_ext, const uint64_t* rc_int,
             const uint64_t* diag) {
  external(v);
  for (int r = 0; r < 4; ++r) {
    for (int i = 0; i < 8; ++i) v[i] = sbox(add(v[i], rc_ext[8 * r + i]));
    external(v);
  }
  for (int r = 0; r < 22; ++r) {
    v[0] = sbox(add(v[0], rc_int[r]));
    uint64_t s = v[0];
    for (int i = 1; i < 8; ++i) s = add(s, v[i]);
    for (int i = 0; i < 8; ++i) v[i] = add(mul(v[i], diag[i]), s);
  }
  for (int r = 4; r < 8; ++r) {
    for (int i = 0; i < 8; ++i) v[i] = sbox(add(v[i], rc_ext[8 * r + i]));
    external(v);
  }
}

}  // namespace

extern "C" {

// rc_ext: the 8 external rounds' 8 constants, round-major; rc_int: the 22
// internal rounds'; diag: the internal matrix's diagonal.
void gl_permute(uint64_t* state, const uint64_t* rc_ext, const uint64_t* rc_int,
                const uint64_t* diag) {
  permute(state, rc_ext, rc_int, diag);
}

uint64_t gl_grind(const uint64_t* pre, int pos, uint64_t threshold, uint64_t limit,
                  const uint64_t* rc_ext, const uint64_t* rc_int, const uint64_t* diag,
                  int threads) {
  constexpr uint64_t CHUNK = 1024;
  std::atomic<uint64_t> best(UINT64_MAX);
  auto scan = [&](int t) {
    for (uint64_t start = t * CHUNK; start < limit; start += threads * CHUNK) {
      if (start >= best.load()) return;
      uint64_t end = std::min(limit, start + CHUNK);
      for (uint64_t nonce = start; nonce < end; ++nonce) {
        uint64_t v[8];
        for (int i = 0; i < 8; ++i) v[i] = pre[i];
        v[pos] = add(v[pos], nonce);
        permute(v, rc_ext, rc_int, diag);
        if (v[0] < threshold) {
          uint64_t seen = best.load();
          while (nonce < seen && !best.compare_exchange_weak(seen, nonce)) {
          }
          return;
        }
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(scan, t);
  scan(0);
  for (auto& th : pool) th.join();
  return best.load();
}

}  // extern "C"
