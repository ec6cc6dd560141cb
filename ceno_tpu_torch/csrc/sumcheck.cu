// Sumcheck kernels over BabyBear-ext4 for Hopper (sm_90a): the round
// evaluations, the folds and the on-device Fiat-Shamir duplex of the fused
// sumcheck (ceno_tpu_torch/sumcheck/{terms,fused}.py).
//
// They replace XLA-jitted functions of the reference, not Pallas kernels:
// K6a sc_round_evals  ceno_tpu/sumcheck/terms.py round_evals / _term_contrib
//                     (:64-136) and round_evals_ext (:174);
// K6b sc_fold         fold_banks (:138) and fold_ext_bank (:159);
// K5/K7 sc_duplex     sumcheck/fused.py _DeviceDuplex (:30-60) over
//                     hash/poseidon2.py permute_device (:178).
//
// A virtual polynomial is a list of T terms scalar_t * prod_k col_{idx[t,k]}
// over two banks of Montgomery words: base (Cb+1, N) and ext (4, Ce+1, N),
// each with a column of ones last, the sentinel that pads every term to DB
// base and DE ext factors. A round evaluates the batched univariate
// g(t) = sum_i sum_terms scalar * prod_k (lo_k[i] + t (hi_k[i] - lo_k[i]))
// at t = 0..deg over the half-cube i < N/2 (lo the first half of a column,
// hi the second), then folds every column to lo + r (hi - lo).
//
// What bounds them on this card. K6a does, per element and term, deg + 1
// products of DB + DE factors, and per node one ext product by the term's
// scalar; it reads each column word once (from device memory; the terms that
// share a column read it again from L1). At the main path's shapes it is
// bound by the integer multiplies, as the Poseidon2 kernels are (PERF.md has
// its bound and time). K6b reads and writes each word once: bound by bytes.
// K5/K7 is one thread on one 16-word sponge: bound by the latency of its
// permutations (about three a round for a deg-3 message), which is why it
// exists at all: it keeps the fused loop on the card without a round trip to
// the host per round.
//
// Design, simple first (a faster K6a is later work):
// - K6a: one thread per element i of the half-cube (a grid-stride loop over
//   at most MAX_BLOCKS blocks of THREADS), looping over the terms; the
//   column's nodes come from lo by adding hi - lo, so t never multiplies; the
//   term's value at each node is multiplied by its scalar and added to the
//   thread's deg + 1 ext sums, which stay in registers (deg is a template
//   parameter, 0..MAX_DEG). Each block reduces its threads' sums in shared
//   memory and writes them to a scratch row; a second launch of one block
//   adds the rows. Every sum is reduced mod p as it is made, never carried
//   unreduced in 64 bits (2^21 summands of up to 2^31 would overflow). Field
//   arithmetic is exact, so this order of summation gives the same bytes as
//   the reference's (and any other) order.
// - K6b: one thread per output word position (column, i), all four
//   components; the challenge r is read from device memory, so the fused
//   loop never brings it to the host. Mixed mode (base and ext banks in, the
//   merged ext bank out) drops the base sentinel and keeps the ext one, as
//   ceno_tpu_torch/sumcheck/terms.py fold_banks does.
// - K5/K7: one thread loads the sponge state, absorbs n words (add into
//   state[pos], permute when pos reaches RATE), then samples one ext
//   challenge (permute first when anything was absorbed since the last
//   permutation, or the squeeze window is used up) and writes it, and
//   optionally the challenge's powers alpha^0 .. alpha^(k-1), to device
//   memory: the rules of ceno_tpu_torch/hash/transcript.py. The absorb and
//   sample sequence is fixed, so the host keeps pos, sq_pos and absorbed and
//   passes them in.
//
// Every value a kernel stores is canonical, in [0, p). Kernels launch on the
// caller's stream and allocate nothing; each C entry point returns
// cudaErrorInvalidValue for arguments outside its limits, else
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"
#include "poseidon2.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;
constexpr int MAX_DEG = 8;       // terms of at most 8 factors (div's and the shard-RAM
                                 // chips' class mains; the single-shard main path's: 4)
constexpr int MAX_FACTORS = 16;  // DB + DE

__device__ __forceinline__ Ext ext_load(const uint32_t* __restrict__ bank, int64_t comp,
                                        int64_t at) {
  return {__ldg(bank + at), __ldg(bank + comp + at), __ldg(bank + 2 * comp + at),
          __ldg(bank + 3 * comp + at)};
}

__device__ __forceinline__ void ext_store(uint32_t* bank, int64_t comp, int64_t at, Ext v) {
  bank[at] = v.c0;
  bank[comp + at] = v.c1;
  bank[2 * comp + at] = v.c2;
  bank[3 * comp + at] = v.c3;
}

// Adds the K = (DEG + 1) * 4 words of every thread of the block; thread k < K
// writes word k of the block's sum to out[k]. blockDim.x must be THREADS.
template <int DEG>
__device__ __forceinline__ void block_sum(const Ext (&acc)[DEG + 1], uint32_t* out) {
  constexpr int K = (DEG + 1) * 4;
  __shared__ uint32_t sh[K * THREADS];
  const int t = threadIdx.x;
#pragma unroll
  for (int d = 0; d <= DEG; ++d) {
    sh[(4 * d) * THREADS + t] = acc[d].c0;
    sh[(4 * d + 1) * THREADS + t] = acc[d].c1;
    sh[(4 * d + 2) * THREADS + t] = acc[d].c2;
    sh[(4 * d + 3) * THREADS + t] = acc[d].c3;
  }
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int k = 0; k < K; ++k) sh[k * THREADS + t] = add(sh[k * THREADS + t], sh[k * THREADS + t + s]);
    }
    __syncthreads();
  }
  if (t < K) out[t] = sh[t * THREADS];
}

// K6a, first pass: block b's sums to partial[b * K .. b * K + K), word
// 4 * t + c the coefficient c of g(t).
template <int DEG>
__global__ void __launch_bounds__(THREADS)
round_evals_kernel(const uint32_t* __restrict__ base, const uint32_t* __restrict__ ext,
                   const int32_t* __restrict__ bidx, const int32_t* __restrict__ eidx,
                   const uint32_t* __restrict__ scalars, uint32_t* __restrict__ partial,
                   int64_t n, int64_t ext_cols, int n_terms, int db, int de) {
  const int64_t half = n / 2, comp = ext_cols * n;
  Ext acc[DEG + 1];
#pragma unroll
  for (int d = 0; d <= DEG; ++d) acc[d] = {0u, 0u, 0u, 0u};
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < half;
       i += static_cast<int64_t>(gridDim.x) * THREADS) {
    for (int term = 0; term < n_terms; ++term) {
      uint32_t pb[DEG + 1];
      Ext pe[DEG + 1];
      for (int k = 0; k < db; ++k) {
        const int64_t at = static_cast<int64_t>(__ldg(bidx + term * db + k)) * n + i;
        const uint32_t lo = __ldg(base + at), diff = sub(__ldg(base + at + half), lo);
        uint32_t v = lo;
#pragma unroll
        for (int d = 0; d <= DEG; ++d) {
          pb[d] = k == 0 ? v : mmul(pb[d], v);
          v = add(v, diff);
        }
      }
      for (int k = 0; k < de; ++k) {
        const int64_t at = static_cast<int64_t>(__ldg(eidx + term * de + k)) * n + i;
        const Ext lo = ext_load(ext, comp, at), diff = ext_sub(ext_load(ext, comp, at + half), lo);
        Ext v = lo;
#pragma unroll
        for (int d = 0; d <= DEG; ++d) {
          pe[d] = k == 0 ? v : ext_mul(pe[d], v);
          v = ext_add(v, diff);
        }
      }
      const Ext sc = {__ldg(scalars + term), __ldg(scalars + n_terms + term),
                      __ldg(scalars + 2 * n_terms + term), __ldg(scalars + 3 * n_terms + term)};
#pragma unroll
      for (int d = 0; d <= DEG; ++d) {
        Ext v;
        if (de == 0)
          v = {pb[d], 0u, 0u, 0u};
        else if (db == 0)
          v = pe[d];
        else
          v = ext_mul_base(pe[d], pb[d]);
        acc[d] = ext_add(acc[d], ext_mul(sc, v));
      }
    }
  }
  block_sum<DEG>(acc, partial + static_cast<int64_t>(blockIdx.x) * (DEG + 1) * 4);
}

// K6a, second pass: one block adds the blocks' rows into out ((DEG + 1), 4).
template <int DEG>
__global__ void __launch_bounds__(THREADS)
round_evals_reduce_kernel(const uint32_t* __restrict__ partial, uint32_t* __restrict__ out,
                          int blocks) {
  constexpr int K = (DEG + 1) * 4;
  Ext acc[DEG + 1];
#pragma unroll
  for (int d = 0; d <= DEG; ++d) acc[d] = {0u, 0u, 0u, 0u};
  for (int b = threadIdx.x; b < blocks; b += THREADS) {
    const uint32_t* row = partial + static_cast<int64_t>(b) * K;
#pragma unroll
    for (int d = 0; d <= DEG; ++d)
      acc[d] = ext_add(acc[d], {row[4 * d], row[4 * d + 1], row[4 * d + 2], row[4 * d + 3]});
  }
  block_sum<DEG>(acc, out);
}

template <int DEG>
void launch_round_evals(const uint32_t* base, const uint32_t* ext, const int32_t* bidx,
                        const int32_t* eidx, const uint32_t* scalars, uint32_t* partial,
                        uint32_t* out, int64_t n, int64_t ext_cols, int n_terms, int db, int de,
                        int blocks, cudaStream_t s) {
  round_evals_kernel<DEG><<<blocks, THREADS, 0, s>>>(base, ext, bidx, eidx, scalars, partial, n,
                                                     ext_cols, n_terms, db, de);
  round_evals_reduce_kernel<DEG><<<1, THREADS, 0, s>>>(partial, out, blocks);
}

// K6b: out (4, cb + ce1, n / 2) from base (cb + 1, n) and ext (4, ce1, n);
// output column c < cb folds base column c (its ext value lo + r (hi - lo)
// has components (lo + r0 d, r1 d, r2 d, r3 d)), column cb + j ext column j.
// blockIdx.y is the output column.
__global__ void __launch_bounds__(THREADS)
fold_kernel(const uint32_t* __restrict__ base, const uint32_t* __restrict__ ext,
            const uint32_t* __restrict__ r_ptr, uint32_t* __restrict__ out, int64_t n, int cb,
            int ce1) {
  const int64_t half = n / 2, out_comp = static_cast<int64_t>(cb + ce1) * half;
  const int c = blockIdx.y;
  const Ext r = {__ldg(r_ptr), __ldg(r_ptr + 1), __ldg(r_ptr + 2), __ldg(r_ptr + 3)};
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < half;
       i += static_cast<int64_t>(gridDim.x) * THREADS) {
    Ext v;
    if (c < cb) {
      const int64_t at = static_cast<int64_t>(c) * n + i;
      const uint32_t lo = __ldg(base + at), diff = sub(__ldg(base + at + half), lo);
      v = {add(lo, mmul(r.c0, diff)), mmul(r.c1, diff), mmul(r.c2, diff), mmul(r.c3, diff)};
    } else {
      const int64_t comp = static_cast<int64_t>(ce1) * n, at = static_cast<int64_t>(c - cb) * n + i;
      const Ext lo = ext_load(ext, comp, at);
      v = ext_add(lo, ext_mul(r, ext_sub(ext_load(ext, comp, at + half), lo)));
    }
    ext_store(out, out_comp, static_cast<int64_t>(c) * half + i, v);
  }
}

// K5/K7, one thread: absorb n_in words into the sponge, then (when out is not
// null) sample one ext challenge into out[0..3] and (when pows is not null)
// write its powers alpha^i into pows[c * pow_stride + i], i < n_pows.
__global__ void __launch_bounds__(1)
duplex_kernel(uint32_t* __restrict__ state, const uint32_t* __restrict__ in, int n_in,
              uint32_t* __restrict__ out, uint32_t* __restrict__ pows, int n_pows,
              int64_t pow_stride, int pos, int sq_pos, int absorbed) {
  uint32_t st[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) st[j] = state[j];
  for (int j = 0; j < n_in; ++j) {
    if (pos == RATE) {
      permute(st);
      pos = 0;
    }
    st[pos] = add(st[pos], in[j]);
    ++pos;
    absorbed = 1;
  }
  if (out != nullptr) {
    uint32_t v[4];
    for (int q = 0; q < 4; ++q) {
      if (absorbed || sq_pos == RATE) {  // (the host sets pos to 0 here too)
        permute(st);
        sq_pos = 0;
        absorbed = 0;
      }
      v[q] = st[sq_pos];
      ++sq_pos;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = v[q];
    if (pows != nullptr) {
      const Ext a = {v[0], v[1], v[2], v[3]};
      Ext cur = {MONTY_ONE, 0u, 0u, 0u};
      for (int i = 0; i < n_pows; ++i) {
        pows[i] = cur.c0;
        pows[pow_stride + i] = cur.c1;
        pows[2 * pow_stride + i] = cur.c2;
        pows[3 * pow_stride + i] = cur.c3;
        cur = ext_mul(cur, a);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) state[j] = st[j];
}

}  // namespace

// K6a: g(0..deg) of the terms over the banks into out ((deg + 1), 4).
// base (db + ... , n) may be null when db == 0. bidx (n_terms, db) and eidx
// (n_terms, de) int32 index the banks (the caller checks their range),
// scalars (4, n_terms); partial holds blocks * (deg + 1) * 4 words, blocks
// in [1, 1024] (the wrapper takes min(1024, ceil(n / 512))).
extern "C" int sc_round_evals(const void* base, const void* ext, const void* bidx,
                              const void* eidx, const void* scalars, void* partial, void* out,
                              int64_t n, int64_t ext_cols, int n_terms, int db, int de, int deg,
                              int blocks, void* stream) {
  if (n < 2 || n % 2 || ext_cols < 0 || n_terms < 0 || db < 0 || de < 0 ||
      db + de < 1 || db + de > MAX_FACTORS || deg < 0 || deg > MAX_DEG || blocks < 1 ||
      blocks > MAX_BLOCKS || (db > 0 && base == nullptr) || (de > 0 && ext == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* b = static_cast<const uint32_t*>(base);
  const auto* e = static_cast<const uint32_t*>(ext);
  const auto* bi = static_cast<const int32_t*>(bidx);
  const auto* ei = static_cast<const int32_t*>(eidx);
  const auto* sc = static_cast<const uint32_t*>(scalars);
  auto* pa = static_cast<uint32_t*>(partial);
  auto* o = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (deg) {
    case 0: launch_round_evals<0>(b, e, bi, ei, sc, pa, o, n, ext_cols, n_terms, db, de, blocks, s); break;
    case 1: launch_round_evals<1>(b, e, bi, ei, sc, pa, o, n, ext_cols, n_terms, db, de, blocks, s); break;
    case 2: launch_round_evals<2>(b, e, bi, ei, sc, pa, o, n, ext_cols, n_terms, db, de, blocks, s); break;
    case 3: launch_round_evals<3>(b, e, bi, ei, sc, pa, o, n, ext_cols, n_terms, db, de, blocks, s); break;
    case 4: launch_round_evals<4>(b, e, bi, ei, sc, pa, o, n, ext_cols, n_terms, db, de, blocks, s); break;
    case 5: launch_round_evals<5>(b, e, bi, ei, sc, pa, o, n, ext_cols, n_terms, db, de, blocks, s); break;
    case 6: launch_round_evals<6>(b, e, bi, ei, sc, pa, o, n, ext_cols, n_terms, db, de, blocks, s); break;
    case 7: launch_round_evals<7>(b, e, bi, ei, sc, pa, o, n, ext_cols, n_terms, db, de, blocks, s); break;
    default: launch_round_evals<8>(b, e, bi, ei, sc, pa, o, n, ext_cols, n_terms, db, de, blocks, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// K6b: fold every column by the ext challenge at r (4 words in device
// memory). Mixed mode (cb >= 0 base columns before their sentinel, base not
// null): base (cb + 1, n) and ext (4, ce1, n) -> out (4, cb + ce1, n / 2).
// Ext mode: base null and cb = 0, ext (4, ce1, n) -> out (4, ce1, n / 2).
extern "C" int sc_fold(const void* base, const void* ext, const void* r, void* out, int64_t n,
                       int cb, int ce1, void* stream) {
  if (n < 2 || n % 2 || cb < 0 || ce1 < 0 || cb + ce1 < 1 || cb + ce1 > 65535 ||
      (cb > 0 && base == nullptr) || (ce1 > 0 && ext == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t half = n / 2;
  const int64_t x = (half + THREADS - 1) / THREADS;
  dim3 grid(static_cast<unsigned>(x < MAX_BLOCKS ? x : MAX_BLOCKS), static_cast<unsigned>(cb + ce1));
  fold_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(base), static_cast<const uint32_t*>(ext),
      static_cast<const uint32_t*>(r), static_cast<uint32_t*>(out), n, cb, ce1);
  return static_cast<int>(cudaGetLastError());
}

// K5/K7: one duplex step on the 16-word Montgomery sponge at state (read and
// written in place): absorb in[0 .. n_in), then, when out is not null, sample
// one ext challenge into out and, when pows is not null, its n_pows powers.
// pos, sq_pos in [0, 8] and absorbed in {0, 1} are the host's bookkeeping
// before the step.
extern "C" int sc_duplex(void* state, const void* in, int n_in, void* out, void* pows,
                         int n_pows, int64_t pow_stride, int pos, int sq_pos, int absorbed,
                         void* stream) {
  if (state == nullptr || n_in < 0 || (n_in > 0 && in == nullptr) || pos < 0 || pos > RATE ||
      sq_pos < 0 || sq_pos > RATE || (absorbed != 0 && absorbed != 1) || n_pows < 0 ||
      (pows != nullptr && (out == nullptr || pow_stride < n_pows)))
    return static_cast<int>(cudaErrorInvalidValue);
  duplex_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(state), static_cast<const uint32_t*>(in), n_in,
      static_cast<uint32_t*>(out), static_cast<uint32_t*>(pows), n_pows, pow_stride, pos, sq_pos,
      absorbed);
  return static_cast<int>(cudaGetLastError());
}
