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
// products of the term's factors besides the sentinels, and per term and
// node one ext product by the term's scalar; it needs each column word once
// from device memory. At the main path's shapes it is bound by the integer
// multiplies, as the Poseidon2 kernels are (PERF.md has its bound and time).
// K6b reads and writes each word once: bound by bytes. K5/K7 works on one
// 16-word sponge: a few hundred bytes and a few permutations a launch, so no
// bound of bytes or operations binds it, but the latency of its dependent
// chain (the loads, then each permutation after the one before, then the
// stores) and the launch itself. It exists to keep the fused loop on the
// card without a round trip to the host per round.
//
// Design:
// - K6a: a grid of term chunks (x) by ranges of the half-cube (y), its plan
//   chosen on the host (ceno_tpu_torch/sumcheck/terms.py round_evals_plan).
//   A block's THREADS threads are t_lanes term slots of e_lanes threads; a
//   short bank (the secp guest's class: one element, 39,422 terms) fills the
//   card from its terms, a long one (a tower level: 2^20 elements, 10 terms)
//   from its elements, and the chunks of one range run side by side (x is
//   the fast axis), so a column they share comes from L2. Each thread sums
//   its one term's product over its elements at the nodes t = 0..deg (a
//   column's nodes come from lo by adding hi - lo, so t never multiplies)
//   and multiplies the deg + 1 sums by the term's scalar once: the sum
//   distributes. A factor that names its bank's ones sentinel is dropped
//   (no padding product). The block first copies its chunk's factor table,
//   sentinels removed, into shared memory; then each thread reads its
//   factors from the banks. The term slots of a block walk the same
//   elements together, so a column that several of its terms read (eq at
//   every tower term) comes from L1 after the first; staging tiles of the
//   columns in shared memory measured slower at every narrow bank (48 KB
//   of static shared memory holds two elements a thread of a tower level's
//   18 columns; PERF.md). deg is a template parameter (0..MAX_DEG): the
//   deg + 1 products and sums stay in registers. Each block reduces its
//   threads' products in shared memory into a scratch row; a second launch
//   of one block adds the rows. Every sum is reduced mod p as it is made,
//   never carried unreduced in 64 bits (2^21 summands of up to 2^31 would
//   overflow). Field arithmetic is exact, so this order of summation gives
//   the same bytes as the reference's (and any other) order.
// - K6b: one thread per output word position (column, i), all four
//   components; the challenge r is read from device memory, so the fused
//   loop never brings it to the host. Mixed mode (base and ext banks in, the
//   merged ext bank out) drops the base sentinel and keeps the ext one, as
//   ceno_tpu_torch/sumcheck/terms.py fold_banks does.
// - K5/K7: one warp, <<<1, 32>>>. It absorbs n words (add into word pos,
//   permute when pos reaches RATE), then samples one ext challenge (permute
//   first when anything was absorbed since the last permutation, or the
//   squeeze window is used up) and writes it, and optionally the challenge's
//   powers alpha^0 .. alpha^(k-1), to device memory: the rules of
//   ceno_tpu_torch/hash/transcript.py. The absorb and sample sequence is
//   fixed, so the host keeps pos, sq_pos and absorbed and passes them in.
//   Against the latency: the state and every absorbed word are loaded at
//   the start, all at once and coalesced (the words into shared memory, up
//   to DUPLEX_TILE of them; a longer absorb takes them a tile at a time), so
//   no device-memory read waits between two permutations; lane i holds
//   state word i in a register (lanes 16-31 a copy), never an array indexed
//   at run time, and the permutation runs on the 16 lanes
//   (csrc/poseidon2.cuh permute_warp), each lane its own word's S-box and
//   products; a chunk of words goes into the state at once, each lane
//   adding the word that falls on its slot; lane i computes alpha^i by a
//   prefix product over the lanes (five ext products deep), and the powers
//   past 32 follow by alpha^32. Every shuffle is in warp-uniform control
//   flow.
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
constexpr int MAX_BLOCKS = 1024;  // K6b: blocks along the elements
constexpr int MAX_DEG = 8;       // terms of at most 8 factors (div's and the shard-RAM
                                 // chips' class mains; the single-shard main path's: 4)
constexpr int MAX_FACTORS = 16;  // DB + DE
constexpr int TABLE_WORDS = 2048;  // K6a: a chunk's factor rows, t_lanes * (DB + DE) words
constexpr int MAX_RANGES = 65535;  // K6a: element ranges (the grid's second axis)
constexpr int DUPLEX_TILE = 1024;  // K5/K7: absorbed words staged in shared memory at once

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

// Adds the K = (DEG + 1) * 4 words of every thread of the block in sh (at
// least K * THREADS words of shared memory); thread k < K writes word k of the
// block's sum to out[k]. blockDim.x must be THREADS.
template <int DEG>
__device__ __forceinline__ void block_sum(const Ext (&acc)[DEG + 1], uint32_t* sh,
                                          uint32_t* out) {
  constexpr int K = (DEG + 1) * 4;
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

// K6a's banks: a column's lo and diff = hi - lo at element e of the
// half-cube.
struct Banks {
  const uint32_t* __restrict__ base;
  const uint32_t* __restrict__ ext;
  int64_t n, half, comp;
  __device__ __forceinline__ void base_at(int c, int64_t e, uint32_t& lo, uint32_t& diff) const {
    const int64_t at = static_cast<int64_t>(c) * n + e;
    lo = __ldg(base + at);
    diff = sub(__ldg(base + at + half), lo);
  }
  __device__ __forceinline__ void ext_at(int c, int64_t e, Ext& lo, Ext& diff) const {
    const int64_t at = static_cast<int64_t>(c) * n + e;
    lo = ext_load(ext, comp, at);
    diff = ext_sub(ext_load(ext, comp, at + half), lo);
  }
};

// Adds one term's product at element e, at the nodes t = 0..DEG, to s. row
// holds the term's factors without the sentinels: nb base columns, then (from
// row[db]) ne ext columns. The nodes of a column are lo, lo + diff, ...: t
// never multiplies. A term of sentinels only is one at every node.
template <int DEG>
__device__ __forceinline__ void add_term(Ext (&s)[DEG + 1], const Banks& banks,
                                         const int32_t* row, int nb, int ne, int db, int64_t e) {
  uint32_t pb[DEG + 1];
  if (nb > 0) {
    uint32_t lo, diff;
    banks.base_at(row[0], e, lo, diff);
#pragma unroll
    for (int d = 0; d <= DEG; ++d) {
      pb[d] = lo;
      lo = add(lo, diff);
    }
    for (int k = 1; k < nb; ++k) {
      banks.base_at(row[k], e, lo, diff);
#pragma unroll
      for (int d = 0; d <= DEG; ++d) {
        pb[d] = mmul(pb[d], lo);
        lo = add(lo, diff);
      }
    }
  }
  if (ne > 0) {
    Ext pe[DEG + 1], lo, diff;
    banks.ext_at(row[db], e, lo, diff);
    if (nb > 0) {
#pragma unroll
      for (int d = 0; d <= DEG; ++d) {
        pe[d] = ext_mul_base(lo, pb[d]);
        lo = ext_add(lo, diff);
      }
    } else {
#pragma unroll
      for (int d = 0; d <= DEG; ++d) {
        pe[d] = lo;
        lo = ext_add(lo, diff);
      }
    }
    for (int k = 1; k < ne; ++k) {
      banks.ext_at(row[db + k], e, lo, diff);
#pragma unroll
      for (int d = 0; d <= DEG; ++d) {
        pe[d] = ext_mul(pe[d], lo);
        lo = ext_add(lo, diff);
      }
    }
#pragma unroll
    for (int d = 0; d <= DEG; ++d) s[d] = ext_add(s[d], pe[d]);
  } else {
#pragma unroll
    for (int d = 0; d <= DEG; ++d) s[d].c0 = add(s[d].c0, nb > 0 ? pb[d] : MONTY_ONE);
  }
}

// K6a's blocks a multiprocessor the compiler keeps registers for. The
// kernel waits on its loads, so at deg <= 4 (every main-path shape but the
// shard-RAM chips') more resident warps pay for fewer registers a thread,
// some of them spilled (PERF.md has the measurement).
#ifndef K6A_MIN_BLOCKS_DEG3
#define K6A_MIN_BLOCKS_DEG3 4  // deg <= 3: 64 registers
#endif
#ifndef K6A_MIN_BLOCKS_DEG4
#define K6A_MIN_BLOCKS_DEG4 3  // deg 4: 80 registers
#endif

// K6a, first pass. Block (x, y) takes the chunk of t_lanes terms from
// x * t_lanes and the y-th of gridDim.y equal ranges of the half-cube; thread
// (slot, lane) = (tid / e_lanes, tid % e_lanes) sums its term slot's product
// over the range's elements lane, lane + e_lanes, ..., multiplies the (DEG +
// 1) sums by the term's scalar once, and the block's sums go to partial row
// y * gridDim.x + x (word 4 * t + c the coefficient c of g(t)).
template <int DEG>
__global__ void __launch_bounds__(THREADS, DEG <= 3 ? K6A_MIN_BLOCKS_DEG3
                                               : DEG == 4 ? K6A_MIN_BLOCKS_DEG4 : 1)
round_evals_kernel(const uint32_t* __restrict__ base, const uint32_t* __restrict__ ext,
                   const int32_t* __restrict__ bidx, const int32_t* __restrict__ eidx,
                   const uint32_t* __restrict__ scalars, uint32_t* __restrict__ partial,
                   int64_t n, int base_cols, int ext_cols, int n_terms, int db, int de,
                   int t_lanes, int e_lanes) {
  constexpr int K = (DEG + 1) * 4;
  __shared__ uint32_t sm[TABLE_WORDS > K * THREADS ? TABLE_WORDS : K * THREADS];  // table, then block_sum
  __shared__ int counts[THREADS];  // a slot's nb | ne << 16
  const int dbe = db + de, slot = threadIdx.x / e_lanes, lane = threadIdx.x % e_lanes;
  const int term = blockIdx.x * t_lanes + slot;
  const bool active = slot < t_lanes && term < n_terms;
  auto* table = reinterpret_cast<int32_t*>(sm);  // slot's row at table[slot * dbe]
  if (active && lane == 0) {
    int32_t* row = table + slot * dbe;
    int nb = 0, ne = 0;
    for (int k = 0; k < db; ++k) {
      const int32_t c = __ldg(bidx + static_cast<int64_t>(term) * db + k);
      if (c != base_cols - 1) row[nb++] = c;
    }
    for (int k = 0; k < de; ++k) {
      const int32_t c = __ldg(eidx + static_cast<int64_t>(term) * de + k);
      if (c != ext_cols - 1) row[db + ne++] = c;
    }
    counts[slot] = nb | ne << 16;
  }
  __syncthreads();
  const int64_t half = n / 2, span = (half + gridDim.y - 1) / gridDim.y;
  const int64_t start = static_cast<int64_t>(blockIdx.y) * span;
  const int64_t end = start + span < half ? start + span : half;
  Ext acc[DEG + 1];
  if (active) {
    const Banks banks{base, ext, n, half, static_cast<int64_t>(ext_cols) * n};
    const int32_t* row = table + slot * dbe;
    const int nb = counts[slot] & 0xffff, ne = counts[slot] >> 16;
    Ext s[DEG + 1];
#pragma unroll
    for (int d = 0; d <= DEG; ++d) s[d] = {0u, 0u, 0u, 0u};
    for (int64_t e = start + lane; e < end; e += e_lanes) add_term<DEG>(s, banks, row, nb, ne, db, e);
    const Ext sc = {__ldg(scalars + term), __ldg(scalars + n_terms + term),
                    __ldg(scalars + 2 * n_terms + term), __ldg(scalars + 3 * n_terms + term)};
#pragma unroll
    for (int d = 0; d <= DEG; ++d) acc[d] = ext_mul(sc, s[d]);
  } else {
#pragma unroll
    for (int d = 0; d <= DEG; ++d) acc[d] = {0u, 0u, 0u, 0u};
  }
  __syncthreads();  // the table is read; block_sum reuses sm
  block_sum<DEG>(acc, sm, partial + (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * K);
}

// K6a, second pass: one block adds the rows into out ((DEG + 1), 4).
template <int DEG>
__global__ void __launch_bounds__(THREADS)
round_evals_reduce_kernel(const uint32_t* __restrict__ partial, uint32_t* __restrict__ out,
                          int64_t rows) {
  constexpr int K = (DEG + 1) * 4;
  __shared__ uint32_t sh[K * THREADS];
  Ext acc[DEG + 1];
#pragma unroll
  for (int d = 0; d <= DEG; ++d) acc[d] = {0u, 0u, 0u, 0u};
  for (int64_t b = threadIdx.x; b < rows; b += THREADS) {
    const uint32_t* row = partial + b * K;
#pragma unroll
    for (int d = 0; d <= DEG; ++d)
      acc[d] = ext_add(acc[d], {row[4 * d], row[4 * d + 1], row[4 * d + 2], row[4 * d + 3]});
  }
  block_sum<DEG>(acc, sh, out);
}

// The argument of both K6a launches.
struct EvalArgs {
  const uint32_t *base, *ext;
  const int32_t *bidx, *eidx;
  const uint32_t* scalars;
  uint32_t *partial, *out;
  int64_t n;
  int base_cols, ext_cols, n_terms, db, de, t_lanes, e_lanes, chunks, ranges;
};

template <int DEG>
void launch_round_evals(const EvalArgs& a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(a.chunks), static_cast<unsigned>(a.ranges));
  round_evals_kernel<DEG><<<grid, THREADS, 0, s>>>(a.base, a.ext, a.bidx, a.eidx, a.scalars,
                                                   a.partial, a.n, a.base_cols, a.ext_cols,
                                                   a.n_terms, a.db, a.de, a.t_lanes, a.e_lanes);
  round_evals_reduce_kernel<DEG><<<1, THREADS, 0, s>>>(
      a.partial, a.out, static_cast<int64_t>(a.chunks) * a.ranges);
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

__device__ __forceinline__ Ext ext_shfl(Ext v, int src) {
  return {__shfl_sync(WARP_ALL, v.c0, src), __shfl_sync(WARP_ALL, v.c1, src),
          __shfl_sync(WARP_ALL, v.c2, src), __shfl_sync(WARP_ALL, v.c3, src)};
}

// K5/K7, one warp: absorb n_in words into the sponge, then (when out is not
// null) sample one ext challenge into out[0..3] and (when pows is not null)
// write its powers alpha^i into pows[c * pow_stride + i], i < n_pows. Every
// loop and every branch around a shuffle or a permutation depends on the
// arguments only, so the warp takes it together.
__global__ void __launch_bounds__(32)
duplex_kernel(uint32_t* __restrict__ state, const uint32_t* __restrict__ in, int n_in,
              uint32_t* __restrict__ out, uint32_t* __restrict__ pows, int n_pows,
              int64_t pow_stride, int pos, int sq_pos, int absorbed) {
  __shared__ uint32_t words[DUPLEX_TILE];
  const int lane = threadIdx.x, i = lane & (WIDTH - 1);
  uint32_t x = state[i];
  const uint32_t diag = DIAG[i];
  for (int t0 = 0; t0 < n_in; t0 += DUPLEX_TILE) {
    const int n = n_in - t0 < DUPLEX_TILE ? n_in - t0 : DUPLEX_TILE;
    __syncwarp();  // the last tile is read
#pragma unroll 4
    for (int k = lane; k < n; k += 32) words[k] = __ldg(in + t0 + k);
    __syncwarp();
    // chunks of up to RATE - pos words, word j + (i - pos) on slot i
    for (int j = 0; j < n;) {
      if (pos == RATE) {
        x = permute_warp(x, diag, lane);
        pos = 0;
      }
      const int m = RATE - pos < n - j ? RATE - pos : n - j;
      if (i >= pos && i < pos + m) x = add(x, words[j + i - pos]);
      pos += m;
      j += m;
    }
    absorbed = 1;
  }
  if (out != nullptr) {
    uint32_t c = 0u;  // lane q < 4: challenge word q
    for (int q = 0; q < 4; ++q) {
      if (absorbed || sq_pos == RATE) {  // (the host sets pos to 0 here too)
        x = permute_warp(x, diag, lane);
        sq_pos = 0;
        absorbed = 0;
      }
      const uint32_t w = __shfl_sync(WARP_ALL, x, sq_pos);
      c = lane == q ? w : c;
      ++sq_pos;
    }
    if (lane < 4) out[lane] = c;
    if (pows != nullptr && n_pows > 0) {
      const Ext a = {__shfl_sync(WARP_ALL, c, 0), __shfl_sync(WARP_ALL, c, 1),
                     __shfl_sync(WARP_ALL, c, 2), __shfl_sync(WARP_ALL, c, 3)};
      // lane l: the product of lane 0's one and lanes 1..l's alpha = alpha^l
      Ext p = lane == 0 ? Ext{MONTY_ONE, 0u, 0u, 0u} : a;
      for (int d = 1; d < 32; d <<= 1) {
        const Ext below = ext_shfl(p, lane >= d ? lane - d : lane);
        const Ext prod = ext_mul(p, below);
        p = lane >= d ? prod : p;
      }
      const Ext a32 = ext_mul(ext_shfl(p, 31), a);
      for (int b = 0; b < n_pows; b += 32) {
        if (b + lane < n_pows) {
          pows[b + lane] = p.c0;
          pows[pow_stride + b + lane] = p.c1;
          pows[2 * pow_stride + b + lane] = p.c2;
          pows[3 * pow_stride + b + lane] = p.c3;
        }
        if (b + 32 < n_pows) p = ext_mul(p, a32);
      }
    }
  }
  if (lane < WIDTH) state[lane] = x;
}

}  // namespace

// K6a: g(0..deg) of the terms over the banks into out ((deg + 1), 4).
// base (base_cols, n) may be null when db == 0; ext (4, ext_cols, n). The last
// column of each bank is the ones sentinel: a factor that names it is taken as
// one and not read. bidx (n_terms, db) and eidx (n_terms, de) int32 index the
// banks (the caller checks their range), scalars (4, n_terms). The plan
// (ceno_tpu_torch/sumcheck/terms.py round_evals_plan): chunks of t_lanes terms
// times ranges of the half-cube blocks, e_lanes threads a term. partial holds
// chunks * ranges * (deg + 1) * 4 words.
extern "C" int sc_round_evals(const void* base, const void* ext, const void* bidx,
                              const void* eidx, const void* scalars, void* partial, void* out,
                              int64_t n, int base_cols, int ext_cols, int n_terms, int db, int de,
                              int deg, int t_lanes, int e_lanes, int chunks, int ranges,
                              void* stream) {
  if (n < 2 || n % 2 || ext_cols < 1 || n_terms < 0 || db < 0 || de < 0 ||
      db + de < 1 || db + de > MAX_FACTORS || deg < 0 || deg > MAX_DEG ||
      (db > 0 && (base == nullptr || base_cols < 1)) || (de > 0 && ext == nullptr) ||
      t_lanes < 1 || e_lanes < 1 || t_lanes * e_lanes > THREADS || chunks < 1 || ranges < 1 ||
      ranges > MAX_RANGES || static_cast<int64_t>(chunks) * t_lanes < n_terms ||
      t_lanes * (db + de) > TABLE_WORDS)
    return static_cast<int>(cudaErrorInvalidValue);
  const EvalArgs a{static_cast<const uint32_t*>(base), static_cast<const uint32_t*>(ext),
                   static_cast<const int32_t*>(bidx), static_cast<const int32_t*>(eidx),
                   static_cast<const uint32_t*>(scalars), static_cast<uint32_t*>(partial),
                   static_cast<uint32_t*>(out), n, base_cols, ext_cols, n_terms, db, de,
                   t_lanes, e_lanes, chunks, ranges};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (deg) {
    case 0: launch_round_evals<0>(a, s); break;
    case 1: launch_round_evals<1>(a, s); break;
    case 2: launch_round_evals<2>(a, s); break;
    case 3: launch_round_evals<3>(a, s); break;
    case 4: launch_round_evals<4>(a, s); break;
    case 5: launch_round_evals<5>(a, s); break;
    case 6: launch_round_evals<6>(a, s); break;
    case 7: launch_round_evals<7>(a, s); break;
    default: launch_round_evals<8>(a, s); break;
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
// before the step. One block of one warp.
extern "C" int sc_duplex(void* state, const void* in, int n_in, void* out, void* pows,
                         int n_pows, int64_t pow_stride, int pos, int sq_pos, int absorbed,
                         void* stream) {
  if (state == nullptr || n_in < 0 || (n_in > 0 && in == nullptr) || pos < 0 || pos > RATE ||
      sq_pos < 0 || sq_pos > RATE || (absorbed != 0 && absorbed != 1) || n_pows < 0 ||
      (pows != nullptr && (out == nullptr || pow_stride < n_pows)))
    return static_cast<int>(cudaErrorInvalidValue);
  duplex_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(state), static_cast<const uint32_t*>(in), n_in,
      static_cast<uint32_t*>(out), static_cast<uint32_t*>(pows), n_pows, pow_stride, pos, sq_pos,
      absorbed);
  return static_cast<int>(cudaGetLastError());
}
