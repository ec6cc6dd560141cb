// Poseidon2-16 Merkle kernels over BabyBear for Hopper (sm_90a).
//
// K1 p2_leaf_sponge replaces the TPU kernel ceno_tpu/hash/poseidon2_pallas.py
//    leaf_sponge (pallas_call at :124, body _leaf_kernel :99): a (C, M)
//    Montgomery codeword -> (8, M) leaf digests, ceil(C/8) rate-8 absorbs per
//    lane, each followed by a full permutation.
// K2 p2_merkle_levels replaces compress_level (pallas_call at :160, body
//    _compress_kernel :138), which the reference calls once per level
//    (ceno_tpu/pcs/merkle.py): every level of one Merkle tree, (8, m) leaves
//    -> (8, m/2), ..., (8, 1), parent i = permute(child 2i || child 2i+1)[:8],
//    in one host call and a few launches (below).
//
// What bounds them on this card: the integer pipes. A permutation does 772
// Montgomery products (8 external rounds x 16 S-boxes x 4, 13 internal rounds
// x (4 + 16 diagonal)), plus one per internal round for 15 * s below, three
// 32-bit multiplies each, and about 1,300 modular additions, against 16
// words read and 8 written per lane for K2 (C + 8 words per lane for K1).
// The stated bound counts the multiplies only, at the 64 per clock per SM of
// cc 9.0: 4.645 ms for K1 at the witness commit (61, 2^22), where this
// design takes about 10.5 ms (PERF.md). In SASS a product is IMAD.WIDE +
// IMAD + IMAD.HI on the multiply-add pipe plus one or two ALU instructions;
// an addition is IADD3 + VIADDMNMX. Per permutation ptxas emits about 2,360
// multiplies, 760 non-multiplying IMADs and 2,880 other integer ALU
// instructions, against 2,320, 1,500 and 7,070 for the compare-and-select
// core this one replaced. The ALU pipe set that core's pace; here the
// multiply-add pipe, which also takes the IMADs that ptxas uses as adds,
// holds more instructions than the ALU pipe. The design spends as few
// instructions per field operation as it can:
//
// - add: s = a + b, then min(s, s - p) unsigned (a, b < p, so s < 2p < 2^32;
//   when s < p, s - p wraps above s). No compare and select.
// - mmul: subtractive Montgomery REDC. With m = lo * p^-1 mod 2^32 the low
//   words of a*b and m*p agree, so r = hi(a*b) - hi(m*p) = (a*b - m*p) / 2^32
//   exactly, and r lies in (-p, p) whenever a*b < p * 2^32; min(r, r + p)
//   unsigned makes it canonical. mmul_lazy returns r + p in (0, 2p) instead.
// - lazy ranges: a value in [0, 2p) may be one operand of a product whose
//   other operand is in [0, p), since 2p * p < p * 2^32. The S-box keeps x^4
//   and x^6 in [0, 2p); the internal rounds keep st[1..15] in [0, 2p) (each is
//   a canonical product plus a canonical sum, stored unreduced) and carry
//   their sum as sum(products) + 15 * s instead of re-adding the state. Sums
//   of three or more reduced values would overflow 32 bits (2^32 / p ~ 2.13),
//   so every other addition reduces.
// - M4 in 11 additions (t01, t23, t0123, t0123 + x1, t0123 + x3, ...) as in
//   Plonky3, against 15 for s + x_i + 2 x_{i+1}; the outer circulant adds the
//   four block products once (12) and each block once more (16).
// - The round loops stay loops, with the round constant fetched by index.
//   Expanding them at compile time (a fold over std::integer_sequence, which
//   cicc compiles) turns every constant into an operand but made K1 slower on
//   the card: 12.7 ms against 11.1 ms with all rounds expanded, 10.7 against
//   10.5 with the internal rounds only, as ~100 KB of code per kernel no
//   longer sits in the instruction cache. No loop carries `#pragma unroll` on
//   the rounds: with it, cicc of CUDA 12.9 crashes (segmentation fault) on
//   this file. The 16-wide state loops do carry it; that form compiles.
// - __launch_bounds__(256, 1): with the minimum of one block per SM stated,
//   ptxas gives K1 56 registers (no spills), and K1 ran faster than with 44
//   or fewer (6 or 8 blocks per SM, which spill). K2's kernels state
//   (512, 1): 44 and 42 registers, no spills.
//
// Layout: one Poseidon2 state per thread, kept in 16 registers through all
// rounds. Threads walk along M, so each column read and each digest write is
// coalesced across a warp. K1 loads the next absorb's (up to) 8 columns into
// registers before it permutes the current state, so the loads overlap the
// arithmetic. Kernels launch on the caller's stream and allocate nothing;
// each C entry point returns cudaGetLastError().
//
// K2. A tree's time has two parts. The large levels run at K1's rate per
// permutation (about 0.315 ns on the card, all SMs busy). A level too small
// to fill the card takes at least one permutation's latency: about 7.9 us
// with one thread per permutation, the step from one tree to the next larger
// one when a single block builds the whole tree. A 2^22 tree has about 13
// such levels; one launch per level (the design this one replaced) also
// paid a launch and a host call for each. p2_merkle_levels runs a plan of
// launches that the caller computes (merkle_plan in hash/poseidon2_merkle.py),
// on its stream, in one call:
// - levels of more than 2^14 parents: merkle_levels_kernel, one thread per
//   parent, 256 threads a block, two levels a launch (the second in 4 of the
//   8 warps, its children from shared memory);
// - smaller levels: merkle_levels_split_kernel, four threads per parent
//   (permute_split: about 4.1 us a level), 512 threads a block, up to 8
//   levels a launch while a level has more than 128 digests; then one block
//   of 256 threads takes the last 7 levels to the root.
// Every level goes to one buffer, from which the openings gather. A 2^22
// tree takes 6 launches (22 before), the PCS slice 72 (371). The plan was
// chosen by timing about 150 of them in turns (tools/torch_p2_cores.py, on
// an H100 80GB HBM3 at 700 W; PERF.md has the tables). Bare launches over
// the 2^22 / 2^19 / 2^21 trees take 1.414 / 0.248 / 0.759 ms, against
// 1.548 / 0.367 / 0.883 for one launch per level. With one thread per
// parent throughout and 256 threads a block, 1, 2, 3, 4 and 6 levels a
// launch took 1.524, 1.482, 1.491, 1.513 and 1.625 ms over the 2^22 tree:
// the narrowing levels leave warps idle. The 28 split plans tried (split at 2^13 to 2^15 parents,
// 32 to 512 threads a block, a top block of 16 to 256 digests) took
// 1.426-1.465 ms over the 2^22 tree and 0.252-0.293 ms over the 2^19 tree.
// Running the split permutation on every warp of a block, so that ptxas
// drops its WARPSYNC.COLLECTIVE fallback around each shuffle, gained 11% on
// a 16-leaf tree and lost 9% on the 2^19 tree, where the idle warps take
// issue slots.
//
// The field helpers (add, dbl, reduce, mmul, mmul_lazy) live in
// csrc/babybear.cuh and the one-thread permutation with its tables in
// csrc/poseidon2.cuh, which csrc/sumcheck.cu shares. The tables are the
// Montgomery forms of RC_EXTERNAL, RC_INTERNAL and INTERNAL_DIAG in
// ceno_tpu_torch/hash/poseidon2.py (checked, with P, PINV, PINV_POS and
// MONTY_15, by tests/test_torch_poseidon2.py); each arithmetic step is
// modelled in Python and checked by tests/test_torch_p2_kernel_arith.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"
#include "poseidon2.cuh"

namespace {

__global__ void __launch_bounds__(256, 1)
leaf_sponge_kernel(const uint32_t* __restrict__ cols, uint32_t* __restrict__ out,
                   int n_cols, int64_t m) {
  int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= m) return;
  uint32_t st[WIDTH], next[RATE];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) st[i] = 0u;
#pragma unroll
  for (int j = 0; j < RATE; ++j) next[j] = j < n_cols ? __ldg(cols + j * m + lane) : 0u;
  int absorbs = n_cols > 0 ? (n_cols + RATE - 1) / RATE : 1;
  for (int a = 0; a < absorbs; ++a) {
#pragma unroll
    for (int j = 0; j < RATE; ++j) st[j] = add(st[j], next[j]);  // a missing column adds 0
    int off = (a + 1) * RATE;
    if (a + 1 < absorbs) {
#pragma unroll
      for (int j = 0; j < RATE; ++j)
        next[j] = off + j < n_cols ? __ldg(cols + (off + j) * m + lane) : 0u;
    }
    permute(st);
  }
#pragma unroll
  for (int j = 0; j < DIGEST; ++j) out[j * m + lane] = st[j];
}

// The same permutation spread over the four threads of an aligned group,
// for the levels too small to fill the card, where a level takes one
// permutation's latency. Thread q of the group holds state words 4q .. 4q + 3
// (one M4 block) in x[0..3], so it runs a quarter of the S-boxes and
// products, and a sum over the blocks is two shuffle steps. Three things
// shorten the dependent chain further:
// - the S-box computes x^2, then x^3 and x^4 side by side, then x^4 * x^3:
//   three products deep instead of four;
// - through the internal rounds every thread keeps its own copy z of state
//   word 0 and runs that round's S-box on it, so no thread waits for a
//   broadcast; the shuffles sum words 1..15 while the S-box runs;
// - the four diagonal entries a thread needs sit in registers, and each
//   round's four constants (a different four in each thread) are loaded a
//   round ahead.
// Every value between steps is in [0, p). All 32 threads of the warp call it
// together, and the shuffles name the full warp. (ptxas still emits a
// WARPSYNC.COLLECTIVE fallback beside each shuffle, as the kernel's test for
// an idle warp is not provably uniform; the fast path runs.)
__device__ __forceinline__ uint32_t group_sum(uint32_t v) {
  v = add(v, __shfl_xor_sync(0xffffffffu, v, 1, 4));
  return add(v, __shfl_xor_sync(0xffffffffu, v, 2, 4));
}

// x^7; x in [0, p) -> [0, p)
__device__ __forceinline__ uint32_t sbox_shallow(uint32_t x) {
  uint32_t x2 = mmul(x, x);         // [0, p)
  uint32_t x3 = mmul(x2, x);        // [0, p)
  uint32_t x4 = mmul_lazy(x2, x2);  // [0, 2p)
  return mmul(x4, x3);              // x4 < 2p, x3 < p: [0, p)
}

__device__ __forceinline__ void external_linear_split(uint32_t (&x)[4]) {
  mat4(x);
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = add(x[k], group_sum(x[k]));
}

__device__ __forceinline__ void external_rounds_split(uint32_t (&x)[4], int q, int r0) {
  uint32_t rc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) rc[k] = RC_EXT[r0][4 * q + k];
  for (int r = r0; r < r0 + ROUNDS_F / 2; ++r) {
    uint32_t next[4];
    const int rn = r + 1 < ROUNDS_F ? r + 1 : r;
#pragma unroll
    for (int k = 0; k < 4; ++k) next[k] = RC_EXT[rn][4 * q + k];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = sbox_shallow(add(x[k], rc[k]));
    external_linear_split(x);
#pragma unroll
    for (int k = 0; k < 4; ++k) rc[k] = next[k];
  }
}

__device__ __forceinline__ void permute_split(uint32_t (&x)[4], int q) {
  uint32_t d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = DIAG[4 * q + k];
  external_linear_split(x);
  external_rounds_split(x, q, 0);
  uint32_t z = __shfl_sync(0xffffffffu, x[0], 0, 4);  // state word 0, in every thread
  uint32_t rc = RC_INT[0];
  for (int r = 0; r < ROUNDS_P; ++r) {
    const uint32_t rc_next = RC_INT[r + 1 < ROUNDS_P ? r + 1 : r];
    uint32_t s0 = sbox_shallow(add(z, rc));
    uint32_t own = add(x[1], add(x[2], x[3]));
    uint32_t s = add(group_sum(q == 0 ? own : add(own, x[0])), s0);  // all 16 words
    z = add(mmul(s0, DIAG[0]), s);
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = add(mmul(x[k], d[k]), s);  // thread 0's x[0]: z
    rc = rc_next;
  }
  x[0] = q == 0 ? z : x[0];
  external_rounds_split(x, q, ROUNDS_F / 2);
}

constexpr int K2_MAX_THREADS = 512;

// Dynamic shared memory of a K2 block whose first level has n parents, in
// words: two buffers (levels alternate between them, so one barrier per level
// suffices), each holding one level's parents as [parity][component][i / 2],
// the odd array 8 (n / 2) + 16 words after the even one. In the kernel with
// one thread per parent, thread i writes parent i to parity i & 1, so the 16
// even lanes of a warp hit banks k and the 16 odd lanes banks k + 16 (n >= 8);
// thread k of the next level reads children 2k and 2k + 1 as word k of each
// parity, consecutive banks across the warp. No access conflicts. 16.6 KB at
// n = 256, 33 KB at n = 512.
__host__ __device__ constexpr int k2_parity_words(int parents) {
  return DIGEST * (parents / 2) + 16;
}

__global__ void __launch_bounds__(K2_MAX_THREADS, 1)
merkle_levels_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                     int64_t half, int levels) {
  extern __shared__ uint32_t sh[];
  const int t = threadIdx.x, row = blockDim.x / 2, parity = k2_parity_words(blockDim.x);
  const uint2* pairs = reinterpret_cast<const uint2*>(in);
  int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x;  // block's first parent
  int64_t width = half;                                          // parents in the level
  uint32_t st[WIDTH];
  for (int l = 0; l < levels; ++l) {
    const bool live = t < (static_cast<int>(blockDim.x) >> l) && first + t < width;
    if (live) {
      if (l == 0) {
#pragma unroll
        for (int j = 0; j < DIGEST; ++j) {
          uint2 v = __ldg(pairs + j * width + first + t);
          st[j] = v.x;
          st[DIGEST + j] = v.y;
        }
      } else {
        const uint32_t* src = sh + ((l + 1) & 1) * 2 * parity;  // written by level l - 1
#pragma unroll
        for (int j = 0; j < DIGEST; ++j) {
          st[j] = src[j * row + t];
          st[DIGEST + j] = src[parity + j * row + t];
        }
      }
      permute(st);
#pragma unroll
      for (int j = 0; j < DIGEST; ++j) out[j * width + first + t] = st[j];
      if (l + 1 < levels) {
        uint32_t* dst = sh + (l & 1) * 2 * parity + (t & 1) * parity + (t >> 1);
#pragma unroll
        for (int j = 0; j < DIGEST; ++j) dst[j * row] = st[j];
      }
    }
    out += DIGEST * width;
    width >>= 1;
    first >>= 1;
    if (l + 1 < levels) __syncthreads();
  }
}

// merkle_levels_kernel with four threads per parent (permute_split): block b
// owns parents [b n0, (b + 1) n0) of the first level, thread 4i + q holding
// words 4q .. 4q + 3 of parent i's state, that is words 4 (q & 1) ..
// 4 (q & 1) + 3 of child 2i + (q >> 1). Threads 4i and 4i + 1 hold the
// parent's digest and write it. The block has max(4 n0, 32) threads; a warp
// with any parent left runs the permutation on all its threads (the shuffles
// name them all), one without stays idle. half must be a multiple of n0.
__global__ void __launch_bounds__(K2_MAX_THREADS, 1)
merkle_levels_split_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                           int64_t half, int levels, int n0) {
  extern __shared__ uint32_t sh[];
  const int t = threadIdx.x, i = t >> 2, q = t & 3;
  const int row = n0 / 2, parity = k2_parity_words(n0);
  const int word = 4 * (q & 1);  // first of the thread's digest words
  int64_t first = static_cast<int64_t>(blockIdx.x) * n0;  // block's first parent
  int64_t width = half;                                  // parents in the level
  uint32_t x[4];
  for (int l = 0; l < levels; ++l) {
    const int n = n0 >> l;
    if (((t & ~31) >> 2) < n) {  // the warp holds a parent of this level
      const bool live = i < n;
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = 0u;
      if (live && l == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          x[k] = __ldg(in + (word + k) * 2 * width + 2 * (first + i) + (q >> 1));
      } else if (live) {
        const uint32_t* src = sh + ((l + 1) & 1) * 2 * parity + (q >> 1) * parity;
#pragma unroll
        for (int k = 0; k < 4; ++k) x[k] = src[(word + k) * row + i];
      }
      permute_split(x, q);
      if (live && q < 2) {
#pragma unroll
        for (int k = 0; k < 4; ++k) out[(word + k) * width + first + i] = x[k];
        if (l + 1 < levels) {
          uint32_t* dst = sh + (l & 1) * 2 * parity + (i & 1) * parity + (i >> 1);
#pragma unroll
          for (int k = 0; k < 4; ++k) dst[(word + k) * row] = x[k];
        }
      }
    }
    out += DIGEST * width;
    width >>= 1;
    first >>= 1;
    if (l + 1 < levels) __syncthreads();
  }
}

constexpr int THREADS = 256;

}  // namespace

extern "C" int p2_leaf_sponge(const void* cols, void* out, int n_cols, int64_t m,
                              void* stream) {
  if (m <= 0) return 0;
  unsigned blocks = static_cast<unsigned>((m + THREADS - 1) / THREADS);
  leaf_sponge_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cols), static_cast<uint32_t*>(out), n_cols, m);
  return static_cast<int>(cudaGetLastError());
}

// Every level of one Merkle tree over the (8, m) leaf digests at `leaves`, in
// the launches of `plan`: n_launches triples (levels, threads, lanes),
// computed by the caller (hash/poseidon2_merkle.py, merkle_plan); lanes is the
// threads per parent, 1 (merkle_levels_kernel) or 4
// (merkle_levels_split_kernel). Each launch starts from the last level the
// one before it wrote (the leaves first). `out` holds 8 (m / 2 + m / 4 + ...)
// words for the levels the plan covers, each level one contiguous (8, width)
// block after the other. With n = threads / lanes parents per block, a launch
// needs n to be a multiple of 2^(levels - 1), and its first level's width a
// multiple of n unless it is a one-thread-per-parent launch of one level.
// Returns the first nonzero cudaGetLastError(), cudaErrorInvalidValue for a
// plan that breaks those rules.
extern "C" int p2_merkle_levels(const void* leaves, void* out, int64_t m,
                                const int32_t* plan, int n_launches, void* stream) {
  const uint32_t* in = static_cast<const uint32_t*>(leaves);
  uint32_t* dst = static_cast<uint32_t*>(out);
  int64_t half = m / 2;
  for (int k = 0; k < n_launches; ++k) {
    const int levels = plan[3 * k], threads = plan[3 * k + 1], lanes = plan[3 * k + 2];
    const int n = (lanes == 1 || lanes == 4) ? threads / lanes : 0;
    if (levels < 1 || levels > 30 || n < 1 || threads % lanes != 0 ||
        threads > K2_MAX_THREADS || half < 1 || n % (1 << (levels - 1)) != 0 ||
        ((levels > 1 || lanes == 4) && half % n != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    unsigned blocks = static_cast<unsigned>((half + n - 1) / n);
    size_t smem = levels > 1 ? 4 * k2_parity_words(n) * sizeof(uint32_t) : 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (lanes == 1)
      merkle_levels_kernel<<<blocks, threads, smem, s>>>(in, dst, half, levels);
    else
      merkle_levels_split_kernel<<<blocks, threads < 32 ? 32 : threads, smem, s>>>(
          in, dst, half, levels, n);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    for (int l = 0; l < levels; ++l) {
      in = dst;
      dst += DIGEST * half;
      half >>= 1;
    }
  }
  return 0;
}
