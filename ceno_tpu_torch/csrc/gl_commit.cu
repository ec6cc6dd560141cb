// The Goldilocks Basefold commit for Hopper (sm_90a): K14a, K14b, K14c.
//
// They replace the reference's XLA device functions of
// ceno_tpu/gl/device.py, which compute over 2-limb uint32 words (the TPU has
// no 64-bit integer path; GL.md):
// K14a gl_encode replaces encode_dev (:54; host mirror gl/pcs.py::encode):
//    (C, N) evals -> (C, N 2^b) codeword in five steps: the variable-reversal
//    gather, the Moebius transform (subtractions only), the zero pad, the
//    bit reversal and a radix-2 DIT with the twiddles of the reference's
//    gl/pcs.py::_stage_twiddles (:58). One launch per Moebius and DIT
//    stage, a gather before and a spread (pad + bit reversal) between them.
//    Stage s's twiddle w_{s+1}^k is read from one table of the top stage,
//    w_M^j for j < M/2, at j = k 2^(log M - 1 - s), since w_{s+1} =
//    w_M^(2^(log M - 1 - s)); gl_twiddles fills that table (one thread per
//    power) once per size.
// K14b gl_leaf_sponge replaces the leaf sponge of hash_and_tree_dev (:162)
//    over permute_device (:126): (C, M) -> (4, M) leaf digests, a chunk of
//    RATE = 4 columns added into the state, then a permutation (7 at C = 26,
//    1 at the fold trees' C = 2); the digest is the first 4 words.
// K14c gl_merkle_levels replaces the rest of hash_and_tree_dev: every level
//    of the tree, (4, m) -> (4, m/2) -> ... -> (4, 1), parent i =
//    permute(child 2i || child 2i+1)[:4]. K2's level-fused plan where it is
//    simple: one launch per level while a level has more than K14C_TOP
//    digests (one thread per parent), then one block takes the levels left
//    to the root through shared memory.
//
// What bounds them on this card: the integer multiply pipe. A GL product is
// 15 IMAD instructions in the SASS (chip_smoke.py counts them in
// gl_mul_probe_kernel); K14b and K14c do 520 products a permutation against
// 8 (C + 4) bytes a leaf, K14a one a butterfly, 21 stages at the commit's
// (26, 2^21), so its products outweigh the matrix it reads and writes once
// (its stages each read and write the whole matrix again: 7.1 ms against a
// 0.51 ms bound, K14b 39% and K14c 32% of theirs; H100 80GB HBM3, 700.00 W,
// PERF.md). The design is the simple one: one state a thread in registers,
// threads along M so that every column read and digest write is coalesced
// across a warp, a launch per stage. Kernels launch on the caller's stream
// and allocate nothing; each C entry point returns cudaGetLastError().
//
// The field (add, sub, a canonical reduce128 after __umul64hi) lives in
// csrc/goldilocks.cuh and the permutation with its tables in
// csrc/poseidon2_gl.cuh. The plain torch versions are in
// ceno_tpu_torch/gl/device.py; tests/test_torch_gl_device.py also compiles
// this file with the host C++ compiler and runs it against them.

#include <cstdint>
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "poseidon2_gl.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int K14C_TOP = 512;  // digests at which one block takes the levels left

__device__ __forceinline__ int64_t bitrev(int64_t i, int bits) {
  return bits ? static_cast<int64_t>(__brev(static_cast<uint32_t>(i)) >> (32 - bits)) : 0;
}

__device__ __forceinline__ int64_t thread_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__global__ void gl_twiddles_kernel(uint64_t* tw, int64_t half, uint64_t w) {
  const int64_t k = thread_index();
  if (k < half) tw[k] = gl::pow(w, static_cast<uint64_t>(k));
}

// x[c][i] = evals[c][bitrev(i)]: the variable reversal.
__global__ void gl_gather_kernel(const uint64_t* __restrict__ evals, uint64_t* __restrict__ x,
                                 int log_n, int64_t total) {
  const int64_t t = thread_index();
  if (t >= total) return;
  const int64_t row = t >> log_n << log_n;
  x[t] = __ldg(evals + row + bitrev(t - row, log_n));
}

// Moebius stage j: in each block of 2^(j+1), the upper half minus the lower.
__global__ void gl_mobius_kernel(uint64_t* x, int log_n, int j, int64_t pairs) {
  const int64_t t = thread_index();
  if (t >= pairs) return;
  const int64_t c = t >> (log_n - 1), q = t & ((int64_t{1} << (log_n - 1)) - 1);
  const int64_t lo = (c << log_n) + ((q >> j) << (j + 1)) + (q & ((int64_t{1} << j) - 1));
  const int64_t hi = lo + (int64_t{1} << j);
  x[hi] = gl::sub(x[hi], x[lo]);
}

// cw[c][i] = x[c][bitrev_m(i)] where that index is below n, else 0: the zero
// pad and the bit reversal in one pass.
__global__ void gl_spread_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ cw,
                                 int log_n, int log_m, int64_t total) {
  const int64_t t = thread_index();
  if (t >= total) return;
  const int64_t c = t >> log_m;
  const int64_t src = bitrev(t & ((int64_t{1} << log_m) - 1), log_m);
  cw[t] = src < (int64_t{1} << log_n) ? __ldg(x + (c << log_n) + src) : 0;
}

// DIT stage s: in each block of 2^(s+1), (lo, hi) -> (lo + w^k hi, lo - w^k hi).
__global__ void gl_dit_kernel(uint64_t* cw, const uint64_t* __restrict__ tw, int log_m, int s,
                              int64_t pairs) {
  const int64_t t = thread_index();
  if (t >= pairs) return;
  const int64_t c = t >> (log_m - 1), q = t & ((int64_t{1} << (log_m - 1)) - 1);
  const int64_t k = q & ((int64_t{1} << s) - 1);
  const int64_t lo = (c << log_m) + ((q >> s) << (s + 1)) + k;
  const int64_t hi = lo + (int64_t{1} << s);
  const uint64_t a = cw[lo];
  const uint64_t b = gl::mul(cw[hi], __ldg(tw + (k << (log_m - 1 - s))));
  cw[lo] = gl::add(a, b);
  cw[hi] = gl::sub(a, b);
}

__global__ void __launch_bounds__(THREADS)
gl_leaf_sponge_kernel(const uint64_t* __restrict__ cols, uint64_t* __restrict__ out, int n_cols,
                      int64_t m) {
  const int64_t lane = thread_index();
  if (lane >= m) return;
  uint64_t st[gl::WIDTH];
#pragma unroll
  for (int i = 0; i < gl::WIDTH; ++i) st[i] = 0;
  for (int off = 0; off < n_cols; off += gl::RATE) {
#pragma unroll
    for (int j = 0; j < gl::RATE; ++j)
      if (off + j < n_cols) st[j] = gl::add(st[j], __ldg(cols + (off + j) * m + lane));
    gl::permute(st);
  }
#pragma unroll
  for (int j = 0; j < gl::DIGEST; ++j) out[j * m + lane] = st[j];
}

// One level: (4, 2 half) children -> (4, half) parents, a thread a parent.
__global__ void __launch_bounds__(THREADS)
gl_merkle_level_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t half) {
  const int64_t i = thread_index();
  if (i >= half) return;
  uint64_t st[gl::WIDTH];
#pragma unroll
  for (int j = 0; j < gl::DIGEST; ++j) {
    st[j] = __ldg(in + j * 2 * half + 2 * i);
    st[j + gl::DIGEST] = __ldg(in + j * 2 * half + 2 * i + 1);
  }
  gl::permute(st);
#pragma unroll
  for (int j = 0; j < gl::DIGEST; ++j) out[j * half + i] = st[j];
}

// Every level above (4, m) digests, m <= K14C_TOP, in one block of m / 2
// threads: level l's parents go to `out` and to one half of a shared double
// buffer, which level l + 1 reads.
__global__ void gl_merkle_top_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                     int64_t m) {
  __shared__ uint64_t sh[2][gl::DIGEST][K14C_TOP / 2];
  const int i = threadIdx.x;
  int64_t half = m / 2;
  for (int l = 0; half >= 1; ++l) {
    if (i < half) {
      uint64_t st[gl::WIDTH];
#pragma unroll
      for (int j = 0; j < gl::DIGEST; ++j) {
        const uint64_t* row = in + j * 2 * half;
        st[j] = l ? sh[(l + 1) & 1][j][2 * i] : __ldg(row + 2 * i);
        st[j + gl::DIGEST] = l ? sh[(l + 1) & 1][j][2 * i + 1] : __ldg(row + 2 * i + 1);
      }
      gl::permute(st);
#pragma unroll
      for (int j = 0; j < gl::DIGEST; ++j) {
        out[j * half + i] = st[j];
        sh[l & 1][j][i] = st[j];
      }
    }
    __syncthreads();
    out += gl::DIGEST * half;
    half >>= 1;
  }
}

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + THREADS - 1) / THREADS); }

}  // namespace

// One GL product a thread. Never launched: chip_smoke.py counts the IMAD
// instructions of its SASS, the multiplies of one product in the bounds.
extern "C" __global__ void gl_mul_probe_kernel(const uint64_t* a, const uint64_t* b,
                                               uint64_t* out) {
  out[threadIdx.x] = gl::mul(a[threadIdx.x], b[threadIdx.x]);
}

// tw[k] = w^k for k < 2^(log_m - 1): the top DIT stage's twiddles, w the
// generator of the order-2^log_m subgroup.
extern "C" int gl_twiddles(void* tw, int log_m, uint64_t w, void* stream) {
  const int64_t half = log_m > 0 ? int64_t{1} << (log_m - 1) : 0;
  if (half == 0) return 0;
  gl_twiddles_kernel<<<blocks_for(half), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(tw), half, w);
  return static_cast<int>(cudaGetLastError());
}

// (C, 2^log_n) evals -> (C, 2^log_m) codeword in `cw`, through `scratch`
// (C 2^log_n words), with `tw` from gl_twiddles at log_m. Launches
// 1 + log_n + 1 + log_m kernels.
extern "C" int gl_encode(const void* evals, void* scratch, void* cw, const void* tw, int n_cols,
                         int log_n, int log_m, void* stream) {
  if (n_cols <= 0) return 0;
  if (log_n < 0 || log_m < log_n || log_m > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* x = static_cast<uint64_t*>(scratch);
  uint64_t* out = static_cast<uint64_t*>(cw);
  const int64_t n_total = static_cast<int64_t>(n_cols) << log_n;
  const int64_t m_total = static_cast<int64_t>(n_cols) << log_m;
  gl_gather_kernel<<<blocks_for(n_total), THREADS, 0, s>>>(static_cast<const uint64_t*>(evals), x,
                                                           log_n, n_total);
  int rc = static_cast<int>(cudaGetLastError());
  for (int j = 0; rc == 0 && j < log_n; ++j) {
    gl_mobius_kernel<<<blocks_for(n_total / 2), THREADS, 0, s>>>(x, log_n, j, n_total / 2);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0) return rc;
  gl_spread_kernel<<<blocks_for(m_total), THREADS, 0, s>>>(x, out, log_n, log_m, m_total);
  rc = static_cast<int>(cudaGetLastError());
  for (int st = 0; rc == 0 && st < log_m; ++st) {
    gl_dit_kernel<<<blocks_for(m_total / 2), THREADS, 0, s>>>(
        out, static_cast<const uint64_t*>(tw), log_m, st, m_total / 2);
    rc = static_cast<int>(cudaGetLastError());
  }
  return rc;
}

extern "C" int gl_leaf_sponge(const void* cols, void* out, int n_cols, int64_t m, void* stream) {
  if (m <= 0) return 0;
  gl_leaf_sponge_kernel<<<blocks_for(m), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(cols), static_cast<uint64_t*>(out), n_cols, m);
  return static_cast<int>(cudaGetLastError());
}

// Every level above the (4, m) leaf digests, m a power of two, into `out`:
// 4 (m/2 + m/4 + ... + 1) words, each level one contiguous (4, width) block
// after the other. One launch per level while the level below has more than
// K14C_TOP digests, then one gl_merkle_top_kernel.
extern "C" int gl_merkle_levels(const void* leaves, void* out, int64_t m, void* stream) {
  if (m < 1 || (m & (m - 1))) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t* in = static_cast<const uint64_t*>(leaves);
  uint64_t* dst = static_cast<uint64_t*>(out);
  while (m > K14C_TOP) {
    const int64_t half = m / 2;
    gl_merkle_level_kernel<<<blocks_for(half), THREADS, 0, s>>>(in, dst, half);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    in = dst;
    dst += gl::DIGEST * half;
    m = half;
  }
  if (m > 1) {
    gl_merkle_top_kernel<<<1, static_cast<unsigned>(m / 2), 0, s>>>(in, dst, m);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}
