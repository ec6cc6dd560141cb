// Poseidon2-16 Merkle kernels over BabyBear for Hopper (sm_90a).
//
// K1 p2_leaf_sponge replaces the TPU kernel ceno_tpu/hash/poseidon2_pallas.py
//    leaf_sponge (pallas_call at :124, body _leaf_kernel :99): a (C, M)
//    Montgomery codeword -> (8, M) leaf digests, ceil(C/8) rate-8 absorbs per
//    lane, each followed by a full permutation.
// K2 p2_compress_level replaces compress_level (pallas_call at :160, body
//    _compress_kernel :138): one Merkle level (8, m) -> (8, m/2), parent i =
//    permute(child 2i || child 2i+1)[:8].
//
// What bounds them on this card: integer multiplies. A permutation does 772
// Montgomery products (8 external rounds x 16 S-boxes x 4, 13 internal rounds
// x (4 + 16 diagonal)), each three 32-bit multiplies, against 16 words read
// and 8 written per lane for K2 (C + 8 words per lane for K1). At the witness
// commit, C = 61 and M = 2^22, K1 runs 8 x 2^22 permutations, about 2.6e10
// Montgomery products, while it moves 1.2 GB.
//
// Design: one Poseidon2 state per thread, kept in 16 registers through all
// rounds (ptxas: 44 registers for K1, 40 for K2, no stack frame, no spills).
// Threads walk along M, so each column read and each digest write is
// coalesced across a warp. Round constants and the internal diagonal sit in
// __constant__ memory; every access is warp-uniform. The loops carry no
// `#pragma unroll`: with it on the round loops, cicc of CUDA 12.9 crashes
// (segmentation fault) on this file, and -O3 unrolls the short loops over
// the state by itself, which is what keeps the state in registers. The
// Montgomery product is the native 32x32->64 multiply plus __umulhi for the
// REDC. K2 reads both children directly (no de-interleave pass) and takes
// every level size, so the reference's scan fallback for small levels has no
// counterpart. Kernels launch on the caller's stream and allocate nothing;
// each C entry point returns cudaGetLastError().
//
// The tables are the Montgomery forms of RC_EXTERNAL, RC_INTERNAL and
// INTERNAL_DIAG in ceno_tpu_torch/hash/poseidon2.py (checked by
// tests/test_torch_poseidon2.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P = 2013265921u;      // 0x78000001
constexpr uint32_t PINV = 2013265919u;   // -p^-1 mod 2^32
constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int DIGEST = 8;
constexpr int ROUNDS_F = 8;
constexpr int ROUNDS_P = 13;

__constant__ uint32_t RC_EXT[ROUNDS_F][WIDTH] = {
  {
    766168529u, 42849511u, 1534762773u, 1687150723u, 1732181260u, 623541720u,
    1217098847u, 1829735532u, 1708823048u, 895403201u, 237441894u, 1399106667u,
    1279855500u, 1130141440u, 1371731712u, 659535638u,
  },
  {
    167158735u, 1789193173u, 1048259134u, 1965514877u, 422751002u, 1138062231u,
    800292851u, 1674694144u, 1946769658u, 332546626u, 948360138u, 428707498u,
    465635015u, 1629643323u, 158566581u, 1424006913u,
  },
  {
    720150656u, 918695383u, 1807907673u, 1303969373u, 896746317u, 1096295878u,
    698776300u, 1924767232u, 1875143247u, 509315130u, 1957004929u, 195206834u,
    1556371868u, 1334002164u, 1235062853u, 985349846u,
  },
  {
    1110296582u, 84912266u, 705857675u, 352775095u, 751215311u, 1478505707u,
    796206905u, 228139996u, 1314130052u, 1483579466u, 1106978758u, 869526933u,
    139172629u, 1769298073u, 609682635u, 1308791647u,
  },
  {
    271507012u, 1761152914u, 810972656u, 938887180u, 1296319296u, 244524238u,
    1687787531u, 993295386u, 983537873u, 1690401865u, 607044488u, 1031828876u,
    2005829937u, 1686507989u, 1447843825u, 985452235u,
  },
  {
    1750326844u, 1005351674u, 1335268920u, 1990836916u, 1415997245u, 618403020u,
    967720456u, 1252096957u, 922625224u, 714248237u, 1850627322u, 1030260955u,
    1617566695u, 1405073856u, 1571264406u, 1833468549u,
  },
  {
    848857345u, 1389522844u, 163478445u, 1414552881u, 1829465990u, 91768747u,
    1130566848u, 1670507734u, 631108560u, 1263651825u, 226118965u, 1269265511u,
    1838997011u, 826701916u, 202637256u, 422722384u,
  },
  {
    861452921u, 1889635838u, 1069166924u, 398150215u, 573337655u, 428530883u,
    109391500u, 1863453426u, 1446206379u, 1334189578u, 802776711u, 1793245921u,
    629305665u, 1065884217u, 1110903628u, 813342273u,
  },
};

__constant__ uint32_t RC_INT[ROUNDS_P] = {
  1805956182u, 1783791557u, 1898229504u, 791730328u, 1067439613u, 470930005u,
  697219082u, 1438235827u, 1437530152u, 1795489607u, 276292843u, 704781599u,
  1744394992u,
};

__constant__ uint32_t DIAG[WIDTH] = {
  788590548u, 35173347u, 362827603u, 1914445193u, 1413077346u, 1019640491u,
  1462621630u, 958343664u, 416606853u, 391992181u, 829197170u, 1229058414u,
  1306287184u, 1291072481u, 158012772u, 1055627160u,
};

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // a, b < p < 2^31: no wrap
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t dbl(uint32_t a) { return add(a, a); }

// Montgomery product a*b/2^32 mod p (operands and result in [0, p)).
__device__ __forceinline__ uint32_t mmul(uint32_t a, uint32_t b) {
  uint64_t t = static_cast<uint64_t>(a) * b;
  uint32_t lo = static_cast<uint32_t>(t);
  uint32_t hi = static_cast<uint32_t>(t >> 32);
  uint32_t m = lo * PINV;
  uint32_t r = hi + __umulhi(m, P) + (lo != 0u);
  return r >= P ? r - P : r;
}

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = mmul(x, x);
  uint32_t x4 = mmul(x2, x2);
  return mmul(mmul(x4, x2), x);
}

// circ(2*M4, M4, M4, M4): y_i = M4 (x_i + sum_j x_j), blocks of four words.
__device__ __forceinline__ void external_linear(uint32_t st[WIDTH]) {
  uint32_t t[4];
  for (int j = 0; j < 4; ++j)
    t[j] = add(add(st[j], st[4 + j]), add(st[8 + j], st[12 + j]));
  for (int b = 0; b < 4; ++b) {
    uint32_t x0 = add(st[4 * b + 0], t[0]);
    uint32_t x1 = add(st[4 * b + 1], t[1]);
    uint32_t x2 = add(st[4 * b + 2], t[2]);
    uint32_t x3 = add(st[4 * b + 3], t[3]);
    uint32_t s = add(add(x0, x1), add(x2, x3));
    st[4 * b + 0] = add(s, add(x0, dbl(x1)));
    st[4 * b + 1] = add(s, add(x1, dbl(x2)));
    st[4 * b + 2] = add(s, add(x2, dbl(x3)));
    st[4 * b + 3] = add(s, add(x3, dbl(x0)));
  }
}

__device__ __forceinline__ void external_round(uint32_t st[WIDTH], int r) {
  for (int i = 0; i < WIDTH; ++i) st[i] = sbox(add(st[i], RC_EXT[r][i]));
  external_linear(st);
}

__device__ __forceinline__ void permute(uint32_t st[WIDTH]) {
  external_linear(st);
  for (int r = 0; r < ROUNDS_F / 2; ++r) external_round(st, r);
  for (int r = 0; r < ROUNDS_P; ++r) {
    st[0] = sbox(add(st[0], RC_INT[r]));
    uint32_t s = st[0];
    for (int i = 1; i < WIDTH; ++i) s = add(s, st[i]);
    for (int i = 0; i < WIDTH; ++i) st[i] = add(mmul(st[i], DIAG[i]), s);
  }
  for (int r = ROUNDS_F / 2; r < ROUNDS_F; ++r) external_round(st, r);
}

__global__ void __launch_bounds__(256)
leaf_sponge_kernel(const uint32_t* __restrict__ cols, uint32_t* __restrict__ out,
                   int n_cols, int64_t m) {
  int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= m) return;
  uint32_t st[WIDTH];
  for (int i = 0; i < WIDTH; ++i) st[i] = 0u;
  int absorbs = n_cols > 0 ? (n_cols + RATE - 1) / RATE : 1;
  for (int a = 0; a < absorbs; ++a) {
    int off = a * RATE;
    for (int j = 0; j < RATE; ++j)
      if (off + j < n_cols) st[j] = add(st[j], __ldg(cols + (off + j) * m + lane));
    permute(st);
  }
  for (int j = 0; j < DIGEST; ++j) out[j * m + lane] = st[j];
}

__global__ void __launch_bounds__(256)
compress_level_kernel(const uint32_t* __restrict__ level, uint32_t* __restrict__ out,
                      int64_t half) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= half) return;
  int64_t m = 2 * half;
  uint32_t st[WIDTH];
  for (int j = 0; j < DIGEST; ++j) {
    st[j] = __ldg(level + j * m + 2 * i);
    st[DIGEST + j] = __ldg(level + j * m + 2 * i + 1);
  }
  permute(st);
  for (int j = 0; j < DIGEST; ++j) out[j * half + i] = st[j];
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

extern "C" int p2_compress_level(const void* level, void* out, int64_t half,
                                 void* stream) {
  if (half <= 0) return 0;
  unsigned blocks = static_cast<unsigned>((half + THREADS - 1) / THREADS);
  compress_level_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(level), static_cast<uint32_t*>(out), half);
  return static_cast<int>(cudaGetLastError());
}
