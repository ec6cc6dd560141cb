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
//   ptxas gives K1 56 registers and K2 64 (no spills), and K1 ran faster
//   than with 44 or fewer (6 or 8 blocks per SM, which spill).
//
// Layout: one Poseidon2 state per thread, kept in 16 registers through all
// rounds. Threads walk along M, so each column read and each digest write is
// coalesced across a warp. K1 loads the next absorb's (up to) 8 columns into
// registers before it permutes the current state, so the loads overlap the
// arithmetic. K2 reads both children directly (no de-interleave pass) and
// takes every level size, so the reference's scan fallback for small levels
// has no counterpart. Kernels launch on the caller's stream and allocate
// nothing; each C entry point returns cudaGetLastError().
//
// The tables are the Montgomery forms of RC_EXTERNAL, RC_INTERNAL and
// INTERNAL_DIAG in ceno_tpu_torch/hash/poseidon2.py (checked, with P, PINV,
// PINV_POS and MONTY_15, by tests/test_torch_poseidon2.py); each arithmetic
// step is modelled in Python and checked by tests/test_torch_p2_kernel_arith.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P = 2013265921u;          // 0x78000001
constexpr uint32_t PINV = 2013265919u;       // -p^-1 mod 2^32 (babybear.PINV)
constexpr uint32_t PINV_POS = 2281701377u;   // p^-1 mod 2^32
constexpr uint32_t MONTY_15 = 2013265889u;   // 15 in Montgomery form
static_assert(P * PINV_POS == 1u && PINV + PINV_POS == 0u, "Montgomery inverse");
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

// x^7; x in [0, p) -> [0, p)
__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = mmul(x, x);          // x * x < p^2: [0, p)
  uint32_t x4 = mmul_lazy(x2, x2);   // x2 < p: [0, 2p)
  uint32_t x6 = mmul_lazy(x4, x2);   // x4 < 2p, x2 < p: [0, 2p)
  return mmul(x6, x);                // x6 < 2p, x < p: [0, p)
}

// M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] on x[0..3] in [0, p)
__device__ __forceinline__ void mat4(uint32_t* x) {
  uint32_t t01 = add(x[0], x[1]);
  uint32_t t23 = add(x[2], x[3]);
  uint32_t t0123 = add(t01, t23);
  uint32_t t01123 = add(t0123, x[1]);
  uint32_t t01233 = add(t0123, x[3]);
  x[3] = add(t01233, dbl(x[0]));  // 3x0 + x1 + x2 + 2x3
  x[1] = add(t01123, dbl(x[2]));  // x0 + 2x1 + 3x2 + x3
  x[0] = add(t01123, t01);        // 2x0 + 3x1 + x2 + x3
  x[2] = add(t01233, t23);        // x0 + x1 + 2x2 + 3x3
}

// circ(2*M4, M4, M4, M4) = M4 on each block plus the sum of the four blocks'
// M4 products; st in [0, p) -> [0, p)
__device__ __forceinline__ void external_linear(uint32_t (&st)[WIDTH]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) mat4(st + 4 * b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t t = add(add(st[j], st[4 + j]), add(st[8 + j], st[12 + j]));
#pragma unroll
    for (int b = 0; b < 4; ++b) st[4 * b + j] = add(st[4 * b + j], t);
  }
}

// st in [0, p) -> [0, p)
__device__ __forceinline__ void external_round(uint32_t (&st)[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) st[i] = sbox(add(st[i], RC_EXT[r][i]));
  external_linear(st);
}

// In: st[0] in [0, p), st[1..15] in [0, 2p), rest = st[1] + ... + st[15] mod p.
// Out: the same ranges, rest updated. st[i] * DIAG[i] < 2p * p < p * 2^32.
__device__ __forceinline__ void internal_round(uint32_t (&st)[WIDTH], uint32_t& rest,
                                               int r) {
  uint32_t x = sbox(add(st[0], RC_INT[r]));
  uint32_t s = add(x, rest);
  st[0] = add(mmul(x, DIAG[0]), s);
  uint32_t prod[WIDTH];
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) {
    prod[i] = mmul(st[i], DIAG[i]);  // [0, p)
    st[i] = prod[i] + s;             // [0, 2p), no wrap
  }
  // rest' = sum_i (prod[i] + s) = sum_i prod[i] + 15 s
  uint32_t a = add(add(prod[1], prod[2]), add(prod[3], prod[4]));
  uint32_t b = add(add(prod[5], prod[6]), add(prod[7], prod[8]));
  uint32_t c = add(add(prod[9], prod[10]), add(prod[11], prod[12]));
  uint32_t d = add(add(prod[13], prod[14]), prod[15]);
  rest = add(add(add(a, b), add(c, d)), mmul(s, MONTY_15));
}

// st in [0, p) -> [0, p)
__device__ __forceinline__ void permute(uint32_t (&st)[WIDTH]) {
  external_linear(st);
  for (int r = 0; r < ROUNDS_F / 2; ++r) external_round(st, r);
  uint32_t rest = st[1];
#pragma unroll
  for (int i = 2; i < WIDTH; ++i) rest = add(rest, st[i]);
  for (int r = 0; r < ROUNDS_P; ++r) internal_round(st, rest, r);
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) st[i] = reduce(st[i]);
  for (int r = ROUNDS_F / 2; r < ROUNDS_F; ++r) external_round(st, r);
}

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

__global__ void __launch_bounds__(256, 1)
compress_level_kernel(const uint32_t* __restrict__ level, uint32_t* __restrict__ out,
                      int64_t half) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= half) return;
  int64_t m = 2 * half;
  uint32_t st[WIDTH];
#pragma unroll
  for (int j = 0; j < DIGEST; ++j) {
    st[j] = __ldg(level + j * m + 2 * i);
    st[DIGEST + j] = __ldg(level + j * m + 2 * i + 1);
  }
  permute(st);
#pragma unroll
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
