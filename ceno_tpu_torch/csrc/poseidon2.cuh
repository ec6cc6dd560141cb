// The Poseidon2-16 permutation over BabyBear, shared by the port's CUDA
// kernels: `permute` for one thread (csrc/poseidon2_merkle.cu, K1 and K2) and
// `permute_warp` spread over the lanes of one warp (csrc/sumcheck.cu, K5/K7).
//
// The tables are the Montgomery forms of RC_EXTERNAL, RC_INTERNAL and
// INTERNAL_DIAG in ceno_tpu_torch/hash/poseidon2.py (checked, with MONTY_15,
// by tests/test_torch_poseidon2.py). `permute` keeps one state of 16
// Montgomery words in registers; the design of its rounds (lazy [0, 2p)
// operands, the 11-addition M4, the internal rounds' running sum) is set out
// in csrc/poseidon2_merkle.cu. Do not put `#pragma unroll` on the round
// loops: cicc of CUDA 12.9 crashes on it.

#pragma once

#include "babybear.cuh"

namespace {

constexpr uint32_t MONTY_15 = 2013265889u;   // 15 in Montgomery form
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

// The permutation spread over one warp, for a single sponge whose latency is
// all that counts (the duplex of csrc/sumcheck.cu). Lane l holds state word
// i = l & 15 in one register; lanes 16-31 mirror lanes 0-15, so all 32 lanes
// run one instruction stream and every shuffle stays inside its half. A lane
// runs its own word's S-box and products; a sum over words is a shuffle
// reduction. All 32 lanes call these functions together, in warp-uniform
// control flow, and every value between steps is canonical, in [0, p).
//
// The internal rounds depend on one word's S-box in turn: every lane keeps
// its own copy z of word 0 and runs that round's S-box on it, while four xor
// shuffles sum words 1..15, so no broadcast is waited for and a round is as
// deep as the longer of the S-box and the reduction.

constexpr unsigned WARP_ALL = 0xffffffffu;

// x^7 three products deep: x^2, then x^3 and x^4 side by side, then x^4 x^3;
// x in [0, p) -> [0, p) (x^4 in [0, 2p), 2p * p < p * 2^32)
__device__ __forceinline__ uint32_t sbox_warp(uint32_t x) {
  const uint32_t x2 = mmul(x, x);
  const uint32_t x3 = mmul(x2, x);
  const uint32_t x4 = mmul_lazy(x2, x2);
  return mmul(x4, x3);
}

// The external layer circ(2 M4, M4, M4, M4) on the lane's word. M4 is
// circulant (rows (2, 3, 1, 1) rotated), so row k of a block is the block's
// sum + x_k + 2 x_{k+1}: three shuffles in the block of four lanes. Then each
// word adds its column's sum over the four blocks: xor shuffles by 4 and 8.
__device__ __forceinline__ uint32_t external_linear_warp(uint32_t x, int lane) {
  const uint32_t next = __shfl_sync(WARP_ALL, x, (lane & ~3) | ((lane + 1) & 3));
  uint32_t s = add(x, __shfl_xor_sync(WARP_ALL, x, 1));
  s = add(s, __shfl_xor_sync(WARP_ALL, s, 2));
  const uint32_t y = add(add(s, x), dbl(next));
  uint32_t c = add(y, __shfl_xor_sync(WARP_ALL, y, 4));
  c = add(c, __shfl_xor_sync(WARP_ALL, c, 8));
  return add(y, c);
}

// External rounds r0 .. r0 + 3. A lane's round constant is its word's, a
// different address in each of 16 lanes (the constant cache serves them one
// after the other), so it is fetched a round ahead.
__device__ __forceinline__ uint32_t external_rounds_warp(uint32_t x, int lane, int r0) {
  const int i = lane & (WIDTH - 1);
  uint32_t rc = RC_EXT[r0][i];
  for (int r = r0; r < r0 + ROUNDS_F / 2; ++r) {
    const uint32_t next = RC_EXT[r + 1 < ROUNDS_F ? r + 1 : r][i];
    x = external_linear_warp(sbox_warp(add(x, rc)), lane);
    rc = next;
  }
  return x;
}

// The 13 internal rounds: word i' = s + DIAG[i] * word i, where word 0 first
// goes through the S-box and s is the sum of all 16 words after it. diag is
// DIAG[lane & 15].
__device__ __forceinline__ uint32_t internal_rounds_warp(uint32_t x, uint32_t diag, int lane) {
  const int i = lane & (WIDTH - 1);
  uint32_t z = __shfl_sync(WARP_ALL, x, 0, WIDTH);  // word 0, in every lane
  uint32_t rc = RC_INT[0];
  for (int r = 0; r < ROUNDS_P; ++r) {
    const uint32_t rc_next = RC_INT[r + 1 < ROUNDS_P ? r + 1 : r];
    const uint32_t s0 = sbox_warp(add(z, rc));
    uint32_t rest = i == 0 ? 0u : x;  // words 1..15, summed while the S-box runs
    rest = add(rest, __shfl_xor_sync(WARP_ALL, rest, 1));
    rest = add(rest, __shfl_xor_sync(WARP_ALL, rest, 2));
    rest = add(rest, __shfl_xor_sync(WARP_ALL, rest, 4));
    rest = add(rest, __shfl_xor_sync(WARP_ALL, rest, 8));
    const uint32_t s = add(s0, rest);
    z = add(mmul(s0, DIAG[0]), s);
    x = add(mmul(x, diag), s);  // lane 0's and 16's: unused, z holds word 0
    rc = rc_next;
  }
  return i == 0 ? z : x;
}

// The permutation of the state that the warp holds, lane l's word l & 15;
// diag is DIAG[lane & 15].
__device__ __forceinline__ uint32_t permute_warp(uint32_t x, uint32_t diag, int lane) {
  x = external_linear_warp(x, lane);
  x = external_rounds_warp(x, lane, 0);
  x = internal_rounds_warp(x, diag, lane);
  return external_rounds_warp(x, lane, ROUNDS_F / 2);
}

}  // namespace
