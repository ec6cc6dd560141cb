// The Poseidon2 permutation over Goldilocks, width 8 (rate 4, x^7 S-box,
// 8 external + 22 internal rounds), for one thread: csrc/gl_commit.cu's leaf
// sponge (K14b) and Merkle levels (K14c). It replaces the reference's
// ceno_tpu/gl/device.py::permute_device (:126), XLA over 2-limb uint32
// words; the plain torch version is ceno_tpu_torch/gl/poseidon2.py::permute.
//
// The tables are RC_EXTERNAL, RC_INTERNAL and INTERNAL_DIAG of
// ceno_tpu_torch/gl/poseidon2.py, canonical words (checked by
// tests/test_torch_gl_device.py). A permutation does 520 GL products: 8
// external rounds x 8 S-boxes x 4, and 22 internal rounds x (4 for the one
// S-box + 8 diagonal products). The state stays in registers, 8 words of 64
// bits; the round loops index their constants by round. No
// `#pragma unroll` on the round loops (cicc of CUDA 12.9 crashed on it for
// the BabyBear rounds, csrc/poseidon2.cuh); the 8-wide loops carry it.

#pragma once

#include "goldilocks.cuh"

namespace gl {

constexpr int WIDTH = 8;
constexpr int RATE = 4;
constexpr int DIGEST = 4;
constexpr int ROUNDS_F = 8;
constexpr int ROUNDS_P = 22;

__constant__ uint64_t RC_EXTERNAL[ROUNDS_F][WIDTH] = {
    {0x1c31c258b5ea6ef5ull, 0x2fa258c9c418f8b4ull, 0x6edb030026e4d8c8ull, 0x3c169011abf01acdull,
     0xc9aeec64d9a2ac60ull, 0xd6aa7efa1ebe5585ull, 0xbdcd31d781a0416aull, 0xa6f46bde0013a5d8ull},
    {0xfa8d5955c4911723ull, 0x6bed084f26065088ull, 0x3c3006ed41ff8be8ull, 0x057833e2f8421816ull,
     0x4224b8cd387cf510ull, 0xee49a43933982773ull, 0xc73744f64eb8b861ull, 0x8a374e39af9b058bull},
    {0xb020850c9515b1a1ull, 0x87a5f229cba95cafull, 0x6a27e75bdf40630dull, 0xee6457628619f27cull,
     0x6af2d2921d522a42ull, 0x6f80e47341b212a6ull, 0x2a89ab39df043ee0ull, 0xd93da772301777b2ull},
    {0xab2db7728a79a2efull, 0xe62d358c2cb1a61full, 0xa402d232cf3baa5dull, 0xa5cd5ab1f72481fdull,
     0xa7bfc3edbc31a50eull, 0x3130faa2ea82bb62ull, 0x5c3c75c03f59e804ull, 0x4282f5767220baa5ull},
    {0xf319142ca8487334ull, 0x55dd256b4cbe8162ull, 0x0c7f6af3195c9fe1ull, 0xfe1143a4b772e7eaull,
     0x60bf47f4601a44d1ull, 0xc299d8ae33e597a3ull, 0xa4fe2e1e5c61754eull, 0x6fc5d95ea11f7d52ull},
    {0x3c5bdaf834c2c835ull, 0x9c6415ce0af4b676ull, 0x9c88f5320fd4fe72ull, 0x3aab023082637268ull,
     0x6dbddf4bd4313bc0ull, 0x864520a853022bf2ull, 0xbdc3c792b82d692full, 0xbe9370521498a782ull},
    {0xa0579c7ef6a89411ull, 0xe88e4ed07fb7dfeeull, 0xb0ac2efe0e4c0120ull, 0xd2423182e8a47b89ull,
     0x89f693f21fb9c607ull, 0x3b3b62d4e4016c0bull, 0xe83cfe440ff29f73ull, 0x298b116fab5b9a24ull},
    {0x821c8507aa1f4834ull, 0xe51a1abf68bbd9c2ull, 0x3fc36866136da791ull, 0xfbd042ae37ab2a99ull,
     0xf22cfd592759bf82ull, 0xf80c60ddac59d72eull, 0x088294e30ae4e6e5ull, 0x601b70f23f9e17cdull},
};
__constant__ uint64_t RC_INTERNAL[ROUNDS_P] = {
    0x40d6b42b049b543eull, 0xd44a0c08ddbb8955ull, 0x175d785435ba2522ull,
    0xa3fb1745f37cf875ull, 0x1fb5e2b1deb75c87ull, 0x48dc464275995790ull,
    0x2e00c89bb8ce922aull, 0x4cd99b15c620f986ull, 0x2b569de83fcce8d5ull,
    0xe4affdd5cf5f35c4ull, 0x083b3b6ad25194a6ull, 0x16ad29e98f3811c4ull,
    0x449fff485e013811ull, 0x9fe8cd128c4ffb61ull, 0x59b90613b24a8d06ull,
    0x8918b9de5c4e83d0ull, 0xaebdc376fb1166ecull, 0x5591b43bc0d163d5ull,
    0x514b99912b0e6ae3ull, 0xa8c340f157102e96ull, 0x46c3c3f96353abb6ull,
    0x057e0a6939435f78ull,
};
__constant__ uint64_t INTERNAL_DIAG[WIDTH] = {
    0x42d5367b3cbd5110ull, 0x3d97f7053e2061aeull, 0x507a72a100ae7e15ull,
    0x4f98d3d222fecb21ull, 0xf0c0ad89fbdf24c8ull, 0x91e75bcb48210191ull,
    0x724e678531502366ull, 0x7ba3fb0b5434dff0ull,
};

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = mul(x, x);
  const uint64_t x4 = mul(x2, x2);
  return mul(mul(x4, x2), x);
}

// M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] on v[0..3]:
// y_i = s + v_i + 2 v_{i+1} with s the sum of the four.
__device__ __forceinline__ void m4(uint64_t* v) {
  const uint64_t s = add(add(v[0], v[1]), add(v[2], v[3]));
  const uint64_t y0 = add(s, add(v[0], dbl(v[1])));
  const uint64_t y1 = add(s, add(v[1], dbl(v[2])));
  const uint64_t y2 = add(s, add(v[2], dbl(v[3])));
  const uint64_t y3 = add(s, add(v[3], dbl(v[0])));
  v[0] = y0;
  v[1] = y1;
  v[2] = y2;
  v[3] = y3;
}

// circ(2 M4, M4): each 4-block plus the other block's words, then M4.
__device__ __forceinline__ void external_linear(uint64_t* st) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t t = add(st[i], st[i + 4]);
    st[i] = add(st[i], t);
    st[i + 4] = add(st[i + 4], t);
  }
  m4(st);
  m4(st + 4);
}

__device__ __forceinline__ void external_round(uint64_t* st, int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) st[i] = sbox(add(st[i], RC_EXTERNAL[r][i]));
  external_linear(st);
}

__device__ __forceinline__ void permute(uint64_t* st) {
  external_linear(st);
  for (int r = 0; r < ROUNDS_F / 2; ++r) external_round(st, r);
  for (int r = 0; r < ROUNDS_P; ++r) {
    st[0] = sbox(add(st[0], RC_INTERNAL[r]));
    uint64_t s = st[0];
#pragma unroll
    for (int i = 1; i < WIDTH; ++i) s = add(s, st[i]);
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) st[i] = add(mul(st[i], INTERNAL_DIAG[i]), s);
  }
  for (int r = ROUNDS_F / 2; r < ROUNDS_F; ++r) external_round(st, r);
}

}  // namespace gl
