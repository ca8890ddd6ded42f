// BN254 prime-field arithmetic for the port's kernels (device side).
//
// An element is 8 little-endian 32-bit limbs in Montgomery form with
// R = 2^256 -- the same integer the JAX package holds as 16x16-bit
// limbs, so the two layouts convert exactly. Every function here
// returns a fully reduced value in [0, p), so results are canonical
// and bit-comparable with the plain PyTorch versions.
//
// The constants below are checked against utils/bigint.py by
// tests/torch_port/test_torch_field.py (the header is parsed there).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define NL 8

// Scalar field r (polynomials, scalars).
struct Fr {
  static constexpr uint32_t N0 = 0xefffffffu;  // -r^{-1} mod 2^32
  static __device__ __forceinline__ uint32_t p(int i) {
    switch (i) {
      case 0: return 0xf0000001u;
      case 1: return 0x43e1f593u;
      case 2: return 0x79b97091u;
      case 3: return 0x2833e848u;
      case 4: return 0x8181585du;
      case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u;
      default: return 0x30644e72u;
    }
  }
  static __device__ __forceinline__ uint32_t one(int i) {  // R mod r
    switch (i) {
      case 0: return 0x4ffffffbu;
      case 1: return 0xac96341cu;
      case 2: return 0x9f60cd29u;
      case 3: return 0x36fc7695u;
      case 4: return 0x7879462eu;
      case 5: return 0x666ea36fu;
      case 6: return 0x9a07df2fu;
      default: return 0x0e0a77c1u;
    }
  }
};

// Base field q (curve coordinates).
struct Fq {
  static constexpr uint32_t N0 = 0xe4866389u;  // -q^{-1} mod 2^32
  static __device__ __forceinline__ uint32_t p(int i) {
    switch (i) {
      case 0: return 0xd87cfd47u;
      case 1: return 0x3c208c16u;
      case 2: return 0x6871ca8du;
      case 3: return 0x97816a91u;
      case 4: return 0x8181585du;
      case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u;
      default: return 0x30644e72u;
    }
  }
  static __device__ __forceinline__ uint32_t one(int i) {  // R mod q
    switch (i) {
      case 0: return 0xc58f0d9du;
      case 1: return 0xd35d438du;
      case 2: return 0xf5c70b3du;
      case 3: return 0x0a78eb28u;
      case 4: return 0x7879462cu;
      case 5: return 0x666ea36fu;
      case 6: return 0x9a07df2fu;
      default: return 0x0e0a77c1u;
    }
  }
};

__device__ __forceinline__ bool f_is_zero(const uint32_t a[NL]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) acc |= a[i];
  return acc == 0;
}

__device__ __forceinline__ void f_copy(uint32_t r[NL], const uint32_t a[NL]) {
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = a[i];
}

template <class F>
__device__ __forceinline__ void f_one(uint32_t r[NL]) {
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = F::one(i);
}

__device__ __forceinline__ void f_zero(uint32_t r[NL]) {
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = 0;
}

// s - p with borrow out; d receives the low 256 bits.
template <class F>
__device__ __forceinline__ uint32_t f_sub_p(uint32_t d[NL], const uint32_t s[NL]) {
  uint32_t br = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t t = (uint64_t)s[i] - F::p(i) - br;
    d[i] = (uint32_t)t;
    br = (uint32_t)(t >> 63);
  }
  return br;
}

// (a + b) mod p for a, b in [0, p).
template <class F>
__device__ __forceinline__ void f_add(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
  uint32_t s[NL], d[NL];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t t = (uint64_t)a[i] + b[i] + c;
    s[i] = (uint32_t)t;
    c = t >> 32;
  }
  uint32_t br = f_sub_p<F>(d, s);
  bool use_d = (c != 0) || (br == 0);
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = use_d ? d[i] : s[i];
}

// (a - b) mod p for a, b in [0, p).
template <class F>
__device__ __forceinline__ void f_sub(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
  uint32_t d[NL];
  uint32_t br = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t t = (uint64_t)a[i] - b[i] - br;
    d[i] = (uint32_t)t;
    br = (uint32_t)(t >> 63);
  }
  uint64_t c = 0;
  uint32_t mask = 0u - br;  // all ones when a < b: add p back
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t t = (uint64_t)d[i] + (F::p(i) & mask) + c;
    r[i] = (uint32_t)t;
    c = t >> 32;
  }
}

// (-a) mod p; maps 0 to 0.
template <class F>
__device__ __forceinline__ void f_neg(uint32_t r[NL], const uint32_t a[NL]) {
  bool z = f_is_zero(a);
  uint32_t d[NL];
  uint32_t br = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t t = (uint64_t)F::p(i) - a[i] - br;
    d[i] = (uint32_t)t;
    br = (uint32_t)(t >> 63);
  }
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = z ? 0u : d[i];
}

// Montgomery product a*b*2^-256 mod p (CIOS, 64-bit accumulators).
// Inputs in [0, p); p < 2^254 keeps every intermediate t below 2p, so
// one conditional subtraction gives the canonical result.
template <class F>
__device__ __forceinline__ void f_mul(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int j = 0; j < NL + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t c = 0;
    const uint32_t bi = b[i];
#pragma unroll
    for (int j = 0; j < NL; j++) {
      uint64_t s = (uint64_t)a[j] * bi + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NL] + c;
    t[NL] = (uint32_t)s;
    t[NL + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::N0;
    s = (uint64_t)m * F::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NL; j++) {
      s = (uint64_t)m * F::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NL] + c;
    t[NL - 1] = (uint32_t)s;
    t[NL] = t[NL + 1] + (uint32_t)(s >> 32);
  }
  uint32_t d[NL];
  uint32_t br = f_sub_p<F>(d, t);
  bool use_d = (t[NL] != 0) || (br == 0);
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = use_d ? d[i] : t[i];
}

// Load / store one element of a limb-major (8, n) array.
__device__ __forceinline__ void f_load(uint32_t r[NL], const uint32_t* base, long long stride, long long idx) {
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = base[i * stride + idx];
}

__device__ __forceinline__ void f_store(uint32_t* base, long long stride, long long idx, const uint32_t a[NL]) {
#pragma unroll
  for (int i = 0; i < NL; i++) base[i * stride + idx] = a[i];
}
