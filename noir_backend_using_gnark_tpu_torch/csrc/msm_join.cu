// K2: Pippenger window join, sum_w 2^(c*w) * T[k][w] for K <= 8 MSMs.
//
// Replaces noir_backend_using_gnark_tpu/ops/msm_pallas.py::
// join_windows_pallas (line 477; kernel body _join_kernel, 436-506;
// pallas_call at 492), which did masked complete doublings per lane and
// a lane fold.
//
// What bounds it on this card: the join is Horner over the windows,
// highest first, a chain of c * (W - 1) doublings and W - 1 complete
// additions per MSM that no design can shorten (scaling by 2^(c(W-1))
// takes that many doublings), and K is at most 8. So the bound is the
// latency of the chain, not bytes or the multiply-add rate: a serial
// doubling is 7 dependent Montgomery products, a serial addition 16.
//
// The design cuts the depth of each step instead: one warp per MSM,
// every lane holding the whole accumulator, and the independent
// products of a step computed at once on lanes 0-3 (lane & 3 picks the
// product), then broadcast with warp shuffles. A doubling (dbl-2009-l)
// becomes 3 rounds of products, an addition (add-2007-bl, complete) 5,
// so a join at c = 6, W = 43 is 252 * 3 + 42 * 5 = 966 dependent
// products instead of about 2,450. The formulas and their branches are
// those of curve.cuh (every lane takes the same branch, as every lane
// holds the same values), so infinite totals, an infinite accumulator
// and equal or opposite partial sums are handled. On request the kernel
// writes, per MSM, the number of rounds of products its chain ran.
#include "curve.cuh"

#define FULL_MASK 0xffffffffu

__device__ __forceinline__ void f_from_lane(uint32_t r[NL], const uint32_t v[NL], int src) {
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = __shfl_sync(FULL_MASK, v[i], src);
}

// r = a[role] for role in 0..3.
__device__ __forceinline__ void f_pick(uint32_t r[NL], int role, const uint32_t a0[NL],
                                       const uint32_t a1[NL], const uint32_t a2[NL],
                                       const uint32_t a3[NL]) {
#pragma unroll
  for (int i = 0; i < NL; i++)
    r[i] = role == 0 ? a0[i] : role == 1 ? a1[i] : role == 2 ? a2[i] : a3[i];
}

// p <- 2p, dbl-2009-l (a = 0) as jac_dbl computes it, in DBL_ROUNDS rounds.
#define DBL_ROUNDS 3
__device__ void warp_dbl(Jac& p, int role) {
  uint32_t a[NL], b[NL], m[NL];
  // Round 1: A = X^2 (lane 0), B = Y^2 (1), Y * Z (2).
  f_pick(a, role, p.x, p.y, p.y, p.y);
  f_pick(b, role, p.x, p.y, p.z, p.z);
  f_mul<Fq>(m, a, b);
  uint32_t A[NL], Bs[NL], yz[NL];
  f_from_lane(A, m, 0);
  f_from_lane(Bs, m, 1);
  f_from_lane(yz, m, 2);
  // Round 2: C = B^2 (0), (X + B)^2 (1), F = E^2 with E = 3A (2).
  uint32_t e[NL], t[NL];
  f_add<Fq>(e, A, A);
  f_add<Fq>(e, e, A);
  f_add<Fq>(t, p.x, Bs);
  f_pick(a, role, Bs, t, e, e);
  f_mul<Fq>(m, a, a);
  uint32_t cc[NL], t2[NL], f[NL];
  f_from_lane(cc, m, 0);
  f_from_lane(t2, m, 1);
  f_from_lane(f, m, 2);
  // D = 2((X + B)^2 - A - C), X3 = F - 2D.
  uint32_t d[NL];
  f_sub<Fq>(d, t2, A);
  f_sub<Fq>(d, d, cc);
  f_add<Fq>(d, d, d);
  f_add<Fq>(t, d, d);
  f_sub<Fq>(p.x, f, t);
  // Round 3 (every lane): Y3 = E (D - X3) - 8C; Z3 = 2YZ.
  f_sub<Fq>(t, d, p.x);
  f_mul<Fq>(p.y, e, t);
  f_add<Fq>(cc, cc, cc);
  f_add<Fq>(cc, cc, cc);
  f_add<Fq>(cc, cc, cc);
  f_sub<Fq>(p.y, p.y, cc);
  f_add<Fq>(p.z, yz, yz);
}

// p <- p + q, both Jacobian, complete, as jac_add computes it, in 5
// rounds; returns the number of rounds it ran.
__device__ int warp_add(Jac& p, const Jac& q, int role) {
  if (jac_is_inf(q)) return 0;
  if (jac_is_inf(p)) {
    p = q;
    return 0;
  }
  uint32_t a[NL], b[NL], m[NL];
  // Round 1: Z1^2 (0), Z2^2 (1), Z1 Z2 (2).
  f_pick(a, role, p.z, q.z, p.z, p.z);
  f_pick(b, role, p.z, q.z, q.z, q.z);
  f_mul<Fq>(m, a, b);
  uint32_t z1z1[NL], z2z2[NL], z1z2[NL];
  f_from_lane(z1z1, m, 0);
  f_from_lane(z2z2, m, 1);
  f_from_lane(z1z2, m, 2);
  // Round 2: U1 = X1 Z2^2 (0), U2 = X2 Z1^2 (1), Z2^3 (2), Z1^3 (3).
  f_pick(a, role, p.x, q.x, q.z, p.z);
  f_pick(b, role, z2z2, z1z1, z2z2, z1z1);
  f_mul<Fq>(m, a, b);
  uint32_t u1[NL], u2[NL], z2c[NL], z1c[NL];
  f_from_lane(u1, m, 0);
  f_from_lane(u2, m, 1);
  f_from_lane(z2c, m, 2);
  f_from_lane(z1c, m, 3);
  uint32_t h[NL];
  f_sub<Fq>(h, u2, u1);
  // Round 3: S1 = Y1 Z2^3 (0), S2 = Y2 Z1^3 (1), H^2 (2), Z3 = Z1 Z2 H (3).
  f_pick(a, role, p.y, q.y, h, z1z2);
  f_pick(b, role, z2c, z1c, h, h);
  f_mul<Fq>(m, a, b);
  uint32_t s1[NL], s2[NL], hh[NL], z3[NL];
  f_from_lane(s1, m, 0);
  f_from_lane(s2, m, 1);
  f_from_lane(hh, m, 2);
  f_from_lane(z3, m, 3);
  uint32_t rr[NL];
  f_sub<Fq>(rr, s2, s1);
  if (f_is_zero(h)) {
    if (!f_is_zero(rr)) {
      jac_set_inf(p);
      return 3;
    }
    warp_dbl(p, role);
    return 3 + DBL_ROUNDS;
  }
  // Round 4: H^3 (0), V = U1 H^2 (1), R^2 (2).
  f_pick(a, role, h, u1, rr, rr);
  f_pick(b, role, hh, hh, rr, rr);
  f_mul<Fq>(m, a, b);
  uint32_t hhh[NL], v[NL], r2[NL];
  f_from_lane(hhh, m, 0);
  f_from_lane(v, m, 1);
  f_from_lane(r2, m, 2);
  // X3 = R^2 - H^3 - 2V.
  uint32_t t[NL];
  f_sub<Fq>(p.x, r2, hhh);
  f_add<Fq>(t, v, v);
  f_sub<Fq>(p.x, p.x, t);
  // Round 5: R (V - X3) (0), S1 H^3 (1); Y3 is their difference.
  f_sub<Fq>(t, v, p.x);
  f_pick(a, role, rr, s1, s1, s1);
  f_pick(b, role, t, hhh, hhh, hhh);
  f_mul<Fq>(m, a, b);
  uint32_t y0[NL], y1[NL];
  f_from_lane(y0, m, 0);
  f_from_lane(y1, m, 1);
  f_sub<Fq>(p.y, y0, y1);
  f_copy(p.z, z3);
  return 5;
}

// totals: x, y, z each (8, K, W) limb-major. out: (24, K). rounds:
// null, or (K,) to receive the rounds of products each MSM's chain ran.
// One block of one warp per MSM.
__global__ void __launch_bounds__(32)
k2_join(uint32_t* __restrict__ out, int* __restrict__ rounds, const uint32_t* __restrict__ tx,
        const uint32_t* __restrict__ ty, const uint32_t* __restrict__ tz, int K, int W, int c) {
  const int k = blockIdx.x;
  const int role = threadIdx.x & 3;
  const long long stride = (long long)K * W;
  Jac acc;
  const long long top = (long long)k * W + W - 1;
  f_load(acc.x, tx, stride, top);
  f_load(acc.y, ty, stride, top);
  f_load(acc.z, tz, stride, top);
  int chain = 0;
  for (int w = W - 2; w >= 0; w--) {
    for (int i = 0; i < c; i++) warp_dbl(acc, role);
    chain += c * DBL_ROUNDS;
    Jac q;
    const long long idx = (long long)k * W + w;
    f_load(q.x, tx, stride, idx);
    f_load(q.y, ty, stride, idx);
    f_load(q.z, tz, stride, idx);
    chain += warp_add(acc, q, role);
  }
  if (threadIdx.x == 0) {
    jac_store(out, K, k, acc);
    if (rounds) rounds[k] = chain;
  }
}

extern "C" int msm_join(void* out, void* rounds, const void* tx, const void* ty, const void* tz,
                        int K, int W, int c, void* stream) {
  if (K <= 0 || K > 8 || W <= 0 || W > 128 || c <= 0) return (int)cudaErrorInvalidValue;
  k2_join<<<K, 32, 0, (cudaStream_t)stream>>>((uint32_t*)out, (int*)rounds, (const uint32_t*)tx,
                                              (const uint32_t*)ty, (const uint32_t*)tz, K, W, c);
  return (int)cudaGetLastError();
}

extern "C" const char* msm_join_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
