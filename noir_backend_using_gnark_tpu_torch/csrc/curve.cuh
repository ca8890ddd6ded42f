// BN254 G1 in Jacobian coordinates over Fq (device side), shared by the
// MSM kernels. Infinity is Z == 0. Every formula here is complete: the
// cases the TPU kernel handled with its lane-select redo (empty bucket,
// infinity or zero digit, doubling, P + (-P)) are plain branches, which
// cost a GPU thread nothing when they are not taken.
#pragma once

#include "field.cuh"

struct Jac {
  uint32_t x[NL], y[NL], z[NL];
};

__device__ __forceinline__ void jac_set_inf(Jac& r) {
  f_one<Fq>(r.x);
  f_one<Fq>(r.y);
  f_zero(r.z);
}

__device__ __forceinline__ bool jac_is_inf(const Jac& p) { return f_is_zero(p.z); }

// 2P, dbl-2009-l (a = 0). Infinity stays infinity (Z3 = 2YZ = 0);
// BN254 G1 has no point of order 2, so Y != 0 for finite P.
__device__ void jac_dbl(Jac& r, const Jac& p) {
  uint32_t a[NL], b[NL], cc[NL], d[NL], e[NL], f[NL], t[NL];
  f_mul<Fq>(a, p.x, p.x);
  f_mul<Fq>(b, p.y, p.y);
  f_mul<Fq>(cc, b, b);
  f_add<Fq>(t, p.x, b);
  f_mul<Fq>(d, t, t);
  f_sub<Fq>(d, d, a);
  f_sub<Fq>(d, d, cc);
  f_add<Fq>(d, d, d);
  f_add<Fq>(e, a, a);
  f_add<Fq>(e, e, a);
  f_mul<Fq>(f, e, e);
  uint32_t x3[NL], y3[NL], z3[NL];
  f_add<Fq>(t, d, d);
  f_sub<Fq>(x3, f, t);
  f_sub<Fq>(t, d, x3);
  f_mul<Fq>(y3, e, t);
  f_add<Fq>(cc, cc, cc);
  f_add<Fq>(cc, cc, cc);
  f_add<Fq>(cc, cc, cc);
  f_sub<Fq>(y3, y3, cc);
  f_mul<Fq>(z3, p.y, p.z);
  f_add<Fq>(z3, z3, z3);
  f_copy(r.x, x3);
  f_copy(r.y, y3);
  f_copy(r.z, z3);
}

// P + Q, both Jacobian; complete.
__device__ void jac_add(Jac& r, const Jac& p, const Jac& q) {
  if (jac_is_inf(p)) { r = q; return; }
  if (jac_is_inf(q)) { r = p; return; }
  uint32_t z1z1[NL], z2z2[NL], u1[NL], u2[NL], s1[NL], s2[NL], h[NL], rr[NL], t[NL];
  f_mul<Fq>(z1z1, p.z, p.z);
  f_mul<Fq>(z2z2, q.z, q.z);
  f_mul<Fq>(u1, p.x, z2z2);
  f_mul<Fq>(u2, q.x, z1z1);
  f_mul<Fq>(t, q.z, z2z2);
  f_mul<Fq>(s1, p.y, t);
  f_mul<Fq>(t, p.z, z1z1);
  f_mul<Fq>(s2, q.y, t);
  f_sub<Fq>(h, u2, u1);
  f_sub<Fq>(rr, s2, s1);
  if (f_is_zero(h)) {
    if (f_is_zero(rr)) jac_dbl(r, p);
    else jac_set_inf(r);
    return;
  }
  uint32_t hh[NL], hhh[NL], v[NL], x3[NL], y3[NL], z3[NL];
  f_mul<Fq>(hh, h, h);
  f_mul<Fq>(hhh, h, hh);
  f_mul<Fq>(v, u1, hh);
  f_mul<Fq>(x3, rr, rr);
  f_sub<Fq>(x3, x3, hhh);
  f_add<Fq>(t, v, v);
  f_sub<Fq>(x3, x3, t);
  f_sub<Fq>(t, v, x3);
  f_mul<Fq>(y3, rr, t);
  f_mul<Fq>(t, s1, hhh);
  f_sub<Fq>(y3, y3, t);
  f_mul<Fq>(z3, p.z, q.z);
  f_mul<Fq>(z3, z3, h);
  f_copy(r.x, x3);
  f_copy(r.y, y3);
  f_copy(r.z, z3);
}

// P + (qx, qy) with the second point affine and finite; complete.
__device__ void jac_add_affine(Jac& r, const Jac& p, const uint32_t qx[NL], const uint32_t qy[NL]) {
  if (jac_is_inf(p)) {
    f_copy(r.x, qx);
    f_copy(r.y, qy);
    f_one<Fq>(r.z);
    return;
  }
  uint32_t z1z1[NL], u2[NL], s2[NL], h[NL], rr[NL], t[NL];
  f_mul<Fq>(z1z1, p.z, p.z);
  f_mul<Fq>(u2, qx, z1z1);
  f_mul<Fq>(t, p.z, z1z1);
  f_mul<Fq>(s2, qy, t);
  f_sub<Fq>(h, u2, p.x);
  f_sub<Fq>(rr, s2, p.y);
  if (f_is_zero(h)) {
    if (f_is_zero(rr)) jac_dbl(r, p);
    else jac_set_inf(r);
    return;
  }
  uint32_t hh[NL], hhh[NL], v[NL], x3[NL], y3[NL], z3[NL];
  f_mul<Fq>(hh, h, h);
  f_mul<Fq>(hhh, h, hh);
  f_mul<Fq>(v, p.x, hh);
  f_mul<Fq>(x3, rr, rr);
  f_sub<Fq>(x3, x3, hhh);
  f_add<Fq>(t, v, v);
  f_sub<Fq>(x3, x3, t);
  f_sub<Fq>(t, v, x3);
  f_mul<Fq>(y3, rr, t);
  f_mul<Fq>(t, p.y, hhh);
  f_sub<Fq>(y3, y3, t);
  f_mul<Fq>(z3, p.z, h);
  f_copy(r.x, x3);
  f_copy(r.y, y3);
  f_copy(r.z, z3);
}

// Load / store a point from three limb-planes groups: coordinate c,
// limb l of element idx at base[(c * NL + l) * stride + idx].
__device__ __forceinline__ void jac_load(Jac& p, const uint32_t* base, long long stride, long long idx) {
  f_load(p.x, base, stride, idx);
  f_load(p.y, base + NL * stride, stride, idx);
  f_load(p.z, base + 2 * NL * stride, stride, idx);
}

__device__ __forceinline__ void jac_store(uint32_t* base, long long stride, long long idx, const Jac& p) {
  f_store(base, stride, idx, p.x);
  f_store(base + NL * stride, stride, idx, p.y);
  f_store(base + 2 * NL * stride, stride, idx, p.z);
}
