// K3: elementwise BN254 field kernels (mont_mul, add, sub, neg).
//
// Replaces the XLA graph of noir_backend_using_gnark_tpu/ops/field.py
// (mont_mul at line 219, a lazy-carry CIOS over 16x16-bit limbs, and
// add/sub/neg beside it). Torch has no 256-bit modular arithmetic, so
// every plain point and polynomial operation of the port runs on this
// one kernel.
//
// Bound: one mont_mul reads 64 bytes and writes 32 bytes per element
// and does 136 32x32->64-bit products (272 integer multiply-adds): at
// the card's rates the bytes take longer than the products, so the
// kernel is memory-bound and is written as one pass with coalesced
// limb-major loads (consecutive threads read consecutive elements of
// each limb plane). One thread owns one element; there is no shared
// memory and no reuse to exploit.
//
// Operand b (and a) may be a broadcast: it is read at index j % period,
// which covers a full operand (period n), a scalar (period 1) and a
// vector repeated over leading batch axes (period = its length).
#include "field.cuh"

enum { OP_MUL = 0, OP_ADD = 1, OP_SUB = 2, OP_NEG = 3 };

template <class F, int OP>
__global__ void field_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b, long long n, long long pa,
                             long long pb) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint32_t x[NL], y[NL], r[NL];
  f_load(x, a, pa, pa == n ? j : j % pa);
  if (OP != OP_NEG) f_load(y, b, pb, pb == n ? j : j % pb);
  if (OP == OP_MUL) f_mul<F>(r, x, y);
  if (OP == OP_ADD) f_add<F>(r, x, y);
  if (OP == OP_SUB) f_sub<F>(r, x, y);
  if (OP == OP_NEG) f_neg<F>(r, x);
  f_store(out, n, j, r);
}

template <class F>
static void launch(int op, uint32_t* out, const uint32_t* a, const uint32_t* b, long long n,
                   long long pa, long long pb, cudaStream_t s) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  switch (op) {
    case OP_MUL: field_kernel<F, OP_MUL><<<blocks, threads, 0, s>>>(out, a, b, n, pa, pb); break;
    case OP_ADD: field_kernel<F, OP_ADD><<<blocks, threads, 0, s>>>(out, a, b, n, pa, pb); break;
    case OP_SUB: field_kernel<F, OP_SUB><<<blocks, threads, 0, s>>>(out, a, b, n, pa, pb); break;
    default: field_kernel<F, OP_NEG><<<blocks, threads, 0, s>>>(out, a, b, n, pa, pb); break;
  }
}

// field: 0 = Fr, 1 = Fq. Returns cudaGetLastError() after the launch.
extern "C" int field_op(int op, int field, void* out, const void* a, const void* b,
                        long long n, long long pa, long long pb, void* stream) {
  if (n <= 0) return 0;
  if (op < OP_MUL || op > OP_NEG || field < 0 || field > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    launch<Fr>(op, (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, pa, pb, s);
  else
    launch<Fq>(op, (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, pa, pb, s);
  return (int)cudaGetLastError();
}

extern "C" const char* field_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
