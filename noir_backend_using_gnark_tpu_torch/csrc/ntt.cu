// K4: radix-2 NTT over BN254 Fr, batched along the last axis.
//
// Replaces noir_backend_using_gnark_tpu/ops/ntt.py::ntt_stages (line
// 174, a scan of log2 n gather/butterfly stages) and the TPU's MXU
// four-step forms in ops/mxu_ntt.py (ntt_mxu, ntt_mxu_big). All three
// compute the same field elements, and so does this kernel: the
// bit-reversed decimation-in-time transform with natural order in and
// natural order out.
//
// Layout: (8, B, n) limb-major int32 words, limb i of element (b, j) at
// i * B * n + b * n + j. The twiddle table is (8, n/2): [w^0 .. w^{n/2-1}].
//
// Bound: n/2 * log2 n Montgomery products per polynomial, each 272
// integer multiply-adds, against 64 bytes of data read and written per
// element once: the products dominate at every size the prover uses,
// so the transform is compute-bound. This first version is simple:
// one launch for the bit-reversal copy (which also applies an optional
// scalar factor, the 1/n of the inverse transform) and one launch per
// butterfly stage, each thread owning one butterfly. Stages that fit in
// shared memory could be fused into one launch; that is later work.
#include "field.cuh"

__global__ void bitrev_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ in,
                              const uint32_t* __restrict__ scale, long long nb, int logn) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nb) return;
  const long long n = 1LL << logn;
  const long long base = e & ~(n - 1);
  const uint32_t j = (uint32_t)(e & (n - 1));
  const uint32_t rj = logn == 0 ? 0u : (__brev(j) >> (32 - logn));
  uint32_t x[NL];
  f_load(x, in, nb, base + rj);
  if (scale != nullptr) {
    uint32_t s[NL];
    f_load(s, scale, 1, 0);
    f_mul<Fr>(x, x, s);
  }
  f_store(out, nb, e, x);
}

__global__ void stage_kernel(uint32_t* __restrict__ data, const uint32_t* __restrict__ table,
                             long long nb, int logn, int s) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (nb >> 1)) return;
  const long long hn = 1LL << (logn - 1);     // butterflies per polynomial
  const long long poly = t >> (logn - 1);
  const long long p = t & (hn - 1);
  const long long half = 1LL << (s - 1);
  const long long jj = p & (half - 1);
  const long long blk = p >> (s - 1);
  const long long i0 = (poly << logn) + (blk << s) + jj;
  const long long i1 = i0 + half;
  uint32_t u[NL], v[NL], w[NL], r[NL];
  f_load(u, data, nb, i0);
  f_load(v, data, nb, i1);
  f_load(w, table, hn, jj << (logn - s));
  f_mul<Fr>(v, v, w);
  f_add<Fr>(r, u, v);
  f_store(data, nb, i0, r);
  f_sub<Fr>(r, u, v);
  f_store(data, nb, i1, r);
}

// out (8, batch, 2^logn) <- NTT of in along the last axis, times the
// scalar `scale` (8 limbs) when it is not null. table: (8, 2^(logn-1)).
extern "C" int ntt_run(void* out, const void* in, const void* table, const void* scale,
                       long long batch, int logn, void* stream) {
  if (logn < 0 || logn > 28) return (int)cudaErrorInvalidValue;
  const long long nb = batch << logn;
  if (nb <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  bitrev_kernel<<<(nb + threads - 1) / threads, threads, 0, st>>>(
      (uint32_t*)out, (const uint32_t*)in, (const uint32_t*)scale, nb, logn);
  for (int s = 1; s <= logn; s++) {
    stage_kernel<<<((nb >> 1) + threads - 1) / threads, threads, 0, st>>>(
        (uint32_t*)out, (const uint32_t*)table, nb, logn, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ntt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
