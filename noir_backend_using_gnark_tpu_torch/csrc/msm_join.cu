// K2: Pippenger window join, sum_w 2^(c*w) * T[k][w] for K <= 8 MSMs.
//
// Replaces noir_backend_using_gnark_tpu/ops/msm_pallas.py::
// join_windows_pallas (line 477; kernel body _join_kernel, 436-506),
// which did masked complete doublings per lane and a lane fold. The
// work is a chain of c * (W - 1) doublings and W additions per MSM that
// cannot be shortened, and K is at most 8, so this kernel runs Horner
// over the windows, highest first, with one thread per MSM: the bound
// is the latency of the chain, not bytes or throughput. The formulas
// are the complete ones of curve.cuh, so infinity totals, an infinity
// accumulator and equal or opposite partial sums are handled.
#include "curve.cuh"

// totals: x, y, z each (8, K, W) limb-major. out: (24, K).
__global__ void join_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ tx,
                            const uint32_t* __restrict__ ty, const uint32_t* __restrict__ tz,
                            int K, int W, int c) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const long long stride = (long long)K * W;
  Jac acc;
  jac_set_inf(acc);
  for (int w = W - 1; w >= 0; w--) {
    for (int i = 0; i < c; i++) jac_dbl(acc, acc);
    Jac q;
    const long long idx = (long long)k * W + w;
    f_load(q.x, tx, stride, idx);
    f_load(q.y, ty, stride, idx);
    f_load(q.z, tz, stride, idx);
    jac_add(acc, acc, q);
  }
  jac_store(out, K, k, acc);
}

extern "C" int msm_join(void* out, const void* tx, const void* ty, const void* tz, int K, int W,
                        int c, void* stream) {
  if (K <= 0 || K > 8 || W <= 0 || W > 128 || c <= 0) return (int)cudaErrorInvalidValue;
  join_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((uint32_t*)out, (const uint32_t*)tx,
                                                  (const uint32_t*)ty, (const uint32_t*)tz, K, W,
                                                  c);
  return (int)cudaGetLastError();
}

extern "C" const char* msm_join_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
