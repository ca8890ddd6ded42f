// K1: Pippenger bucket accumulation over BN254 G1.
//
// Replaces noir_backend_using_gnark_tpu/ops/msm_pallas.py::
// accumulate_buckets_pallas (line 645; kernel body _accum_kernel,
// 514-732) and keeps its contract: for every window w < W and bucket
// b < B = 2^(c-1) + 1, the Jacobian sum
//     S[w][b] = sum over points j with |digit(w, j)| == b of sign * P_j,
// bucket 0 left at infinity. The signed c-bit digits are computed by the
// caller (ops/msm.py::signed_digits) and arrive as an int8 stream, with
// infinity inputs already given digit 0.
//
// What is not kept: the TPU's select-chain bucket tables, which exist
// because TPU lanes cannot gather. Here each thread owns a private
// bucket table for one window and walks a strided slice of the points
// (the GPU analogue of the TPU's 128 per-lane tables); a fold pass then
// sums the T tables of each window with complete additions, F tables
// per thread per launch, until one table is left.
//
// Bound: about 11 Montgomery products per (window, nonzero digit) pair
// in the accumulation, against 64 bytes of points and W bytes of digits
// per point: the products dominate by far, so the kernel is
// compute-bound. The bucket tables (T * W * B points) live in device
// memory and mostly in L2; they are read and written once per add.
// Sorting points by (window, digit) to share work is later work.
#include "curve.cuh"

// Table layout: limb-plane major, (24, W, B, T): coordinate c, limb l of
// bucket (w, b) of table t at ((c * 8 + l) * W * B + w * B + b) * T + t.
__global__ void accum_kernel(uint32_t* __restrict__ tables, const uint32_t* __restrict__ px,
                             const uint32_t* __restrict__ py, const int8_t* __restrict__ digits,
                             long long n, int W, int B, int T) {
  long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)W * T) return;
  const int w = (int)(gid / T);
  const int t = (int)(gid % T);
  const long long stride = (long long)W * B * T;
  Jac inf;
  jac_set_inf(inf);
  for (int b = 0; b < B; b++) jac_store(tables, stride, ((long long)w * B + b) * T + t, inf);
  for (long long j = t; j < n; j += T) {
    const int d = digits[(long long)w * n + j];
    if (d == 0) continue;
    const int b = d < 0 ? -d : d;
    uint32_t qx[NL], qy[NL];
    f_load(qx, px, n, j);
    f_load(qy, py, n, j);
    if (d < 0) f_neg<Fq>(qy, qy);
    const long long slot = ((long long)w * B + b) * T + t;
    Jac acc;
    jac_load(acc, tables, stride, slot);
    jac_add_affine(acc, acc, qx, qy);
    jac_store(tables, stride, slot, acc);
  }
}

// dst[(w, b), g] = sum of src[(w, b), t] for t in [g * F, (g + 1) * F).
__global__ void fold_kernel(uint32_t* __restrict__ dst, const uint32_t* __restrict__ src, int W,
                            int B, int t_in, int t_out, int F) {
  long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long wb_count = (long long)W * B;
  if (gid >= wb_count * t_out) return;
  const long long wb = gid / t_out;
  const int g = (int)(gid % t_out);
  const long long s_stride = wb_count * t_in;
  const long long d_stride = wb_count * t_out;
  Jac acc;
  jac_load(acc, src, s_stride, wb * t_in + (long long)g * F);
  for (int k = 1; k < F; k++) {
    const int t = g * F + k;
    if (t >= t_in) break;
    Jac q;
    jac_load(q, src, s_stride, wb * t_in + t);
    jac_add(acc, acc, q);
  }
  jac_store(dst, d_stride, wb * t_out + g, acc);
}

// out: (24, W, B) Jacobian bucket sums. scratch_a: (24, W, B, T);
// scratch_b: (24, W, B, ceil(T / fold)). px, py: (8, n) Fq Montgomery
// affine; digits: (W, n) int8 signed digits, |digit| < B.
extern "C" int msm_accumulate(void* out, void* scratch_a, void* scratch_b, const void* px,
                              const void* py, const void* digits, long long n, int W, int B,
                              int T, int fold, void* stream) {
  if (n <= 0 || W <= 0 || B <= 0 || T <= 0 || fold < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 128;
  const long long workers = (long long)W * T;
  accum_kernel<<<(workers + threads - 1) / threads, threads, 0, st>>>(
      (uint32_t*)scratch_a, (const uint32_t*)px, (const uint32_t*)py, (const int8_t*)digits, n,
      W, B, T);
  uint32_t* src = (uint32_t*)scratch_a;
  int t_in = T;
  while (true) {
    const int t_out = (t_in + fold - 1) / fold;
    uint32_t* dst = t_out == 1 ? (uint32_t*)out
                               : (src == (uint32_t*)scratch_a ? (uint32_t*)scratch_b
                                                              : (uint32_t*)scratch_a);
    const long long jobs = (long long)W * B * t_out;
    fold_kernel<<<(jobs + threads - 1) / threads, threads, 0, st>>>(dst, src, W, B, t_in, t_out,
                                                                   fold);
    if (t_out == 1) break;
    src = dst;
    t_in = t_out;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* msm_accum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
