// K4: NTT over BN254 Fr, batched along the last axis, as fused
// shared-memory passes.
//
// Replaces noir_backend_using_gnark_tpu/ops/ntt.py::ntt_stages (line
// 174, a scan of log2 n gather/butterfly stages) and the TPU's MXU
// four-step forms in ops/mxu_ntt.py (ntt_mxu, ntt_mxu_big). All three
// compute the same field elements, and so does this kernel: natural
// order in, natural order out, times an optional single-element scale
// (the 1/n of the inverse transform).
//
// Layout: (8, B, n) limb-major int32 words, limb i of element (b, j) at
// i * B * n + b * n + j. The twiddle table is (8, n/2): [w^0 .. w^{n/2-1}],
// and every root the kernel needs comes from it, with w^e = -w^{e-n/2}
// for e >= n/2.
//
// Bound: n/2 * log2 n Montgomery products per polynomial (264 integer
// multiply-adds each) against 64 bytes read and written per element: at
// the card's rates the products set the pace at every size the prover
// uses, and one read and one write of the batch cost a seventh of them
// at (8, 14, 2^18).
//
// The first design launched a bit-reversal pass and then one kernel per
// stage, one butterfly per thread: at 2^18 that was 19 launches, each
// reading and writing the whole batch (about 4.5 GB at (8, 14, 2^18)),
// with the early stages' twiddles strided across the table. This one
// touches device memory once per pass:
//
//   * log2 n is split into P passes of at most NTT_LMAX bits (ntt_split;
//     P = 1 up to 2^9, 2 up to 2^18, 3 up to 2^27, 4 at 2^28). With
//     n = L_0 ... L_{P-1}, input index j = sum j_q A_q and output index
//     k = sum k_q B_q (A_q = L_0 .. L_{q-1}, B_q = L_{q+1} .. L_{P-1}).
//     Pass 0 transforms digit P-1: columns of stride A_{P-1}, each
//     stored as a contiguous row at sum_{q<P-1} j_q B_q of `out`, the
//     one transposing pass. Pass p >= 1 transforms digit q = P-1-p in
//     place in `out`, at stride B_q. So the last pass leaves natural
//     order and no scratch is needed (the four-step order with the
//     transposition first).
//   * A block holds NTT_COLS sub-transforms of L_q <= 2^9 elements in
//     shared memory, limb-planar, each row padded by one word in 16 so
//     that the butterflies' strides spread over the banks. Its loads
//     are 4-byte cp.async (a warp reads whole 32-byte sectors: NTT_COLS
//     adjacent columns of one row, or one row), each element landing at
//     its bit-reversed slot, so there is no global bit reversal.
//   * The sub-transform runs as radix-4 rounds (two radix-2 stages on
//     four elements in registers between __syncthreads), one thread per
//     radix-4 unit up to 256 threads, after a lone radix-2 stage when
//     log2 L is odd; the first stage's twiddles are all 1 and are
//     skipped. Its roots w^(i n / L) are copied into shared memory once
//     per block.
//   * The epilogue multiplies each output by the next pass's twiddle
//     w^(A_{q-1} j_{q-1} (k B_q + s)), or by the scale after digit 0,
//     and stores it to device memory.
#include "field.cuh"

#define NTT_LMAX 9
#define NTT_COLS 4
#define NTT_MAX_PASSES 4
#define NTT_THREADS 256

enum { KIND_SINGLE = 0, KIND_FIRST = 1, KIND_INPLACE = 2 };

struct NttPass {
  long long n, nb, batch;
  int kind;                        // KIND_*
  int q;                           // the digit this pass transforms
  int npass;
  int parts[NTT_MAX_PASSES];       // log2 L_q
  int log_a[NTT_MAX_PASSES];       // log2 A_q
  int log_b[NTT_MAX_PASSES];       // log2 B_q
};

// Where one block's NTT_COLS sub-transforms live, and its epilogue.
struct BlockPlan {
  long long in0, in_c, in_j;       // element j of column c: in0 + c * in_c + j * in_j
  long long out0, out_c, out_k;    // output k of column c: out0 + c * out_c + k * out_k
  int cvalid;                      // columns that exist (fewer only for KIND_SINGLE)
  bool twiddle;                    // epilogue: twiddle, else the scale (if any)
  unsigned long long tm0, tmc, tmmask, km, s0, sc;
  // twiddle exponent of output k of column c:
  // ((tm0 + c * tmc) & tmmask) * (k * km + s0 + c * sc) mod n
};

__host__ __device__ inline int tile_pitch(int l) {
  const int L = 1 << l;
  return L + (L >> 4) + 4;
}

__host__ __device__ inline size_t smem_bytes(int l) {
  const int L = 1 << l;
  const int half = L > 1 ? L / 2 : 1;
  return 4u * (size_t)(8 * NTT_COLS * tile_pitch(l) + 8 * half);
}

__device__ __forceinline__ int swz(int i) { return i + (i >> 4); }

__device__ __forceinline__ int brev_bits(int j, int l) {
  return l == 0 ? 0 : (int)(__brev((unsigned)j) >> (32 - l));
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One element of a limb-planar shared array (limb planes `stride` apart).
__device__ __forceinline__ void s_load(uint32_t r[NL], const uint32_t* p, int stride) {
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = p[i * stride];
}

__device__ __forceinline__ void s_store(uint32_t* p, int stride, const uint32_t a[NL]) {
#pragma unroll
  for (int i = 0; i < NL; i++) p[i * stride] = a[i];
}

// (a, b) <- (a + b, a - b)
__device__ __forceinline__ void butterfly(uint32_t a[NL], uint32_t b[NL]) {
  uint32_t t[NL];
  f_add<Fr>(t, a, b);
  f_sub<Fr>(b, a, b);
  f_copy(a, t);
}

__device__ BlockPlan plan_block(const NttPass& ps, long long g) {
  BlockPlan bp;
  const long long n = ps.n;
  bp.cvalid = NTT_COLS;
  bp.twiddle = false;
  bp.tm0 = bp.tmc = bp.km = bp.s0 = bp.sc = 0;
  bp.tmmask = ~0ull;
  if (ps.kind == KIND_SINGLE) {
    // NTT_COLS whole polynomials, side by side.
    const long long poly0 = g * NTT_COLS;
    const long long left = ps.batch - poly0;
    bp.cvalid = left < NTT_COLS ? (int)left : NTT_COLS;
    bp.in0 = bp.out0 = poly0 * n;
    bp.in_c = bp.out_c = n;
    bp.in_j = bp.out_k = 1;
    return bp;
  }
  const int q = ps.q;
  const int l = ps.parts[q];
  if (ps.kind == KIND_FIRST) {
    // Digit P-1: columns col0 + c of stride A_{P-1}, stored as rows.
    const long long per_poly = (n >> l) / NTT_COLS;
    const long long poly = g / per_poly;
    const long long col0 = (g - poly * per_poly) * NTT_COLS;
    bp.in0 = poly * n + col0;
    bp.in_c = 1;
    bp.in_j = 1LL << ps.log_a[q];
    long long row = 0;
    for (int d = 0; d < ps.npass - 1; d++)
      row += ((col0 >> ps.log_a[d]) & ((1LL << ps.parts[d]) - 1)) << ps.log_b[d];
    bp.out0 = poly * n + row;
    bp.out_c = 1LL << ps.log_b[0];  // adjacent columns differ in j_0 only
    bp.out_k = 1;
    bp.twiddle = true;              // A_{q-1} j_{q-1} = col rounded down to A_{q-1}
    bp.tm0 = (unsigned long long)col0;
    bp.tmc = 1;
    bp.tmmask = ~((1ull << ps.log_a[q - 1]) - 1);
    bp.km = 1;
    return bp;
  }
  // KIND_INPLACE, digit q: prefix a (A_q of them), suffix s0 + c (B_q).
  const long long stride = 1LL << ps.log_b[q];
  const long long per_prefix = stride / NTT_COLS;
  const long long per_poly = (1LL << ps.log_a[q]) * per_prefix;
  const long long poly = g / per_poly;
  const long long h = g - poly * per_poly;
  const long long a = h / per_prefix;
  const long long s0 = (h - a * per_prefix) * NTT_COLS;
  bp.in0 = bp.out0 = poly * n + (a << (l + ps.log_b[q])) + s0;
  bp.in_c = bp.out_c = 1;
  bp.in_j = bp.out_k = stride;
  if (q >= 1) {
    bp.twiddle = true;
    bp.tm0 = (unsigned long long)(a & ((1LL << ps.parts[q - 1]) - 1)) << ps.log_a[q - 1];
    bp.km = (unsigned long long)stride;
    bp.s0 = (unsigned long long)s0;
    bp.sc = 1;
  }
  return bp;
}

// Every element of the block's columns, by 4-byte cp.async, to its
// bit-reversed slot of the tile (limb planes NTT_COLS * pitch apart).
// Column passes read NTT_COLS adjacent words of a row; one-pass blocks
// read along each polynomial.
template <int NT>
__device__ __forceinline__ void load_tile(uint32_t* tile, const uint32_t* in, const NttPass& ps,
                                          int l, int pitch) {
  const BlockPlan bp = plan_block(ps, blockIdx.x);
  const int L = 1 << l;
  const int lc = NTT_COLS * L;
  for (int w = threadIdx.x; w < 8 * lc; w += NT) {
    const int limb = w / lc;
    const int r = w - limb * lc;
    int c, j;
    if (ps.kind != KIND_SINGLE) {
      c = r % NTT_COLS;
      j = r / NTT_COLS;
    } else {
      j = r & (L - 1);
      c = r >> l;
    }
    if (c >= bp.cvalid) continue;
    cp_async4(tile + (limb * NTT_COLS + c) * pitch + swz(brev_bits(j, l)),
              in + limb * ps.nb + bp.in0 + c * bp.in_c + j * bp.in_j);
  }
}

// One pass: NTT_COLS sub-transforms of 2^l elements per block, with NT
// threads: one per radix-4 unit, at most NTT_THREADS (smaller
// sub-transforms take smaller blocks, more of them to an SM; the bound
// keeps 128 registers a thread at every NT). `in` and `out` are the same
// array for the in-place passes, so neither is __restrict__.
template <int NT>
__global__ void __launch_bounds__(NT, 2 * NTT_THREADS / NT)
ntt_pass(uint32_t* out, const uint32_t* in, const uint32_t* __restrict__ table,
         const uint32_t* __restrict__ scale, NttPass ps) {
  extern __shared__ uint32_t smem[];
  const int l = ps.parts[ps.q];
  const int L = 1 << l;
  const int pitch = tile_pitch(l);
  const int plane = NTT_COLS * pitch;  // words between limb planes of the tile
  const int half = L > 1 ? L / 2 : 1;  // roots held
  uint32_t* tile = smem;
  uint32_t* roots = smem + 8 * plane;
  const long long n = ps.n, nb = ps.nb;
  const long long tstride = n > 1 ? n / 2 : 1;
  const int tid = threadIdx.x;

  // ---- load: every element to its bit-reversed slot, and the roots ---
  load_tile<NT>(tile, in, ps, l, pitch);
  if (L > 1) {
    const long long step = n >> l;
    for (int w = tid; w < 8 * half; w += NT) {
      const int limb = w / half;
      const int i = w - limb * half;
      cp_async4(roots + w, table + limb * tstride + i * step);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- the sub-transforms: decimation in time, in place ---------------
  int s = 1;
  if (l & 1) {  // a lone stage 1: twiddles all 1
    for (int u = tid; u < NTT_COLS * (L >> 1); u += NT) {
      const int c = u >> (l - 1);
      const int i0 = (u & ((L >> 1) - 1)) << 1;
      uint32_t* row = tile + c * pitch;
      uint32_t e0[NL], e1[NL];
      s_load(e0, row + swz(i0), plane);
      s_load(e1, row + swz(i0 + 1), plane);
      butterfly(e0, e1);
      s_store(row + swz(i0), plane, e0);
      s_store(row + swz(i0 + 1), plane, e1);
    }
    s = 2;
    __syncthreads();
  }
  for (; s < l; s += 2) {  // stages s and s + 1
    const int h = 1 << (s - 1);
#pragma unroll 1
    for (int u = tid; u < NTT_COLS * (L >> 2); u += NT) {
      const int c = u >> (l - 2);
      const int v = u & ((L >> 2) - 1);
      const int jj = v & (h - 1);
      const int i0 = ((v >> (s - 1)) << (s + 1)) + jj;
      uint32_t* row = tile + c * pitch;
      uint32_t e0[NL], e1[NL], e2[NL], e3[NL], w[NL];
      s_load(e0, row + swz(i0), plane);
      s_load(e1, row + swz(i0 + h), plane);
      s_load(e2, row + swz(i0 + 2 * h), plane);
      s_load(e3, row + swz(i0 + 3 * h), plane);
      if (s > 1) {  // stage s: w_{2h}^jj (1 when s = 1)
        s_load(w, roots + jj * (L >> s), half);
        f_mul<Fr>(e1, e1, w);
        f_mul<Fr>(e3, e3, w);
      }
      butterfly(e0, e1);
      butterfly(e2, e3);
      if (s > 1) {  // stage s + 1: w_{4h}^jj (1 when s = 1)
        s_load(w, roots + jj * (L >> (s + 1)), half);
        f_mul<Fr>(e2, e2, w);
      }
      butterfly(e0, e2);
      s_load(w, roots + (jj + h) * (L >> (s + 1)), half);  // w_{4h}^(jj+h)
      f_mul<Fr>(e3, e3, w);
      butterfly(e1, e3);
      s_store(row + swz(i0), plane, e0);
      s_store(row + swz(i0 + h), plane, e1);
      s_store(row + swz(i0 + 2 * h), plane, e2);
      s_store(row + swz(i0 + 3 * h), plane, e3);
    }
    __syncthreads();
  }

  // ---- epilogue: twiddle or scale, then store ---------------------------
  // (the plan is derived again here, so that it holds no registers
  // through the butterflies)
  const BlockPlan bp = plan_block(ps, blockIdx.x);
  uint32_t factor[NL];
  const bool scaled = !bp.twiddle && scale != nullptr;
  if (scaled) f_load(factor, scale, 1, 0);
#pragma unroll 1
  for (int e = tid; e < NTT_COLS * L; e += NT) {
    int c, k;
    if (ps.kind == KIND_INPLACE) {  // rows of NTT_COLS adjacent words
      c = e % NTT_COLS;
      k = e / NTT_COLS;
    } else {
      k = e & (L - 1);
      c = e >> l;
    }
    if (c >= bp.cvalid) continue;
    uint32_t x[NL];
    s_load(x, tile + c * pitch + swz(k), plane);
    if (bp.twiddle) {
      const unsigned long long tm = (bp.tm0 + c * bp.tmc) & bp.tmmask;
      const unsigned long long ex = (tm * ((unsigned long long)k * bp.km + bp.s0 + c * bp.sc)) & (n - 1);
      if (ex != 0) {
        uint32_t w[NL];
        const bool neg = ex >= (unsigned long long)(n / 2);
        f_load(w, table, tstride, neg ? ex - n / 2 : ex);
        if (neg) f_neg<Fr>(w, w);
        f_mul<Fr>(x, x, w);
      }
    } else if (scaled) {
      f_mul<Fr>(x, x, factor);
    }
    f_store(out, nb, bp.out0 + c * bp.out_c + k * bp.out_k, x);
  }
}

// K4's split of logn into passes (ops/ntt.py::ntt_plan mirrors it): the
// fewest parts of at most NTT_LMAX bits, as equal as they can be, the
// larger ones first.
static int ntt_split(int logn, int parts[NTT_MAX_PASSES]) {
  const int npass = logn == 0 ? 1 : (logn + NTT_LMAX - 1) / NTT_LMAX;
  for (int p = 0; p < npass; p++) parts[p] = logn / npass + (p < logn % npass ? 1 : 0);
  return npass;
}

// out (8, batch, 2^logn) <- NTT of in along the last axis, times the
// scalar `scale` (8 limbs) when it is not null. table: (8, 2^(logn-1)).
// `out` must not overlap `in`; it also holds the passes' intermediates.
extern "C" int ntt_run(void* out, const void* in, const void* table, const void* scale,
                       long long batch, int logn, void* stream) {
  if (logn < 0 || logn > 28 || batch < 0) return (int)cudaErrorInvalidValue;
  const long long nb = batch << logn;
  if (nb <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  NttPass ps = {};
  ps.n = 1LL << logn;
  ps.nb = nb;
  ps.batch = batch;
  ps.npass = ntt_split(logn, ps.parts);
  int max_l = 0;
  for (int q = 0; q < ps.npass; q++) {
    ps.log_a[q] = ps.log_b[q] = 0;
    for (int d = 0; d < q; d++) ps.log_a[q] += ps.parts[d];
    for (int d = q + 1; d < ps.npass; d++) ps.log_b[q] += ps.parts[d];
    max_l = ps.parts[q] > max_l ? ps.parts[q] : max_l;
  }
  using PassFn = void (*)(uint32_t*, const uint32_t*, const uint32_t*, const uint32_t*, NttPass);
  const PassFn kernels[] = {ntt_pass<32>, ntt_pass<64>, ntt_pass<128>, ntt_pass<NTT_THREADS>};
  const int threads[] = {32, 64, 128, NTT_THREADS};
  cudaError_t err = cudaSuccess;
  for (PassFn kernel : kernels) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(max_l));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  for (int p = 0; p < ps.npass; p++) {
    ps.q = ps.npass - 1 - p;
    const int l = ps.parts[ps.q];
    long long blocks;
    if (ps.npass == 1) {
      ps.kind = KIND_SINGLE;
      blocks = (batch + NTT_COLS - 1) / NTT_COLS;
    } else {
      ps.kind = p == 0 ? KIND_FIRST : KIND_INPLACE;
      blocks = (nb >> l) / NTT_COLS;
    }
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    // One thread per radix-4 unit of a round, at most NTT_THREADS.
    const int units = NTT_COLS * (1 << l) / 4;
    const int pick = units <= 32 ? 0 : units <= 64 ? 1 : units <= 128 ? 2 : 3;
    kernels[pick]<<<(unsigned)blocks, threads[pick], smem_bytes(l), st>>>(
        (uint32_t*)out, p == 0 ? (const uint32_t*)in : (const uint32_t*)out,
        (const uint32_t*)table, (const uint32_t*)scale, ps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* ntt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
