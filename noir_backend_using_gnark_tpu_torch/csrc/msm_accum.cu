// K1: Pippenger bucket accumulation over BN254 G1, sorted by bucket.
//
// Replaces noir_backend_using_gnark_tpu/ops/msm_pallas.py::
// accumulate_buckets_pallas (line 645; kernel body _accum_kernel,
// 514-732; pallas_call at 696) and keeps its contract: for every window
// w < W and bucket b < B = 2^(c-1) + 1, the Jacobian sum
//     S[w][b] = sum over points j with |digit(w, j)| == b of sign * P_j,
// bucket 0 and empty buckets at infinity. The signed c-bit digits are
// the recoding of ops/msm.py::signed_digits (a digit above 2^(c-1)
// becomes digit - 2^c with a carry into the next window).
//
// What bounds it on this card: about 11 Montgomery products per
// (window, nonzero digit) pair, against 64 bytes of point and 32 bytes
// of scalar per point, so it is bound by the card's 32-bit multiply-add
// rate. What costs more than that bound is everything around the
// products: too few threads, dependent chains, and bucket tables that
// do not fit in L2. The design keeps the products and drops the rest:
//
//   1. k1_pass<false>: each warp takes a chunk of CHUNK scalars; one
//      lane per scalar recodes its W digits on the device and copies its
//      point into point-major order (16 words, so a gather reads 64
//      contiguous bytes). The warp counts its (window, |digit|) keys in
//      its own shared histogram (lanes with one key are grouped with
//      __match_any_sync) and writes it as its chunk's row of `slices`.
//      Zero digits and points at infinity make no pair.
//   2. k1_slices: one warp per key scans that key's column of `slices`
//      over the chunks, so each chunk learns where its pairs of the key
//      start among the key's pairs, and writes the key's count.
//   3. k1_scan (one block): exclusive prefix sums of the key counts
//      (where each key's pairs start) and, for every reduction level,
//      of the number of partial sums each key has there.
//   4. k1_pass<true>: each warp recodes its chunk again in the same
//      order and writes each pair's payload (point index, sign) at its
//      key's start + its chunk's slice start + its rank in the warp: a
//      counting sort by key, written here, with no library sort and no
//      atomics, so the order of pairs, and S[w][b]'s Jacobian
//      coordinates, are the same in every run.
//   5. k1_runs: one thread per run of RUN consecutive pairs of one key
//      sums them with mixed additions in registers and writes one
//      partial. Runs have a fixed length, so a bucket that holds every
//      point costs the same total work as evenly spread buckets, and
//      2^17 points give about 350k runs: enough threads for 132 SMs.
//   6. k1_fold (levels 2..L) and k1_final: one thread per FAN partials
//      of one key, complete additions, until one sum per key is left,
//      written into out. With FAN = 2 each level is one addition deep,
//      so the short tail levels cost little latency.
#include "curve.cuh"

// W * B for 3 <= c <= 7 is at most 37 * 65 = 2405 keys.
#define KEYS_MAX 2560
// Sorted pairs summed per thread in registers (one run), and partial
// sums of one key added per thread in each later level (PERF.md has the
// sweep of other values on an H100 that chose these).
#define RUN 16
#define FAN 2
// The sort's unit: the scalars of one warp, SCALARS_PER_LANE per lane.
#define SCALARS_PER_LANE 8
#define CHUNK (32 * SCALARS_PER_LANE)
#define PASS_THREADS 128
#define PASS_WARPS (PASS_THREADS / 32)
#define SLICE_THREADS 256
#define SCAN_THREADS 1024
#define SCAN_PER_THREAD ((KEYS_MAX + SCAN_THREADS - 1) / SCAN_THREADS)
#define CURVE_THREADS 128
#define FULL_MASK 0xffffffffu

// Takes the low c bits of the 256-bit scalar s as the next window,
// shifts s right by c, and applies the signed recoding with `carry`.
__device__ __forceinline__ void next_digit(uint32_t s[NL], int c, int& carry, int& mag, int& neg) {
  const int t = (int)(s[0] & ((1u << c) - 1)) + carry;
#pragma unroll
  for (int i = 0; i < NL - 1; i++) s[i] = __funnelshift_r(s[i], s[i + 1], c);
  s[NL - 1] >>= c;
  neg = t > (1 << (c - 1));
  mag = neg ? (1 << c) - t : t;
  carry = neg;
}

// One warp per chunk of CHUNK scalars. SCATTER false: count the chunk's
// pairs per key into its row of slices (chunks, K) and copy its points
// into pts. SCATTER true: place each pair's payload at pair_off[key] +
// slices[chunk][key] + its rank in the chunk. Both walk the scalars in
// the same order (lane, then scalar, then window), and every lane runs
// every loop trip, so the warp-wide intrinsics see full warps.
template <bool SCATTER>
__global__ void __launch_bounds__(PASS_THREADS)
k1_pass(int* __restrict__ slices, const int* __restrict__ pair_off, uint32_t* __restrict__ payload,
        uint32_t* __restrict__ pts, const uint32_t* __restrict__ px,
        const uint32_t* __restrict__ py, const uint8_t* __restrict__ pinf,
        const uint32_t* __restrict__ scalars, long long n, int W, int B, int c) {
  __shared__ int warp_hist[PASS_WARPS][KEYS_MAX];
  const int K = W * B;
  const int lane = threadIdx.x & 31;
  const long long chunk = ((long long)blockIdx.x * PASS_THREADS + threadIdx.x) >> 5;
  if (chunk * CHUNK >= n) return;  // whole warps leave together
  int* hist = warp_hist[threadIdx.x >> 5];
  int* row = slices + chunk * K;
  for (int k = lane; k < K; k += 32) hist[k] = SCATTER ? pair_off[k] + row[k] : 0;
  __syncwarp();
  for (int it = 0; it < SCALARS_PER_LANE; it++) {
    const long long j = chunk * CHUNK + it * 32 + lane;
    uint32_t s[NL];
    bool live = false;
    if (j < n) {
#pragma unroll
      for (int l = 0; l < NL; l++) s[l] = scalars[l * n + j];
      live = pinf[j] == 0;
      if (!SCATTER) {
        uint4* dst = reinterpret_cast<uint4*>(pts + j * 16);
        dst[0] = make_uint4(px[0 * n + j], px[1 * n + j], px[2 * n + j], px[3 * n + j]);
        dst[1] = make_uint4(px[4 * n + j], px[5 * n + j], px[6 * n + j], px[7 * n + j]);
        dst[2] = make_uint4(py[0 * n + j], py[1 * n + j], py[2 * n + j], py[3 * n + j]);
        dst[3] = make_uint4(py[4 * n + j], py[5 * n + j], py[6 * n + j], py[7 * n + j]);
      }
    } else {
      f_zero(s);
    }
    int carry = 0;
    for (int w = 0; w < W; w++) {
      int mag, neg;
      next_digit(s, c, carry, mag, neg);
      const bool emit = live && mag != 0;
      const int key = w * B + mag;
      const unsigned peers = __match_any_sync(FULL_MASK, emit ? key : -1);
      const int leader = __ffs(peers) - 1;
      int pos = 0;
      if (emit && lane == leader) {
        pos = hist[key];
        hist[key] = pos + __popc(peers);
      }
      if (SCATTER) {
        pos = __shfl_sync(FULL_MASK, pos, leader);
        if (emit)
          payload[pos + __popc(peers & ((1u << lane) - 1))] = (uint32_t)j | ((uint32_t)neg << 31);
      }
      __syncwarp();
    }
  }
  if (!SCATTER)
    for (int k = lane; k < K; k += 32) row[k] = hist[k];
}

// One warp per key k: slices[:, k] <- its exclusive prefix sum over the
// chunks, counts[k] <- its total.
__global__ void __launch_bounds__(SLICE_THREADS)
k1_slices(int* __restrict__ slices, int* __restrict__ counts, long long chunks, int K) {
  const int k = (int)(((long long)blockIdx.x * SLICE_THREADS + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= K) return;
  int base = 0;
  for (long long first = 0; first < chunks; first += 32) {
    const long long ch = first + lane;
    const int v = ch < chunks ? slices[ch * K + k] : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL_MASK, incl, d);
      if (lane >= d) incl += u;
    }
    if (ch < chunks) slices[ch * K + k] = base + incl - v;
    base += __shfl_sync(FULL_MASK, incl, 31);
  }
  if (lane == 0) counts[k] = base;
}

// offsets holds levels + 1 rows of K + 1 ints. Row 0: where each key's
// pairs start (entry K: the number of pairs). Row l >= 1: where each
// key's level-l partials start, a key with n_k pairs having
// ceil(n_k / (RUN * FAN^(l-1))) of them.
__global__ void __launch_bounds__(SCAN_THREADS)
k1_scan(int* __restrict__ offsets, const int* __restrict__ counts, int K, int levels) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (K + SCAN_THREADS - 1) / SCAN_THREADS;
  long long span = 1;
  for (int l = 0; l <= levels; l++) {
    int vals[SCAN_PER_THREAD];
    int local = 0;
#pragma unroll
    for (int i = 0; i < SCAN_PER_THREAD; i++) {
      const int k = tid * per + i;
      vals[i] = (i < per && k < K) ? (int)((counts[k] + span - 1) / span) : 0;
      local += vals[i];
    }
    int incl = local;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int ws = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, ws, d);
        if (lane >= d) ws += v;
      }
      warp_sums[lane] = ws;
    }
    __syncthreads();
    int acc = incl - local + (warp > 0 ? warp_sums[warp - 1] : 0);
    int* row = offsets + (long long)l * (K + 1);
#pragma unroll
    for (int i = 0; i < SCAN_PER_THREAD; i++) {
      const int k = tid * per + i;
      if (i < per && k < K) row[k] = acc;
      acc += vals[i];
    }
    if (tid == SCAN_THREADS - 1) row[K] = acc;
    __syncthreads();
    span = l == 0 ? RUN : span * FAN;
  }
}

// The key whose range [off[k], off[k + 1]) holds r, for 0 <= r < off[K].
__device__ __forceinline__ int find_key(const int* __restrict__ off, int K, int r) {
  int lo = 0, hi = K;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= r) lo = mid;
    else hi = mid;
  }
  return lo;
}

// One thread per run: the sum of up to RUN sorted pairs of one key.
// part: (24, part_stride) Jacobian partials, planar.
__global__ void __launch_bounds__(CURVE_THREADS)
k1_runs(uint32_t* __restrict__ part, long long part_stride, const int* __restrict__ offsets,
        const uint32_t* __restrict__ payload, const uint32_t* __restrict__ pts, int K) {
  const int* pair_off = offsets;
  const int* run_off = offsets + (K + 1);
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= run_off[K]) return;
  const int k = find_key(run_off, K, (int)r);
  const int start = pair_off[k] + ((int)r - run_off[k]) * RUN;
  const int end = min(start + RUN, pair_off[k + 1]);
  Jac acc;
  jac_set_inf(acc);
  for (int e = start; e < end; e++) {
    const uint32_t v = payload[e];
    const uint4* p = reinterpret_cast<const uint4*>(pts + (long long)(v & 0x7fffffffu) * 16);
    const uint4 x0 = p[0], x1 = p[1], y0 = p[2], y1 = p[3];
    uint32_t qx[NL] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    uint32_t qy[NL] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
    if (v >> 31) f_neg<Fq>(qy, qy);
    jac_add_affine(acc, acc, qx, qy);
  }
  jac_store(part, part_stride, r, acc);
}

// One thread per group of up to FAN partials of one key (complete
// additions): level l - 1 (src, src_off) -> level l (dst, dst_off).
__global__ void __launch_bounds__(CURVE_THREADS)
k1_fold(uint32_t* __restrict__ dst, long long dst_stride, const uint32_t* __restrict__ src,
        long long src_stride, const int* __restrict__ src_off, const int* __restrict__ dst_off,
        int K) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= dst_off[K]) return;
  const int k = find_key(dst_off, K, (int)r);
  const int start = src_off[k] + ((int)r - dst_off[k]) * FAN;
  const int end = min(start + FAN, src_off[k + 1]);
  Jac acc;
  jac_load(acc, src, src_stride, start);
  for (int e = start + 1; e < end; e++) {
    Jac q;
    jac_load(q, src, src_stride, e);
    jac_add(acc, acc, q);
  }
  jac_store(dst, dst_stride, r, acc);
}

// One thread per key: the sum of its last-level partials (infinity for
// an empty key) into out (24, K).
__global__ void __launch_bounds__(CURVE_THREADS)
k1_final(uint32_t* __restrict__ out, const uint32_t* __restrict__ src, long long src_stride,
         const int* __restrict__ src_off, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  Jac acc;
  jac_set_inf(acc);
  for (int e = src_off[k]; e < src_off[k + 1]; e++) {
    Jac q;
    jac_load(q, src, src_stride, e);
    jac_add(acc, acc, q);
  }
  jac_store(out, K, k, acc);
}

// The least L >= 1 with RUN * FAN^L >= n: the final pass then adds at
// most FAN partials per key.
static int num_levels(long long n) {
  int levels = 1;
  for (long long span = (long long)RUN * FAN; span < n; span *= FAN) levels++;
  return levels;
}

// Partial sums at level l >= 1, summed over keys: at most
// W * n / (RUN * FAN^(l-1)) + K.
static long long level_capacity(long long n, long long K, int W, int level) {
  long long span = RUN;
  for (int l = 1; l < level; l++) span *= FAN;
  return (long long)W * n / span + K;
}

static unsigned grid_for(long long threads, int block) {
  return (unsigned)((threads + block - 1) / block);
}

// out: (24, W, B) Jacobian bucket sums. px, py: (8, n) Fq Montgomery
// affine; pinf: (n,) bool; scalars: (8, n) canonical Fr.
// Scratch, all int32: pts (n, 16); table (table_len): slices
// (ceil(n / CHUNK), K), counts (K), offsets (levels + 1, K + 1);
// payload (W * n); part_a (24, cap_a) and part_b (24, cap_b), at least
// the level-1 and level-2 capacities. Any smaller size is refused.
extern "C" int msm_accumulate(void* out, void* pts, void* table, void* payload, void* part_a,
                              void* part_b, const void* px, const void* py, const void* pinf,
                              const void* scalars, long long n, int W, int B, int c,
                              long long table_len, long long cap_a, long long cap_b,
                              void* stream) {
  const long long K = (long long)W * B;
  // c >= 3: the signed recoding's top carry needs c * W >= 255 bits, and
  // c = 2 gives 254.
  if (n <= 0 || c < 3 || c > 7 || W <= 0 || B != (1 << (c - 1)) + 1 || K > KEYS_MAX ||
      (long long)W * n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int levels = num_levels(n);
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  if (table_len < chunks * K + K + (levels + 1) * (K + 1) ||
      cap_a < level_capacity(n, K, W, 1) || (levels >= 2 && cap_b < level_capacity(n, K, W, 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* slices = (int*)table;
  int* counts = slices + chunks * K;
  int* offsets = counts + K;
  const unsigned pass_grid = grid_for(chunks * 32, PASS_THREADS);
  k1_pass<false><<<pass_grid, PASS_THREADS, 0, st>>>(
      slices, offsets, (uint32_t*)payload, (uint32_t*)pts, (const uint32_t*)px,
      (const uint32_t*)py, (const uint8_t*)pinf, (const uint32_t*)scalars, n, W, B, c);
  k1_slices<<<grid_for(K * 32, SLICE_THREADS), SLICE_THREADS, 0, st>>>(slices, counts, chunks,
                                                                       (int)K);
  k1_scan<<<1, SCAN_THREADS, 0, st>>>(offsets, counts, (int)K, levels);
  k1_pass<true><<<pass_grid, PASS_THREADS, 0, st>>>(
      slices, offsets, (uint32_t*)payload, (uint32_t*)pts, (const uint32_t*)px,
      (const uint32_t*)py, (const uint8_t*)pinf, (const uint32_t*)scalars, n, W, B, c);
  k1_runs<<<grid_for(level_capacity(n, K, W, 1), CURVE_THREADS), CURVE_THREADS, 0, st>>>(
      (uint32_t*)part_a, cap_a, offsets, (const uint32_t*)payload, (const uint32_t*)pts, (int)K);
  uint32_t* src = (uint32_t*)part_a;
  long long src_stride = cap_a;
  for (int l = 2; l <= levels; l++) {
    uint32_t* dst = (l % 2 == 0) ? (uint32_t*)part_b : (uint32_t*)part_a;
    const long long dst_stride = (l % 2 == 0) ? cap_b : cap_a;
    k1_fold<<<grid_for(level_capacity(n, K, W, l), CURVE_THREADS), CURVE_THREADS, 0, st>>>(
        dst, dst_stride, src, src_stride, offsets + (l - 1) * (K + 1), offsets + l * (K + 1),
        (int)K);
    src = dst;
    src_stride = dst_stride;
  }
  k1_final<<<grid_for(K, CURVE_THREADS), CURVE_THREADS, 0, st>>>(
      (uint32_t*)out, src, src_stride, offsets + levels * (K + 1), (int)K);
  return (int)cudaGetLastError();
}

extern "C" const char* msm_accum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
