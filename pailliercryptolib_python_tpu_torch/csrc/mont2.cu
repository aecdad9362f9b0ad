// Kernels K12 (mm2_mul), K13 (mm2_sqr), K14 (mm2_exp) and K15
// (mm2_exp_shared): the matmul-Montgomery ("v2") functions over 16-bit
// limbs, for Hopper (sm_90a), all four on the cooperative 32-bit-word
// routine of csrc/coop.cuh.
//
// K12 replaces pailliercryptolib_python_tpu/ops/pallas_mont2.py
//     _mm2_mul_kernel (:364, wrapper mm2_mul_p :378): a*b*R^-1 mod m.
// K13 replaces pailliercryptolib_python_tpu/ops/pallas_mont2.py
//     _mm2_sqr_kernel (:403, wrapper mm2_sqr_p :410): a*a*R^-1 mod m.
// K14 replaces pailliercryptolib_python_tpu/ops/pallas_mont2.py
//     _mm2_exp_kernel (:435, wrapper mm2_exp_p :475): base^e with a
//     per-element exponent, 4-bit windows, a 16-entry table, win_start.
// K15 replaces pailliercryptolib_python_tpu/ops/pallas_mont2.py
//     _mm2_exp_shared_kernel (:521, wrapper mm2_exp_shared_p :559):
//     base^e with one exponent for the batch, a 2^window-entry table.
//
// Layout: limbs-major (L, B) uint32 tensors holding 16-bit limbs.  The
// weights wmu int8 (4L, 4L) and wm int8 (8L, 4L)
// (ops/matmul_mont.const_mult_weights) are kernel operands; the kernels
// take no modulus: m lives only inside wm.
//
// On the TPU the two reductions q = T*mu mod R and q*m were int8 nibble
// matrix products of these weights on the MXU.  Here each kernel
// computes the same function, the unique Montgomery product, by CIOS
// word steps on the integer pipes (a group of 8-32 lanes a column, K
// words a lane in registers, (g, K) from coop_shape, as K8-K11), its
// reduction by the modulus's words; wmu is not read.  The nibble
// reduction runs only in the plain twins (ops/mont2.py mm2_mul_plain,
// ops/matmul_mont.mm_reduce).  K12 is one coop_mul(x, x, y) a column
// and K13 one coop_mul(x, x, x) (K9's and K8's bodies).  m and n' come
// from column 0 of wm: byte (v*2L + t, 0) is nibble 4t+v of m, and n' =
// -m^-1 mod 2^32 follows from word 0 by four Newton steps.  K12 and K13
// stage m once a block (wm_modulus_block: the block's threads build its
// W words in shared memory together, a few byte loads each, then every
// lane copies its K words); each lane reading its own words' bytes
// (wm_modulus, 8K loads a lane) was slower in K12 and K13 at L=257, and
// the staged form slower in K15's chain, which reads them per lane once
// for the whole chain (PERF.md §6).  What bounds K12 and K13: a
// product is 4W^2 IMAD on the integer pipes (chip_smoke.py
// coop_floor_ms), microseconds at B=4096; a launch and W dependent word
// steps set their time, as K8's and K9's.
//
// K14 is K10's chain (coop::exp_chain, shared with csrc/mont.cu): the
// 16-entry table in shared memory, four squarings and one product a
// window from win_start, T[digit] kept by a mask over all 16 entries
// (the digits are per element and secret: a digit never forms an
// address), 128 threads a block (64 at K=17); its modulus and n' read
// per lane from wm (wm_modulus), once for the chain (staged once a
// block it timed no faster, PERF.md §6).  It runs 14 +
// 5 (n_win - win_start) products a column, 4W^2 IMAD each: the integer
// pipes bound it (chip_smoke.py coop_floor_ms).
//
// K15's 2^window-entry table lies in global scratch in the kernel's own
// layout, indexed by the shared, key-derived digit (ROADMAP C5, as K7),
// the next window's entry staged in shared memory by cp.async while the
// current window's squarings run (K11's pattern).  The squarings are
// coop_mul(acc, acc, acc).
//
// K12-K15 accept 2 <= L <= 520 (kMaxLimbs, as csrc/mont3.cu) and return
// cudaErrorInvalidValue otherwise.  The Montgomery result is unique, so
// K12-K15 equal their plain twins (ops/mont2.py), the TPU kernels and K3
// / K8 / K9 / K4 / K10 / K7 limb for limb.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop.cuh"

namespace {

constexpr int kMaxLimbs = 520;      // MontCtx.MXU_MAX_LIMBS, csrc/mont3.cu

// Word i of the modulus m from column 0 of the weights wm (8L, 4L) int8
// = const_mult_weights(m, L, 4, 2L): byte (v*2L + t, 0) is nibble 4t+v
// of m, so limb t of m is sum_v wm[v*2L + t, 0] << 4v, and word i holds
// limbs 2i and 2i+1 (0 past L).
__device__ __forceinline__ uint32_t wm_word(const int8_t* wm, int L, int i) {
  const size_t row = 4 * static_cast<size_t>(L);       // bytes a row
  uint32_t w = 0u;
  for (int h = 0; h < 2; ++h) {
    const int t = 2 * i + h;
    if (t >= L) break;
    for (int v = 0; v < 4; ++v) {
      const uint8_t nib = static_cast<uint8_t>(
          wm[(static_cast<size_t>(v) * 2 * L + t) * row]);
      w |= static_cast<uint32_t>(nib) << (16 * h + 4 * v);
    }
  }
  return w;
}

// n' = -m^-1 mod 2^32 from m's word 0 by four Newton steps y = y (2 +
// m y) from y = -m mod 2^32, right mod 2^3 (m^2 = 1 mod 8 for odd m):
// 3, 6, 12, 24, 48 bits.
__device__ __forceinline__ uint32_t neg_inv32(uint32_t m0) {
  uint32_t y = 0u - m0;
  for (int i = 0; i < 4; ++i) y *= 2u + m0 * y;
  return y;
}

// K15's modulus words and n', each lane reading its own K words from wm.
template <int K>
__device__ __forceinline__ void wm_modulus(coop::Lane<K>& ln, const int8_t* wm,
                                           int L, int g) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) ln.n[kk] = wm_word(wm, L, ln.j * K + kk);
  ln.np = neg_inv32(__shfl_sync(coop::kFull, ln.n[0], 0, g));
}

// K12's and K13's modulus words and n', once a block: the block's
// threads build m's W words in shared memory together (word i by thread
// i mod blockDim.x, eight independent byte loads a word), then every
// lane copies its K words and derives n' from word 0.  Every thread of
// the block calls it (a __syncthreads).
template <int K>
__device__ __forceinline__ void wm_modulus_block(coop::Lane<K>& ln,
                                                 const int8_t* wm, int L) {
  __shared__ uint32_t mw[kMaxLimbs / 2];       // 1,040 B
  for (int i = threadIdx.x; i < ln.W; i += blockDim.x)
    mw[i] = wm_word(wm, L, i);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int i = ln.j * K + kk;
    ln.n[kk] = i < ln.W ? mw[i] : 0u;
  }
  ln.np = neg_inv32(mw[0]);
}

// K12: a*b*R^-1 mod m, one product a column (K9's body, its modulus
// from the weights).  The operands' loads are issued before the
// modulus's, so their latencies overlap.
template <int K>
__global__ void __launch_bounds__(coop::kCoopThreads, 1)
mm2_mul_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out,
               const int8_t* wm, int L, int B, int g) {
  coop::Lane<K> ln;
  coop::lane_place(ln, 0, L, B, g);
  uint32_t x[K], y[K];
  coop::load_words(x, a + ln.col, B, L, ln.j);
  coop::load_words(y, b + ln.col, B, L, ln.j);
  wm_modulus_block(ln, wm, L);
  coop::coop_mul(x, x, y, ln.n, ln.np, ln.W, ln.shift, ln.j, g);
  if (ln.live) coop::store_words(x, out + ln.col, B, L, ln.j);
}

// K13: a*a*R^-1 mod m, one coop_mul(x, x, x) a column (K8's body): one
// operand array in registers.
template <int K>
__global__ void __launch_bounds__(coop::kCoopThreads, 1)
mm2_sqr_kernel(const uint32_t* a, uint32_t* out, const int8_t* wm, int L,
               int B, int g) {
  coop::Lane<K> ln;
  coop::lane_place(ln, 0, L, B, g);
  uint32_t x[K];
  coop::load_words(x, a + ln.col, B, L, ln.j);
  wm_modulus_block(ln, wm, L);
  coop::coop_mul(x, x, x, ln.n, ln.np, ln.W, ln.shift, ln.j, g);
  if (ln.live) coop::store_words(x, out + ln.col, B, L, ln.j);
}

// K14: base^e with per-element 4-bit digits (n_win, B), K10's chain
// (coop::exp_chain; tab: (16, K, blockDim.x) words of dynamic shared
// memory) with the modulus and n' read per lane from wm.  The operands'
// loads are issued before the modulus's.
template <int K>
__global__ void __launch_bounds__(128, 1)
mm2_exp_kernel(const uint32_t* base, const int32_t* digits,
               const uint32_t* one, uint32_t* out, const int8_t* wm, int L,
               int B, int n_win, int win_start, int g) {
  extern __shared__ uint32_t tab[];
  coop::Lane<K> ln;
  coop::lane_place(ln, 0, L, B, g);
  uint32_t x[K], acc[K];
  coop::load_words(x, base + ln.col, B, L, ln.j);
  coop::load_words(acc, one + ln.col, B, L, ln.j);
  wm_modulus(ln, wm, L, g);
  coop::exp_chain(acc, x, ln, tab, digits, B, n_win, win_start, g);
  if (ln.live) coop::store_words(acc, out + ln.col, B, L, ln.j);
}

// K15: base^e with one exponent for the batch on the cooperative routine
// (coop.cuh), the TPU kernel's chain: T[0] = one, T[1] = base, T[d] =
// T[d-1] * base (2^window entries), acc = one, then per window `window`
// squarings and one product by T[digit].  The table lies in global
// scratch, each thread's K words of entry d at tab[(d K + kk) S + gid]
// (S threads in the grid): a warp reads 32 consecutive words, and each
// thread reads back only what it wrote.  The digits are shared and
// key-derived (ROADMAP C5, as K7): T[digit] of window w+1 is copied by
// cp.async into the thread's column of a shared stage (K, blockDim.x)
// while window w runs; the last entry is fetched twice, so no branch
// guards the copy.
template <int K>
__global__ void __launch_bounds__(coop::kCoopThreads, 1)
mm2_exp_shared_kernel(const uint32_t* base, const int32_t* digits, int n_win,
                      const uint32_t* one, uint32_t* out, uint32_t* table,
                      const int8_t* wm, int L, int B, int window, int g) {
  extern __shared__ uint32_t stage[];
  const int nt = blockDim.x;
  coop::Lane<K> ln;
  coop::lane_place(ln, 0, L, B, g);
  wm_modulus(ln, wm, L, g);
  const int j = ln.j;
  const size_t S = static_cast<size_t>(gridDim.x) * nt;
  uint32_t* te = table + static_cast<size_t>(blockIdx.x) * nt + threadIdx.x;
  uint32_t* st = stage + threadIdx.x;
  uint32_t acc[K], x[K];
  coop::load_words(x, base + ln.col, B, L, j);
  coop::load_words(acc, one + ln.col, B, L, j);
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    te[kk * S] = acc[kk];                         // T[0] = one
    te[(K + kk) * S] = x[kk];                     // T[1] = base
    acc[kk] = x[kk];
  }
  for (int d = 2; d < (1 << window); ++d) {       // T[d] = T[d-1] * base
    coop::coop_mul(acc, acc, x, ln.n, ln.np, ln.W, ln.shift, j, g);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) te[(d * K + kk) * S] = acc[kk];
  }
  coop::load_words(acc, one + ln.col, B, L, j);   // acc = one
  if (n_win > 0) {
    const size_t e = static_cast<size_t>(__ldg(digits)) * K;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) x[kk] = te[(e + kk) * S];
  }
  for (int w = 0; w < n_win; ++w) {
    const size_t e =
        static_cast<size_t>(__ldg(digits + (w + 1 < n_win ? w + 1 : w))) * K;
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      coop::cp_async4(st + kk * nt, te + (e + kk) * S, 4);
    rns_tile::cp_async_commit();
    for (int r = 0; r < window; ++r)
      coop::coop_mul(acc, acc, acc, ln.n, ln.np, ln.W, ln.shift, j, g);
    coop::coop_mul(acc, acc, x, ln.n, ln.np, ln.W, ln.shift, j, g);
    rns_tile::cp_async_wait_all();
#pragma unroll
    for (int kk = 0; kk < K; ++kk) x[kk] = st[kk * nt];
  }
  if (ln.live) coop::store_words(acc, out + ln.col, B, L, j);
}

// K15's table scratch in 32-bit words at L limbs, B columns, 2^window
// entries: K words an entry for every thread of the grid.
inline size_t exp_shared_table_words(int L, int B, int window) {
  const coop::CoopShape sh = coop::coop_shape((L + 1) / 2, B);
  const size_t threads = static_cast<size_t>(
      coop::blocks_for(B, sh.g, coop::kCoopThreads)) * coop::kCoopThreads;
  return (static_cast<size_t>(1) << window) * sh.K * threads;
}

inline bool bad_limbs(int L, int B) {
  return L < 2 || L > kMaxLimbs || B < 1;
}

}  // namespace

// K12 and K13 read m from wm; wmu stays in the signature (the
// reference's) and is not read.
extern "C" int pct_mm2_mul(const uint32_t* a, const uint32_t* b,
                           uint32_t* out, const int8_t* wmu,
                           const int8_t* wm, int L, int B, void* stream) {
  if (bad_limbs(L, B)) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return coop::with_shape(L, B, [&](auto k, int g) {
    constexpr int K = decltype(k)::value;
    mm2_mul_kernel<K><<<coop::blocks_for(B, g, coop::kCoopThreads),
                        coop::kCoopThreads, 0, st>>>(a, b, out, wm, L, B, g);
    return cudaGetLastError();
  });
}

extern "C" int pct_mm2_sqr(const uint32_t* a, uint32_t* out,
                           const int8_t* wmu, const int8_t* wm, int L, int B,
                           void* stream) {
  if (bad_limbs(L, B)) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return coop::with_shape(L, B, [&](auto k, int g) {
    constexpr int K = decltype(k)::value;
    mm2_sqr_kernel<K><<<coop::blocks_for(B, g, coop::kCoopThreads),
                        coop::kCoopThreads, 0, st>>>(a, out, wm, L, B, g);
    return cudaGetLastError();
  });
}

// K14 reads m from wm; wmu stays in the signature (the reference's) and
// is not read.
extern "C" int pct_mm2_exp(const uint32_t* base, const int32_t* digits,
                           const uint32_t* one, uint32_t* out,
                           const int8_t* wmu, const int8_t* wm, int L, int B,
                           int n_win, int win_start, void* stream) {
  if (bad_limbs(L, B) || n_win < 0 || win_start < 0) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return coop::with_shape(L, B, [&](auto k, int g) {
    constexpr int K = decltype(k)::value;
    static std::atomic<unsigned long long> raised{0};
    return coop::launch_exp(mm2_exp_kernel<K>, raised, K, B, g, st, base,
                            digits, one, out, wm, L, B, n_win, win_start, g);
  });
}

// K15 reads m from wm; wmu stays in the signature (the reference's) and
// is not read.
extern "C" int pct_mm2_exp_shared(const uint32_t* base, const int32_t* digits,
                                  int n_win, const uint32_t* one,
                                  uint32_t* out, uint32_t* table,
                                  const int8_t* wmu, const int8_t* wm, int L,
                                  int B, int window, void* stream) {
  if (bad_limbs(L, B) || n_win < 0 || window < 1 || window > 8) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return coop::with_shape(L, B, [&](auto k, int g) {
    constexpr int K = decltype(k)::value;
    const size_t smem = static_cast<size_t>(K) * coop::kCoopThreads *
                        sizeof(uint32_t);
    mm2_exp_shared_kernel<K>
        <<<coop::blocks_for(B, g, coop::kCoopThreads), coop::kCoopThreads,
           smem, st>>>(base, digits, n_win, one, out, table, wm, L, B,
                       window, g);
    return cudaGetLastError();
  });
}

// The words of table scratch a launch of K15 needs (the wrapper
// allocates them): 2^window entries of K words for every thread.
extern "C" long long pct_mm2_exp_shared_table_words(int L, int B,
                                                    int window) {
  if (bad_limbs(L, B) || window < 1 || window > 8) return -1;
  return static_cast<long long>(exp_shared_table_words(L, B, window));
}
