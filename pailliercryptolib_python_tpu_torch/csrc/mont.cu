// Kernels K9 (mont_mul), K10 (mont_exp) and K11 (mont_chain): Montgomery
// arithmetic over 16-bit limbs with a modulus per column (or one shared
// modulus), for Hopper (sm_90a).
//
// K9 replaces pailliercryptolib_python_tpu/ops/pallas_mont.py
//    _mont_mul_kernel (:111, wrapper mont_mul_p :125): a*b*R^-1 mod n_col.
// K10 replaces pailliercryptolib_python_tpu/ops/pallas_mont.py
//    _mont_exp_kernel (:155, wrapper mont_exp_p :185): base^e mod n_col
//    with a per-element exponent, 4-bit fixed window, 16-entry table
//    built in the kernel, one-hot table select, windows before win_start
//    skipped.
// K11 replaces pailliercryptolib_python_tpu/ops/pallas_mont.py
//    _mont_chain_kernel (:233, wrapper mont_chain_p :245): acc0 times the
//    product of n_win pre-gathered factors, one Montgomery product per
//    factor (the fused form of the limb comb encrypt chain).
//
// They serve every Montgomery context without the mm3 weights of K3/K4:
// the per-element contexts of MontCtx.for_moduli (the device-batched
// Miller-Rabin of keygen, one prime candidate per column, and the fused
// CRT decrypt over [p^2]*B ++ [q^2]*B) and moduli whose L exceeds the
// weights' 520 limbs (n^2 of keys past the RNS bound); K11 also serves
// the shared n^2 of the limb comb encrypt.  The modulus and `one` are
// read at column stride 0 and row stride 1 when shared ((L, 1)), or
// column stride 1 and row stride B when per-element ((L, B)); n0
// (-n^-1 mod 2^16) from n0[col], or n0[0] when shared (per_elem
// selects).  Every product is the unique Montgomery result (a*b + q*n)/R,
// R = 2^(16L), q = -a*b*n^-1 mod R, so the kernels equal the TPU kernels,
// the plain twins and K3/K4 on a shared modulus limb for limb.
//
// All three run on the cooperative routine of csrc/coop.cuh (coop_mul:
// a group of 8-32 lanes a column, K 32-bit words a lane in registers,
// (g, K) from coop_shape, lane_setup placing each lane); K8, K12, K13
// and K15 run on it too.
//
// K9 loads a, b and its modulus (K words a lane each), runs one coop_mul
// and stores.  K11 loads acc0 into registers and runs one coop_mul per
// factor; the limbs of factor w+1 are copied into shared memory by
// cp.async while the product by factor w runs, and paired into words
// after it, so a small batch, whose few warps cannot hide a load, need
// not wait for it (PERF.md, K11: how the chain's time splits between
// the factors' bytes and the products).  K10 runs coop::exp_chain, the
// chain it shares with K14 (csrc/mont2.cu): its 16-entry table in shared
// memory, each thread's K words of an entry at stride blockDim.x (16 K
// blockDim.x words a block: 73,728 B at K=9, 128 threads), written and
// read by its own thread only.  K10's digits are secret (a plaintext,
// or a keygen candidate's (c-1)>>tz, among which are the primes), so
// each window reads all 16 entries and keeps T[digit] by mask: a digit
// never forms an address (the TPU's one-hot select).
//
// What bounds them.  A product is W^2 32x32-bit word products of two
// multiply-adds (low and high word) for a*b and W^2 for q*n: 4W^2 IMAD,
// the integer pipes' floor (per-element moduli rule out K3's Toeplitz
// reduction on the tensor cores, whose int8 count sets the bound that
// PERF.md prints).  K10 runs (2^4 - 2) + n_win*5 products a column (one
// in five a square): at L=129, B=8192, 256 windows 1,294 products x 4 x
// 65^2 x 8192 = 1.8e11 IMAD over 132 SMs x 64 IMAD/clk.  K11 runs n_win
// products a column; at L=257, B=4096, 86 factors its factors are 362
// MB, a tenth of a millisecond of memory time, against 86 x 4 x 129^2 x
// 4096 = 2.3e10 IMAD.  K9 is one product a column, its floor microseconds:
// the W dependent word steps' latency and the loads set its time.  The
// latency of a word step (two shuffles and the q multiply on its chain)
// is hidden by the other groups of the SM when B is large, not at the
// keygen shape (B=256, 64 warps on 132 SMs).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop.cuh"
#include "rns_tile.cuh"   // allow_max_shared, cp_async_*

namespace {

constexpr int kMaxLimbs = 1040;     // ops/mont.MAX_LIMBS

using coop::Lane;
using coop::coop_mul;
using coop::cp_async4;
using coop::kCoopThreads;
using coop::blocks_for;
using coop::lane_setup;
using coop::load_words;
using coop::store_words;
using coop::with_shape;

// K9: one product a column.
template <int K>
__global__ void __launch_bounds__(128, 1)
mont_mul_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out,
                const uint32_t* n, const uint32_t* n0, int per_elem, int L,
                int B, int g) {
  Lane<K> ln;
  lane_setup(ln, n, n0, per_elem, L, B, g);
  uint32_t x[K], y[K];
  load_words(x, a + ln.col, B, L, ln.j);
  load_words(y, b + ln.col, B, L, ln.j);
  coop_mul(x, x, y, ln.n, ln.np, ln.W, ln.shift, ln.j, g);
  if (ln.live) store_words(x, out + ln.col, B, L, ln.j);
}

// K11: acc = acc0, then acc = acc * factors[w] for w < n_win.  The limbs
// of factor w+1 are copied into shared memory by cp.async while product w
// runs (stage: (2K, blockDim.x) words, each thread its own column of
// them), and paired into words after it; the last factor is fetched
// twice, so no branch guards the copy.
template <int K>
__global__ void __launch_bounds__(128, 1)
mont_chain_kernel(const uint32_t* factors, const uint32_t* acc0,
                  uint32_t* out, const uint32_t* n, const uint32_t* n0,
                  int per_elem, int n_win, int L, int B, int g) {
  extern __shared__ uint32_t stage[];
  const int nt = blockDim.x;
  Lane<K> ln;
  lane_setup(ln, n, n0, per_elem, L, B, g);
  uint32_t acc[K], f[K];
  load_words(acc, acc0 + ln.col, B, L, ln.j);
  const size_t plane = static_cast<size_t>(L) * B;
  const uint32_t* fp = factors + ln.col;
  uint32_t* st = stage + threadIdx.x;
  if (n_win > 0) load_words(f, fp, B, L, ln.j);
  for (int w = 0; w < n_win; ++w) {
    const uint32_t* src = fp + (w + 1 < n_win ? w + 1 : w) * plane;
#pragma unroll
    for (int kk = 0; kk < 2 * K; ++kk) {          // limb 2jK + kk
      const int l = 2 * ln.j * K + kk;
      cp_async4(st + kk * nt, l < L ? src + static_cast<size_t>(l) * B : src,
                l < L ? 4 : 0);
    }
    rns_tile::cp_async_commit();
    coop_mul(acc, acc, f, ln.n, ln.np, ln.W, ln.shift, ln.j, g);
    rns_tile::cp_async_wait_all();
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      f[kk] = (st[2 * kk * nt] & 0xFFFFu) | (st[(2 * kk + 1) * nt] << 16);
  }
  if (ln.live) store_words(acc, out + ln.col, B, L, ln.j);
}

// K10: tab: (16, K, blockDim.x) words of dynamic shared memory
// (coop::exp_chain).
template <int K>
__global__ void __launch_bounds__(128, 1)
mont_exp_kernel(const uint32_t* base, const int32_t* digits,
                const uint32_t* one, uint32_t* out, const uint32_t* n,
                const uint32_t* n0, int per_elem, int L, int B, int n_win,
                int win_start, int g) {
  extern __shared__ uint32_t tab[];
  Lane<K> ln;
  lane_setup(ln, n, n0, per_elem, L, B, g);
  uint32_t x[K], acc[K];
  load_words(x, base + ln.col, B, L, ln.j);
  load_words(acc, one + ln.c, ln.sn, L, ln.j);
  coop::exp_chain(acc, x, ln, tab, digits, B, n_win, win_start, g);
  if (ln.live) store_words(acc, out + ln.col, B, L, ln.j);
}

// K11's staged factor: 2K limbs a thread (17,408 B a block at K=17).
inline size_t chain_smem(int K) {
  return static_cast<size_t>(2) * K * kCoopThreads * sizeof(uint32_t);
}

}  // namespace

extern "C" int pct_mont_mul(const uint32_t* a, const uint32_t* b,
                            uint32_t* out, const uint32_t* n,
                            const uint32_t* n0, int per_elem, int L, int B,
                            void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return with_shape(L, B, [&](auto k, int g) {
    constexpr int K = decltype(k)::value;
    mont_mul_kernel<K><<<blocks_for(B, g, kCoopThreads), kCoopThreads, 0,
                         st>>>(a, b, out, n, n0, per_elem, L, B, g);
    return cudaGetLastError();
  });
}

extern "C" int pct_mont_exp(const uint32_t* base, const int32_t* digits,
                            const uint32_t* one, uint32_t* out,
                            const uint32_t* n, const uint32_t* n0,
                            int per_elem, int L, int B, int n_win,
                            int win_start, void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1 || n_win < 0 || win_start < 0) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return with_shape(L, B, [&](auto k, int g) {
    constexpr int K = decltype(k)::value;
    static std::atomic<unsigned long long> raised{0};
    return coop::launch_exp(mont_exp_kernel<K>, raised, K, B, g, st, base,
                            digits, one, out, n, n0, per_elem, L, B, n_win,
                            win_start, g);
  });
}

extern "C" int pct_mont_chain(const uint32_t* factors, const uint32_t* acc0,
                              uint32_t* out, const uint32_t* n,
                              const uint32_t* n0, int per_elem, int n_win,
                              int L, int B, void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1 || n_win < 0) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return with_shape(L, B, [&](auto k, int g) {
    constexpr int K = decltype(k)::value;
    mont_chain_kernel<K><<<blocks_for(B, g, kCoopThreads), kCoopThreads,
                           chain_smem(K), st>>>(factors, acc0, out, n, n0,
                                                per_elem, n_win, L, B, g);
    return cudaGetLastError();
  });
}

// The group width g and words a lane K that the cooperative kernels
// (K8-K13, K15) run at for L limbs and B columns (coop_shape), as
// g * 100 + K.
extern "C" int pct_mont_exp_shape(int L, int B) {
  const coop::CoopShape sh = coop::coop_shape((L + 1) / 2, B);
  return sh.g * 100 + sh.K;
}
