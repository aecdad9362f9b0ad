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
// All three run on one cooperative routine, coop_mul below: a group of g
// threads (8, 16 or 32 lanes of one warp) owns one column, each thread K
// consecutive 32-bit words of it (the 16-bit limbs paired at load, split
// again at the store; K in {3, 5, 9, 17}).  coop_shape picks (g, K) for
// all three from W = ceil(L/2) and B, g*K > W: the least padding where
// the batch fills the card, g=8, K=9 at L=129, B=8192 and g=8, K=17 at
// L=257, B=4096; else the least K, g=16, K=3 at L=65, B=256; up to g=32,
// K=17 at L=1040.  lane_setup gives a lane its place: its group index j,
// its column (groups past B compute column B-1 and store nothing, so
// every lane of a warp takes part in the shuffles), the K words of its
// modulus and n'.  A product is W word steps of CIOS: word i of the outer
// operand comes from its owner by __shfl_sync, each thread adds a_i * b
// and then q * n over its K words with 64-bit multiply-adds (the carry
// out of its top word kept in a 64-bit th, which belongs to the next
// thread's word 0), q = t_0 * n' mod 2^32 comes from the group's first
// thread by __shfl_sync, and the group shifts t down one word, the
// neighbour's word 0 arriving by __shfl_down_sync; th is folded in
// there, so it stays below 2^34, and the last carries resolve once at
// the product's end.  n' = -n^-1 mod 2^32 is one Newton step from the
// 16-bit n0: n' = n0 (2 + n n0) mod 2^32.  R stays 2^(16L): for odd L
// (257, 129 and 65 are all odd) W full word steps divide by 2^(32W) =
// 2^16 R, so the outer operand enters shifted by 16 bits (word i is
// a_i << 16 | a_(i-1) >> 16, made from the broadcast words): (a 2^16 b +
// q' n) / (2^16 R) with q' = 2^16 q is the same unique result.  The
// operands, the running sum and the modulus stay in registers: no kernel
// here keeps a limb array in local memory.
//
// K9 loads a, b and its modulus (K words a lane each), runs one coop_mul
// and stores.  K11 loads acc0 into registers and runs one coop_mul per
// factor; the limbs of factor w+1 are copied into shared memory by
// cp.async while the product by factor w runs, and paired into words
// after it, so a small batch, whose few warps cannot hide a load, need
// not wait for it (PERF.md, K11: how the chain's time splits between
// the factors' bytes and the products).  K10 builds
// its 16-entry table in shared memory, each thread's K words of an entry
// at stride blockDim.x (16 K blockDim.x words a block: 73,728 B at K=9,
// 128 threads), written and read by its own thread only.  K10's digits
// are secret (a plaintext, or a keygen candidate's (c-1)>>tz, among
// which are the primes), so each window reads all 16 entries and keeps
// T[digit] by mask: a digit never forms an address (the TPU's one-hot
// select).
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
#include <type_traits>
#include <cuda_runtime.h>

#include "rns_tile.cuh"   // allow_max_shared, cp_async_*

namespace {

constexpr int kMaxLimbs = 1040;     // ops/mont.MAX_LIMBS
constexpr unsigned kFull = 0xFFFFFFFFu;

// Words jK .. jK+K-1 of a column of 16-bit limbs at row stride s (limbs
// at or past L read as 0).
template <int K>
__device__ __forceinline__ void load_words(uint32_t (&w)[K], const uint32_t* p,
                                           size_t s, int L, int j) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int l = 2 * (j * K + kk);
    const uint32_t lo = l < L ? p[l * s] & 0xFFFFu : 0u;
    const uint32_t hi = l + 1 < L ? p[(l + 1) * s] & 0xFFFFu : 0u;
    w[kk] = lo | (hi << 16);
  }
}

template <int K>
__device__ __forceinline__ void store_words(const uint32_t (&w)[K], uint32_t* p,
                                            size_t s, int L, int j) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int l = 2 * (j * K + kk);
    if (l < L) p[l * s] = w[kk] & 0xFFFFu;
    if (l + 1 < L) p[(l + 1) * s] = w[kk] >> 16;
  }
}

// r = a * b * 2^(-16L) mod n for the column of a group of g lanes (lane
// j of the group holds words jK .. jK+K-1 of a, b and n); a, b < 2n,
// 4n < 2^(16L).  W = ceil(L/2) word steps; `shift` (L odd) feeds the
// outer operand in as a * 2^16.  r may alias a or b: it is written
// after the last step.  Every lane of the warp calls it together.
template <int K>
__device__ __forceinline__ void coop_mul(uint32_t (&r)[K], const uint32_t (&a)[K],
                                         const uint32_t (&b)[K],
                                         const uint32_t (&n)[K], uint32_t np,
                                         int W, bool shift, int j, int g) {
  uint32_t t[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) t[kk] = 0u;
  uint64_t th = 0;          // carry into word (j+1)K: the next lane's word 0
  uint32_t prev = 0u;       // word i-1 of a (for the shifted operand)
  const bool top = j == g - 1;
  for (int o = 0; o * K < W; ++o) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      if (o * K + kk >= W) break;            // the same in every lane
      const uint32_t w = __shfl_sync(kFull, a[kk], o, g);
      const uint32_t ai = shift ? __funnelshift_l(prev, w, 16) : w;
      prev = w;
      uint64_t c = 0;                         // t += ai * b
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const uint64_t s = static_cast<uint64_t>(ai) * b[m] + t[m] + c;
        t[m] = static_cast<uint32_t>(s);
        c = s >> 32;
      }
      th += c;
      // q = t_0 n' mod 2^32 makes word 0 vanish: t += q * n
      const uint32_t q = __shfl_sync(kFull, t[0] * np, 0, g);
      c = 0;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const uint64_t s = static_cast<uint64_t>(q) * n[m] + t[m] + c;
        t[m] = static_cast<uint32_t>(s);
        c = s >> 32;
      }
      th += c;
      // t >>= 32: the next lane's word 0 and th become word K-1
      const uint32_t up = __shfl_down_sync(kFull, t[0], 1, g);
#pragma unroll
      for (int m = 0; m + 1 < K; ++m) t[m] = t[m + 1];
      const uint64_t s = th + (top ? 0u : up);
      t[K - 1] = static_cast<uint32_t>(s);
      th = s >> 32;
    }
  }
  // th < 4: ripple it (and any carry it makes) up the group.  The top
  // lane's carry is 0 (g*K > W words hold t < b + n).
  uint32_t carry = top ? 0u : static_cast<uint32_t>(th);
  while (__any_sync(kFull, carry != 0u)) {
    const uint32_t up = __shfl_up_sync(kFull, carry, 1, g);
    uint64_t c = j == 0 ? 0u : up;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const uint64_t s = t[m] + c;
      t[m] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    carry = top ? 0u : static_cast<uint32_t>(c);
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk) r[kk] = t[kk];
}

// A lane's place in its column group (see the header): j, the column
// (B-1 for a group past B, which stores nothing), the modulus column c
// and row stride sn, W and the odd-L shift, the modulus's K words and n'.
template <int K>
struct Lane {
  int j, col, c, W;
  size_t sn;
  bool live, shift;
  uint32_t n[K];
  uint32_t np;
};

template <int K>
__device__ __forceinline__ void lane_setup(Lane<K>& ln, const uint32_t* n,
                                           const uint32_t* n0, int per_elem,
                                           int L, int B, int g) {
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  ln.j = static_cast<int>(gid & (g - 1));
  const long long col_id = gid / g;
  ln.live = col_id < B;
  ln.col = ln.live ? static_cast<int>(col_id) : B - 1;
  ln.c = per_elem ? ln.col : 0;
  ln.sn = per_elem ? static_cast<size_t>(B) : 1u;
  ln.W = (L + 1) / 2;
  ln.shift = (L & 1) != 0;
  load_words(ln.n, n + ln.c, ln.sn, L, ln.j);
  const uint32_t nw0 = __shfl_sync(kFull, ln.n[0], 0, g);
  const uint32_t h = n0[ln.c];                    // -n^-1 mod 2^16
  ln.np = h * (2u + nw0 * h);                     // -n^-1 mod 2^32
}

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

// One 32-bit word (bytes = 4), or zeros (bytes = 0), copied into shared
// memory by cp.async; rns_tile::cp_async_wait_all waits for it.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
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

// K10: tab: (16, K, blockDim.x) words of dynamic shared memory.
template <int K>
__global__ void __launch_bounds__(128, 1)
mont_exp_kernel(const uint32_t* base, const int32_t* digits,
                const uint32_t* one, uint32_t* out, const uint32_t* n,
                const uint32_t* n0, int per_elem, int L, int B, int n_win,
                int win_start, int g) {
  extern __shared__ uint32_t tab[];
  const int nt = blockDim.x;
  Lane<K> ln;
  lane_setup(ln, n, n0, per_elem, L, B, g);
  const int j = ln.j, col = ln.col;
  uint32_t x[K], acc[K];
  load_words(x, base + col, B, L, j);
  load_words(acc, one + ln.c, ln.sn, L, j);
  uint32_t* te = tab + threadIdx.x;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    te[kk * nt] = acc[kk];                        // T[0] = one
    te[(K + kk) * nt] = x[kk];                    // T[1] = base
    acc[kk] = x[kk];
  }
  for (int d = 2; d < 16; ++d) {                  // T[d] = T[d-1] * base
    coop_mul(acc, acc, x, ln.n, ln.np, ln.W, ln.shift, j, g);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) te[(d * K + kk) * nt] = acc[kk];
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk) acc[kk] = te[kk * nt];   // acc = one
  for (int w = win_start; w < n_win; ++w) {
    for (int s = 0; s < 4; ++s)
      coop_mul(acc, acc, acc, ln.n, ln.np, ln.W, ln.shift, j, g);
    const int d = __ldg(digits + static_cast<size_t>(w) * B + col);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {              // x = T[d], all 16 read
      uint32_t v = 0u;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        v |= te[(e * K + kk) * nt] & (0u - static_cast<uint32_t>(e == d));
      x[kk] = v;
    }
    coop_mul(acc, acc, x, ln.n, ln.np, ln.W, ln.shift, j, g);
  }
  if (ln.live) store_words(acc, out + col, B, L, j);
}

// (g, K) of K9, K10 and K11 for W words and B columns, g in {8, 16, 32},
// K in {3, 5, 9, 17}, g*K >= W+1 (a spare word for t < b + n): the least
// padding g*K when the batch fills the card (at least 4 warps an SM),
// else the least K: a small batch leaves too few warps to hide a word
// step's latency, and a shorter step has less of it.
struct CoopShape {
  int g, K;
};

inline CoopShape coop_shape(int W, int B) {
  CoopShape pad{0, 0}, lat{0, 0};
  for (int K : {3, 5, 9, 17}) {
    int g = 8;
    while (g * K < W + 1) g *= 2;
    if (g > 32) continue;
    if (pad.g == 0 || g * K < pad.g * pad.K) pad = {g, K};
    if (lat.g == 0) lat = {g, K};
  }
  const long long warps = static_cast<long long>(B) * pad.g / 32;
  return warps >= 4 * 132 ? pad : lat;
}

// K9 and K11 take 128 threads a block.  K10 takes 128 (64 at K=17), so a
// block's table stays under 74 KB and three blocks share an SM.
constexpr int kCoopThreads = 128;
inline int exp_threads(int K) { return K == 17 ? 64 : 128; }

inline size_t exp_smem(int K) {
  return static_cast<size_t>(16) * K * exp_threads(K) * sizeof(uint32_t);
}

// K11's staged factor: 2K limbs a thread (17,408 B a block at K=17).
inline size_t chain_smem(int K) {
  return static_cast<size_t>(2) * K * kCoopThreads * sizeof(uint32_t);
}

inline int blocks_for(int B, int g, int nt) {
  const long long threads = static_cast<long long>(B) * g;
  return static_cast<int>((threads + nt - 1) / nt);
}

template <int K>
cudaError_t launch_exp(const uint32_t* base, const int32_t* digits,
                       const uint32_t* one, uint32_t* out, const uint32_t* n,
                       const uint32_t* n0, int per_elem, int L, int B,
                       int n_win, int win_start, int g, cudaStream_t stream) {
  static std::atomic<unsigned long long> raised{0};
  const cudaError_t e =
      rns_tile::allow_max_shared(mont_exp_kernel<K>, raised);
  if (e != cudaSuccess) return e;
  const int nt = exp_threads(K);
  mont_exp_kernel<K><<<blocks_for(B, g, nt), nt, exp_smem(K), stream>>>(
      base, digits, one, out, n, n0, per_elem, L, B, n_win, win_start, g);
  return cudaGetLastError();
}

// Calls launch(std::integral_constant<int, K>{}, g) for the (g, K) that
// coop_shape picks at L limbs and B columns (the one switch over K).
template <class F>
cudaError_t with_shape(int L, int B, F&& launch) {
  const CoopShape sh = coop_shape((L + 1) / 2, B);
  switch (sh.K) {
    case 3: return launch(std::integral_constant<int, 3>{}, sh.g);
    case 5: return launch(std::integral_constant<int, 5>{}, sh.g);
    case 9: return launch(std::integral_constant<int, 9>{}, sh.g);
    case 17: return launch(std::integral_constant<int, 17>{}, sh.g);
    default: return cudaErrorInvalidValue;
  }
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
    return launch_exp<decltype(k)::value>(base, digits, one, out, n, n0,
                                          per_elem, L, B, n_win, win_start,
                                          g, st);
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

// The group width g and words a lane K that K9, K10 and K11 run at for
// L limbs and B columns (coop_shape), as g * 100 + K.
extern "C" int pct_mont_exp_shape(int L, int B) {
  const CoopShape sh = coop_shape((L + 1) / 2, B);
  return sh.g * 100 + sh.K;
}
