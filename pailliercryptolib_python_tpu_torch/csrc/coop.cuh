// The cooperative 32-bit-word Montgomery routine of kernels K9, K10, K11
// (csrc/mont.cu), K8 and K16 (csrc/mont3.cu), K12, K13, K14 and K15
// (csrc/mont2.cu), for Hopper (sm_90a), and the 4-bit fixed-window chain
// K10 and K14 share (exp_chain, its launch: exp_threads, exp_smem,
// launch_exp).
//
// A group of g threads (8, 16 or 32 lanes of one warp) owns one column,
// each thread K consecutive 32-bit words of it (the 16-bit limbs paired
// at load, split again at the store; K in {3, 5, 9, 17}).  coop_shape
// picks (g, K) from W = ceil(L/2) and B, g*K > W: the least padding where
// the batch fills the card, g=8, K=9 at L=129, B=8192 and g=8, K=17 at
// L=257, B=4096; else the least K, g=16, K=3 at L=65, B=256; up to g=32,
// K=17 at L=1040.  lane_place gives a lane its place: its group index j,
// its column (groups past B compute column B-1 and store nothing, so
// every lane of a warp takes part in the shuffles); lane_setup adds the K
// words of its modulus and n'.
//
// A product (coop_mul) is W word steps of CIOS: word i of the outer
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
// on this routine keeps a limb array in local memory.  A square is
// coop_mul(x, x, x, ...): one operand array in registers.
//
// What bounds it: a product is W^2 32x32-bit word products of two
// multiply-adds (low and high word) for a*b and W^2 for q*n, 4W^2 IMAD
// on the integer pipes (chip_smoke.py coop_floor_ms).  The latency of a
// word step (two shuffles and the q multiply on its chain) is hidden by
// the other groups of the SM when B is large.

#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "rns_tile.cuh"   // allow_max_shared, cp_async_*

namespace coop {

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

// Everything of a Lane but its modulus words and n'.
template <int K>
__device__ __forceinline__ void lane_place(Lane<K>& ln, int per_elem, int L,
                                           int B, int g) {
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
}

// The modulus from 16-bit limbs n at row stride ln.sn (column ln.c), and
// n' from n0 = -n^-1 mod 2^16 (n0[ln.c]).
template <int K>
__device__ __forceinline__ void lane_setup(Lane<K>& ln, const uint32_t* n,
                                           const uint32_t* n0, int per_elem,
                                           int L, int B, int g) {
  lane_place(ln, per_elem, L, B, g);
  load_words(ln.n, n + ln.c, ln.sn, L, ln.j);
  const uint32_t nw0 = __shfl_sync(kFull, ln.n[0], 0, g);
  const uint32_t h = n0[ln.c];                    // -n^-1 mod 2^16
  ln.np = h * (2u + nw0 * h);                     // -n^-1 mod 2^32
}

// The shared modulus n (L limbs at row stride 1) with n0 = -n^-1 mod
// 2^16 given by value (K8).
template <int K>
__device__ __forceinline__ void lane_setup(Lane<K>& ln, const uint32_t* n,
                                           uint32_t n0, int L, int B, int g) {
  lane_place(ln, 0, L, B, g);
  load_words(ln.n, n, 1, L, ln.j);
  const uint32_t nw0 = __shfl_sync(kFull, ln.n[0], 0, g);
  ln.np = n0 * (2u + nw0 * n0);
}

// One 32-bit word (bytes = 4), or zeros (bytes = 0), copied into shared
// memory by cp.async; rns_tile::cp_async_wait_all waits for it.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// The 4-bit fixed-window chain of K10 (csrc/mont.cu) and K14
// (csrc/mont2.cu) for a lane whose modulus words, n', W and shift are
// set: on entry x holds base and acc the Montgomery one, on exit acc
// holds base^e.  T[0] = one, T[1] = base, T[d] = T[d-1] * base (14
// products) in dynamic shared memory tab, (16, K, blockDim.x) words,
// each thread's K words of an entry at stride blockDim.x, written and
// read by its own thread only; then acc = one and per window from
// win_start four squarings coop_mul(acc, acc, acc) and one product by
// T[digit].  The digits (n_win, B) are per element and secret (a
// plaintext, a keygen candidate's (c-1)>>tz, a ct*pt exponent), so
// each window reads all 16 entries and keeps T[digit] by mask: a digit
// never forms an address (the TPU kernels' one-hot select).
template <int K>
__device__ __forceinline__ void exp_chain(uint32_t (&acc)[K], uint32_t (&x)[K],
                                          const Lane<K>& ln, uint32_t* tab,
                                          const int32_t* digits, int B,
                                          int n_win, int win_start, int g) {
  const int nt = blockDim.x;
  uint32_t* te = tab + threadIdx.x;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    te[kk * nt] = acc[kk];                        // T[0] = one
    te[(K + kk) * nt] = x[kk];                    // T[1] = base
    acc[kk] = x[kk];
  }
  for (int d = 2; d < 16; ++d) {                  // T[d] = T[d-1] * base
    coop_mul(acc, acc, x, ln.n, ln.np, ln.W, ln.shift, ln.j, g);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) te[(d * K + kk) * nt] = acc[kk];
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk) acc[kk] = te[kk * nt];   // acc = one
  for (int w = win_start; w < n_win; ++w) {
    for (int s = 0; s < 4; ++s)
      coop_mul(acc, acc, acc, ln.n, ln.np, ln.W, ln.shift, ln.j, g);
    const int d = __ldg(digits + static_cast<size_t>(w) * B + ln.col);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {              // x = T[d], all 16 read
      uint32_t v = 0u;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        v |= te[(e * K + kk) * nt] & (0u - static_cast<uint32_t>(e == d));
      x[kk] = v;
    }
    coop_mul(acc, acc, x, ln.n, ln.np, ln.W, ln.shift, ln.j, g);
  }
}

// (g, K) for W words and B columns, g in {8, 16, 32}, K in {3, 5, 9,
// 17}, g*K >= W+1 (a spare word for t < b + n): the least padding g*K
// when the batch fills the card (at least 4 warps an SM), else the least
// K: a small batch leaves too few warps to hide a word step's latency,
// and a shorter step has less of it.
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

// Threads a block of the cooperative kernels (the exp_chain kernels
// aside: exp_threads).
constexpr int kCoopThreads = 128;

inline int blocks_for(int B, int g, int nt) {
  const long long threads = static_cast<long long>(B) * g;
  return static_cast<int>((threads + nt - 1) / nt);
}

// The exp_chain kernels (K10, K14) take 128 threads a block (64 at
// K=17), so a block's table stays under 74 KB and three blocks share an
// SM.
inline int exp_threads(int K) { return K == 17 ? 64 : 128; }

inline size_t exp_smem(int K) {
  return static_cast<size_t>(16) * K * exp_threads(K) * sizeof(uint32_t);
}

// Launch an exp_chain kernel at (g, K) over B columns with its table's
// dynamic shared memory, after raising the kernel's limit above 48 KB to
// the table's size once per device (`raised`: one flag word per kernel
// instantiation, rns_tile::allow_max_shared).
template <class Kernel, class... Args>
cudaError_t launch_exp(Kernel kernel, std::atomic<unsigned long long>& raised,
                       int K, int B, int g, cudaStream_t stream,
                       Args... args) {
  const size_t smem = exp_smem(K);
  const cudaError_t e = rns_tile::allow_max_shared(kernel, raised,
                                                   static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int nt = exp_threads(K);
  kernel<<<blocks_for(B, g, nt), nt, smem, stream>>>(args...);
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

}  // namespace coop
