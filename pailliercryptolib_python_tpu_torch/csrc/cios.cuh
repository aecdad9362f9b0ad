// The CIOS column routines shared by every limb-Montgomery kernel:
// K3/K4/K7 (csrc/mont3.cu, one modulus for the batch) and K9/K10
// (csrc/mont.cu, a modulus per column).
//
// Layout: limbs-major (L, B) uint32 tensors holding 16-bit limbs; one
// thread owns one column (one big number) and walks its limbs at a row
// stride, so a warp's loads of one limb row are coalesced.
//
// The product is CIOS with 16-bit digits: every partial sum
// t + a_i*b_j + carry stays below 2^32, so the carries are exact in one
// 32-bit register.  The result (a*b + q*m)/R with q = -a*b*m^-1 mod R is
// unique and symmetric in a and b, so every kernel built on it equals
// the TPU kernels and the plain twins limb for limb, whichever operand
// it walks in the outer loop.

#pragma once

#include <cstddef>
#include <cstdint>

namespace cios {

// Limb i of a column stored at row stride s.
struct Strided {
  const uint32_t* p;
  int s;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return p[i * s];
  }
};

// Limb i of table entry d, selected without indexing by d: all 16
// entries (planes `plane` apart, row stride s) are read and the one
// whose index equals d is kept by mask.  The addresses a thread touches
// do not depend on d (the TPU kernels' one-hot select).
struct OneHot16 {
  const uint32_t* tab;
  size_t plane;
  int s;
  int d;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    uint32_t v = 0u;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const uint32_t mask = 0u - static_cast<uint32_t>(e == d);
      v |= tab[e * plane + static_cast<size_t>(i) * s] & mask;
    }
    return v;
  }
};

// out = a*b*R^-1 mod n for one column.  a(i) yields limb i of the outer
// operand (read L times); b is read at row stride sb (L^2 times) and out
// written at stride so; b and out may alias: out is written only after
// the last read.  n: limbs at row stride sn; n0 = -n^-1 mod 2^16;
// t: scratch of L+2 words.
template <class A>
__device__ __forceinline__ void mont_mul_col(
    const A& a, const uint32_t* b, int sb, uint32_t* out, int so,
    const uint32_t* n, int sn, uint32_t n0, int L, uint32_t* t) {
  for (int j = 0; j < L + 2; ++j) t[j] = 0u;
  for (int i = 0; i < L; ++i) {
    const uint32_t ai = a(i);
    uint32_t c = 0u;
    for (int j = 0; j < L; ++j) {            // t += a_i * b
      const uint32_t s = t[j] + ai * b[j * sb] + c;   // <= 2^32 - 1
      t[j] = s & 0xFFFFu;
      c = s >> 16;
    }
    uint32_t s = t[L] + c;
    t[L] = s & 0xFFFFu;
    t[L + 1] = s >> 16;
    const uint32_t m = (t[0] * n0) & 0xFFFFu;  // t + m*n = 0 mod 2^16
    c = (t[0] + m * n[0]) >> 16;
    for (int j = 1; j < L; ++j) {            // (t + m*n) / 2^16
      const uint32_t s2 = t[j] + m * n[j * sn] + c;
      t[j - 1] = s2 & 0xFFFFu;
      c = s2 >> 16;
    }
    s = t[L] + c;
    t[L - 1] = s & 0xFFFFu;
    t[L] = t[L + 1] + (s >> 16);
  }
  for (int j = 0; j < L; ++j) out[j * so] = t[j];   // < 2m < R: t[L] == 0
}

// base^e of one column (column pointers with row stride B): table
// T[0] = one, T[1] = base, T[d] = T[d-1] * base (2^window entries, entry
// d at tab + d*L*B), acc = one, then per window from win_start to n_win:
// `window` squarings and one product by T[digit].  dig points at this
// column's digit of window 0; dstride is the step between windows (B for
// per-element digits, 1 for a shared exponent).  n and one are read at
// row stride sn (1 for a shared (L, 1) modulus, B for per-column moduli).
//
// kOneHot (window 4 only): the digit is secret (a plaintext, or a prime
// candidate), so each window reads all 16 entries and keeps T[digit] by
// mask (OneHot16), as the TPU kernels do.  Otherwise the digit indexes
// the table: it is one key-derived exponent shared by the batch.
template <int kMaxLimbs, bool kOneHot>
__device__ void exp_col(const uint32_t* bc, const int32_t* dig, int dstride,
                        const uint32_t* one, uint32_t* outc, uint32_t* tab,
                        const uint32_t* n, int sn, uint32_t n0, int L, int B,
                        int window, int win_start, int n_win) {
  uint32_t t[kMaxLimbs + 2];
  uint32_t acc[kMaxLimbs];
  const size_t plane = static_cast<size_t>(L) * B;
  for (int j = 0; j < L; ++j) {
    tab[j * B] = one[j * sn];
    tab[plane + j * B] = bc[j * B];
  }
  for (int d = 2; d < (1 << window); ++d)    // T[d] = T[d-1] * base
    mont_mul_col(Strided{tab + (d - 1) * plane, B}, bc, B, tab + d * plane,
                 B, n, sn, n0, L, t);
  for (int j = 0; j < L; ++j) acc[j] = one[j * sn];
  for (int w = win_start; w < n_win; ++w) {
    for (int s = 0; s < window; ++s)
      mont_mul_col(Strided{acc, 1}, acc, 1, acc, 1, n, sn, n0, L, t);
    const int d = dig[static_cast<size_t>(w) * dstride];
    if (kOneHot) {
      mont_mul_col(OneHot16{tab, plane, B, d}, acc, 1, acc, 1, n, sn, n0, L,
                   t);
    } else {
      mont_mul_col(Strided{acc, 1}, tab + d * plane, B, acc, 1, n, sn, n0, L,
                   t);
    }
  }
  for (int j = 0; j < L; ++j) outc[j * B] = acc[j];
}

}  // namespace cios
