// The CIOS column routines shared by every limb-Montgomery kernel:
// K3/K4/K7/K8 (csrc/mont3.cu, one modulus for the batch) and K9/K10/K11
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

// out = a*a*R^-1 mod n for one column, by the symmetric product: each
// cross product a_i*a_j (i < j) is formed once, the whole array is
// doubled in one carry pass, the diagonal a_i^2 is added, and L REDC
// steps follow (the TPU's _mm2_square order, pallas_mont2.py:235-252).
// A doubled cross product would not fit t + 2*a_i*a_j + c in 32 bits,
// hence the separate doubling pass; every partial sum here stays below
// 2^32.  a is read at row stride sa (about L^2/2 times), out written at
// stride so after the last read of a (they may alias).  t: scratch of
// 2L words.  (T + q*n)/R with q = -T*n^-1 mod R is unique, so the result
// equals mont_mul_col(a, a) limb for limb; the multiplies are
// L(L+1)/2 + L^2 instead of 2L^2.
__device__ __forceinline__ void mont_sqr_col(
    const uint32_t* a, int sa, uint32_t* out, int so, const uint32_t* n,
    int sn, uint32_t n0, int L, uint32_t* t) {
  for (int j = 0; j < 2 * L; ++j) t[j] = 0u;
  for (int i = 0; i < L - 1; ++i) {          // t = sum_{i<j} a_i a_j
    const uint32_t ai = a[i * sa];
    uint32_t c = 0u;
    for (int j = i + 1; j < L; ++j) {
      const uint32_t s = t[i + j] + ai * a[j * sa] + c;   // <= 2^32 - 1
      t[i + j] = s & 0xFFFFu;
      c = s >> 16;
    }
    t[i + L] = c;                            // first write of this word
  }
  uint32_t c = 0u;
  for (int j = 0; j < 2 * L; ++j) {          // t *= 2
    const uint32_t s = (t[j] << 1) + c;
    t[j] = s & 0xFFFFu;
    c = s >> 16;
  }
  c = 0u;
  for (int i = 0; i < L; ++i) {              // t += sum a_i^2 2^(32 i)
    const uint32_t ai = a[i * sa];
    const uint32_t p = ai * ai;
    uint32_t s = t[2 * i] + (p & 0xFFFFu) + c;
    t[2 * i] = s & 0xFFFFu;
    s = t[2 * i + 1] + (p >> 16) + (s >> 16);
    t[2 * i + 1] = s & 0xFFFFu;
    c = s >> 16;
  }
  uint32_t top = 0u;                         // carry into word i + L + 1
  for (int i = 0; i < L; ++i) {              // REDC: t += m*n*2^(16 i)
    const uint32_t m = (t[i] * n0) & 0xFFFFu;
    c = 0u;
    for (int j = 0; j < L; ++j) {
      const uint32_t s = t[i + j] + m * n[j * sn] + c;
      t[i + j] = s & 0xFFFFu;
      c = s >> 16;
    }
    const uint32_t s = t[i + L] + c + top;
    t[i + L] = s & 0xFFFFu;
    top = s >> 16;
  }
  for (int j = 0; j < L; ++j) out[j * so] = t[L + j];   // < 2n < R: top == 0
}

// Largest L at which the fixed-window chains square through
// mont_sqr_col (the TPU kernels' PRESHIFT_MAX_L, pallas_mont2.py:63):
// 2L words then fit the product's scratch of every kernel built here.
constexpr int kSqrMaxLimbs = 192;

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
//
// kSqr: square through mont_sqr_col, as the TPU's mm3 chains do at
// L <= kSqrMaxLimbs (pallas_mont3.py:317-322, 405-410); the caller picks
// this instantiation only for such L.  The per-element-moduli chain
// (K10) keeps the product routine, as the TPU's _mont_exp_kernel.  A
// template parameter and no run-time test: the product-only chains then
// compile to the code they had before the squaring routine existed (a
// run-time flag here cost K4 18-23% at L=257 on the H100).
template <int kMaxLimbs, bool kOneHot, bool kSqr>
__device__ void exp_col(const uint32_t* bc, const int32_t* dig, int dstride,
                        const uint32_t* one, uint32_t* outc, uint32_t* tab,
                        const uint32_t* n, int sn, uint32_t n0, int L, int B,
                        int window, int win_start, int n_win) {
  static_assert(2 * kSqrMaxLimbs <= kMaxLimbs + 2, "square scratch");
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
    for (int s = 0; s < window; ++s) {
      if (kSqr) {
        mont_sqr_col(acc, 1, acc, 1, n, sn, n0, L, t);
      } else {
        mont_mul_col(Strided{acc, 1}, acc, 1, acc, 1, n, sn, n0, L, t);
      }
    }
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
