// The matmul-Montgomery (nibble, "v2") column routines of kernel K14
// (csrc/mont2.cu mm2_exp, the only kernel left on them: K12, K13 and K15
// run on the cooperative routine of csrc/coop.cuh): one thread owns one
// column (one big number) of a limbs-major (L, B) uint32 tensor of
// 16-bit limbs.
//
// A Montgomery product here is the TPU's _mm2_val
// (pailliercryptolib_python_tpu/ops/pallas_mont2.py:332-351):
//   1. T = a*b (or a*a by the symmetric product) as 2L canonical limbs;
//   2. the nibbles of T[0..L) in block order (column u*L + k of the
//      weights holds bits 4u..4u+3 of limb k), packed four to a 32-bit
//      word: the 4L nibbles are exactly L words;
//   3. q = T*mu mod R: output limb t is sum_v slot_v << 4v, slot_v the
//      dot product of row v*L + t of W_mu (4L, 4L) with the nibbles,
//      taken four int8 pairs at a time by __dp4a; carried to canonical
//      limbs mod R;
//   4. the same with q's nibbles and rows v*2L + t of W_m (8L, 4L) for
//      t < 2L, plus T, carried: the low L limbs are 0 and the high L
//      limbs are (T + q*m)/R < 2m.
// The modulus never appears: it lives only inside W_m, as on the TPU.
//
// Bounds.  A slot is a sum of 4L products of two nibbles, at most
// 4L*225 < 2^31 (int32, exact).  A recombined limb is at most
// 900L*4369 < 2^32 for L <= 1092, so it is exact in uint32; the carry
// pass adds T's limb and the carry in a 64-bit register.  The product
// T = a*b keeps every partial sum t + a_i*b_j + c below 2^32.
//
// The weights are read from global memory; every thread of a warp reads
// the same word at the same step (one broadcast load), and each row is L
// consecutive words, so a warp walks the weights in order through L1.

#pragma once

#include <cstddef>
#include <cstdint>

#include "cios.cuh"

namespace mm2 {

// x[0..L) = the 4L nibbles of v[0..L) in block order, four to a word
// (byte c of the vector is byte c & 3 of word c >> 2, as the int8 rows
// of the weights lie in memory).
__device__ __forceinline__ void nibble_words(const uint32_t* v, int L,
                                             uint32_t* x) {
  uint32_t cur = 0u;
  int c = 0;
  for (int u = 0; u < 4; ++u) {
    for (int k = 0; k < L; ++k, ++c) {
      cur |= ((v[k] >> (4 * u)) & 15u) << (8 * (c & 3));
      if ((c & 3) == 3) {
        x[c >> 2] = cur;
        cur = 0u;
      }
    }
  }
}

// sum_v slot_v << 4v for output limb t: slot_v is row v*rows + t of the
// weights w (rows of L words) dotted with the nibble words x.
__device__ __forceinline__ uint32_t slot_limb(const int* w, int rows, int t,
                                              const uint32_t* x, int L) {
  const int* r0 = w + static_cast<size_t>(t) * L;
  const size_t vs = static_cast<size_t>(rows) * L;
  int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  for (int j = 0; j < L; ++j) {
    const int xj = static_cast<int>(x[j]);
    s0 = __dp4a(__ldg(r0 + j), xj, s0);
    s1 = __dp4a(__ldg(r0 + vs + j), xj, s1);
    s2 = __dp4a(__ldg(r0 + 2 * vs + j), xj, s2);
    s3 = __dp4a(__ldg(r0 + 3 * vs + j), xj, s3);
  }
  return static_cast<uint32_t>(s0) + (static_cast<uint32_t>(s1) << 4) +
         (static_cast<uint32_t>(s2) << 8) + (static_cast<uint32_t>(s3) << 12);
}

// out = (T + q*m)/R, q = T*mu mod R, for a canonical 2L-limb T < mR;
// out written at row stride so.  x, q: scratch of L words each.
__device__ __forceinline__ void reduce_col(const uint32_t* T, const int* wmu,
                                           const int* wm, int L, uint32_t* x,
                                           uint32_t* q, uint32_t* out,
                                           int so) {
  nibble_words(T, L, x);
  uint64_t c = 0u;
  for (int t = 0; t < L; ++t) {              // q = T*mu mod R
    c += slot_limb(wmu, L, t, x, L);
    q[t] = static_cast<uint32_t>(c) & 0xFFFFu;
    c >>= 16;
  }
  nibble_words(q, L, x);
  c = 0u;
  for (int t = 0; t < 2 * L; ++t) {          // T + q*m, high half
    c += static_cast<uint64_t>(slot_limb(wm, 2 * L, t, x, L)) + T[t];
    if (t >= L) out[(t - L) * so] = static_cast<uint32_t>(c) & 0xFFFFu;
    c >>= 16;
  }
}

// T = a*b, 2L canonical limbs.  a(i) yields limb i of the outer operand
// (read L times), b is read at row stride sb (L^2 times).
template <class A>
__device__ __forceinline__ void wide_mul(const A& a, const uint32_t* b,
                                         int sb, int L, uint32_t* T) {
  for (int j = 0; j < 2 * L; ++j) T[j] = 0u;
  for (int i = 0; i < L; ++i) {
    const uint32_t ai = a(i);
    uint32_t c = 0u;
    for (int j = 0; j < L; ++j) {
      const uint32_t s = T[i + j] + ai * b[j * sb] + c;   // <= 2^32 - 1
      T[i + j] = s & 0xFFFFu;
      c = s >> 16;
    }
    T[i + L] = c;                            // first write of this word
  }
}

// T = a*a, 2L canonical limbs, by the symmetric product in
// _mm2_square's order (pallas_mont2.py:235-329): each cross product
// a_i*a_j (i < j) once, one doubling pass, then the diagonal.  a is read
// at row stride sa.
__device__ __forceinline__ void wide_sqr(const uint32_t* a, int sa, int L,
                                         uint32_t* T) {
  for (int j = 0; j < 2 * L; ++j) T[j] = 0u;
  for (int i = 0; i < L - 1; ++i) {
    const uint32_t ai = a[i * sa];
    uint32_t c = 0u;
    for (int j = i + 1; j < L; ++j) {
      const uint32_t s = T[i + j] + ai * a[j * sa] + c;   // <= 2^32 - 1
      T[i + j] = s & 0xFFFFu;
      c = s >> 16;
    }
    T[i + L] = c;
  }
  uint32_t c = 0u;
  for (int j = 0; j < 2 * L; ++j) {          // T *= 2
    const uint32_t s = (T[j] << 1) + c;
    T[j] = s & 0xFFFFu;
    c = s >> 16;
  }
  c = 0u;
  for (int i = 0; i < L; ++i) {              // T += sum a_i^2 2^(32 i)
    const uint32_t ai = a[i * sa];
    const uint32_t p = ai * ai;
    uint32_t s = T[2 * i] + (p & 0xFFFFu) + c;
    T[2 * i] = s & 0xFFFFu;
    s = T[2 * i + 1] + (p >> 16) + (s >> 16);
    T[2 * i + 1] = s & 0xFFFFu;
    c = s >> 16;
  }
}

// Per-thread scratch of one column's product: T (2L), x and q (L each).
template <int kMaxLimbs>
struct Scratch {
  uint32_t T[2 * kMaxLimbs];
  uint32_t x[kMaxLimbs];
  uint32_t q[kMaxLimbs];
};

// out = a*b*R^-1 mod m (out at row stride so; it may alias b or a: it is
// written only after T is formed).
template <int kMaxLimbs, class A>
__device__ __forceinline__ void mul_col(const A& a, const uint32_t* b, int sb,
                                        uint32_t* out, int so, const int* wmu,
                                        const int* wm, int L,
                                        Scratch<kMaxLimbs>& s) {
  wide_mul(a, b, sb, L, s.T);
  reduce_col(s.T, wmu, wm, L, s.x, s.q, out, so);
}

// out = a*a*R^-1 mod m through the symmetric product.
template <int kMaxLimbs>
__device__ __forceinline__ void sqr_col(const uint32_t* a, int sa,
                                        uint32_t* out, int so, const int* wmu,
                                        const int* wm, int L,
                                        Scratch<kMaxLimbs>& s) {
  wide_sqr(a, sa, L, s.T);
  reduce_col(s.T, wmu, wm, L, s.x, s.q, out, so);
}

// base^e of one column, the TPU's _mm2_exp_kernel (window 4): table
// T[0] = one, T[1] = base, T[d] = T[d-1]*base (16 entries, entry d at
// tab + d*L*B), acc = one, then per window from win_start to n_win: four
// squarings and one product by T[digit].  dig points at this column's
// digit of window 0, dstride is the step between windows (B).  The digit
// is secret, so each window reads all 16 entries and keeps T[digit] by
// mask (cios::OneHot16).  kSqr: square through sqr_col (L <=
// cios::kSqrMaxLimbs, the TPU's PRESHIFT_MAX_L), else through the
// product; a template parameter, not a run-time flag.
template <int kMaxLimbs, bool kSqr>
__device__ void exp_col(const uint32_t* bc, const int32_t* dig, int dstride,
                        const uint32_t* onec, uint32_t* outc, uint32_t* tab,
                        const int* wmu, const int* wm, int L, int B,
                        int win_start, int n_win) {
  Scratch<kMaxLimbs> s;
  uint32_t acc[kMaxLimbs];
  const size_t plane = static_cast<size_t>(L) * B;
  for (int j = 0; j < L; ++j) {
    tab[j * B] = onec[j * B];
    tab[plane + j * B] = bc[j * B];
  }
  for (int d = 2; d < 16; ++d)               // T[d] = T[d-1] * base
    mul_col(cios::Strided{tab + (d - 1) * plane, B}, bc, B, tab + d * plane,
            B, wmu, wm, L, s);
  for (int j = 0; j < L; ++j) acc[j] = onec[j * B];
  for (int w = win_start; w < n_win; ++w) {
    for (int r = 0; r < 4; ++r) {
      if (kSqr) {
        sqr_col(acc, 1, acc, 1, wmu, wm, L, s);
      } else {
        mul_col(cios::Strided{acc, 1}, acc, 1, acc, 1, wmu, wm, L, s);
      }
    }
    const int d = dig[static_cast<size_t>(w) * dstride];
    mul_col(cios::OneHot16{tab, plane, B, d}, acc, 1, acc, 1, wmu, wm, L, s);
  }
  for (int j = 0; j < L; ++j) outc[j * B] = acc[j];
}

}  // namespace mm2
