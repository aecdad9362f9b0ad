// The CIOS column routine of K8 (csrc/mont3.cu, mont_sqr_col: one
// thread owns one column, one modulus for the batch), and the helpers
// the nibble kernels borrow (mm2.cuh, mont2.cu: Strided, OneHot16,
// kSqrMaxLimbs).  K9, K10 and K11 run on the cooperative 32-bit-word
// routine of csrc/mont.cu (a group of lanes a column, words in
// registers); K3, K4 and K7 on the tile of csrc/mm3_tile.cuh.
//
// Layout: limbs-major (L, B) uint32 tensors holding 16-bit limbs; one
// thread owns one column (one big number) and walks its limbs at a row
// stride, so a warp's loads of one limb row are coalesced.
//
// The square is CIOS with 16-bit digits: every partial sum
// t + a_i*a_j + carry stays below 2^32, so the carries are exact in one
// 32-bit register.  The result (T + q*m)/R with q = -T*m^-1 mod R is
// unique, so K8 equals the TPU kernel, the plain twin and K3(a, a) limb
// for limb.
//
// What bounds K8: per-thread latency.  One thread walks a square's
// L(L+1)/2 + L^2 dependent multiply-adds with its 2L-word running sum
// in local memory, and one thread per column leaves most of the card
// idle at B=4096; both the int8 bound and the integer pipes are 2-3
// orders of magnitude away (PERF.md, K8).

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

// out = a*a*R^-1 mod n for one column, by the symmetric product: each
// cross product a_i*a_j (i < j) is formed once, the whole array is
// doubled in one carry pass, the diagonal a_i^2 is added, and L REDC
// steps follow (the TPU's _mm2_square order, pallas_mont2.py:235-252).
// A doubled cross product would not fit t + 2*a_i*a_j + c in 32 bits,
// hence the separate doubling pass; every partial sum here stays below
// 2^32.  a is read at row stride sa (about L^2/2 times), out written at
// stride so after the last read of a (they may alias).  t: scratch of
// 2L words.  (T + q*n)/R with q = -T*n^-1 mod R is unique, so the result
// equals a product a*a limb for limb; the multiplies are
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

// Largest L at which the nibble chains (K14, K15, mm2.cuh) square
// through their squaring routine (the TPU kernels' PRESHIFT_MAX_L,
// pallas_mont2.py:63): 2L words then fit their product's scratch.
constexpr int kSqrMaxLimbs = 192;

}  // namespace cios
