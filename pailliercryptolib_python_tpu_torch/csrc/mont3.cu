// Kernels K3 (mm3_mul), K4 (mm3_exp) and K7 (mm3_exp_shared):
// shared-modulus Montgomery arithmetic over 16-bit limbs, for Hopper
// (sm_90a).
//
// K3 replaces pailliercryptolib_python_tpu/ops/pallas_mont3.py
//    _mm3_mul_kernel (:239, wrapper mm3_mul_p :247): a*b*R^-1 mod m.
// K4 replaces pailliercryptolib_python_tpu/ops/pallas_mont3.py
//    _mm3_exp_kernel (:306, wrapper mm3_exp_p :342): base^e with a
//    per-element exponent, 4-bit fixed window, 16-entry table.
// K7 replaces pailliercryptolib_python_tpu/ops/pallas_mont3.py
//    _mm3_exp_shared_kernel (:391, wrapper mm3_exp_shared_p :430):
//    base^e with one exponent shared by the batch (the limb CRT
//    decrypt), w-bit fixed window, 2^w-entry table.
//
// Layout: limbs-major (L, B) uint32 tensors holding 16-bit limbs; one
// thread owns one column (one big number) and walks its limbs with
// stride B, so a warp's loads of one limb row are coalesced.
//
// What the TPU kernel did and what this does instead.  The TPU kernel
// reduced with two signed-byte Toeplitz matrix products on the MXU.
// Hopper has native 32x32-bit integer multiplies, so this kernel runs a
// plain CIOS reduction with 16-bit digits: every partial sum
// t + a_i*b_j + carry stays below 2^32, so the carries are exact in one
// 32-bit register.  The result (a*b + q*m)/R with q = -a*b*m^-1 mod R is
// unique, so it equals the TPU kernel's limb for limb (and the plain
// twin's, ops/mont3.py).
//
// What bounds it on the H100.  Each product is L^2 (66k at L=257)
// dependent multiply-adds per column on the integer pipes; the running
// sum t (L+2 words) lives in per-thread local memory, so every inner
// step reads and writes it through L1/L2.  With one thread per column a
// 4096-wide batch fills only 128 warps on 132 SMs: the kernel is
// latency-bound, not throughput-bound.  Later work: 32-bit digits with
// __umulhi (4x fewer steps), t in registers/shared memory, and several
// threads per column.
//
// K4 keeps its 16-entry table in a global scratch the wrapper allocates
// ((16, L, B), coalesced like the operands; 67 MB at L=257, B=4096) and
// honours win_start directly in the window loop.  The table index is a
// digit of the plaintext exponent (not of the key).
//
// K7 runs the same column routine with a 2^w-entry table in global
// scratch ((32, 129, B) u32 at w=5: 68 MB at B=4096) and the exponent
// p-1 (q-1) as one int32 digit vector for the whole batch.  The TPU
// kernel squared through K8's body; CIOS output is unique, so acc*acc
// through the product routine gives the same limbs (a dedicated square
// is K8's work).  The digits are key-derived and every column reads the
// same entry at the same step, so the table index follows the key, as
// on the TPU and as in K2 (README threat-model note, ROADMAP C5).  Bound:
// as K3, per-product latency; (2^w - 2) + n_win (w + 1) products of
// 2 L^2 16x16-bit limb products each per column.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLimbs = 520;      // MontCtx.MXU_MAX_LIMBS
constexpr int kThreads = 32;        // one warp: spreads a batch over more SMs

// out = a*b*R^-1 mod n for one column, CIOS over 16-bit digits.
// a, b, out are read/written at stride sa, sb, so (L words each); they
// may alias: out is written only after the last read.  n: (L,) limbs,
// n0 = -n^-1 mod 2^16, t: scratch of L+2 words.
__device__ __forceinline__ void mont_mul_col(
    const uint32_t* a, int sa, const uint32_t* b, int sb, uint32_t* out,
    int so, const uint32_t* n, uint32_t n0, int L, uint32_t* t) {
  for (int j = 0; j < L + 2; ++j) t[j] = 0u;
  for (int i = 0; i < L; ++i) {
    const uint32_t ai = a[i * sa];
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
      const uint32_t s2 = t[j] + m * n[j] + c;
      t[j - 1] = s2 & 0xFFFFu;
      c = s2 >> 16;
    }
    s = t[L] + c;
    t[L - 1] = s & 0xFFFFu;
    t[L] = t[L + 1] + (s >> 16);
  }
  for (int j = 0; j < L; ++j) out[j * so] = t[j];   // < 2m < R: t[L] == 0
}

__global__ void mm3_mul_kernel(const uint32_t* a, const uint32_t* b,
                               uint32_t* out, const uint32_t* n, uint32_t n0,
                               int L, int B) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  uint32_t t[kMaxLimbs + 2];
  mont_mul_col(a + col, B, b + col, B, out + col, B, n, n0, L, t);
}

// base^e of one column (column pointers with row stride B): table
// T[0] = one, T[1] = base, T[d] = T[d-1] * base (2^window entries, entry
// d at tab + d*L*B), acc = one, then per window from win_start to n_win:
// `window` squarings and one product by T[digit].  dig points at this
// column's digit of window 0; dstride is the step between windows (B for
// per-element digits, 1 for a shared exponent).
__device__ void exp_col(const uint32_t* bc, const int32_t* dig, int dstride,
                        const uint32_t* one, uint32_t* outc, uint32_t* tab,
                        const uint32_t* n, uint32_t n0, int L, int B,
                        int window, int win_start, int n_win) {
  uint32_t t[kMaxLimbs + 2];
  uint32_t acc[kMaxLimbs];
  const size_t plane = static_cast<size_t>(L) * B;
  for (int j = 0; j < L; ++j) {
    tab[j * B] = one[j];
    tab[plane + j * B] = bc[j * B];
  }
  for (int d = 2; d < (1 << window); ++d)    // T[d] = T[d-1] * base
    mont_mul_col(tab + (d - 1) * plane, B, bc, B, tab + d * plane, B, n, n0,
                 L, t);
  for (int j = 0; j < L; ++j) acc[j] = one[j];
  for (int w = win_start; w < n_win; ++w) {
    for (int s = 0; s < window; ++s)
      mont_mul_col(acc, 1, acc, 1, acc, 1, n, n0, L, t);
    const int d = dig[static_cast<size_t>(w) * dstride];
    mont_mul_col(acc, 1, tab + d * plane, B, acc, 1, n, n0, L, t);
  }
  for (int j = 0; j < L; ++j) outc[j * B] = acc[j];
}

__global__ void mm3_exp_kernel(const uint32_t* base, const int32_t* digits,
                               const uint32_t* one, uint32_t* out,
                               uint32_t* table, const uint32_t* n,
                               uint32_t n0, int L, int B, int n_win,
                               int win_start) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  exp_col(base + col, digits + col, B, one, out + col, table + col, n, n0, L,
          B, 4, win_start, n_win);
}

__global__ void mm3_exp_shared_kernel(const uint32_t* base,
                                      const int32_t* digits, int n_win,
                                      const uint32_t* one, uint32_t* out,
                                      uint32_t* table, const uint32_t* n,
                                      uint32_t n0, int L, int B, int window) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  exp_col(base + col, digits, 1, one, out + col, table + col, n, n0, L, B,
          window, 0, n_win);
}

inline int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int pct_mm3_mul(const uint32_t* a, const uint32_t* b,
                           uint32_t* out, const uint32_t* n, unsigned n0,
                           int L, int B, void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1) return cudaErrorInvalidValue;
  mm3_mul_kernel<<<blocks_for(B), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, b, out, n, n0, L,
                                                        B);
  return cudaGetLastError();
}

extern "C" int pct_mm3_exp(const uint32_t* base, const int32_t* digits,
                           const uint32_t* one, uint32_t* out,
                           uint32_t* table, const uint32_t* n, unsigned n0,
                           int L, int B, int n_win, int win_start,
                           void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1 || win_start < 0) {
    return cudaErrorInvalidValue;
  }
  mm3_exp_kernel<<<blocks_for(B), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      base, digits, one, out, table, n, n0, L, B, n_win, win_start);
  return cudaGetLastError();
}

extern "C" int pct_mm3_exp_shared(const uint32_t* base, const int32_t* digits,
                                  int n_win, const uint32_t* one,
                                  uint32_t* out, uint32_t* table,
                                  const uint32_t* n, unsigned n0, int L,
                                  int B, int window, void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1 || n_win < 0 || window < 1
      || window > 8) {
    return cudaErrorInvalidValue;
  }
  mm3_exp_shared_kernel<<<blocks_for(B), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      base, digits, n_win, one, out, table, n, n0, L, B, window);
  return cudaGetLastError();
}
