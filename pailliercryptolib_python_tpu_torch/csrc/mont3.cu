// Kernels K3 (mm3_mul) and K4 (mm3_exp): shared-modulus Montgomery
// arithmetic over 16-bit limbs, for Hopper (sm_90a).
//
// K3 replaces pailliercryptolib_python_tpu/ops/pallas_mont3.py
//    _mm3_mul_kernel (:239, wrapper mm3_mul_p :247): a*b*R^-1 mod m.
// K4 replaces pailliercryptolib_python_tpu/ops/pallas_mont3.py
//    _mm3_exp_kernel (:306, wrapper mm3_exp_p :342): base^e with a
//    per-element exponent, 4-bit fixed window, 16-entry table.
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

__global__ void mm3_exp_kernel(const uint32_t* base, const uint32_t* digits,
                               const uint32_t* one, uint32_t* out,
                               uint32_t* table, const uint32_t* n,
                               uint32_t n0, int L, int B, int n_win,
                               int win_start) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  uint32_t t[kMaxLimbs + 2];
  uint32_t acc[kMaxLimbs];
  const size_t plane = static_cast<size_t>(L) * B;
  uint32_t* tab = table + col;               // entry d: tab + d*plane
  const uint32_t* bc = base + col;
  for (int j = 0; j < L; ++j) {
    tab[j * B] = one[j];
    tab[plane + j * B] = bc[j * B];
  }
  for (int d = 2; d < 16; ++d)               // T[d] = T[d-1] * base
    mont_mul_col(tab + (d - 1) * plane, B, bc, B, tab + d * plane, B, n, n0,
                 L, t);
  for (int j = 0; j < L; ++j) acc[j] = one[j];
  for (int w = win_start; w < n_win; ++w) {
    for (int s = 0; s < 4; ++s)
      mont_mul_col(acc, 1, acc, 1, acc, 1, n, n0, L, t);
    const uint32_t d = digits[static_cast<size_t>(w) * B + col];
    mont_mul_col(acc, 1, tab + d * plane, B, acc, 1, n, n0, L, t);
  }
  for (int j = 0; j < L; ++j) out[col + j * B] = acc[j];
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

extern "C" int pct_mm3_exp(const uint32_t* base, const uint32_t* digits,
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
