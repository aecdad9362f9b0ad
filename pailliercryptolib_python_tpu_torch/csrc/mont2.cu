// Kernels K12 (mm2_mul), K13 (mm2_sqr), K14 (mm2_exp) and K15
// (mm2_exp_shared): matmul-Montgomery ("v2") arithmetic over 16-bit
// limbs whose reduction is two int8 nibble matrix products, for Hopper
// (sm_90a).
//
// K12 replaces pailliercryptolib_python_tpu/ops/pallas_mont2.py
//     _mm2_mul_kernel (:364, wrapper mm2_mul_p :378): a*b*R^-1 mod m.
// K13 replaces pailliercryptolib_python_tpu/ops/pallas_mont2.py
//     _mm2_sqr_kernel (:403, wrapper mm2_sqr_p :410): a*a*R^-1 mod m
//     through the symmetric product.
// K14 replaces pailliercryptolib_python_tpu/ops/pallas_mont2.py
//     _mm2_exp_kernel (:435, wrapper mm2_exp_p :475): base^e with a
//     per-element exponent, 4-bit windows, a 16-entry table, win_start.
// K15 replaces pailliercryptolib_python_tpu/ops/pallas_mont2.py
//     _mm2_exp_shared_kernel (:521, wrapper mm2_exp_shared_p :559):
//     base^e with one exponent for the batch, a 2^window-entry table.
//
// Layout: limbs-major (L, B) uint32 tensors holding 16-bit limbs; one
// thread owns one column and walks its limbs with stride B, so a warp's
// loads of one limb row are coalesced.  The weights wmu int8 (4L, 4L)
// and wm int8 (8L, 4L) (ops/matmul_mont.const_mult_weights) are kernel
// operands; the kernels take no modulus: m lives only inside wm.
//
// What the TPU kernel did and what this does.  On the TPU the two
// reductions q = T*mu mod R and q*m were int8 matrix products on the MXU
// over a tile of 128 columns.  Here each thread does them for its own
// column with __dp4a (four int8 multiply-adds an instruction) on the
// integer pipes: the column routine csrc/mm2.cuh mm2::mul_col / sqr_col
// (the TPU's _mm2_val / _mm2_sqr_val).  The reduction is the nibble one,
// not CIOS, so these kernels are the oracle for a tensor-core version.
//
// Bounds of the arithmetic (every step exact): a slot is at most
// 4L*225 < 2^31; a recombined limb is at most 900L*4369 < 2^32 for
// L <= 1092.  These kernels accept 2 <= L <= 520 (kMaxLimbs, as
// csrc/mont3.cu) and return cudaErrorInvalidValue otherwise.
//
// What bounds it on the H100.  A product is L^2 16x16-bit limb products
// plus 12L^2 __dp4a (48L^2 nibble multiply-adds: (4L)(4L) for q, (8L)(4L)
// for q*m), so about 26 times the int8 work of CIOS's 2L^2 limb
// products; every __dp4a reads one weight word, the same word across
// the warp (3 MB of weights a product at L=257, served by L1/L2).  With
// one thread per column a 4096-wide batch is 128 warps on 132 SMs: the
// kernel is latency-bound, far above its bound.  Moving the two weight
// products onto int8 tensor cores (mma.sync / wgmma) over a tile of
// columns is the next design.
//
// K14 keeps its 16-entry table in a global scratch (16, L, B) and
// selects the entry by a constant-access one-hot mask over all 16
// (cios::OneHot16; the digits are secret, ROADMAP C9).  K15's table is
// (2^window, L, B) indexed by the shared, key-derived digit (ROADMAP C5,
// as K7).  Both square through mm2::sqr_col at L <= cios::kSqrMaxLimbs
// (192, the TPU's PRESHIFT_MAX_L) and through the product above it, an
// instantiation picked on the host.  pct_sqr_max_limbs reports the
// cutoff; chip_smoke.py holds ops/mont2.PRESHIFT_MAX_L to it.  The Montgomery result is unique,
// so K12-K15 equal their plain twins (ops/mont2.py), the TPU kernels and
// K3 / K8 / K4 / K7 limb for limb.

#include <cstdint>
#include <cuda_runtime.h>

#include "mm2.cuh"

namespace {

constexpr int kMaxLimbs = 520;      // MontCtx.MXU_MAX_LIMBS, csrc/mont3.cu
constexpr int kThreads = 32;        // one warp: spreads a batch over more SMs

__global__ void mm2_mul_kernel(const uint32_t* a, const uint32_t* b,
                               uint32_t* out, const int* wmu, const int* wm,
                               int L, int B) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  mm2::Scratch<kMaxLimbs> s;
  mm2::mul_col(cios::Strided{a + col, B}, b + col, B, out + col, B, wmu, wm,
               L, s);
}

__global__ void mm2_sqr_kernel(const uint32_t* a, uint32_t* out,
                               const int* wmu, const int* wm, int L, int B) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  mm2::Scratch<kMaxLimbs> s;
  mm2::sqr_col(a + col, B, out + col, B, wmu, wm, L, s);
}

template <bool kSqr>
__global__ void mm2_exp_kernel(const uint32_t* base, const int32_t* digits,
                               const uint32_t* one, uint32_t* out,
                               uint32_t* table, const int* wmu, const int* wm,
                               int L, int B, int n_win, int win_start) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  mm2::exp_col<kMaxLimbs, true, kSqr>(base + col, digits + col, B, one + col,
                                      out + col, table + col, wmu, wm, L, B,
                                      4, win_start, n_win);
}

template <bool kSqr>
__global__ void mm2_exp_shared_kernel(const uint32_t* base,
                                      const int32_t* digits, int n_win,
                                      const uint32_t* one, uint32_t* out,
                                      uint32_t* table, const int* wmu,
                                      const int* wm, int L, int B,
                                      int window) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  mm2::exp_col<kMaxLimbs, false, kSqr>(base + col, digits, 1, one + col,
                                       out + col, table + col, wmu, wm, L, B,
                                       window, 0, n_win);
}

inline int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

inline bool bad_limbs(int L, int B) {
  return L < 2 || L > kMaxLimbs || B < 1;
}

inline const int* words(const int8_t* w) {
  return reinterpret_cast<const int*>(w);
}

}  // namespace

extern "C" int pct_mm2_mul(const uint32_t* a, const uint32_t* b,
                           uint32_t* out, const int8_t* wmu,
                           const int8_t* wm, int L, int B, void* stream) {
  if (bad_limbs(L, B)) return cudaErrorInvalidValue;
  mm2_mul_kernel<<<blocks_for(B), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      a, b, out, words(wmu), words(wm), L, B);
  return cudaGetLastError();
}

extern "C" int pct_mm2_sqr(const uint32_t* a, uint32_t* out,
                           const int8_t* wmu, const int8_t* wm, int L, int B,
                           void* stream) {
  if (bad_limbs(L, B)) return cudaErrorInvalidValue;
  mm2_sqr_kernel<<<blocks_for(B), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      a, out, words(wmu), words(wm), L, B);
  return cudaGetLastError();
}

extern "C" int pct_mm2_exp(const uint32_t* base, const int32_t* digits,
                           const uint32_t* one, uint32_t* out,
                           uint32_t* table, const int8_t* wmu,
                           const int8_t* wm, int L, int B, int n_win,
                           int win_start, void* stream) {
  if (bad_limbs(L, B) || n_win < 0 || win_start < 0) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = L <= cios::kSqrMaxLimbs ? mm2_exp_kernel<true>
                                              : mm2_exp_kernel<false>;
  kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      base, digits, one, out, table, words(wmu), words(wm), L, B, n_win,
      win_start);
  return cudaGetLastError();
}

extern "C" int pct_mm2_exp_shared(const uint32_t* base, const int32_t* digits,
                                  int n_win, const uint32_t* one,
                                  uint32_t* out, uint32_t* table,
                                  const int8_t* wmu, const int8_t* wm, int L,
                                  int B, int window, void* stream) {
  if (bad_limbs(L, B) || n_win < 0 || window < 1 || window > 8) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = L <= cios::kSqrMaxLimbs
                          ? mm2_exp_shared_kernel<true>
                          : mm2_exp_shared_kernel<false>;
  kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      base, digits, n_win, one, out, table, words(wmu), words(wm), L, B,
      window);
  return cudaGetLastError();
}

extern "C" int pct_sqr_max_limbs() { return cios::kSqrMaxLimbs; }
