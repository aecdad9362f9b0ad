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
// K9 and K10 serve every Montgomery context without the mm3 weights of K3/K4:
// the per-element contexts of MontCtx.for_moduli (the device-batched
// Miller-Rabin of keygen, one prime candidate per column, and the fused
// CRT decrypt over [p^2]*B ++ [q^2]*B) and moduli whose L exceeds the
// weights' 520 limbs (n^2 of keys past the RNS bound).
//
// Layout and arithmetic: cios.cuh (one thread per column, CIOS with
// 16-bit digits; the unique Montgomery product, so K9 equals K3 and K10
// equals K4 limb for limb on a shared modulus).  The modulus and `one`
// are read at column stride 0 and row stride 1 when shared ((L, 1)), or
// column stride 1 and row stride B when per-element ((L, B)); n0 is read
// from n0[col], or n0[0] when shared (per_elem selects).
//
// K10's table: T[0] = one, T[1] = base, T[d] = T[d-1]*base for d = 2..15,
// in wrapper-allocated global scratch (16, L, B) (67.6 MB at L=129,
// B=8192).  Per window: 4 squarings through the product routine, then a
// product by the entry whose index equals the digit, selected by mask
// after reading all 16 (cios::OneHot16): the digits include every keygen
// candidate's (c-1)>>tz, and the secret primes are among the candidates.
//
// K11 is one thread per column: the accumulator stays in the thread's
// local memory between products and only the factors (n_win, L, B)
// stream from global memory, each limb once per product (362 MB at
// n_win=86, L=257, B=4096).  The TPU kernel revisited its output block
// over a (batch tile, window) grid instead.  Products run in the order
// j = 0..n_win-1, so the result equals the streamed chain of K3/K9
// products limb for limb.  Work: n_win products of 2L^2 limb products;
// bytes: the factor array, acc0, the modulus and n0 read once, the
// output written once.  The gather that builds the factor array from
// the comb is eager PyTorch in the wrapper's caller.
//
// What bounds it on the H100.  Work: K9 is one product and K10
// (2^4 - 2) + n_win*5 products per column, each 2L^2 16x16-bit limb
// products (counted as 4 int8 multiply-adds each, as for K3); bytes: the
// inputs read once (operands, per-column moduli, n0, one, digits) and the
// output written once.  Like K3 the kernels are latency-bound, far from
// either bound: one thread per column walks L^2 dependent multiply-adds
// with its running sum t (L+2 words) and accumulator in local memory.
// The limit is L <= 1040 (n^2 of an 8192-bit key has L = 1025): the two
// local arrays then take ~8 KB per thread.  Later work: 32-bit digits
// with __umulhi, the running sum in registers or shared memory, several
// threads per column.

#include <cstdint>
#include <cuda_runtime.h>

#include "cios.cuh"

namespace {

constexpr int kMaxLimbs = 1040;     // ops/mont.MAX_LIMBS
constexpr int kThreads = 32;        // one warp: spreads a batch over more SMs

__global__ void mont_mul_kernel(const uint32_t* a, const uint32_t* b,
                                uint32_t* out, const uint32_t* n,
                                const uint32_t* n0, int per_elem, int L,
                                int B) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  const int c = per_elem ? col : 0;
  uint32_t t[kMaxLimbs + 2];
  cios::mont_mul_col(cios::Strided{a + col, B}, b + col, B, out + col, B,
                     n + c, per_elem ? B : 1, n0[c], L, t);
}

__global__ void mont_exp_kernel(const uint32_t* base, const int32_t* digits,
                                const uint32_t* one, uint32_t* out,
                                uint32_t* table, const uint32_t* n,
                                const uint32_t* n0, int per_elem, int L,
                                int B, int n_win, int win_start) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  const int c = per_elem ? col : 0;
  cios::exp_col<kMaxLimbs>(base + col, digits + col, one + c, out + col,
                           table + col, n + c, per_elem ? B : 1, n0[c], L, B,
                           win_start, n_win);
}

__global__ void mont_chain_kernel(const uint32_t* factors,
                                  const uint32_t* acc0, uint32_t* out,
                                  const uint32_t* n, const uint32_t* n0,
                                  int per_elem, int n_win, int L, int B) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  const int c = per_elem ? col : 0;
  const int sn = per_elem ? B : 1;
  const uint32_t n0c = n0[c];
  uint32_t t[kMaxLimbs + 2];
  uint32_t acc[kMaxLimbs];
  for (int j = 0; j < L; ++j) acc[j] = acc0[static_cast<size_t>(j) * B + col];
  const size_t plane = static_cast<size_t>(L) * B;
  for (int w = 0; w < n_win; ++w)            // acc = acc * factors[w]
    cios::mont_mul_col(cios::Strided{factors + w * plane + col, B}, acc, 1,
                       acc, 1, n + c, sn, n0c, L, t);
  for (int j = 0; j < L; ++j) out[static_cast<size_t>(j) * B + col] = acc[j];
}

inline int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int pct_mont_mul(const uint32_t* a, const uint32_t* b,
                            uint32_t* out, const uint32_t* n,
                            const uint32_t* n0, int per_elem, int L, int B,
                            void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1) return cudaErrorInvalidValue;
  mont_mul_kernel<<<blocks_for(B), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, b, out, n, n0,
                                                         per_elem, L, B);
  return cudaGetLastError();
}

extern "C" int pct_mont_exp(const uint32_t* base, const int32_t* digits,
                            const uint32_t* one, uint32_t* out,
                            uint32_t* table, const uint32_t* n,
                            const uint32_t* n0, int per_elem, int L, int B,
                            int n_win, int win_start, void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1 || n_win < 0 || win_start < 0) {
    return cudaErrorInvalidValue;
  }
  mont_exp_kernel<<<blocks_for(B), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      base, digits, one, out, table, n, n0, per_elem, L, B, n_win,
      win_start);
  return cudaGetLastError();
}

extern "C" int pct_mont_chain(const uint32_t* factors, const uint32_t* acc0,
                              uint32_t* out, const uint32_t* n,
                              const uint32_t* n0, int per_elem, int n_win,
                              int L, int B, void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1 || n_win < 0) {
    return cudaErrorInvalidValue;
  }
  mont_chain_kernel<<<blocks_for(B), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      factors, acc0, out, n, n0, per_elem, n_win, L, B);
  return cudaGetLastError();
}
