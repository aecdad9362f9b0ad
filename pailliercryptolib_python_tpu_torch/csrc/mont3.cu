// Kernels K3 (mm3_mul), K4 (mm3_exp), K7 (mm3_exp_shared) and K8
// (mm3_sqr): shared-modulus Montgomery arithmetic over 16-bit limbs, for
// Hopper (sm_90a).
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
// K8 replaces pailliercryptolib_python_tpu/ops/pallas_mont3.py
//    _mm3_sqr_kernel (:273, wrapper mm3_sqr_p :280, body _mm3_sqr_val
//    :224 over _mm2_square, pallas_mont2.py:235): a*a*R^-1 mod m.
//
// Layout: limbs-major (L, B) uint32 tensors holding 16-bit limbs.
//
// K3 runs on the tile routine of mm3_tile.cuh: one CTA of 512 threads
// owns 32 columns, spreads the schoolbook product a*b over its threads
// by (column, block of 128 output limbs), and does the Montgomery
// reduction as the TPU kernel did, two Toeplitz byte products (q = T_lo
// mu mod R, then T + q*m), here as mma.sync m16n8k32 u8 products of the
// host-built W_mu, W_m (ops/mont3.py tile_weights, kept on the MontCtx)
// with the tile's bytes, read from global memory in fragment order.
// mm3_tile.cuh gives the shared-memory layout (115,712 B at L=257,
// 217,088 B at L=520; the launcher refuses a shape that does not fit) and
// what bounds it (the L^2 multiply-adds of the product per column).  The
// result (a*b + q*m)/R with q = -a*b*m^-1 mod R is unique, so it equals
// the TPU kernel, the plain twin and the CIOS kernels limb for limb.
//
// K4, K7 and K8: one thread owns one column (one big number) and walks
// its limbs with stride B, so a warp's loads of one limb row are
// coalesced; CIOS with 16-bit digits (cios.cuh): every partial sum
// t + a_i*b_j + carry stays below 2^32, so the carries are exact in one
// 32-bit register.  Each product is L^2 (66k at L=257) dependent
// multiply-adds per column, and the running sum lives in per-thread
// local memory; with one thread per column a 4096-wide batch fills only
// 128 warps on 132 SMs, so they are latency-bound.  They move onto the
// tile routine next.
//
// K4 keeps its 16-entry table in a global scratch the wrapper allocates
// ((16, L, B), coalesced like the operands; 67 MB at L=257, B=4096) and
// honours win_start directly in the window loop.  Its digits are
// plaintext exponents, so each window reads all 16 entries and keeps the
// one whose index equals the digit by mask (cios::OneHot16, the TPU
// kernel's one-hot select, pallas_mont3.py:329-336); the per-element
// path of the shared column routine does this for K4 and K10 alike.
//
// The column routines (CIOS product, fixed-window chain) live in
// cios.cuh, shared with K9/K10 (csrc/mont.cu).
//
// K7 runs the same column routine with a 2^w-entry table in global
// scratch ((32, 129, B) u32 at w=5: 68 MB at B=4096) and the exponent
// p-1 (q-1) as one int32 digit vector for the whole batch.  The TPU
// kernel squared through K8's body at L <= 192; so do K4 and K7 here
// (cios::mont_sqr_col at L <= cios::kSqrMaxLimbs, the product routine
// above it): the Montgomery result is unique, so either squaring gives
// the same limbs.  The digits are key-derived and every column reads the
// same entry at the same step, so the table index follows the key, as
// on the TPU and as in K2 (README threat-model note, ROADMAP C5).  Bound:
// as K3, per-product latency; (2^w - 2) + n_win (w + 1) products of
// 2 L^2 16x16-bit limb products each per column.
//
// K8 is one thread per column through cios::mont_sqr_col: the symmetric
// product (each cross product once, one doubling pass, the diagonal) in
// a 2L-word local array, then L REDC steps; K8(a) equals K3(a, a) limb
// for limb.  L <= 520 as K3 (the local array is then ~4 KB per thread).
// Work model: counted as K3's, one product's 2 L^2 16x16-bit limb
// products, so both rows read the same bound for the same function
// (the kernel itself runs L(L+1)/2 + L^2 multiplies); bytes: a read
// once, the modulus, the output written once.  Bound by per-thread
// latency: the 2L-word running array lives in local memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "cios.cuh"
#include "mm3_tile.cuh"

namespace {

constexpr int kMaxLimbs = 520;      // MontCtx.MXU_MAX_LIMBS
constexpr int kThreads = 32;        // one warp: spreads a batch over more SMs

using rns_tile::kMaxShared;

__global__ void __launch_bounds__(mm3_tile::kThreads, 1)
mm3_mul_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out,
               mm3_tile::Ops op, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  mm3_tile::tile_mul(a, b, out, op, blockIdx.x * mm3_tile::kNC, B, smem);
}

template <bool kSqr>
__global__ void mm3_exp_kernel(const uint32_t* base, const int32_t* digits,
                               const uint32_t* one, uint32_t* out,
                               uint32_t* table, const uint32_t* n,
                               uint32_t n0, int L, int B, int n_win,
                               int win_start) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  cios::exp_col<kMaxLimbs, true, kSqr>(base + col, digits + col, B, one,
                                       out + col, table + col, n, 1, n0, L,
                                       B, 4, win_start, n_win);
}

template <bool kSqr>
__global__ void mm3_exp_shared_kernel(const uint32_t* base,
                                      const int32_t* digits, int n_win,
                                      const uint32_t* one, uint32_t* out,
                                      uint32_t* table, const uint32_t* n,
                                      uint32_t n0, int L, int B, int window) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  cios::exp_col<kMaxLimbs, false, kSqr>(base + col, digits, 1, one, out + col,
                                        table + col, n, 1, n0, L, B, window,
                                        0, n_win);
}

__global__ void mm3_sqr_kernel(const uint32_t* a, uint32_t* out,
                               const uint32_t* n, uint32_t n0, int L, int B) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  uint32_t t[2 * kMaxLimbs];
  cios::mont_sqr_col(a + col, B, out + col, B, n, 1, n0, L, t);
}

inline int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int pct_mm3_mul(const uint32_t* a, const uint32_t* b,
                           uint32_t* out, const uint8_t* Wmu,
                           const uint8_t* Wm, int L, int B, void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1) return cudaErrorInvalidValue;
  const size_t smem = mm3_tile::smem_bytes(L);
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> raised{0};
  const cudaError_t e = rns_tile::allow_max_shared(mm3_mul_kernel, raised);
  if (e != cudaSuccess) return e;
  const mm3_tile::Ops op{reinterpret_cast<const uint4*>(Wmu),
                         reinterpret_cast<const uint4*>(Wm), L,
                         (2 * L + 15) / 16, (4 * L + 15) / 16,
                         (2 * L + 31) / 32};
  mm3_mul_kernel<<<(B + mm3_tile::kNC - 1) / mm3_tile::kNC,
                   mm3_tile::kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(a, b, out, op, B);
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
  const auto kernel = L <= cios::kSqrMaxLimbs ? mm3_exp_kernel<true>
                                              : mm3_exp_kernel<false>;
  kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
  const auto kernel = L <= cios::kSqrMaxLimbs
                          ? mm3_exp_shared_kernel<true>
                          : mm3_exp_shared_kernel<false>;
  kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      base, digits, n_win, one, out, table, n, n0, L, B, window);
  return cudaGetLastError();
}

extern "C" int pct_mm3_sqr(const uint32_t* a, uint32_t* out,
                           const uint32_t* n, unsigned n0, int L, int B,
                           void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1) return cudaErrorInvalidValue;
  mm3_sqr_kernel<<<blocks_for(B), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, out, n, n0, L, B);
  return cudaGetLastError();
}
