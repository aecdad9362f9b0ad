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
// K3, K4 and K7 run on the tile routines of mm3_tile.cuh: one CTA of 512
// threads owns 32 columns, spreads the schoolbook product over its
// threads by (column, block of 128 output limbs), and does the Montgomery
// reduction as the TPU kernel did, two Toeplitz byte products (q = T_lo
// mu mod R, then T + q*m), here as mma.sync m16n8k32 u8 products of the
// host-built W_mu, W_m (ops/mont3.py tile_weights, kept on the MontCtx)
// with the tile's bytes, read from global memory in fragment order.  K3
// is one product (mm3_tile::tile_mul with global operands); K4 and K7 are
// a tile's whole chain (mm3_tile::tile_chain), the accumulator kept in
// shared memory between products.  mm3_tile.cuh gives the shared-memory
// layout (115,712 B at L=257, 217,088 B at L=520; the launchers refuse a
// shape that does not fit) and what bounds a product (the L^2
// multiply-adds of the product per column).  The result (a*b + q*m)/R
// with q = -a*b*m^-1 mod R is unique, so every product equals the TPU
// kernel's, the plain twins' and the CIOS kernels' limb for limb, and so
// do the chains, which run the TPU kernels' order of products.
//
// K4's table lies in global scratch the wrapper allocates, tile by tile
// as (tiles, 16, L, 32) uint16 (33.7 MB at L=257, B=4096), and win_start
// is honoured in the window loop.  Its digits are plaintext exponents:
// the b-loader of each window product reads all 16 entries of the tile's
// table for every (limb, column) and keeps the one whose index equals the
// column's digit by mask (the TPU kernel's one-hot select,
// pallas_mont3.py:329-336), so a digit never forms an address.  The
// window's 32 digits are staged in shared memory at its top (all of them
// at once would not fit beside the tile at L=513 with 1024 windows, a
// 4096-bit key's r^n).
//
// K7's table is (tiles, 2^w, L, 32) uint16 in global scratch (33.8 MB at
// w=5, L=129, B=4096) and its exponent p-1 (q-1) one int32 digit vector
// for the whole batch.  The digits are key-derived and every column reads
// the same entry at the same step, so the entry read follows the key, as
// on the TPU (pallas_mont3.py:422) and in K2 (README threat-model note,
// ROADMAP C5): only T[d] is read, copied into shared memory by cp.async
// while the window's squarings run, where it fits beside the tile (L <=
// 480); above that the window product reads it from global memory.
// Staging takes 2% off the chain at L=129, B=4096, w=5 (PERF.md, K7).
//
// Work of a chain: (2^w - 2) + n_win tile products (K4: w=4) of 2 L^2
// 16x16-bit limb products each per column, and n_win w squarings of
// L(L+1)/2 + L^2 (the function's work; the chain runs each square as a
// tile product); bound, as K3, by the product's multiply-adds, so a
// chain costs its products' sum.
//
// K8 runs on the cooperative 32-bit-word routine of coop.cuh (K9's, a
// group of 8-32 lanes a column, the words in registers, (g, K) from
// coop_shape) in lane_setup's shared-modulus mode: one coop_mul(x, x, x)
// a column, one operand array in registers.  K8(a) equals K3(a, a) and
// K9(a, a) limb for limb.  L <= 520 as K3.  Work model: a square's
// L(L+1)/2 + L^2 16x16-bit limb products (the function's work; the
// routine runs it as a product, 4W^2 IMAD); bytes: a read once, the
// modulus, the output written once.

#include <cstdint>
#include <cuda_runtime.h>

#include "coop.cuh"
#include "mm3_tile.cuh"

namespace {

constexpr int kMaxLimbs = 520;      // MontCtx.MXU_MAX_LIMBS

using mm3_tile::kNC;
using mm3_tile::u16;
using rns_tile::kMaxShared;

__global__ void __launch_bounds__(mm3_tile::kThreads, 1)
mm3_mul_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out,
               mm3_tile::Ops op, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int col0 = blockIdx.x * kNC;
  mm3_tile::tile_mul(
      mm3_tile::Global{a, col0, B}, mm3_tile::Global{b, col0, B},
      [&](int r, int col, u16 v) {
        const int gc = col0 + col;
        if (gc < B) out[static_cast<size_t>(r) * B + gc] = v;
      },
      op, smem);
}

// K4: the tile's 4-bit chain; digits (n_win, B); dig, the window's
// digits, past the tile's shared memory.
__global__ void __launch_bounds__(mm3_tile::kThreads, 1)
mm3_exp_kernel(const uint32_t* base, const int32_t* digits,
               const uint32_t* one, uint32_t* out, u16* tab,
               mm3_tile::Ops op, int B, int n_win, int win_start) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = op.L, col0 = blockIdx.x * kNC;
  const size_t SZ = static_cast<size_t>(L) * kNC;
  u16* tb = tab + blockIdx.x * 16 * SZ;
  int* dig = reinterpret_cast<int*>(smem + mm3_tile::smem_bytes(L));
  mm3_tile::tile_chain(
      base, one, out, tb, op, col0, B, 4, win_start, n_win,
      [&](int w) {
        for (int c = threadIdx.x; c < kNC; c += blockDim.x) {
          const int gc = col0 + c;
          dig[c] = gc < B ? __ldg(digits + static_cast<size_t>(w) * B + gc)
                          : 0;
        }
      },
      [&](int r, int col) -> u16 {           // one-hot: all 16 entries
        const int d = dig[col];
        const u16* e = tb + r * kNC + col;
        uint32_t v = 0u;
#pragma unroll
        for (int t = 0; t < 16; ++t)
          v |= e[t * SZ] & (0u - static_cast<uint32_t>(t == d));
        return static_cast<u16>(v);
      },
      smem);
}

// K7: the tile's w-bit chain of one shared exponent, digits (n_win,);
// with `staged`, T[d] is copied past the tile's shared memory during the
// squarings, else read from the table.
__global__ void __launch_bounds__(mm3_tile::kThreads, 1)
mm3_exp_shared_kernel(const uint32_t* base, const int32_t* digits,
                      int n_win, const uint32_t* one, uint32_t* out,
                      u16* tab, mm3_tile::Ops op, int B, int window,
                      bool staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = op.L;
  const size_t SZ = static_cast<size_t>(L) * kNC;
  u16* tb = tab + blockIdx.x * (SZ << window);
  u16* buf = reinterpret_cast<u16*>(smem + mm3_tile::smem_bytes(L));
  const u16* src = buf;
  mm3_tile::tile_chain(
      base, one, out, tb, op, blockIdx.x * kNC, B, window, 0, n_win,
      [&](int w) {
        const u16* e = tb + static_cast<size_t>(__ldg(digits + w)) * SZ;
        if (!staged) {
          src = e;
          return;
        }
        for (int i = threadIdx.x; i < 4 * L; i += blockDim.x)   // 64L B
          rns_tile::cp_async16(buf + 8 * i, e + 8 * i);
        rns_tile::cp_async_commit();
      },
      [&](int r, int col) -> u16 { return src[r * kNC + col]; }, smem);
}

// K8: a*a*R^-1 mod n a column on the cooperative routine (coop.cuh):
// the shared modulus's mode of lane_setup, one operand array in
// registers.
template <int K>
__global__ void __launch_bounds__(coop::kCoopThreads, 1)
mm3_sqr_kernel(const uint32_t* a, uint32_t* out, const uint32_t* n,
               uint32_t n0, int L, int B, int g) {
  coop::Lane<K> ln;
  coop::lane_setup(ln, n, n0, L, B, g);
  uint32_t x[K];
  coop::load_words(x, a + ln.col, B, L, ln.j);
  coop::coop_mul(x, x, x, ln.n, ln.np, ln.W, ln.shift, ln.j, g);
  if (ln.live) coop::store_words(x, out + ln.col, B, L, ln.j);
}

mm3_tile::Ops tile_ops(const uint8_t* Wmu, const uint8_t* Wm, int L) {
  return {reinterpret_cast<const uint4*>(Wmu),
          reinterpret_cast<const uint4*>(Wm), L, (2 * L + 15) / 16,
          (4 * L + 15) / 16, (2 * L + 31) / 32};
}

// Dynamic shared memory of a launch of K3 (kernel 0: the tile), K4
// (1: the tile and one window's 32 digits) or K7 (2: the tile and, where
// it fits, the staged table entry of 64L bytes).
size_t mm3_smem(int L, int kernel) {
  const size_t tile = mm3_tile::smem_bytes(L);
  if (kernel == 1) return tile + kNC * sizeof(int);
  const size_t entry = static_cast<size_t>(L) * kNC * sizeof(u16);
  return kernel == 2 && tile + entry <= kMaxShared ? tile + entry : tile;
}

// Raises kernel's shared-memory limit once per device, then launches it
// over the tiles of B columns with smem bytes, if they fit.
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, std::atomic<unsigned long long>& raised,
                 size_t smem, int B, void* stream, Args... args) {
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  const cudaError_t e = rns_tile::allow_max_shared(kernel, raised);
  if (e != cudaSuccess) return e;
  kernel<<<(B + kNC - 1) / kNC, mm3_tile::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pct_mm3_mul(const uint32_t* a, const uint32_t* b,
                           uint32_t* out, const uint8_t* Wmu,
                           const uint8_t* Wm, int L, int B, void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> raised{0};
  return launch_tiles(mm3_mul_kernel, raised, mm3_smem(L, 0), B, stream, a,
                      b, out, tile_ops(Wmu, Wm, L), B);
}

extern "C" int pct_mm3_exp(const uint32_t* base, const int32_t* digits,
                           const uint32_t* one, uint32_t* out,
                           uint16_t* table, const uint8_t* Wmu,
                           const uint8_t* Wm, int L, int B, int n_win,
                           int win_start, void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1 || win_start < 0) {
    return cudaErrorInvalidValue;
  }
  static std::atomic<unsigned long long> raised{0};
  return launch_tiles(mm3_exp_kernel, raised, mm3_smem(L, 1), B, stream,
                      base, digits, one, out, table, tile_ops(Wmu, Wm, L), B,
                      n_win, win_start);
}

extern "C" int pct_mm3_exp_shared(const uint32_t* base, const int32_t* digits,
                                  int n_win, const uint32_t* one,
                                  uint32_t* out, uint16_t* table,
                                  const uint8_t* Wmu, const uint8_t* Wm,
                                  int L, int B, int window, void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1 || n_win < 0 || window < 1
      || window > 8) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = mm3_smem(L, 2);
  static std::atomic<unsigned long long> raised{0};
  return launch_tiles(mm3_exp_shared_kernel, raised, smem, B, stream, base,
                      digits, n_win, one, out, table, tile_ops(Wmu, Wm, L),
                      B, window, smem > mm3_smem(L, 0));
}

// The dynamic shared memory a launch of K3 (kernel 0), K4 (1) or K7 (2)
// asks for at L limbs; the launchers refuse more than kMaxShared.
extern "C" long long pct_mm3_smem(int L, int kernel) {
  return static_cast<long long>(mm3_smem(L, kernel));
}

extern "C" int pct_mm3_sqr(const uint32_t* a, uint32_t* out,
                           const uint32_t* n, unsigned n0, int L, int B,
                           void* stream) {
  if (L < 2 || L > kMaxLimbs || B < 1) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return coop::with_shape(L, B, [&](auto k, int g) {
    constexpr int K = decltype(k)::value;
    mm3_sqr_kernel<K><<<coop::blocks_for(B, g, coop::kCoopThreads),
                        coop::kCoopThreads, 0, st>>>(a, out, n, n0, L, B, g);
    return cudaGetLastError();
  });
}
