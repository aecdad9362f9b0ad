// One RNS-Montgomery product for a tile of kNC columns owned by one CTA,
// with both base extensions as int8 tensor-core products.  Kernels K1
// (rns_mul), K2 (rns_exp_sched), K5 (rns_exp_elem) and K6
// (rns_exp_shared) in rns.cu run on it, and K3's reduction (mm3_tile.cuh)
// uses its mma_u8.
//
// The function is ops/rns.py rns_mont_mul's (the JAX package's _mul_val),
// limb for limb:
//   S   = cmul(X, Y)                       all CH channels
//   xi  = shoup(S[B])                      k digits
//   S_A, S_B = W1 . [xi_lo; xi_hi]         first base extension
//   Rp  = cmul2(S, u5, combine(S_A,S_B), v5)   on B' and m_r
//   xi' = shoup(Rp[B'])
//   T_A, T_B = W2 . [xi'_lo; xi'_hi]       second base extension
//   Zh  = combine(T_A, T_B)                on B and m_r
//   delta from the redundant channel; Z = cmul2(Zh, w9b, delta, w9n)
//
// The extensions as one matrix product each.  For output row j (o = k+1
// rows), S_A[j] = C_lo[j].x0 + D_lo[j].x1 and S_B[j] = C_hi[j].x0 +
// D_hi[j].x1, where x0, x1 are the low and high bytes of the k digits.
// So [S_A; S_B] = W . X with W = [[C_lo, D_lo], [C_hi, D_hi]] (2o x 2KP)
// and X = [x0; x1] (2KP x kNC).  The host (ops/rns_kernels.py
// tile_weights) builds W from the same byte planes as the E stacks, with
// two choices for this card:
//  - the rows are interleaved (row 2j is S_A[j], row 2j+1 is S_B[j]), so
//    an mma accumulator fragment holds S_A and S_B of one output row in
//    two neighbouring lanes and the epilogue needs one shuffle and no
//    shared-memory buffer;
//  - the bytes are kept unsigned, and X too: mma.sync takes u8 x u8 with
//    an s32 sum, which is the true dot itself (at most 2k * 255^2 < 2^31),
//    so neither the centring of the TPU's signed int8 MXU nor its
//    correction terms (CS1, CS2) are needed.
// W is zero-padded to M = 2o rounded up to 16 and K = 2KP (a multiple of
// 32), and stored in mma fragment order: for m-tile mt and k-step ks,
// lane L's four A registers are 16 contiguous bytes at
// ((mt * KS + ks) * 32 + L) * 16, so one 16-byte load per lane fetches a
// whole A fragment without bank conflicts (shared) or wasted sectors
// (global).
//
// Instruction.  mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32: M=262 at
// k=130 pads to 272 (4%), where wgmma's 64-row tiles would pad to 320
// (22%), and the tensor-core work of a product is small beside its
// elementwise work (below), so the synchronous warp-level product is
// enough.
//
// What bounds it.  At K2's shape (k=130, kNC=32) a product is 2 x 272 x
// 288 x 32 = 5.0 M int8 MACs (1,224 m16n8k32 instructions over 16 warps)
// and ~25 k elementwise 16-bit modular operations (the cmul pass over CH
// channels, two Shoup packs, the combine + cmul2 epilogues, the final
// cmul2), each a handful of integer instructions on shared memory.  The
// second term sets the pace: the design spreads every elementwise pass
// over the CTA's 512 threads by (channel, column) pairs, one pass between
// two __syncthreads() each, and keeps the states in shared memory as
// uint16 (every channel modulus is a 16-bit prime and every primitive
// returns a value below it).

#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace rns_tile {

constexpr int kNC = 32;          // columns a CTA owns
constexpr int kThreads = 512;    // 16 warps
constexpr size_t kMaxShared = 232448;   // a block's limit on the H100

using u16 = uint16_t;

// Raises a kernel's dynamic shared-memory limit to `bytes` (kMaxShared
// unless given; static shared memory counts against the same 227 KB),
// once per device (the attribute belongs to the kernel's instance on the
// current device); `done` is the kernel's own bit set of devices already
// raised.  The launchers still check each launch's size against it.
template <typename Kernel>
inline cudaError_t allow_max_shared(Kernel kernel,
                                    std::atomic<unsigned long long>& done,
                                    int bytes = static_cast<int>(kMaxShared)) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

__device__ __forceinline__ uint32_t csub(uint32_t r, uint32_t m) {
  return r >= m ? r - m : r;
}

// a*b*2^-16 mod m (16-bit REDC), a, b < 2^16.  The carry of
// tl + (u*m mod 2^16) is exactly (tl != 0).
__device__ __forceinline__ uint32_t cmul(uint32_t a, uint32_t b, uint32_t m,
                                         uint32_t n0) {
  const uint32_t t = a * b, tl = t & 0xFFFFu;
  const uint32_t um = ((tl * n0) & 0xFFFFu) * m;
  return csub((t >> 16) + (um >> 16) + (tl != 0u), m);
}

// a*c mod m with Shoup companion ch = floor(c 2^16 / m); uint32 wrap of
// a*c - q*m is intended (the true value lies in [0, 2m)).
__device__ __forceinline__ uint32_t cmul_shoup(uint32_t a, uint32_t c,
                                               uint32_t ch, uint32_t m) {
  const uint32_t q = (a * ch) >> 16;
  return csub(a * c - q * m, m);
}

// (a*b + c*d) * 2^-16 mod m with one shared REDC.
__device__ __forceinline__ uint32_t cmul2(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d, uint32_t m,
                                          uint32_t n0) {
  const uint32_t P = a * b, Q = c * d;
  const uint32_t lo = (P & 0xFFFFu) + (Q & 0xFFFFu);
  const uint32_t hi = (P >> 16) + (Q >> 16);
  const uint32_t ll = lo & 0xFFFFu;
  const uint32_t um = ((ll * n0) & 0xFFFFu) * m;
  const uint32_t r = hi + (lo >> 16) + (um >> 16) + (ll != 0u);
  return csub(csub(r, m), m);
}

__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b,
                                           uint32_t m) {
  return a >= b ? a - b : a + m - b;
}

// (S_A + 2^8 S_B) * 2^-16 mod m for exact non-negative accumulators.
__device__ __forceinline__ uint32_t combine_dual(int32_t SA, int32_t SB,
                                                 uint32_t m, uint32_t n0,
                                                 int nlev) {
  const uint32_t t = static_cast<uint32_t>(SA)
                     + ((static_cast<uint32_t>(SB) & 0xFFu) << 8);
  const uint32_t B1 = static_cast<uint32_t>(SB >> 8);
  const uint32_t tl = t & 0xFFFFu;
  const uint32_t um = ((tl * n0) & 0xFFFFu) * m;
  uint32_t r = (t >> 16) + (um >> 16) + (tl != 0u) + B1;
  for (int lev = nlev - 1; lev >= 0; --lev) {
    const uint32_t mm = m << lev;
    if (r >= mm) r -= mm;
  }
  return r;
}

// Operands of the tile product.  vec (CHP, 16) uint32 as in rns.cu
// (columns 0 mods, 1 n0, 3 Shoup constant, 4 u5, 5 v5, 6 w9n, 7 w9b,
// 8 Shoup companion, 9 one); skc[0..1] the SK constants; W1/W2 the
// fragment-ordered extension matrices (MT m-tiles x KS k-steps x 32
// lanes x 16 B); XS the digit tile's row stride in bytes.
struct TileOps {
  const uint32_t* vec;
  const uint32_t* skc;
  const uint4* W1;
  const uint4* W2;
  int k, CH, KP, nlev, MT, KS, XS;
};

__device__ __forceinline__ uint32_t V(const TileOps& op, int row, int col) {
  return __ldg(op.vec + row * 16 + col);
}

// Row stride of the digit tile: 2KP bytes plus 16, so that the eight
// column rows an mma B fragment reads start in eight distinct bank
// quadruples (2KP/4 is a multiple of 8 words; +4 words makes the stride
// 4 mod 8).
__host__ __device__ inline int digit_stride(int KP) { return 2 * KP + 16; }

// Shared memory of one tile product besides its states: the digit tile
// (kNC x XS bytes) and the per-column delta.
__host__ __device__ inline size_t work_bytes(int KP) {
  return static_cast<size_t>(kNC) * digit_stride(KP) + kNC * sizeof(uint32_t);
}

// Bytes of one fragment-ordered extension matrix.
__host__ __device__ inline size_t w_bytes(int MT, int KS) {
  return static_cast<size_t>(MT) * KS * 32 * 16;
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared (bypassing L1).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shoup-multiply k channels (rows r0..r0+k-1 of the state) by the vec
// column-3/8 constants and write their bytes into the digit tile: column
// col's row holds the low bytes at [0, KP) and the high bytes at
// [KP, 2KP), digits past k zero.  One thread makes one 4-digit word.
__device__ __forceinline__ void pack(const u16* st, int r0, const TileOps& op,
                                     uint8_t* xs) {
  const int KW = op.KP / 4;
  for (int it = threadIdx.x; it < KW * kNC; it += blockDim.x) {
    const int col = it & (kNC - 1), w = it / kNC;
    uint32_t w0 = 0u, w1 = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = 4 * w + b;
      if (i < op.k) {
        const int r = r0 + i;
        const uint32_t v = cmul_shoup(st[r * kNC + col], V(op, r, 3),
                                      V(op, r, 8), V(op, r, 0));
        w0 |= (v & 0xFFu) << (8 * b);
        w1 |= (v >> 8) << (8 * b);
      }
    }
    uint32_t* row = reinterpret_cast<uint32_t*>(xs + col * op.XS);
    row[w] = w0;
    row[KW + w] = w1;
  }
}

// One base extension: W (fragment order, in shared memory or, with
// kGlobalW, in global memory read through L2) times the digit tile, and
// for every output row j <= k and column, epi(j, col, S_A, S_B).  A warp
// takes units of one m-tile and NTU n-tiles of 8 columns; with W in
// global memory NTU = 4 reads each A fragment once per CTA.
template <int NTU, bool kGlobalW, class Epi>
__device__ __forceinline__ void extend(const uint4* W, const TileOps& op,
                                       const uint8_t* xs, Epi epi) {
  constexpr int NU = (kNC / 8) / NTU;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool odd = (g & 1) != 0;
  for (int u = warp; u < op.MT * NU; u += nwarp) {
    const int mt = u / NU, nb = (u % NU) * NTU;
    int acc[NTU][4];
#pragma unroll
    for (int j = 0; j < NTU; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    const uint4* wp = W + static_cast<size_t>(mt) * op.KS * 32 + lane;
    const uint8_t* xb = xs + (nb * 8 + g) * op.XS + t * 4;
    uint4 a = kGlobalW ? __ldg(wp) : wp[0];
    for (int ks = 0; ks < op.KS; ++ks) {
      uint4 an = a;
      if (ks + 1 < op.KS) an = kGlobalW ? __ldg(wp + (ks + 1) * 32)
                                        : wp[(ks + 1) * 32];
#pragma unroll
      for (int j = 0; j < NTU; ++j) {
        const uint8_t* xp = xb + j * 8 * op.XS + ks * 32;
        mma_u8(acc[j], a, *reinterpret_cast<const uint32_t*>(xp),
               *reinterpret_cast<const uint32_t*>(xp + 16));
      }
      a = an;
    }
    // Accumulator rows mt*16 + g (+8): even g holds S_A, odd g S_B of
    // output row mt*8 + g/2 (+4).  Each lane pair swaps one value, so the
    // even lane ends with both sums of column 2t, the odd lane of 2t+1.
#pragma unroll
    for (int j = 0; j < NTU; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
        const int recv = __shfl_xor_sync(0xFFFFFFFFu, odd ? v0 : v1, 4);
        const int row = mt * 8 + (g >> 1) + 4 * h;
        const int col = (nb + j) * 8 + 2 * t + (odd ? 1 : 0);
        if (row <= op.k) epi(row, col, odd ? recv : v0, odd ? v1 : recv);
      }
    }
  }
}

// One RNS-Montgomery product of the tile, in place in st (CH x kNC
// uint16, channel-major): st = x * y * M^-1, where first(c, col, i)
// returns cmul(x, y) of channel c, column col (i = c * kNC + col; it may
// read st[i], which no other thread touches in that pass).  after_first()
// runs once every thread has passed the cmul pass (K2 starts its next
// operand's copy there).  Ends with a __syncthreads().
template <int NTU, bool kGlobalW, class First, class AfterFirst>
__device__ __forceinline__ void tile_mul(u16* st, First first,
                                         AfterFirst after_first,
                                         const uint4* W1, const uint4* W2,
                                         const TileOps& op, uint8_t* xs,
                                         uint32_t* delta) {
  const int k = op.k, nt = blockDim.x;
  for (int i = threadIdx.x; i < op.CH * kNC; i += nt)
    st[i] = static_cast<u16>(first(i / kNC, i & (kNC - 1), i));
  __syncthreads();
  after_first();
  // first extension: B -> B' and m_r, then r' on those channels
  pack(st, 0, op, xs);
  __syncthreads();
  extend<NTU, kGlobalW>(W1, op, xs, [&](int j, int col, int SA, int SB) {
    const int c = k + j;
    const uint32_t m = V(op, c, 0), n0 = V(op, c, 1);
    const uint32_t q = combine_dual(SA, SB, m, n0, op.nlev);
    u16& s = st[c * kNC + col];
    s = static_cast<u16>(cmul2(s, V(op, c, 4), q, V(op, c, 5), m, n0));
  });
  __syncthreads();
  // second extension: B' -> B and m_r (Shenoy-Kumaresan)
  pack(st, k, op, xs);
  __syncthreads();
  extend<NTU, kGlobalW>(W2, op, xs, [&](int j, int col, int SA, int SB) {
    const int c = j < k ? j : 2 * k;
    const uint32_t m = V(op, c, 0), n0 = V(op, c, 1);
    const uint32_t zh = combine_dual(SA, SB, m, n0, op.nlev);
    if (j < k) {
      st[c * kNC + col] = static_cast<u16>(zh);
    } else {
      delta[col] = submod(cmul(zh, __ldg(op.skc), m, n0),
                          cmul(st[c * kNC + col], __ldg(op.skc + 1), m, n0),
                          m);
    }
  });
  __syncthreads();
  for (int i = threadIdx.x; i < k * kNC; i += nt) {
    const int c = i / kNC;
    st[i] = static_cast<u16>(cmul2(st[i], V(op, c, 7), delta[i & (kNC - 1)],
                                   V(op, c, 6), V(op, c, 0), V(op, c, 1)));
  }
  __syncthreads();
}

}  // namespace rns_tile
