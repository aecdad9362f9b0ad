// One shared-modulus Montgomery product a*b*R^-1 mod m for a tile of kNC
// columns owned by one CTA, with the reduction as two u8 Toeplitz
// products on the tensor cores, and the fixed-window chain of such
// products.  Kernels K3 (mm3_mul: one product), K4 (mm3_exp) and K7
// (mm3_exp_shared: a chain each) in mont3.cu run on it; K8 runs on the
// cooperative routine of coop.cuh.
//
// The function is the TPU kernel's (pallas_mont3.py _mm3_reduce /
// _mm3_val), R = 2^(16L), mu = -m^-1 mod R:
//   T = a*b                              2L limbs, integer pipes
//   q = T_lo * mu mod R                  W_mu . bytes(T_lo)   (mma)
//   s = T + q*m                          W_m  . bytes(q)      (mma)
//   out = s / R                          limbs L..2L-1 of s
// The result (a*b + q*m)/R is unique, so it equals the CIOS kernels, the
// plain twin (ops/mont3.py mm3_mul_plain) and the TPU kernel limb for
// limb.
//
// The Toeplitz matrices.  W_mu[p, i] = byte_{p-i}(mu) for p, i < 2L
// (lower triangular) and W_m[p, i] = byte_{p-i}(m) for p < 4L, i < 2L (a
// band of width 2L), built on the host (ops/mont3.py tile_weights) and
// kept on the MontCtx, zero-padded to whole m16n8k32 tiles and stored in
// mma fragment order (rns_tile.cuh says how).  Row p of W . bytes(x) is
// the byte slot S_p with x*c = sum_p S_p 2^(8p).  Both operands are
// unsigned bytes: mma.sync takes u8 x u8 into s32 and every slot is below
// 2L * 255^2 < 2^31 (L <= 520), the true dot, so the TPU's centring, BIAS
// and off1/off2 are not needed.  The warps skip the fragments that are
// zero by the matrices' shape, and read the others from global memory
// (L2), each A fragment once per CTA.
//
// Slots to limbs.  A slot pair (S_2j, S_2j+1), which the accumulator
// fragment holds in two neighbouring lanes, adds lo = S_2j mod 2^16 +
// (S_2j+1 mod 2^8) 2^8 to limb j and mid = S_2j div 2^16 + S_2j+1 div 2^8
// to limb j+1 of a u32 slot array (shared-memory atomics: neighbouring
// pairs meet on one limb); every slot stays below 2^21.  One warp then
// resolves a column's carries 32 limbs at a time (warp_carry: two local
// spill passes, then a one-bit ripple by ballot, generate/propagate
// added as integers).
//
// The product.  A unit is one column and kKB = 128 consecutive output
// limbs, 4 a lane: the lane walks i and keeps the four b limbs its
// outputs need in registers (one new b and one broadcast a_i a step, four
// 32x32->64-bit multiply-adds).  b carries kPad zero limbs on both
// sides, so no step needs a bound check.  The units are dealt out
// column-fastest, so every warp gets every output block of two columns
// and the triangle is balanced.  Each 64-bit column sum goes into the
// slot array as three 16-bit parts.
//
// Shared memory, per column (bytes, each row stride 16 mod 32 so the
// eight columns of an mma B fragment fall in distinct banks):
//   row P: a (2L) and b (2L + 4 kPad); later q's slots (4(L+2)) and q;
//   row T: T's slots (4(2L+2)); later T (4L) and s's slots (4(L+2)).
// 32 x (12L + 544) B or so: 115,712 B at L=257, 217,088 B at L=520.
//
// s in two halves: its low L limbs are 0 by construction, so the slots of
// rows p < 2L of W_m . q and T_lo go through the slot array first, only
// for the carry they pass on; then the rows p >= 2L and T_hi, whose
// limbs are the output.  The slot array then needs L+2 words, not 2L+2.
//
// What bounds it.  The product is L^2 multiply-adds per column on the
// integer pipes (66 k at L=257), two shared loads and four IMAD.WIDE a
// lane step; the reductions are ~(2L/16)(2L/32)/2 + (4L/16)(2L/32)/2
// m16n8k32 instructions per 8 columns; the carry passes 5L/32 warp steps
// per column.  The multiply-adds set the pace.
//
// Operands and result.  tile_mul takes a loader (r, col) -> limb for a
// and one for b, and a store for the result's limbs: K3 passes loaders
// of (L, B) arrays in global memory (Global) and a store into one.  The
// result also stays where step 9 leaves it, row T at byte 4L (Acc reads
// it), so a chain feeds it to the next product without a round trip
// through global memory: step 1 reads both operands into row P before it
// zeroes row T.
//
// The chain (tile_chain, K4 and K7).  One CTA runs a tile's whole
// fixed-window exponentiation in the TPU kernels' order
// (pallas_mont3.py _mm3_exp_kernel / _mm3_exp_shared_kernel): the table
// T[0] = one, T[1] = base, T[t] = T[t-1]*base, then from acc = one per
// window `window` squarings acc*acc and one product acc*T[d].  Every
// product's result is unique, so the chain equals the plain twins, the
// TPU kernels and the CIOS chains limb for limb, whichever way they
// square.  The table lies in global scratch, tile by tile as (tiles,
// 2^window, L, kNC) uint16 (33.7 MB at L=257, B=4096, 16 entries), each
// entry written once by its CTA and read back through L2; base is read
// from global memory for each table product.  On chip: the product's
// shared memory (the accumulator in row T) and what the kernel stages
// beside it (K4 one window's digits, K7 its next table entry).  The
// chain's cost is its products': (2^window - 2) + windows * (window + 1)
// tile products, each as K3's.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "rns_tile.cuh"

namespace mm3_tile {

constexpr int kNC = 32;          // columns a CTA owns
constexpr int kThreads = 512;    // 16 warps
constexpr int kPad = 128;        // zero limbs on each side of b
constexpr int kKB = 128;         // output limbs of one product unit
constexpr unsigned kFull = 0xFFFFFFFFu;

using u16 = uint16_t;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The smallest stride >= bytes that is 16 mod 32.
__host__ __device__ inline int stride16(int bytes) {
  return round_up(bytes - 16, 32) + 16;
}

__host__ __device__ inline int row_p(int L) {
  return stride16(4 * L + 4 * kPad);
}

__host__ __device__ inline int row_t(int L) {
  return stride16(8 * L + 8);
}

__host__ __device__ inline size_t smem_bytes(int L) {
  return static_cast<size_t>(kNC) * (row_p(L) + row_t(L));
}

// Operands: W_mu (MT1 m-tiles x KS k-steps), W_m (MT2 x KS), both in
// fragment order; KS k-steps of 32 over the 2L bytes of the operand.
struct Ops {
  const uint4* Wmu;
  const uint4* Wm;
  int L, MT1, MT2, KS;
};

// Resolves n slots d[0..n) of one column, plus cin at slot 0 (d[0] +
// cin < 2^32), into 16-bit limbs written to out (which may alias d: a
// chunk's 32 slots are all read before its limbs are written) or, with
// out null, dropped; returns the carry out of limb n-1 (on every lane).
// One warp.
__device__ __forceinline__ uint32_t warp_carry(const uint32_t* d, int n,
                                               uint32_t cin, u16* out) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    uint32_t x = i < n ? d[i] : 0u;
    if (lane == 0) x += cin;
    const uint32_t s1 = x >> 16;
    uint32_t up = __shfl_up_sync(kFull, s1, 1);
    const uint32_t y = (x & 0xFFFFu) + (lane ? up : 0u);
    const uint32_t s2 = y >> 16;
    up = __shfl_up_sync(kFull, s2, 1);
    const uint32_t a = (y & 0xFFFFu) + (lane ? up : 0u);     // <= 2^16
    // one-bit ripple: lane l generates a carry when a = 2^16 and passes
    // one on when a = 2^16 - 1; with G, P as integers the carry into
    // lane l is bit l of (G + (G|P)) ^ G ^ (G|P)
    const uint64_t G = __ballot_sync(kFull, a > 0xFFFFu);
    const uint64_t Y = G | __ballot_sync(kFull, a == 0xFFFFu);
    const uint64_t S = G + Y;
    const uint32_t c = static_cast<uint32_t>(((S ^ G ^ Y) >> lane) & 1u);
    const uint32_t co = s1 + s2 + ((a + c) >> 16);   // into limb i+1
    __syncwarp();
    if (out != nullptr && i < n) out[i] = static_cast<u16>((a + c) & 0xFFFFu);
    const int last = n - base - 1 < 31 ? n - base - 1 : 31;
    cin = __shfl_sync(kFull, co, last);
  }
  return cin;
}

// One reduction product over m-tiles [mt0, mt1): W (fragment order,
// global) times the tile's operand bytes (column col's row at
// xs + col * XS, bytes [0, 32 KS)), and for each slot pair j (rows 2j,
// 2j+1) and column, epi(j, col, S_2j, S_2j+1).  Only k-steps
// [ks_lo(mt), ks_hi(mt)] are read: the rest of the row tile is zero.  A
// warp takes one m-tile and all four n-tiles, so each A fragment is read
// once per CTA.
template <class KsLo, class KsHi, class Epi>
__device__ __forceinline__ void toeplitz(const uint4* W, int KS, int mt0,
                                         int mt1, const uint8_t* xs, int XS,
                                         KsLo ks_lo, KsHi ks_hi, Epi epi) {
  constexpr int NT = kNC / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool odd = (g & 1) != 0;
  for (int mt = mt0 + warp; mt < mt1; mt += nwarp) {
    int acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    const uint4* wp = W + static_cast<size_t>(mt) * KS * 32 + lane;
    const uint8_t* xb = xs + g * XS + t * 4;
    const int k1 = ks_hi(mt);
    for (int ks = ks_lo(mt); ks <= k1; ++ks) {
      const uint4 a = __ldg(wp + ks * 32);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint8_t* xp = xb + j * 8 * XS + ks * 32;
        rns_tile::mma_u8(acc[j], a, *reinterpret_cast<const uint32_t*>(xp),
                         *reinterpret_cast<const uint32_t*>(xp + 16));
      }
    }
    // accumulator rows mt*16 + g (+8): the even lane of a pair ends with
    // both slots of column 2t, the odd lane of column 2t+1
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
        const int recv = __shfl_xor_sync(kFull, odd ? v0 : v1, 4);
        const int pair = mt * 8 + (g >> 1) + 4 * h;
        const int col = j * 8 + 2 * t + (odd ? 1 : 0);
        epi(pair, col, static_cast<uint32_t>(odd ? recv : v0),
            static_cast<uint32_t>(odd ? v1 : recv));
      }
    }
  }
}

// Adds the slot pair (S_2j, S_2j+1) to limbs j, j+1 of a slot array.
__device__ __forceinline__ void add_pair(uint32_t* d, int j, uint32_t s0,
                                         uint32_t s1) {
  const uint32_t lo = (s0 & 0xFFFFu) + ((s1 & 0xFFu) << 8);
  const uint32_t mid = (s0 >> 16) + (s1 >> 8);
  if (lo) atomicAdd(d + j, lo);
  if (mid) atomicAdd(d + j + 1, mid);
}

// Limb r of tile column col of an (L, B) int32 array in global memory
// whose tile starts at column col0; columns past B read as 0.
struct Global {
  const uint32_t* p;
  int col0, B;
  __device__ __forceinline__ u16 operator()(int r, int col) const {
    const int gc = col0 + col;
    return gc < B ? static_cast<u16>(__ldg(p + static_cast<size_t>(r) * B
                                           + gc))
                  : u16{0};
  }
};

// Limb r of tile column col of the last product's result, where step 9
// of tile_mul leaves it (row T at byte 4L); at() also writes it.
struct Acc {
  unsigned char* smem;
  int L;
  __device__ __forceinline__ u16& at(int r, int col) const {
    return reinterpret_cast<u16*>(smem + static_cast<size_t>(kNC) * row_p(L)
                                  + col * row_t(L) + 4 * L)[r];
  }
  __device__ __forceinline__ u16 operator()(int r, int col) const {
    return at(r, col);
  }
};

// The tile's product a * b * R^-1 mod m: load_a(r, col), load_b(r, col)
// give limb r < L of tile column col of each operand (each is called once
// per limb and column, in step 1, before anything else of the product
// touches shared memory); store(r, col, limb) takes the result's limbs,
// which also stay in row T for Acc until the next product's step 1.
template <class LoadA, class LoadB, class Store>
__device__ __forceinline__ void tile_mul(LoadA load_a, LoadB load_b,
                                         Store store, const Ops& op,
                                         unsigned char* smem) {
  const int L = op.L, RP = row_p(L), RT = row_t(L);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
  unsigned char* P = smem;
  unsigned char* Tr = smem + static_cast<size_t>(kNC) * RP;
  auto rowp = [&](int col) { return P + col * RP; };
  auto rowt = [&](int col) { return Tr + col * RT; };
  const int bo = L + kPad;                 // b[0] in row P, in limbs

  // 1. a, b into row P (b between kPad zero limbs); then (the loaders may
  // read the last result in row T) T's slots to 0
  for (int i = tid; i < kNC * (L + 2 * kPad); i += nt) {
    const int col = i & (kNC - 1), r = i / kNC - kPad;   // r in [-kPad, L+kPad)
    u16* rp = reinterpret_cast<u16*>(rowp(col));
    const bool in = r >= 0 && r < L;
    rp[bo + r] = in ? load_b(r, col) : u16{0};
    if (in) rp[r] = load_a(r, col);
  }
  __syncthreads();
  for (int i = tid; i < kNC * (2 * L + 2); i += nt)
    reinterpret_cast<uint32_t*>(rowt(i / (2 * L + 2)))[i % (2 * L + 2)] = 0u;
  __syncthreads();

  // 2. T = a*b into T's slots
  const int nkb = (2 * L - 1 + kKB - 1) / kKB;
  for (int u = warp; u < nkb * kNC; u += nwarp) {
    const int kb = u / kNC, col = u % kNC;
    const int k0 = kb * kKB, kl = k0 + 4 * lane;
    const int ilo = k0 - (L - 1) > 0 ? k0 - (L - 1) : 0;
    const int ihi = k0 + kKB - 1 < L - 1 ? k0 + kKB - 1 : L - 1;
    const u16* ar = reinterpret_cast<const u16*>(rowp(col));
    const u16* br = ar + bo;
    uint64_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    uint32_t w0 = br[kl - ilo], w1 = br[kl + 1 - ilo];
    uint32_t w2 = br[kl + 2 - ilo], w3 = br[kl + 3 - ilo];
    for (int i = ilo; i <= ihi; ++i) {   // w_r = b[kl + r - i]
      const uint32_t ai = ar[i];
      c0 += static_cast<uint64_t>(ai) * w0;
      c1 += static_cast<uint64_t>(ai) * w1;
      c2 += static_cast<uint64_t>(ai) * w2;
      c3 += static_cast<uint64_t>(ai) * w3;
      w3 = w2; w2 = w1; w1 = w0;
      w0 = br[kl - i - 1];
    }
    // C_k = lo + mid 2^16 + hi 2^32 goes to slots k, k+1, k+2
    const uint32_t d[6] = {
        static_cast<uint32_t>(c0 & 0xFFFFu),
        static_cast<uint32_t>(((c0 >> 16) & 0xFFFFu) + (c1 & 0xFFFFu)),
        static_cast<uint32_t>((c0 >> 32) + ((c1 >> 16) & 0xFFFFu)
                              + (c2 & 0xFFFFu)),
        static_cast<uint32_t>((c1 >> 32) + ((c2 >> 16) & 0xFFFFu)
                              + (c3 & 0xFFFFu)),
        static_cast<uint32_t>((c2 >> 32) + ((c3 >> 16) & 0xFFFFu)),
        static_cast<uint32_t>(c3 >> 32)};
    uint32_t* dt = reinterpret_cast<uint32_t*>(rowt(col));
#pragma unroll
    for (int r = 0; r < 6; ++r)
      if (d[r] && kl + r < 2 * L + 2) atomicAdd(dt + kl + r, d[r]);
  }
  __syncthreads();

  // 3. T's slots -> T (u16, in place); s's slot array (row T at 4L) =
  // T_lo; q's slot array (row P) to 0
  for (int col = warp; col < kNC; col += nwarp) {
    uint32_t* dt = reinterpret_cast<uint32_t*>(rowt(col));
    warp_carry(dt, 2 * L, 0u, reinterpret_cast<u16*>(dt));
    __syncwarp();
    const u16* T = reinterpret_cast<const u16*>(dt);
    uint32_t* ds = reinterpret_cast<uint32_t*>(rowt(col) + 4 * L);
    for (int j = lane; j < L + 2; j += 32) ds[j] = j < L ? T[j] : 0u;
  }
  for (int i = tid; i < kNC * (L + 2); i += nt)
    reinterpret_cast<uint32_t*>(rowp(i / (L + 2)))[i % (L + 2)] = 0u;
  __syncthreads();

  // 4. q's slots: W_mu . bytes(T_lo) (row tile mt: k-steps up to its
  // last row, the matrix is lower triangular)
  const auto from0 = [](int) { return 0; };
  toeplitz(op.Wmu, op.KS, 0, op.MT1, Tr, RT, from0,
           [&](int mt) {
             const int k = (16 * mt + 15) / 32;
             return k < op.KS - 1 ? k : op.KS - 1;
           },
           [&](int j, int col, uint32_t s0, uint32_t s1) {
             if (j < L) add_pair(reinterpret_cast<uint32_t*>(rowp(col)), j,
                                 s0, s1);
           });
  __syncthreads();

  // 5. q = its slots mod R (u16, in place)
  for (int col = warp; col < kNC; col += nwarp) {
    uint32_t* dq = reinterpret_cast<uint32_t*>(rowp(col));
    warp_carry(dq, L, 0u, reinterpret_cast<u16*>(dq));
  }
  __syncthreads();

  // 6. s, low half: rows p < 2L of W_m . bytes(q) (band: k-steps from
  // row tile's first row - 2L + 1 to its last row)
  const auto band_lo = [&](int mt) {
    const int i = 16 * mt - 2 * L + 1;
    return i > 0 ? i / 32 : 0;
  };
  const auto band_hi = [&](int mt) {
    const int k = (16 * mt + 15) / 32;
    return k < op.KS - 1 ? k : op.KS - 1;
  };
  const int mt_mid = (2 * L) / 16;         // first row tile with p >= 2L
  toeplitz(op.Wm, op.KS, 0, (2 * L + 15) / 16, P, RP, band_lo, band_hi,
           [&](int j, int col, uint32_t s0, uint32_t s1) {
             if (j < L) add_pair(reinterpret_cast<uint32_t*>(rowt(col)
                                                            + 4 * L),
                                 j, s0, s1);
           });
  __syncthreads();

  // 7. the low half's carry (its limbs are 0 mod R), with the spill of
  // its last pair into limb L -> the high half's slot array = T_hi + it
  for (int col = warp; col < kNC; col += nwarp) {
    uint32_t* ds = reinterpret_cast<uint32_t*>(rowt(col) + 4 * L);
    const uint32_t c = warp_carry(ds, L, 0u, nullptr) + ds[L];
    __syncwarp();
    const u16* T = reinterpret_cast<const u16*>(rowt(col));
    for (int j = lane; j < L + 2; j += 32)
      ds[j] = (j < L ? T[L + j] : 0u) + (j == 0 ? c : 0u);
  }
  __syncthreads();

  // 8. s, high half: rows 2L <= p < 4L
  toeplitz(op.Wm, op.KS, mt_mid, op.MT2, P, RP, band_lo, band_hi,
           [&](int j, int col, uint32_t s0, uint32_t s1) {
             const int jh = j - L;
             if (jh >= 0 && jh < L)
               add_pair(reinterpret_cast<uint32_t*>(rowt(col) + 4 * L), jh,
                        s0, s1);
           });
  __syncthreads();

  // 9. s / R (u16, in place), then out, coalesced
  for (int col = warp; col < kNC; col += nwarp) {
    uint32_t* ds = reinterpret_cast<uint32_t*>(rowt(col) + 4 * L);
    warp_carry(ds, L, 0u, reinterpret_cast<u16*>(ds));
  }
  __syncthreads();
  for (int i = tid; i < kNC * L; i += nt) {
    const int col = i & (kNC - 1), r = i / kNC;
    store(r, col, reinterpret_cast<const u16*>(rowt(col) + 4 * L)[r]);
  }
}

// One tile's fixed-window chain (the head of this file): base (L, B) and
// one (L, 1) int32 in global memory; tb this tile's (2^window, L, kNC)
// uint16 block of the table scratch; windows w0 .. n_win-1; the result
// into out (L, B) int32.  before(w) runs on every thread at the top of
// window w (K4 stages the window's digits, K7 starts the copy of its
// entry); pick(r, col) loads the window product's b, after the squarings,
// a cp.async.wait_all and a __syncthreads.
template <class Before, class Pick>
__device__ __forceinline__ void tile_chain(const uint32_t* base,
                                           const uint32_t* one,
                                           uint32_t* out, u16* tb,
                                           const Ops& op, int col0, int B,
                                           int window, int w0, int n_win,
                                           Before before, Pick pick,
                                           unsigned char* smem) {
  const int L = op.L, tid = threadIdx.x, nt = blockDim.x;
  const size_t SZ = static_cast<size_t>(L) * kNC;    // one table entry
  const Global gb{base, col0, B};
  const Acc acc{smem, L};
  const auto keep = [](int, int, u16) {};
  // T[0] = one, T[1] = base, and acc = base, T[2]'s first operand
  for (int i = tid; i < L * kNC; i += nt) {
    const int r = i / kNC, col = i & (kNC - 1);
    const u16 b = gb(r, col);
    tb[i] = static_cast<u16>(__ldg(one + r));
    tb[SZ + i] = b;
    acc.at(r, col) = b;
  }
  __syncthreads();
  for (int t = 2; t < (1 << window); ++t) {          // T[t] = T[t-1] base
    u16* e = tb + t * SZ;
    tile_mul(acc, gb,
             [&](int r, int col, u16 v) { e[r * kNC + col] = v; }, op, smem);
  }
  __syncthreads();
  for (int i = tid; i < L * kNC; i += nt)            // acc = one
    acc.at(i / kNC, i & (kNC - 1)) = static_cast<u16>(__ldg(one + i / kNC));
  __syncthreads();
  for (int w = w0; w < n_win; ++w) {
    before(w);
    for (int s = 0; s < window; ++s) tile_mul(acc, acc, keep, op, smem);
    rns_tile::cp_async_wait_all();
    __syncthreads();
    tile_mul(acc, pick, keep, op, smem);             // acc * T[d]
  }
  for (int i = tid; i < L * kNC; i += nt) {
    const int r = i / kNC, col = i & (kNC - 1), gc = col0 + col;
    if (gc < B) out[static_cast<size_t>(r) * B + gc] = acc(r, col);
  }
}

}  // namespace mm3_tile
