// Kernels K1 (rns_mul), K2 (rns_exp_sched), K5 (rns_exp_elem) and K6
// (rns_exp_shared): RNS-Montgomery products over 16-bit prime channels,
// for Hopper (sm_90a).
//
// K1 replaces pailliercryptolib_python_tpu/ops/pallas_rns.py
//    _rns_mul_kernel (:578, wrapper rns_mul_p :612, body _mul_val
//    :319-346): one product x*y*M^-1 of two (CH, B) states.
// K2 replaces pailliercryptolib_python_tpu/ops/pallas_rns.py
//    _rns_exp_sched_kernel (:416, wrapper rns_exp_sched_p :486): the
//    whole sliding-window chain c^e * M with a shared exponent.
// K5 replaces pailliercryptolib_python_tpu/ops/pallas_rns.py
//    _rns_exp_elem_kernel (:501, wrapper rns_exp_elem_p :624): the
//    fixed-window chain c^e * M with one exponent per column (ct*pt).
// K6 replaces pailliercryptolib_python_tpu/ops/pallas_rns.py
//    _rns_exp_kernel (:349, call _exp_call :383, wrapper
//    rns_exp_shared_p :639): the fixed-window chain c^e * M with one
//    exponent shared by the batch (a CRT half of decrypt).
//
// All four run on the tile routine of rns_tile.cuh: one CTA owns
// rns_tile::kNC = 32 columns, its states lie in shared memory as uint16,
// and both base extensions of every product are int8 tensor-core
// products (mma.sync m16n8k32 u8) of the host-built extension matrices
// W1, W2 with the tile's digits.  rns_tile.cuh says what bounds a product
// and what the design does about it: its elementwise passes over the
// tile's CH x 32 states set the pace, not the tensor-core products; a
// chain costs the sum of its products.
//
// K1 (one product): W1 and W2 (287 KB together at CH=521) do not fit a
// block's shared memory beside the state, so every warp reads its A
// fragments straight from global memory in fragment order (16 bytes a
// lane, 512 contiguous bytes a warp; 50 MB of L2 hold both matrices for
// all 128 CTAs).  Each CTA reads all of W once a product whichever way
// it is staged, so a shared-memory ring of W slabs would move the same
// bytes out of L2; it would pay only with cluster multicast, which this
// kernel does not use.  x and y are read once, in the cmul pass, and the
// output written once.
//
// K2 (the whole sliding-window chain): one CTA runs every product of its
// tile's chain: c^2, the 2^(w-1) odd powers, `one`, then each schedule
// entry (0 squares, t multiplies by T[t-1]).  At CH=261 W1 and W2 (2 x
// 78,336 B) stay in shared memory for the whole chain beside the
// accumulator, the operand buffer (CH x 32 uint16 each), the digit tile
// and delta: 199,936 B of the 232,448 a block may use.  Where they do
// not fit (CH > ~280) the kernel reads them from global memory as K1
// does.  The odd-power table lies in global scratch the wrapper
// allocates, tile by tile ((tiles, 2^(w-1), CH, 32) uint16), so one entry
// of one tile is one contiguous block of CH x 64 bytes; after the cmul
// pass of each product, the operand of the next multiply of the schedule
// is copied into the operand buffer with cp.async while the product's
// extensions run.  The table index comes from the schedule of the secret
// exponent p-1 (q-1): every CTA reads the same entry at the same step,
// so the access pattern follows the key, as on the TPU (pallas_rns.py
// :443-445).  A constant-access select would read all 32 entries at every
// table step, 32 times the table traffic; the README records the
// key-derived index.
//
// One K2 launch runs both CRT halves of a decrypt: a grid of
// halves x ceil(B/32) CTAs, CTA b serving half b / tiles and tile
// b % tiles, so no tile straddles the halves.  The halves share the RNS
// base, hence W1, W2, the schedule's length (sched_len depends on the
// key's size alone) and the window; each brings its own entered state,
// schedule, output and per-channel constants (vec, skc: p^2 or q^2).  A
// chain is latency-bound within its CTA (~15.5 us a product at CH=261
// whatever B), so where one half fills few SMs (8 of 132 at 4096 bits,
// B=256) the second half ran on idle SMs after the first: side by side
// the decrypt's K2 takes one chain's time, not two.  The merged grid
// never takes more waves than the two launches it replaces:
// ceil(2T / SMs) <= 2 ceil(T / SMs) for T tiles a half.  A one-half
// launch is the same kernel with one half.
//
// K6 (the fixed-window chain of a CRT half): the same CTA layout as K2,
// W1, W2 resident in shared memory where they fit (CH <= ~280, the
// 2048-bit key's p^2 base), else read from global memory.  X stays in
// the operand buffer while the table [one, X, X^2, ..., X^(2^w-1)] is
// built by T[t] = T[t-1] X (2^w - 2 products) into global scratch the
// wrapper allocates, tile by tile ((tiles, 2^w, CH, 32) uint16: 68 MB at
// CH=261, B=4096, w=5); then from acc = one, per window w squarings and
// one product by T[d] (a zero digit multiplies by `one`), the plain
// twin's order of products, so every state equals it.  The digit is one
// key-derived value (p-1 or q-1) shared by the batch: it indexes the
// table, as in the TPU kernel (:374-375) and in K2 (README threat-model
// note, ROADMAP C5), and T[d] of the next window is copied into the
// operand buffer by cp.async while the squarings run.  The TPU kernel's
// table had to fit a VMEM tile; here it lies in global memory and no
// such limit applies.  Work: (2^w - 2) + n_win (w + 1) products, each
// K1's two extensions.
//
// K5 (the per-element chain of ct*pt): one CTA runs every product of
// its tile's chain, 2^w - 2 to build the table and w + 1 a window (94 at
// w=4 and 16 windows), each one tile_mul, in the TPU kernel's order so
// every state equals the plain twin's: T[0] = one, T[1] = X, T[t] =
// T[t-1] X; acc = one; per window w squarings, then acc * T[d], a zero
// digit multiplying by `one`.  Shared memory holds the accumulator and X
// as uint16, the digit tile, delta and the tile's (n_win, 32) digits as
// bytes: 84,736 + 32 n_win B at CH=521.  W1, W2 are read from global
// memory, as in K1, at every CH; the launcher refuses a shape past
// 232,448 B.  The table lies in global
// scratch the wrapper allocates, tile by tile ((tiles, 2^w, CH, 32)
// uint16: 68 MB at CH=521, B=4096, w=4), so one entry of one tile is one
// contiguous block of CH x 64 bytes.  The digits are the plaintext's, so
// the entry is chosen as on the TPU (:530-534) by a constant-access
// one-hot select inside the product's cmul pass: each (channel, column)
// reads all 2^w entries and keeps the one whose index equals its digit
// by mask; the digit never forms an address.  Bound: the chain's
// products, each K1's work; the select reads 2^w x CH x 64 B per tile and
// window (1.1 GB at CH=521, B=4096, 16 windows, from L2 and HBM).

#include <cstdint>
#include <cuda_runtime.h>

#include "rns_tile.cuh"

namespace {

using rns_tile::cmul;
using rns_tile::kNC;
using rns_tile::TileOps;
using rns_tile::u16;

// State copies between global (CH, B) int32 and a tile's (CH, kNC)
// uint16 shared state; columns past B read as 0 and are not written.
__device__ __forceinline__ void load_tile(const uint32_t* g, u16* st, int CH,
                                          int col0, int B) {
  for (int i = threadIdx.x; i < CH * kNC; i += blockDim.x) {
    const int c = i / kNC, col = col0 + (i & (kNC - 1));
    st[i] = col < B ? static_cast<u16>(g[static_cast<size_t>(c) * B + col])
                    : u16{0};
  }
}

__device__ __forceinline__ void store_tile(const u16* st, uint32_t* g, int CH,
                                           int col0, int B) {
  for (int i = threadIdx.x; i < CH * kNC; i += blockDim.x) {
    const int c = i / kNC, col = col0 + (i & (kNC - 1));
    if (col < B) g[static_cast<size_t>(c) * B + col] = st[i];
  }
}

// 16-byte copy of one (CH, kNC) uint16 state between shared and global
// scratch (CH * 64 bytes, a multiple of 16).
__device__ __forceinline__ void copy_state(uint4* dst, const uint4* src,
                                           int CH) {
  for (int i = threadIdx.x; i < CH * 4; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ void prefetch_state(u16* dst, const u16* src,
                                               int CH) {
  for (int i = threadIdx.x; i < CH * 4; i += blockDim.x)
    rns_tile::cp_async16(dst + 8 * i, src + 8 * i);
  rns_tile::cp_async_commit();
}

// W1, W2 for K2's and K6's chains: with kSharedW copied once into shared
// memory at p (W1, W2 then point there), else left in global memory.
// Returns the first byte past them.
template <bool kSharedW>
__device__ __forceinline__ unsigned char* stage_w(const TileOps& op,
                                                  unsigned char* p,
                                                  const uint4*& W1,
                                                  const uint4*& W2) {
  if (!kSharedW) return p;
  const size_t wb = rns_tile::w_bytes(op.MT, op.KS);
  uint4* w1 = reinterpret_cast<uint4*>(p);
  uint4* w2 = reinterpret_cast<uint4*>(p + wb);
  for (size_t i = threadIdx.x; i < wb / 16; i += blockDim.x) {
    w1[i] = __ldg(op.W1 + i);
    w2[i] = __ldg(op.W2 + i);
  }
  W1 = w1;
  W2 = w2;
  return p + 2 * wb;
}

// K1: one product per tile; W from global memory (NTU = 4: each A
// fragment is read once per CTA).
__global__ void __launch_bounds__(rns_tile::kThreads, 1)
rns_mul_kernel(const uint32_t* x, const uint32_t* y, uint32_t* out,
               TileOps op, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  u16* st = reinterpret_cast<u16*>(smem);
  uint8_t* xs = smem + static_cast<size_t>(op.CH) * kNC * sizeof(u16);
  uint32_t* delta = reinterpret_cast<uint32_t*>(xs + kNC * op.XS);
  const int col0 = blockIdx.x * kNC;
  rns_tile::tile_mul<4, true>(
      st,
      [&](int c, int col, int) -> uint32_t {
        const int gc = col0 + col;
        if (gc >= B) return 0u;
        const size_t at = static_cast<size_t>(c) * B + gc;
        return cmul(x[at], y[at], rns_tile::V(op, c, 0),
                    rns_tile::V(op, c, 1));
      },
      [] {}, op.W1, op.W2, op, xs, delta);
  store_tile(st, out, op.CH, col0, B);
}

// One CRT half of a K2 launch: its entered state and output ((CH, B)
// int32), its schedule and its per-channel constants (TileOps vec, skc).
struct SchedHalf {
  const uint32_t* x;
  const int32_t* sched;
  uint32_t* out;
  const uint32_t* vec;
  const uint32_t* skc;
};

// K2: the whole chain of a tile.  kSharedW: W1, W2 copied into shared
// memory once (NTU = 1 balances the 4 MT units over 16 warps); else read
// from global memory as in K1.  CTAs [0, tiles) serve half h0, the rest
// h1 (a one-half launch has tiles CTAs); op's vec and skc are the
// served half's.  tab: (halves x tiles, 2^(w-1), CH, kNC) uint16.
template <bool kSharedW>
__global__ void __launch_bounds__(rns_tile::kThreads, 1)
rns_exp_sched_kernel(SchedHalf h0, SchedHalf h1, int n_ops, u16* tab,
                     TileOps op, int window, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = (B + kNC - 1) / kNC;
  const bool second = static_cast<int>(blockIdx.x) >= tiles;
  const uint32_t* x = second ? h1.x : h0.x;
  const int32_t* sched = second ? h1.sched : h0.sched;
  uint32_t* out = second ? h1.out : h0.out;
  op.vec = second ? h1.vec : h0.vec;
  op.skc = second ? h1.skc : h0.skc;
  const int CH = op.CH, SZ = CH * kNC;
  const uint4* W1 = op.W1;
  const uint4* W2 = op.W2;
  unsigned char* p = stage_w<kSharedW>(op, smem, W1, W2);
  u16* acc = reinterpret_cast<u16*>(p);
  u16* opb = acc + SZ;
  uint8_t* xs = reinterpret_cast<uint8_t*>(opb + SZ);
  uint32_t* delta = reinterpret_cast<uint32_t*>(xs + kNC * op.XS);
  const int col0 = (blockIdx.x - (second ? tiles : 0)) * kNC;
  const int tsize = 1 << (window - 1);
  u16* tb = tab + static_cast<size_t>(blockIdx.x) * tsize * SZ;
  constexpr int NTU = kSharedW ? 1 : 4;
  const auto none = [] {};

  load_tile(x, opb, CH, col0, B);                 // T[0] = c
  __syncthreads();
  copy_state(reinterpret_cast<uint4*>(tb), reinterpret_cast<const uint4*>(opb),
             CH);
  rns_tile::tile_mul<NTU, !kSharedW>(             // acc = c^2
      acc,
      [&](int c, int, int i) -> uint32_t {
        return cmul(opb[i], opb[i], rns_tile::V(op, c, 0),
                    rns_tile::V(op, c, 1));
      },
      none, W1, W2, op, xs, delta);
  for (int t = 1; t < tsize; ++t) {               // T[t] = T[t-1] c^2
    rns_tile::tile_mul<NTU, !kSharedW>(
        opb,
        [&](int c, int, int i) -> uint32_t {
          return cmul(opb[i], acc[i], rns_tile::V(op, c, 0),
                      rns_tile::V(op, c, 1));
        },
        none, W1, W2, op, xs, delta);
    copy_state(reinterpret_cast<uint4*>(tb + static_cast<size_t>(t) * SZ),
               reinterpret_cast<const uint4*>(opb), CH);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < SZ; i += blockDim.x)   // acc = one
    acc[i] = static_cast<u16>(rns_tile::V(op, i / kNC, 9));
  // the operand of the next multiply goes into opb ahead of its product
  int nxt = 0;
  while (nxt < n_ops && __ldg(sched + nxt) == 0) ++nxt;
  if (nxt < n_ops)
    prefetch_state(opb, tb + static_cast<size_t>(__ldg(sched + nxt) - 1) * SZ,
                   CH);
  for (int j = 0; j < n_ops; ++j) {
    const int d = __ldg(sched + j);        // 0: square; t: times T[t-1]
    if (d != 0) {
      rns_tile::cp_async_wait_all();
      __syncthreads();
    }
    const u16* other = d != 0 ? opb : acc;
    rns_tile::tile_mul<NTU, !kSharedW>(
        acc,
        [&](int c, int, int i) -> uint32_t {
          return cmul(acc[i], other[i], rns_tile::V(op, c, 0),
                      rns_tile::V(op, c, 1));
        },
        [&] {
          if (d == 0) return;
          nxt = j + 1;
          while (nxt < n_ops && __ldg(sched + nxt) == 0) ++nxt;
          if (nxt < n_ops)
            prefetch_state(
                opb, tb + static_cast<size_t>(__ldg(sched + nxt) - 1) * SZ,
                CH);
        },
        W1, W2, op, xs, delta);
  }
  store_tile(acc, out, CH, col0, B);
}

// K5: the whole per-element chain of a tile; W from global memory as in
// K1 (NTU = 4).  The
// table [one, X, X^2, ..., X^(2^w-1)] of the tile lies in global scratch
// (tab: (tiles, 2^w, CH, kNC) uint16), written and read by this CTA
// alone (plain loads: it is written in this launch).  The digits are the
// plaintext's: each window's product by T[d] reads all 2^w entries of
// every (channel, column) and keeps the one whose index equals the
// column's digit by mask, so the digit never forms an address.
__global__ void __launch_bounds__(rns_tile::kThreads, 1)
rns_exp_elem_kernel(const uint32_t* x, const int32_t* digits, int n_win,
                    uint32_t* out, u16* tab, TileOps op, int window, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int CH = op.CH, SZ = CH * kNC;
  const uint4* W1 = op.W1;
  const uint4* W2 = op.W2;
  u16* acc = reinterpret_cast<u16*>(smem);
  u16* xst = acc + SZ;
  uint8_t* xs = reinterpret_cast<uint8_t*>(xst + SZ);
  uint32_t* delta = reinterpret_cast<uint32_t*>(xs + kNC * op.XS);
  uint8_t* dig = reinterpret_cast<uint8_t*>(delta + kNC);   // (n_win, kNC)
  const int col0 = blockIdx.x * kNC;
  const int tsize = 1 << window;
  u16* tb = tab + static_cast<size_t>(blockIdx.x) * tsize * SZ;
  const auto none = [] {};

  load_tile(x, xst, CH, col0, B);
  for (int i = threadIdx.x; i < n_win * kNC; i += blockDim.x) {
    const int gc = col0 + (i & (kNC - 1));
    dig[i] = gc < B ? static_cast<uint8_t>(
                          __ldg(digits + static_cast<size_t>(i / kNC) * B + gc))
                    : uint8_t{0};
  }
  for (int i = threadIdx.x; i < SZ; i += blockDim.x)       // T[0] = one
    tb[i] = static_cast<u16>(rns_tile::V(op, i / kNC, 9));
  __syncthreads();
  copy_state(reinterpret_cast<uint4*>(tb + SZ),            // T[1] = X
             reinterpret_cast<const uint4*>(xst), CH);
  for (int t = 2; t < tsize; ++t) {                        // T[t] = T[t-1] X
    const u16* prev = t == 2 ? xst : acc;
    rns_tile::tile_mul<4, true>(
        acc,
        [&](int c, int, int i) -> uint32_t {
          return cmul(prev[i], xst[i], rns_tile::V(op, c, 0),
                      rns_tile::V(op, c, 1));
        },
        none, W1, W2, op, xs, delta);
    copy_state(reinterpret_cast<uint4*>(tb + static_cast<size_t>(t) * SZ),
               reinterpret_cast<const uint4*>(acc), CH);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < SZ; i += blockDim.x)       // acc = one
    acc[i] = static_cast<u16>(rns_tile::V(op, i / kNC, 9));
  for (int j = 0; j < n_win; ++j) {
    for (int r = 0; r < window; ++r)
      rns_tile::tile_mul<4, true>(
          acc,
          [&](int c, int, int i) -> uint32_t {
            return cmul(acc[i], acc[i], rns_tile::V(op, c, 0),
                        rns_tile::V(op, c, 1));
          },
          none, W1, W2, op, xs, delta);
    const uint8_t* dj = dig + j * kNC;
    rns_tile::tile_mul<4, true>(                    // acc * T[d]
        acc,
        [&](int c, int col, int i) -> uint32_t {
          const uint32_t d = dj[col];
          uint32_t sel = 0u;
          for (int t = 0; t < tsize; ++t) {
            const uint32_t mask = 0u - static_cast<uint32_t>(d == t);
            sel |= tb[static_cast<size_t>(t) * SZ + i] & mask;
          }
          return cmul(acc[i], sel, rns_tile::V(op, c, 0),
                      rns_tile::V(op, c, 1));
        },
        none, W1, W2, op, xs, delta);
  }
  store_tile(acc, out, CH, col0, B);
}

// K6: the whole fixed-window chain of a tile, W1, W2 staged as in K2.
// tab: (tiles, 2^w, CH, kNC) uint16, written and read by this CTA alone.
template <bool kSharedW>
__global__ void __launch_bounds__(rns_tile::kThreads, 1)
rns_exp_shared_kernel(const uint32_t* x, const int32_t* digits, int n_win,
                      uint32_t* out, u16* tab, TileOps op, int window,
                      int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int CH = op.CH, SZ = CH * kNC;
  const uint4* W1 = op.W1;
  const uint4* W2 = op.W2;
  unsigned char* p = stage_w<kSharedW>(op, smem, W1, W2);
  u16* acc = reinterpret_cast<u16*>(p);
  u16* opb = acc + SZ;
  uint8_t* xs = reinterpret_cast<uint8_t*>(opb + SZ);
  uint32_t* delta = reinterpret_cast<uint32_t*>(xs + kNC * op.XS);
  const int col0 = blockIdx.x * kNC;
  const int tsize = 1 << window;
  u16* tb = tab + static_cast<size_t>(blockIdx.x) * tsize * SZ;
  constexpr int NTU = kSharedW ? 1 : 4;
  const auto none = [] {};

  load_tile(x, opb, CH, col0, B);                          // X
  for (int i = threadIdx.x; i < SZ; i += blockDim.x)       // T[0] = one
    tb[i] = static_cast<u16>(rns_tile::V(op, i / kNC, 9));
  __syncthreads();
  copy_state(reinterpret_cast<uint4*>(tb + SZ),            // T[1] = X
             reinterpret_cast<const uint4*>(opb), CH);
  for (int t = 2; t < tsize; ++t) {                        // T[t] = T[t-1] X
    const u16* prev = t == 2 ? opb : acc;
    rns_tile::tile_mul<NTU, !kSharedW>(
        acc,
        [&](int c, int, int i) -> uint32_t {
          return cmul(prev[i], opb[i], rns_tile::V(op, c, 0),
                      rns_tile::V(op, c, 1));
        },
        none, W1, W2, op, xs, delta);
    copy_state(reinterpret_cast<uint4*>(tb + static_cast<size_t>(t) * SZ),
               reinterpret_cast<const uint4*>(acc), CH);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < SZ; i += blockDim.x)       // acc = one
    acc[i] = static_cast<u16>(rns_tile::V(op, i / kNC, 9));
  __syncthreads();               // X's last reader is done: opb is free
  if (n_win > 0)
    prefetch_state(opb, tb + static_cast<size_t>(__ldg(digits)) * SZ, CH);
  for (int j = 0; j < n_win; ++j) {
    for (int r = 0; r < window; ++r)
      rns_tile::tile_mul<NTU, !kSharedW>(
          acc,
          [&](int c, int, int i) -> uint32_t {
            return cmul(acc[i], acc[i], rns_tile::V(op, c, 0),
                        rns_tile::V(op, c, 1));
          },
          none, W1, W2, op, xs, delta);
    rns_tile::cp_async_wait_all();
    __syncthreads();
    rns_tile::tile_mul<NTU, !kSharedW>(                    // acc * T[d]
        acc,
        [&](int c, int, int i) -> uint32_t {
          return cmul(acc[i], opb[i], rns_tile::V(op, c, 0),
                      rns_tile::V(op, c, 1));
        },
        [&] {
          if (j + 1 < n_win)
            prefetch_state(
                opb, tb + static_cast<size_t>(__ldg(digits + j + 1)) * SZ,
                CH);
        },
        W1, W2, op, xs, delta);
  }
  store_tile(acc, out, CH, col0, B);
}

// The tile kernels' operands: MT m-tiles of 16 rows over the 2(k+1)
// interleaved extension rows, KS k-steps of 32 over the 2KP digit bytes.
inline TileOps tile_ops(const uint32_t* vec, const uint32_t* skc,
                        const uint8_t* W1, const uint8_t* W2, int k, int CH,
                        int KP, int nlev) {
  return TileOps{vec, skc, reinterpret_cast<const uint4*>(W1),
                 reinterpret_cast<const uint4*>(W2), k, CH, KP, nlev,
                 (2 * (k + 1) + 15) / 16, 2 * KP / 32,
                 rns_tile::digit_stride(KP)};
}

inline size_t state_bytes(int CH) {
  return static_cast<size_t>(CH) * kNC * sizeof(u16);
}

using rns_tile::kMaxShared;

inline bool bad_tile_shape(int k, int CH, int KP, int B) {
  return k < 1 || CH != 2 * k + 1 || KP % 16 != 0 || KP < k || B < 1;
}

}  // namespace

extern "C" int pct_rns_mul(const uint32_t* x, const uint32_t* y,
                           uint32_t* out, const uint32_t* vec,
                           const uint32_t* skc, const uint8_t* W1,
                           const uint8_t* W2, int k, int CH, int KP, int nlev,
                           int B, void* stream) {
  if (bad_tile_shape(k, CH, KP, B)) return cudaErrorInvalidValue;
  const size_t smem = state_bytes(CH) + rns_tile::work_bytes(KP);
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> raised{0};
  const cudaError_t e = rns_tile::allow_max_shared(rns_mul_kernel, raised);
  if (e != cudaSuccess) return e;
  rns_mul_kernel<<<(B + kNC - 1) / kNC, rns_tile::kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      x, y, out, tile_ops(vec, skc, W1, W2, k, CH, KP, nlev), B);
  return cudaGetLastError();
}

// K2 over `halves` (1 or 2) CRT halves of B columns each, one schedule
// length n_ops; the second half's pointers are read only when halves = 2.
extern "C" int pct_rns_exp_sched(const uint32_t* x0, const uint32_t* x1,
                                 const int32_t* sched0, const int32_t* sched1,
                                 int n_ops, uint32_t* out0, uint32_t* out1,
                                 uint16_t* tab, const uint32_t* vec0,
                                 const uint32_t* vec1, const uint32_t* skc0,
                                 const uint32_t* skc1, const uint8_t* W1,
                                 const uint8_t* W2, int k, int CH, int KP,
                                 int nlev, int window, int halves, int B,
                                 void* stream) {
  if (bad_tile_shape(k, CH, KP, B) || window < 1 || window > 8
      || n_ops < 0 || halves < 1 || halves > 2) {
    return cudaErrorInvalidValue;
  }
  const TileOps op = tile_ops(vec0, skc0, W1, W2, k, CH, KP, nlev);
  const SchedHalf h0{x0, sched0, out0, vec0, skc0};
  const SchedHalf h1 =
      halves == 2 ? SchedHalf{x1, sched1, out1, vec1, skc1} : h0;
  const size_t smem = 2 * state_bytes(CH) + rns_tile::work_bytes(KP);
  const size_t smem_w = smem + 2 * rns_tile::w_bytes(op.MT, op.KS);
  const bool shared_w = smem_w <= kMaxShared;
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> raised[2] = {{0}, {0}};
  const auto kernel = shared_w ? rns_exp_sched_kernel<true>
                               : rns_exp_sched_kernel<false>;
  const size_t bytes = shared_w ? smem_w : smem;
  const cudaError_t e = rns_tile::allow_max_shared(kernel, raised[shared_w]);
  if (e != cudaSuccess) return e;
  kernel<<<halves * ((B + kNC - 1) / kNC), rns_tile::kThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(h0, h1, n_ops, tab, op,
                                                window, B);
  return cudaGetLastError();
}

extern "C" int pct_rns_exp_elem(const uint32_t* x, const int32_t* digits,
                                int n_win, uint32_t* out, uint16_t* tab,
                                const uint32_t* vec, const uint32_t* skc,
                                const uint8_t* W1, const uint8_t* W2, int k,
                                int CH, int KP, int nlev, int window, int B,
                                void* stream) {
  if (bad_tile_shape(k, CH, KP, B) || window < 1 || window > 8
      || n_win < 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = 2 * state_bytes(CH) + rns_tile::work_bytes(KP)
                      + static_cast<size_t>(n_win) * kNC;
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> raised{0};
  const cudaError_t e =
      rns_tile::allow_max_shared(rns_exp_elem_kernel, raised);
  if (e != cudaSuccess) return e;
  rns_exp_elem_kernel<<<(B + kNC - 1) / kNC, rns_tile::kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, digits, n_win, out, tab, tile_ops(vec, skc, W1, W2, k, CH, KP, nlev),
      window, B);
  return cudaGetLastError();
}

extern "C" int pct_rns_exp_shared(const uint32_t* x, const int32_t* digits,
                                  int n_win, uint32_t* out, uint16_t* tab,
                                  const uint32_t* vec, const uint32_t* skc,
                                  const uint8_t* W1, const uint8_t* W2, int k,
                                  int CH, int KP, int nlev, int window, int B,
                                  void* stream) {
  if (bad_tile_shape(k, CH, KP, B) || window < 1 || window > 8
      || n_win < 0) {
    return cudaErrorInvalidValue;
  }
  const TileOps op = tile_ops(vec, skc, W1, W2, k, CH, KP, nlev);
  const size_t smem = 2 * state_bytes(CH) + rns_tile::work_bytes(KP);
  const size_t smem_w = smem + 2 * rns_tile::w_bytes(op.MT, op.KS);
  const bool shared_w = smem_w <= kMaxShared;
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> raised[2] = {{0}, {0}};
  const auto kernel = shared_w ? rns_exp_shared_kernel<true>
                               : rns_exp_shared_kernel<false>;
  const size_t bytes = shared_w ? smem_w : smem;
  const cudaError_t e = rns_tile::allow_max_shared(kernel, raised[shared_w]);
  if (e != cudaSuccess) return e;
  kernel<<<(B + kNC - 1) / kNC, rns_tile::kThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(x, digits, n_win, out, tab,
                                                op, window, B);
  return cudaGetLastError();
}
