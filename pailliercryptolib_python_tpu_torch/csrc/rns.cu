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
// One product, per column (see ops/rns.py rns_mont_mul, its plain twin):
//   S   = cmul(X, Y)                       all CH channels
//   xi  = shoup(S[B])                      k digits
//   S_A, S_B = E1 . xi  (centred int8)     first base extension
//   Rp  = cmul2(S, u5, combine(S_A,S_B), v5)   on B' and m_r
//   xi' = shoup(Rp[B'])
//   T_A, T_B = E2 . xi'                    second base extension
//   Zh  = combine(T_A, T_B)                on B and m_r
//   delta from the redundant channel; Z = cmul2(Zh, w9b, delta, w9n)
//   out = [Z | Rp]
// Operands come packed as in the JAX package (ops/rns_kernels.py pack):
// vec (CHP, 16) uint32 columns 0 mods, 1 n0, 2 n032, 3 Shoup constant,
// 4 u5, 5 v5, 6 w9n, 7 w9b, 8 Shoup companion, 9 one, 10 CS1, 11 CS2;
// skc[0..1] the SK constants; E1/E2 (4(k+1), KP) int8 stacks
// [C_lo; C_hi; D_lo; D_hi] - 128, zero-padded from k to KP columns.
//
// What the TPU kernel did and what this does instead.  On the TPU the
// extension dots ran on the MXU as int8 matmuls over a batch tile held
// in VMEM.  Here one thread owns one column: it packs its k digits as
// centred int8 words into shared memory and runs the dots with __dp4a
// (4 int8 MACs per instruction); every thread of a warp reads the same
// E row, so each 16-byte E load is one broadcast transaction.  The state
// is updated in place in the output column, so K1 needs no scratch.
//
// What bounds it on the H100.  At CH=521 each E stack is 1044 x 272 B =
// 284 KB, more than the 227 KB of shared memory a block may use, so E is
// read through L1/L2 (50 MB L2 holds both stacks) instead of being
// staged.  A product is two base extensions of 4(k+1)k int8 MACs each
// per column (2 x 71k dp4a at k=260, KP=272); the bound in chip_smoke.py
// counts those MACs at 2 int8 operations each against the bytes of the
// states read and written once.  With one thread per column a 4096-wide
// batch fills only 128 warps on 132 SMs, so the kernel is bound by
// instruction latency, 2-3 orders of magnitude above that bound.  Later
// work: the
// extensions as int8 tensor-core (mma/wgmma) products over a column
// tile, with E tiled over k through shared memory.
//
// K2 keeps its odd-power table ((2^(w-1), CH, B), 137 MB at w=6, CH=261,
// B=4096) and c^2 in global scratch the wrapper allocates, and the
// accumulator in the output column.  The table index comes from the
// schedule of the secret exponent p-1 (q-1): every column reads the same
// entry at the same step, so the access pattern follows the key, as on
// the TPU.  The port's README records this; a constant-access select is
// later work.
//
// K5 keeps its 2^w-entry table [one, X, X^2, ..., X^(2^w-1)] ((16, CH, B)
// at w=4: 137 MB at CH=521, B=4096) in global scratch the wrapper
// allocates, built by successive products with X in the TPU kernel's
// order, so every state equals the plain twin's.  The accumulator lives
// in the output column.  The digits are the plaintext's, so the entry
// is chosen as on the TPU (:530-534) by a constant-access one-hot
// select: all 2^w entries of every channel are read and masked, and the
// digit never forms an address.  A zero digit multiplies by `one`.
// Bound: the same per-product latency as K1 ((2^w - 2) + n_win (w + 1)
// products per column; ops model 2 extensions x 4(k+1)k int8 MACs per
// product and column), plus 2^w x CH table reads per window.
//
// K6 keeps K5's table [one, X, X^2, ..., X^(2^w-1)] ((32, CH, B) at w=5:
// 137 MB at CH=261, B=4096) in global scratch the wrapper allocates,
// built in the same order, and the accumulator in the output column.
// Per window: w squarings, then one product by T[digit], a zero digit
// multiplying by `one`, so every state equals the plain twin's.  The
// digit is one key-derived value (p-1 or q-1) shared by the batch: it
// indexes the table, as in the TPU kernel (:374-375) and in K2.  The
// TPU kernel's table had to fit a VMEM tile; here it lies in global
// memory and no such limit applies.  Work: (2^w - 2) + n_win (w + 1)
// products per column, each two extensions of 4(k+1)k int8 MACs; bytes:
// X, the digits and the constants read once, the output written once.
// Bound: the same per-product latency as K1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

struct Ops {
  const uint32_t* vec;   // (CHP, 16)
  const uint32_t* skc;   // (8,)
  const int8_t* E1;      // (4(k+1), KP)
  const int8_t* E2;
  int k, CH, KP, nlev;
};

__device__ __forceinline__ uint32_t V(const Ops& o, int row, int col) {
  return o.vec[row * 16 + col];
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

// Centred-int8 digit words of one column in shared memory: word w of the
// low-byte plane at xs[w*nt + tid], of the high-byte plane at
// xs[(KW + w)*nt + tid] (KW = KP/4; digits past k are 0).
__device__ __forceinline__ void put_digit_word(uint32_t* xs, int KW, int w,
                                               int tid, int nt, uint32_t w0,
                                               uint32_t w1) {
  xs[w * nt + tid] = w0;
  xs[(KW + w) * nt + tid] = w1;
}

// Dots of row j of the stacked E (o = k+1 output rows) with the packed
// digits: S_A = E[j].x0 + E[2o+j].x1, S_B = E[o+j].x0 + E[3o+j].x1
// (centred parts only; the caller adds the static corrections).
__device__ __forceinline__ void ext_dots(const int8_t* E, int o, int KP,
                                         int j, const uint32_t* xs, int tid,
                                         int nt, int& SA, int& SB) {
  const int KW = KP / 4;
  const int4* a0 = reinterpret_cast<const int4*>(E + static_cast<size_t>(j) * KP);
  const int4* a1 =
      reinterpret_cast<const int4*>(E + static_cast<size_t>(2 * o + j) * KP);
  const int4* b0 =
      reinterpret_cast<const int4*>(E + static_cast<size_t>(o + j) * KP);
  const int4* b1 =
      reinterpret_cast<const int4*>(E + static_cast<size_t>(3 * o + j) * KP);
  int sa = 0, sb = 0;
  for (int q = 0; q < KP / 16; ++q) {
    const int4 ea0 = __ldg(a0 + q), ea1 = __ldg(a1 + q);
    const int4 eb0 = __ldg(b0 + q), eb1 = __ldg(b1 + q);
    const uint32_t* x0 = xs + (4 * q) * nt + tid;
    const uint32_t* x1 = xs + (KW + 4 * q) * nt + tid;
    const int p0 = x0[0], p1 = x0[nt], p2 = x0[2 * nt], p3 = x0[3 * nt];
    const int h0 = x1[0], h1 = x1[nt], h2 = x1[2 * nt], h3 = x1[3 * nt];
    sa = __dp4a(ea0.x, p0, sa); sb = __dp4a(eb0.x, p0, sb);
    sa = __dp4a(ea0.y, p1, sa); sb = __dp4a(eb0.y, p1, sb);
    sa = __dp4a(ea0.z, p2, sa); sb = __dp4a(eb0.z, p2, sb);
    sa = __dp4a(ea0.w, p3, sa); sb = __dp4a(eb0.w, p3, sb);
    sa = __dp4a(ea1.x, h0, sa); sb = __dp4a(eb1.x, h0, sb);
    sa = __dp4a(ea1.y, h1, sa); sb = __dp4a(eb1.y, h1, sb);
    sa = __dp4a(ea1.z, h2, sa); sb = __dp4a(eb1.z, h2, sb);
    sa = __dp4a(ea1.w, h3, sa); sb = __dp4a(eb1.w, h3, sb);
  }
  SA = sa;
  SB = sb;
}

// Shoup-multiply k channels of a column (rows r0..r0+k-1 of `st`, stride
// s) by the vec column-3/8 constants and pack the results as centred
// digit words.  Returns sum(x0 - 128) + sum(x1 - 128) over the k digits.
__device__ __forceinline__ int pack_digits(const uint32_t* st, int s, int r0,
                                           const Ops& op, uint32_t* xs,
                                           int tid, int nt) {
  const int KW = op.KP / 4;
  int sum = 0;
  for (int w = 0; w < KW; ++w) {
    uint32_t w0 = 0u, w1 = 0u;
    for (int b = 0; b < 4; ++b) {
      const int i = 4 * w + b;
      if (i < op.k) {
        const int r = r0 + i;
        const uint32_t v = cmul_shoup(st[r * s], V(op, r, 3), V(op, r, 8),
                                      V(op, r, 0));
        const int c0 = static_cast<int>(v & 0xFFu) - 128;
        const int c1 = static_cast<int>(v >> 8) - 128;
        sum += c0 + c1;
        w0 |= (static_cast<uint32_t>(c0) & 0xFFu) << (8 * b);
        w1 |= (static_cast<uint32_t>(c1) & 0xFFu) << (8 * b);
      }
    }
    put_digit_word(xs, KW, w, tid, nt, w0, w1);
  }
  return sum;
}

// The rest of one RNS-Montgomery product of a column, once o (row
// stride s) holds S = cmul(x, y) on all CH channels: the two base
// extensions and the Shenoy-Kumaresan correction, in place.
__device__ void rns_mul_finish(uint32_t* o, int s, const Ops& op,
                               uint32_t* xs, int tid, int nt) {
  const int k = op.k, ob = k + 1;
  // first extension: B -> B' and m_r, then r' on those channels
  int corr = 128 * pack_digits(o, s, 0, op, xs, tid, nt);
  for (int j = 0; j <= k; ++j) {
    int SA, SB;
    ext_dots(op.E1, ob, op.KP, j, xs, tid, nt, SA, SB);
    SA += corr + static_cast<int>(V(op, j, 10));
    SB += corr + static_cast<int>(V(op, ob + j, 10));
    const int c = k + j;
    const uint32_t m = V(op, c, 0), n0 = V(op, c, 1);
    const uint32_t q = combine_dual(SA, SB, m, n0, op.nlev);
    o[c * s] = cmul2(o[c * s], V(op, c, 4), q, V(op, c, 5), m, n0);
  }
  // second extension: B' -> B and m_r (Shenoy-Kumaresan)
  corr = 128 * pack_digits(o, s, k, op, xs, tid, nt);
  uint32_t zr = 0u;
  for (int j = 0; j <= k; ++j) {
    int SA, SB;
    ext_dots(op.E2, ob, op.KP, j, xs, tid, nt, SA, SB);
    SA += corr + static_cast<int>(V(op, j, 11));
    SB += corr + static_cast<int>(V(op, ob + j, 11));
    const int c = j < k ? j : 2 * k;
    const uint32_t zh = combine_dual(SA, SB, V(op, c, 0), V(op, c, 1),
                                     op.nlev);
    if (j < k) o[c * s] = zh; else zr = zh;
  }
  const uint32_t mr = V(op, 2 * k, 0), n0r = V(op, 2 * k, 1);
  const uint32_t delta = submod(cmul(zr, op.skc[0], mr, n0r),
                                cmul(o[2 * k * s], op.skc[1], mr, n0r), mr);
  for (int i = 0; i < k; ++i)
    o[i * s] = cmul2(o[i * s], V(op, i, 7), delta, V(op, i, 6), V(op, i, 0),
                     V(op, i, 1));
}

// One RNS-Montgomery product of a column: o = x*y*M^-1.  x, y, o are
// column pointers with row stride s; o may alias x and/or y (each
// channel of x, y is read once, before o's channel is written).
__device__ void rns_mul_col(const uint32_t* x, const uint32_t* y, uint32_t* o,
                            int s, const Ops& op, uint32_t* xs, int tid,
                            int nt) {
  for (int c = 0; c < op.CH; ++c)
    o[c * s] = cmul(x[c * s], y[c * s], V(op, c, 0), V(op, c, 1));
  rns_mul_finish(o, s, op, xs, tid, nt);
}

__global__ void rns_mul_kernel(const uint32_t* x, const uint32_t* y,
                               uint32_t* out, Ops op, int B) {
  extern __shared__ uint32_t xs[];
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  rns_mul_col(x + col, y + col, out + col, B, op, xs, threadIdx.x,
              blockDim.x);
}

__global__ void rns_exp_sched_kernel(const uint32_t* x, const int32_t* sched,
                                     int n_ops, uint32_t* out, uint32_t* tab,
                                     uint32_t* c2, Ops op, int window,
                                     int B) {
  extern __shared__ uint32_t xs[];
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  const int tid = threadIdx.x, nt = blockDim.x, CH = op.CH;
  const size_t plane = static_cast<size_t>(CH) * B;
  const uint32_t* xc = x + col;
  uint32_t* tb = tab + col;
  uint32_t* c2c = c2 + col;
  uint32_t* acc = out + col;
  rns_mul_col(xc, xc, c2c, B, op, xs, tid, nt);            // c^2
  for (int c = 0; c < CH; ++c) tb[c * B] = xc[c * B];      // T[0] = c
  const int tsize = 1 << (window - 1);
  for (int t = 1; t < tsize; ++t)                          // T[t] = c^(2t+1)
    rns_mul_col(tb + (t - 1) * plane, c2c, tb + t * plane, B, op, xs, tid,
                nt);
  for (int c = 0; c < CH; ++c) acc[c * B] = V(op, c, 9);   // one
  for (int j = 0; j < n_ops; ++j) {
    const int d = sched[j];                  // 0: square; t: times T[t-1]
    const uint32_t* operand = d == 0 ? acc : tb + (d - 1) * plane;
    rns_mul_col(acc, operand, acc, B, op, xs, tid, nt);
  }
}

__global__ void rns_exp_elem_kernel(const uint32_t* x, const int32_t* digits,
                                    int n_win, uint32_t* out, uint32_t* tab,
                                    Ops op, int window, int B) {
  extern __shared__ uint32_t xs[];
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  const int tid = threadIdx.x, nt = blockDim.x, CH = op.CH;
  const size_t plane = static_cast<size_t>(CH) * B;
  const uint32_t* xc = x + col;
  uint32_t* tb = tab + col;
  uint32_t* acc = out + col;
  const int tsize = 1 << window;
  for (int c = 0; c < CH; ++c) {
    tb[c * B] = V(op, c, 9);                              // T[0] = one
    tb[plane + c * B] = xc[c * B];                        // T[1] = X
  }
  for (int t = 2; t < tsize; ++t)                         // T[t] = T[t-1] X
    rns_mul_col(tb + (t - 1) * plane, xc, tb + t * plane, B, op, xs, tid,
                nt);
  for (int c = 0; c < CH; ++c) acc[c * B] = V(op, c, 9);
  for (int j = 0; j < n_win; ++j) {
    for (int r = 0; r < window; ++r)
      rns_mul_col(acc, acc, acc, B, op, xs, tid, nt);
    const int d = digits[static_cast<size_t>(j) * B + col];
    // acc * T[d]: every entry is read; the digit only builds masks
    for (int c = 0; c < CH; ++c) {
      uint32_t sel = tb[c * B];
      for (int t = 1; t < tsize; ++t) {
        const uint32_t v = tb[t * plane + c * B];
        const uint32_t mask = 0u - static_cast<uint32_t>(d == t);
        sel = (v & mask) | (sel & ~mask);
      }
      acc[c * B] = cmul(acc[c * B], sel, V(op, c, 0), V(op, c, 1));
    }
    rns_mul_finish(acc, B, op, xs, tid, nt);
  }
}

__global__ void rns_exp_shared_kernel(const uint32_t* x,
                                      const int32_t* digits, int n_win,
                                      uint32_t* out, uint32_t* tab, Ops op,
                                      int window, int B) {
  extern __shared__ uint32_t xs[];
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  const int tid = threadIdx.x, nt = blockDim.x, CH = op.CH;
  const size_t plane = static_cast<size_t>(CH) * B;
  const uint32_t* xc = x + col;
  uint32_t* tb = tab + col;
  uint32_t* acc = out + col;
  const int tsize = 1 << window;
  for (int c = 0; c < CH; ++c) {
    tb[c * B] = V(op, c, 9);                              // T[0] = one
    tb[plane + c * B] = xc[c * B];                        // T[1] = X
  }
  for (int t = 2; t < tsize; ++t)                         // T[t] = T[t-1] X
    rns_mul_col(tb + (t - 1) * plane, xc, tb + t * plane, B, op, xs, tid,
                nt);
  for (int c = 0; c < CH; ++c) acc[c * B] = V(op, c, 9);
  for (int j = 0; j < n_win; ++j) {
    for (int r = 0; r < window; ++r)
      rns_mul_col(acc, acc, acc, B, op, xs, tid, nt);
    rns_mul_col(acc, tb + digits[j] * plane, acc, B, op, xs, tid, nt);
  }
}

inline size_t shared_bytes(int KP) {
  return static_cast<size_t>(2 * (KP / 4)) * kThreads * sizeof(uint32_t);
}

inline bool bad_shape(int k, int CH, int KP, int B) {
  return k < 1 || CH != 2 * k + 1 || KP % 16 != 0 || KP < k || B < 1
         || shared_bytes(KP) > 48 * 1024;
}

}  // namespace

extern "C" int pct_rns_mul(const uint32_t* x, const uint32_t* y,
                           uint32_t* out, const uint32_t* vec,
                           const uint32_t* skc, const int8_t* E1,
                           const int8_t* E2, int k, int CH, int KP, int nlev,
                           int B, void* stream) {
  if (bad_shape(k, CH, KP, B)) return cudaErrorInvalidValue;
  const Ops op{vec, skc, E1, E2, k, CH, KP, nlev};
  rns_mul_kernel<<<(B + kThreads - 1) / kThreads, kThreads, shared_bytes(KP),
                   static_cast<cudaStream_t>(stream)>>>(x, y, out, op, B);
  return cudaGetLastError();
}

extern "C" int pct_rns_exp_sched(const uint32_t* x, const int32_t* sched,
                                 int n_ops, uint32_t* out, uint32_t* tab,
                                 uint32_t* c2, const uint32_t* vec,
                                 const uint32_t* skc, const int8_t* E1,
                                 const int8_t* E2, int k, int CH, int KP,
                                 int nlev, int window, int B, void* stream) {
  if (bad_shape(k, CH, KP, B) || window < 1 || window > 8 || n_ops < 0) {
    return cudaErrorInvalidValue;
  }
  const Ops op{vec, skc, E1, E2, k, CH, KP, nlev};
  rns_exp_sched_kernel<<<(B + kThreads - 1) / kThreads, kThreads,
                         shared_bytes(KP),
                         static_cast<cudaStream_t>(stream)>>>(
      x, sched, n_ops, out, tab, c2, op, window, B);
  return cudaGetLastError();
}

extern "C" int pct_rns_exp_elem(const uint32_t* x, const int32_t* digits,
                                int n_win, uint32_t* out, uint32_t* tab,
                                const uint32_t* vec, const uint32_t* skc,
                                const int8_t* E1, const int8_t* E2, int k,
                                int CH, int KP, int nlev, int window, int B,
                                void* stream) {
  if (bad_shape(k, CH, KP, B) || window < 1 || window > 8 || n_win < 0) {
    return cudaErrorInvalidValue;
  }
  const Ops op{vec, skc, E1, E2, k, CH, KP, nlev};
  rns_exp_elem_kernel<<<(B + kThreads - 1) / kThreads, kThreads,
                        shared_bytes(KP),
                        static_cast<cudaStream_t>(stream)>>>(
      x, digits, n_win, out, tab, op, window, B);
  return cudaGetLastError();
}

extern "C" int pct_rns_exp_shared(const uint32_t* x, const int32_t* digits,
                                  int n_win, uint32_t* out, uint32_t* tab,
                                  const uint32_t* vec, const uint32_t* skc,
                                  const int8_t* E1, const int8_t* E2, int k,
                                  int CH, int KP, int nlev, int window, int B,
                                  void* stream) {
  if (bad_shape(k, CH, KP, B) || window < 1 || window > 8 || n_win < 0) {
    return cudaErrorInvalidValue;
  }
  const Ops op{vec, skc, E1, E2, k, CH, KP, nlev};
  rns_exp_shared_kernel<<<(B + kThreads - 1) / kThreads, kThreads,
                          shared_bytes(KP),
                          static_cast<cudaStream_t>(stream)>>>(
      x, digits, n_win, out, tab, op, window, B);
  return cudaGetLastError();
}
