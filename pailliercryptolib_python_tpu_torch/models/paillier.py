"""Paillier / DJN scheme layer: host keygen, the public context (encrypt,
re-randomization, HE add, sum, ct*pt) and the private context (CRT
decrypt), on torch tensors.

Counterpart of ``pailliercryptolib_python_tpu/models/paillier.py``.  DJN
encryption and re-randomization take the RNS route: the input enters RNS
and is multiplied by the per-key comb table's entries (kernel K1 per
window on CUDA); a plain-Paillier key multiplies by r^n (kernel K4).
ct*pt runs the per-element RNS chain (kernel K5) for exponents of 8 or
more 4-bit windows, the limb modexp (kernel K4) below.  Decryption
reduces into the p^2/q^2 domains (stage 1), exponentiates per CRT half
(stage 2: the RNS sliding-window chain, kernel K2, or with
``decrypt_engine="limb"`` the shared-exponent limb modexp, kernel K7) and
recombines (stage 3).  Every shared-modulus product is kernel K3.

Ciphertexts are (L, B) int32 limb tensors in the Montgomery domain mod
n^2, on the context's device.
"""

from __future__ import annotations

import atexit
import os
import secrets

import numpy as np
import torch

from ..device import resolve
from ..ops.limb import (LIMB_BITS, LIMB_DTYPE, big_mul, cond_sub,
                        int_to_limbs, ints_to_limbs, limbs_for_bits,
                        limbs_to_ints, normalize, sub_mod_base, to_device)
from ..ops import mont3 as _m3
from ..ops import montgomery as mg
from ..ops import rns as _rns
from ..ops import rns_kernels as _rk
from ..ops.reduction import exact_div
from ..utils import config as _config

WINDOW = 4          # per-element modexp window (ct*pt)
RNS_MAX_MBITS = 14000


def pad_batch(b: int) -> int:
    """Batch padding granularity (8 below 128 columns, then 128)."""
    if b <= 8:
        return 8
    step = 8 if b < 128 else 128
    return -(-b // step) * step


def _rns_mbits(bits: int) -> int:
    """RNS base size for a modulus of `bits` bits (rounded to 16 so keys
    share cached bases); raises past the engine's channel-count bound
    instead of changing engine."""
    mbits = -(-bits // 16) * 16
    if mbits > RNS_MAX_MBITS:
        raise NotImplementedError(
            f"{bits}-bit modulus exceeds the RNS engine's bound "
            f"({RNS_MAX_MBITS} bits); the limb engines that serve such "
            f"keys are still to be ported (ROADMAP.md)")
    return mbits


# ---------------------------------------------------------------------------
# Host keygen: OS entropy, native trial-division sieve, Miller-Rabin.
# ---------------------------------------------------------------------------

def _small_primes(limit: int = 8192):
    sieve = np.ones(limit, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(limit ** 0.5) + 1):
        if sieve[i]:
            sieve[i * i::i] = False
    return [int(p) for p in np.nonzero(sieve)[0]]


_SMALL_PRIMES = _small_primes()


def _mr_round(n: int, d: int, r: int, a: int) -> bool:
    x = pow(a, d, n)
    if x == 1 or x == n - 1:
        return True
    for _ in range(r - 1):
        x = x * x % n
        if x == n - 1:
            return True
    return False


def is_probable_prime(n: int, rounds: int = 8) -> bool:
    """Miller-Rabin: base 2 plus `rounds` random bases."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES[:64]:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    if not _mr_round(n, d, r, 2):
        return False
    for _ in range(rounds):
        if not _mr_round(n, d, r, secrets.randbelow(n - 3) + 2):
            return False
    return True


def generate_prime(bits: int) -> int:
    """Random `bits`-bit prime: windowed sieve + Miller-Rabin."""
    from .. import native
    window = 2048
    while True:
        base = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        mask = native.sieve_window(base, window, _SMALL_PRIMES)
        for j in range(len(mask)):
            if not mask[j]:
                continue
            cand = base + 2 * j
            if cand.bit_length() != bits:
                break
            if is_probable_prime(cand):
                return cand


_PRIME_POOL = None
_POOL_BROKEN = False


def _pool_usable() -> bool:
    """A spawn pool re-imports __main__; a file-less __main__ (REPL,
    stdin) cannot be, so skip the pool there and after any failure."""
    if _POOL_BROKEN:
        return False
    import sys
    main = sys.modules.get("__main__")
    return main is None or hasattr(main, "__file__")


def _prime_pool():
    """Persistent 2-worker spawn pool for concurrent p/q searches
    (CPython's bigint pow holds the GIL).  Workers run host code only."""
    global _PRIME_POOL
    if _PRIME_POOL is None:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        pool = ProcessPoolExecutor(2, mp_context=mp.get_context("spawn"))
        atexit.register(pool.shutdown)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        saved = os.environ.get("PYTHONPATH")
        try:
            os.environ["PYTHONPATH"] = pkg_root
            for f in [pool.submit(int, 0), pool.submit(int, 1)]:
                f.result(timeout=120)
        finally:
            if saved is None:
                os.environ.pop("PYTHONPATH", None)
            else:
                os.environ["PYTHONPATH"] = saved
        _PRIME_POOL = pool
    return _PRIME_POOL


def generate_key_ints(n_length: int = 1024, enable_DJN: bool = True) -> dict:
    """Raw key material as Python ints: p, q of n_length/2 bits with
    n = p*q of exactly n_length bits; DJN adds hs = h^n mod n^2 with
    h = -x^2 mod n and randbits = n_length // 2."""
    global _POOL_BROKEN
    half = n_length // 2
    cfgp = _config.get_config().keygen_parallel
    use_pool = ((cfgp == "1") or (cfgp == "auto" and half >= 1536)) \
        and _pool_usable()
    while True:
        if use_pool:
            try:
                pool = _prime_pool()
                fp = pool.submit(generate_prime, half)
                fq = pool.submit(generate_prime, half)
                p, q = fp.result(), fq.result()
            except (OSError, RuntimeError, EOFError):
                use_pool = False
                _POOL_BROKEN = True
                continue
        else:
            p = generate_prime(half)
            q = generate_prime(half)
        if p == q:
            continue
        n = p * q
        if n.bit_length() == n_length:
            break
    out = {"n": n, "p": p, "q": q, "enable_DJN": enable_DJN, "bits": n_length}
    if enable_DJN:
        nsq = n * n
        x = secrets.randbelow(n - 1) + 1
        h = (-(x * x)) % n
        # hs = h^n mod n^2 through CRT (exponents reduce mod p(p-1), q(q-1))
        psq, qsq = p * p, q * q
        hp = pow(h % psq, n % (p * (p - 1)), psq)
        hq = pow(h % qsq, n % (q * (q - 1)), qsq)
        qinv = pow(qsq, -1, psq)
        out["hs"] = (hq + qsq * ((qinv * (hp - hq)) % psq)) % nsq
        out["randbits"] = half
    return out


# ---------------------------------------------------------------------------
# Public (encryption) context.
# ---------------------------------------------------------------------------

class PublicContext:
    """Device state for one public key: the Montgomery context mod n^2,
    the RNS base/key of n^2, and the lazily built RNS comb table."""

    def __init__(self, n: int, bits: int | None = None,
                 enable_DJN: bool = True, hs: int | None = None,
                 randbits: int | None = None, device=None):
        self.device = resolve(device)
        self.n = n
        self.bits = bits or n.bit_length()
        self.nsquare = n * n
        self.enable_DJN = enable_DJN and hs is not None
        self.hs = hs
        self.randbits = randbits if randbits else (self.bits // 2)
        self.ctx = mg.MontCtx.for_modulus(self.nsquare, device=self.device)
        self.L = self.ctx.num_limbs
        cfg = _config.get_config()
        max_w = (cfg.comb_window_tpu if self.device.type == "cuda"
                 else cfg.comb_window_cpu)
        self.comb_window = _config.choose_comb_window(self.randbits, self.L,
                                                      max_w)
        self.Ln = limbs_for_bits(self.bits)
        self.n_limbs = to_device(int_to_limbs(n, self.Ln)[:, None],
                                 self.device)
        self.n_win_ct = -(-self.bits // WINDOW)
        self._rns = None            # lazy (base, key) of n^2
        self._rns_mul = None        # lazy ct*pt RNS plan (False: none)
        self._comb_rns = None       # lazy (n_win, CH, 2^w) comb states
        self._n_digits = None       # lazy digits of n (plain r^n)
        if self.enable_DJN:
            # shrink the window until the RNS comb fits half the budget
            CH = self.rns_plan()[0].CH
            cap = cfg.comb_hbm_budget_bytes // 2
            w = self.comb_window
            while w > 2 and -(-self.randbits // w) * CH * (1 << w) * 4 > cap:
                w -= 1
            self.comb_window = w

    def rns_plan(self):
        """(RnsBase, RnsModulus) of n^2 for the encrypt engine."""
        _config.require_rns("encrypt_engine")
        return self._rns_base_key()

    def _rns_base_key(self):
        if self._rns is None:
            mbits = _rns_mbits(2 * self.bits + 2)
            base = _rns.RnsBase.for_bits(mbits, self.device)
            self._rns = (base, _rns.RnsModulus.build(base, self.nsquare,
                                                     self.L))
        return self._rns

    def _rns_mul_plan(self):
        """(base, key, window) of the ct*pt RNS engine, or None.  On when
        either engine knob allows RNS and n^2 is within the RNS bound;
        window 4, the JAX package's choice off the TPU, so both packages
        take the same digits."""
        if self._rns_mul is None:
            cfg = _config.get_config()
            ok = (cfg.decrypt_engine in ("auto", "rns")
                  or cfg.encrypt_engine in ("auto", "rns"))
            mbits = -(-(2 * self.bits + 2) // 16) * 16
            self._rns_mul = False
            if ok and mbits <= RNS_MAX_MBITS:
                self._rns_mul = (*self._rns_base_key(), WINDOW)
        return self._rns_mul or None

    @property
    def comb_rns(self) -> torch.Tensor:
        """(n_win, CH, 2^w) int32 states of hs^(d * 2^(w*j)) * M."""
        if self._comb_rns is None:
            if not self.enable_DJN:
                raise ValueError("comb_rns: DJN disabled for this key")
            base, key = self.rns_plan()
            lad = to_device(self._host_pow2_ladder(), self.device)
            self._comb_rns = _build_comb_rns(
                lad, base, key, w=self.comb_window,
                n_win=-(-self.randbits // self.comb_window),
                randbits=self.randbits)
        return self._comb_rns

    @property
    def n_exp_digits(self) -> torch.Tensor:
        """(n_win_ct,) MSB-first 4-bit digits of n (plain r^n)."""
        if self._n_digits is None:
            self._n_digits = torch.from_numpy(mg.exponent_digits(
                [self.n], self.n_win_ct, WINDOW)[:, 0].astype(np.int32)
            ).to(self.device)
        return self._n_digits

    def _host_pow2_ladder(self) -> np.ndarray:
        """(L, randbits) limbs of hs^(2^t) * R mod n^2 (host bigints: a
        sequential one-column chain)."""
        nsq = self.nsquare
        R = 1 << (LIMB_BITS * self.L)
        vals = []
        cur = self.hs % nsq
        for _ in range(self.randbits):
            vals.append(cur * R % nsq)
            cur = cur * cur % nsq
        return ints_to_limbs(vals, self.L)

    # -- encodings host -> device --------------------------------------------

    def transfer_limbs(self, maxbits: int) -> int:
        """Limb rows packed for a batch whose widest encoding has
        `maxbits` bits (power-of-two bucketed; the full Ln under
        fixed_shape_ops)."""
        if _config.get_config().fixed_shape_ops:
            return self.Ln
        Lmin = max(1, limbs_for_bits(maxbits))
        if Lmin <= self.Ln // 2:
            return min(self.Ln, 1 << (Lmin - 1).bit_length())
        return self.Ln

    def encodings_to_device(self, encodings: list,
                            pad_to: int | None = None) -> torch.Tensor:
        """B ints (mod n) -> (Ln, B_pad) canonical limbs on the device;
        small values pack only the limbs they need and zero-extend."""
        B = pad_to or pad_batch(len(encodings))
        Lb = self.transfer_limbs(
            max((int(e).bit_length() for e in encodings), default=1))
        arr = ints_to_limbs(list(encodings) + [0] * (B - len(encodings)), Lb)
        out = torch.zeros((self.Ln, B), dtype=LIMB_DTYPE, device=self.device)
        out[:Lb] = to_device(arr, self.device)
        return out

    def sample_obfuscator_digits(self, b: int) -> np.ndarray:
        """Random DJN exponents r < 2^randbits from OS entropy, as
        (n_win, pad_batch(b)) LSB-first base-2^comb_window digits."""
        B = pad_batch(b)
        w = self.comb_window
        n_win = -(-self.randbits // w)
        rbytes = -(-self.randbits // 8)
        raw = np.frombuffer(secrets.token_bytes(B * rbytes),
                            dtype=np.uint8).reshape(B, rbytes).copy()
        extra = 8 * rbytes - self.randbits
        if extra:
            raw[:, -1] &= (1 << (8 - extra)) - 1
        from .. import native
        digs = native.extract_windows(raw.tobytes(), B, rbytes, w, n_win)
        if digs is None:
            bits = np.unpackbits(raw, axis=1, bitorder="little")
            need = n_win * w
            if bits.shape[1] < need:
                bits = np.pad(bits, ((0, 0), (0, need - bits.shape[1])))
            bits = bits[:, :need].reshape(B, n_win, w).astype(np.uint32)
            digs = (bits << np.arange(w, dtype=np.uint32)).sum(
                axis=2, dtype=np.uint32).T
        return np.ascontiguousarray(digs).astype(np.uint16)

    # -- core ops --------------------------------------------------------------

    def encrypt_raw(self, m_limbs: torch.Tensor) -> torch.Tensor:
        """(1 + m*n) mod n^2 in Montgomery form; m_limbs (Ln, B) < n."""
        return mg.to_mont(_encrypt_raw_canonical(m_limbs, self.n_limbs,
                                                 self.L), self.ctx)

    def _fresh_digits(self, b: int) -> torch.Tensor:
        return torch.from_numpy(self.sample_obfuscator_digits(b).astype(
            np.int32)).to(self.device)

    def obfuscate(self, ct_mont: torch.Tensor) -> torch.Tensor:
        """Multiply in a fresh obfuscator (re-randomization).  DJN: the
        RNS comb chain with fresh digits (K1); plain Paillier: r^n with
        r uniform in [1, n) per column (K4), then one product (K3)."""
        B = ct_mont.shape[1]
        if self.enable_DJN:
            base, key = self.rns_plan()
            return _rns.rns_comb_product(ct_mont, self.comb_rns,
                                         self._fresh_digits(B), base, key,
                                         self.ctx, self.L, mont_input=True)
        rs = [secrets.randbelow(self.n - 1) + 1 for _ in range(B)]
        r_m = mg.to_mont(to_device(ints_to_limbs(rs, self.L), self.device),
                         self.ctx)
        obf = mg.mont_exp(r_m, self.n_exp_digits[:, None].expand(
            self.n_win_ct, B), self.ctx, window=WINDOW)
        return mg.mont_mul(ct_mont, obf, self.ctx)

    def encrypt(self, encodings: list, apply_obfuscator: bool = True,
                pad_to: int | None = None) -> torch.Tensor:
        """Encodings (ints mod n) -> Montgomery ciphertexts (L, B_pad).
        DJN obfuscation takes the RNS comb route; a plain-Paillier key
        encrypts raw and then obfuscates with r^n."""
        m = self.encodings_to_device(encodings, pad_to)
        if apply_obfuscator and self.enable_DJN:
            base, key = self.rns_plan()
            raw = _encrypt_raw_canonical(m, self.n_limbs, self.L)
            return _rns.rns_comb_product(raw, self.comb_rns,
                                         self._fresh_digits(m.shape[1]),
                                         base, key, self.ctx, self.L)
        ct = self.encrypt_raw(m)
        if apply_obfuscator:
            ct = self.obfuscate(ct)
        return ct

    def add_ct(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """HE addition: ciphertext product mod n^2 (kernel K3)."""
        return mg.mont_mul(a, b, self.ctx)

    def mul_pt(self, ct: torch.Tensor, exponents: list) -> torch.Tensor:
        """HE ct*pt: ct^e per column, exponents >= 0.

        RNS route (kernel K5) when the plan is on and the widest exponent
        needs 8 or more 4-bit windows: the window count is bucketed to
        max(4, next power of two), capped at ceil(bits/4).  Limb route
        (kernel K4) otherwise, with the leading all-zero windows skipped.
        Under fixed_shape_ops both run the full mod-n window count and
        every exponent takes the RNS route when the plan is on."""
        B = ct.shape[1]
        exps = list(exponents) + [0] * (B - len(exponents))
        fixed = _config.get_config().fixed_shape_ops
        maxbits = max((int(e).bit_length() for e in exps), default=1)
        rplan = self._rns_mul_plan()
        if rplan is not None and not fixed and -(-maxbits // WINDOW) < 8:
            rplan = None
        if rplan is not None:
            base, key, w = rplan
            nw_full = -(-self.bits // w)
            needed = max(1, -(-maxbits // w))
            nw = nw_full if fixed else min(
                nw_full, max(4, 1 << max(0, needed - 1).bit_length()))
            digits = mg.exponent_digits(exps, nw, w)
            return _rns.rns_pow_elem(ct, digits, base, key, self.ctx, w,
                                     self.L)
        n_win_needed = (self.n_win_ct if fixed
                        else max(1, -(-maxbits // WINDOW)))
        n_win_total = max(self.n_win_ct, n_win_needed)
        digits = mg.exponent_digits(exps, n_win_total, WINDOW)
        return mg.mont_exp(ct, digits, self.ctx, window=WINDOW,
                           win_start=n_win_total - n_win_needed)

    def gather_batch(self, ct: torch.Tensor, idx) -> torch.Tensor:
        """out[:, j] = ct[:, idx[j]], padded to pad_batch(len(idx))."""
        full = np.zeros(pad_batch(len(idx)), dtype=np.int64)
        full[:len(idx)] = np.asarray(idx, dtype=np.int64)
        return torch.index_select(ct, 1, torch.from_numpy(full).to(ct.device))

    def tree_reduce(self, ct: torch.Tensor, b: int) -> torch.Tensor:
        """HE sum of the first b ciphertexts, total in column 0."""
        return self.segment_tree_reduce(ct, 1, b)

    def segment_tree_reduce(self, ct: torch.Tensor, groups: int,
                            seg: int) -> torch.Tensor:
        """HE sums of `groups` contiguous segments of length `seg`;
        returns (L, pad_batch(groups)) with the group sums in order."""
        return _segment_tree_reduce(ct, self.ctx, groups, seg, self.L)

    def export_cts(self, ct_mont: torch.Tensor, b: int) -> list:
        """Montgomery ciphertexts -> canonical Python ints."""
        return limbs_to_ints(mg.from_mont(ct_mont, self.ctx))[:b]

    def import_cts(self, cts: list) -> torch.Tensor:
        """Canonical ciphertext ints -> Montgomery tensor (padding with 1,
        a valid encryption of 0)."""
        B = pad_batch(len(cts))
        arr = ints_to_limbs(list(cts) + [1] * (B - len(cts)), self.L)
        return mg.to_mont(to_device(arr, self.device), self.ctx)


def _build_comb_rns(lad_pos, base, key, *, w, n_win, randbits):
    """Native RNS comb build: ladder (L, randbits) of hs^(2^t)*R ->
    (n_win, CH, 2^w) states of hs^(d*2^(w*j)) * M.  Entries [2^b, 2^(b+1))
    of every window are one batched RNS product (kernel K1 on CUDA) of
    the entries built so far with ladder column w*j+b."""
    CH = base.CH
    lad = _rns.rns_enter(lad_pos, base, key)            # (CH, randbits)
    one = key.one_ch.to(LIMB_DTYPE)                     # (CH, 1)
    pad_cols = n_win * w - randbits                     # identity bits
    if pad_cols:
        lad = torch.cat([lad, one.expand(CH, pad_cols)], dim=1)
    lad = lad.reshape(CH, n_win, w)
    T = torch.stack([one.expand(CH, n_win), lad[:, :, 0]], dim=2)
    for b in range(1, w):
        half = 1 << b
        lad_b = lad[:, :, b:b + 1].expand(CH, n_win, half)
        blk = _rk.rns_mul(T.reshape(CH, n_win * half),
                          lad_b.reshape(CH, n_win * half), base, key)
        T = torch.cat([T, blk.reshape(CH, n_win, half)], dim=2)
    return T.permute(1, 0, 2).contiguous()              # (n_win, CH, 2^w)


def _segment_tree_reduce(ct, ctx, groups, seg, L):
    """HE sums over `groups` contiguous segments of length `seg`: pad each
    to a power of two with the Montgomery one, then log2 folding rounds,
    each one product (kernel K3) of the upper half into the lower."""
    P = 1 << max(0, (seg - 1).bit_length())
    one = ctx.one.to(LIMB_DTYPE)
    if seg == P and groups * P == ct.shape[1]:
        arr = ct
    else:
        arr = one.expand(L, groups * P).clone()
        dst = np.concatenate([np.arange(g * P, g * P + seg)
                              for g in range(groups)])
        dst_t = torch.from_numpy(dst).to(ct.device)
        arr[:, dst_t] = ct[:, :groups * seg]
    width = P
    while width > 1:
        half = width // 2
        a3 = arr.reshape(L, groups, width)
        lo = a3[:, :, :half].reshape(L, groups * half)
        hi = a3[:, :, half:].reshape(L, groups * half)
        arr = mg.mont_mul(lo, hi, ctx)
        width = half
    out = one.expand(L, pad_batch(groups)).clone()
    out[:, :groups] = arr[:, :groups]
    return out


def _encrypt_raw_canonical(m_limbs, n_limbs, L):
    """(1 + m*n) mod n^2 as canonical limbs (the RNS encrypt input)."""
    mn = big_mul(m_limbs, n_limbs, out_limbs=L).to(torch.int64)
    mn[0] += 1
    return normalize(mn)


# ---------------------------------------------------------------------------
# Private (decryption) context: CRT decrypt.
# ---------------------------------------------------------------------------

class PrivateContext:
    """CRT decryption for one key, on the public context's device.  The
    stage-2 engine is read from ``decrypt_engine`` when the context is
    built: "auto"/"rns" the RNS chain (K2), anything else the limb
    shared-exponent modexp (K7)."""

    def __init__(self, pub: PublicContext, p: int, q: int):
        if p * q != pub.n:
            raise ValueError("PrivateContext: p*q != n")
        self.pub = pub
        self.p, self.q = p, q
        dev = pub.device
        n = pub.n
        self.Lh = limbs_for_bits(max((p * p).bit_length(),
                                     (q * q).bit_length()) + 2)
        self.Lq = limbs_for_bits(max(p.bit_length(), q.bit_length()) + 2)
        Lh, Lq = self.Lh, self.Lq
        psq, qsq = p * p, q * q
        Rh = 1 << (LIMB_BITS * Lh)
        Rq = 1 << (LIMB_BITS * Lq)
        g = n + 1
        self.hp = pow((pow(g, p - 1, psq) - 1) // p, -1, p)
        self.hq = pow((pow(g, q - 1, qsq) - 1) // q, -1, q)
        self.pinv_mod_q = pow(p, -1, q)
        self._p_ctx = mg.MontCtx.for_modulus(p, min_bits=LIMB_BITS * Lq,
                                             device=dev)
        self._q_ctx = mg.MontCtx.for_modulus(q, min_bits=LIMB_BITS * Lq,
                                             device=dev)
        self._sq_p = mg.MontCtx.for_modulus(psq, min_bits=LIMB_BITS * Lh,
                                            device=dev)
        self._sq_q = mg.MontCtx.for_modulus(qsq, min_bits=LIMB_BITS * Lh,
                                            device=dev)
        ebits = max((p - 1).bit_length(), (q - 1).bit_length())
        # limb engine: shared-exponent digits of p-1, q-1 at the window of
        # the JAX package's plan (5 at Lh=129)
        self.dec_window = (_m3.shared_exp_window(Lh)
                           if self._sq_p.wmu is not None else 5)
        digd = mg.exponent_digits([p - 1, q - 1],
                                  -(-ebits // self.dec_window),
                                  self.dec_window)
        self.dig_p = np.ascontiguousarray(digd[:, 0].astype(np.int32))
        self.dig_q = np.ascontiguousarray(digd[:, 1].astype(np.int32))
        self.use_rns = _config.get_config().decrypt_engine in ("auto", "rns")
        if self.use_rns:
            self.rns_base = _rns.RnsBase.for_bits(
                _rns_mbits(max(psq.bit_length(), qsq.bit_length())), dev)
            self.rns_p = _rns.RnsModulus.build(self.rns_base, psq, Lh)
            self.rns_q = _rns.RnsModulus.build(self.rns_base, qsq, Lh)
            self.rns_sched_window = _rk.plan_sched(self.rns_base.CH)
            self.rsched_p = _rns.sliding_schedule(
                p - 1, self.rns_sched_window, ebits)
            self.rsched_q = _rns.sliding_schedule(
                q - 1, self.rns_sched_window, ebits)
        # stage 1: residue planes of 2^(16l) mod p^2 / q^2 and the folded
        # constant F2 = R_h^2 * 2^32 * R_n2^-1
        Rn2 = 1 << (LIMB_BITS * pub.L)
        t64 = lambda a: torch.from_numpy(a.astype(np.int64)).to(dev)
        self.Cp_lo, self.Cp_hi = map(t64, _rns._residue_planes_np(
            psq, Lh, pub.L))
        self.Cq_lo, self.Cq_hi = map(t64, _rns._residue_planes_np(
            qsq, Lh, pub.L))
        col = lambda v, L: to_device(int_to_limbs(v, L)[:, None], dev)
        self.f2_p = col(pow(Rh, 2, psq) * pow(2, 32, psq) % psq
                        * pow(Rn2, -1, psq) % psq, Lh)
        self.f2_q = col(pow(Rh, 2, qsq) * pow(2, 32, qsq) % qsq
                        * pow(Rn2, -1, qsq) % qsq, Lh)
        # stage 3: exact-division inverses and Montgomery-form multipliers
        self.pinv_R = col(pow(p, -1, Rq), Lq)
        self.qinv_R = col(pow(q, -1, Rq), Lq)
        self.hpR = col(self.hp * Rq % p, Lq)
        self.hqR = col(self.hq * Rq % q, Lq)
        self.pinvqR = col(self.pinv_mod_q * Rq % q, Lq)
        self.p_limbs = col(p, Lq)
        self.q_limbs = col(q, Lq)

    def decrypt_to_ints(self, ct_mont: torch.Tensor, b: int) -> list:
        """Montgomery ciphertexts mod n^2 -> plaintext ints."""
        return limbs_to_ints(self.decrypt_device(ct_mont))[:b]

    def decrypt_device(self, ct_mont: torch.Tensor) -> torch.Tensor:
        """Montgomery ciphertexts mod n^2 -> canonical plaintext limbs
        (Ln, B) on the device."""
        B = ct_mont.shape[1]
        base_m = _crt_stage_reduce(ct_mont, self)
        if self.use_rns:
            u_p = _rns.rns_crt_exp_sched(base_m[:, :B], self.rsched_p,
                                         self.rns_base, self.rns_p,
                                         self._sq_p, self.rns_sched_window,
                                         self.Lh)
            u_q = _rns.rns_crt_exp_sched(base_m[:, B:], self.rsched_q,
                                         self.rns_base, self.rns_q,
                                         self._sq_q, self.rns_sched_window,
                                         self.Lh)
        elif self._sq_p.wmu is not None:
            u_p = _crt_stage_exp_half(base_m[:, :B], self._sq_p, self.dig_p,
                                      self.dec_window)
            u_q = _crt_stage_exp_half(base_m[:, B:], self._sq_q, self.dig_q,
                                      self.dec_window)
        else:
            raise NotImplementedError(
                "decrypt_engine='limb' on a context without mm3 weights "
                "needs the per-element-moduli modexp (MontCtx.for_moduli, "
                "kernels K9/K10), still to be ported (ROADMAP.md)")
        return _crt_stage_recombine(torch.cat([u_p, u_q], dim=1), self)


def _crt_stage_reduce(ct_mont, s: PrivateContext):
    """Stage 1: the Montgomery-form mod-n^2 ciphertext X = c*R_n2 into
    the p^2 and q^2 domains: residue fold (V = X mod m, V < m*2^25), a
    2-step short REDC (X*2^-32, < 1.02m), one product by F2 -> c*R_h."""
    B = ct_mont.shape[1]

    def half(C_lo, C_hi, sq, f2):
        v = _rns.residue_fold_limbs(ct_mont, C_lo, C_hi, s.Lh)
        w = mg.mont_reduce_wide(v, sq, iters=2)
        return mg.mont_mul(w, f2.expand(s.Lh, B), sq)

    return torch.cat([half(s.Cp_lo, s.Cp_hi, s._sq_p, s.f2_p),
                      half(s.Cq_lo, s.Cq_hi, s._sq_q, s.f2_q)], dim=1)


def _crt_stage_exp_half(base_m, sq_ctx, digits, window):
    """Stage 2 of the limb engine, one prime's half: the shared-exponent
    modexp (kernel K7 on CUDA) and the Montgomery exit (canonical)."""
    u = mg.mont_exp_shared(base_m, digits, sq_ctx, window=window)
    return mg.from_mont(u, sq_ctx)


def _crt_stage_recombine(u, s: PrivateContext):
    """Stage 3: L-function by exact Hensel division, the h-multiplies and
    Garner recombination m = m_p + p*((m_q - m_p) * p^-1 mod q)."""
    Lh, Lq, Ln = s.Lh, s.Lq, s.pub.Ln
    B = u.shape[1] // 2
    one_arr = torch.zeros((Lh, 1), dtype=LIMB_DTYPE, device=u.device)
    one_arr[0, 0] = 1
    um1 = sub_mod_base(u, one_arr)
    dinv = torch.cat([s.pinv_R.expand(Lq, B), s.qinv_R.expand(Lq, B)], dim=1)
    t = exact_div(um1, dinv, Lq)                        # (Lq, 2B)
    mp = cond_sub(mg.mont_mul(t[:, :B], s.hpR.expand(Lq, B), s._p_ctx),
                  s.p_limbs)
    mq = cond_sub(mg.mont_mul(t[:, B:], s.hqR.expand(Lq, B), s._q_ctx),
                  s.q_limbs)
    mp_mod_q = cond_sub(mp, s.q_limbs)                  # m_p < p < 2q
    q_minus = sub_mod_base(s.q_limbs.expand(Lq, B), mp_mod_q)
    diff = cond_sub(normalize(mq.to(torch.int64) + q_minus.to(torch.int64)),
                    s.q_limbs)
    u2 = cond_sub(mg.mont_mul(diff, s.pinvqR, s._q_ctx), s.q_limbs)
    pu = big_mul(u2, s.p_limbs, out_limbs=Ln).to(torch.int64)
    pu[:Lq] += mp.to(torch.int64)
    return normalize(pu)                                # < n


# ---------------------------------------------------------------------------
# State carried across from the JAX package.
# ---------------------------------------------------------------------------

_MONT_FIELDS = ("n_limbs", "n0inv", "r2", "one", "wmu", "wm", "off1", "off2")
_PRIV_LIMBS = ("f2_p", "f2_q", "pinv_R", "qinv_R", "hpR", "hqR", "pinvqR",
               "p_limbs", "q_limbs")
_PRIV_PLANES = ("Cp_lo", "Cp_hi", "Cq_lo", "Cq_hi")


def from_jax_state(state: dict, device=None):
    """Build (PublicContext, PrivateContext) from the JAX package's
    per-key arrays, given as numpy arrays, so both packages compute from
    identical constants.

    state = {"n", "p", "q", "hs", "randbits", "bits": ints,
             "pub": {"ctx": {MontCtx leaves}, "rns_key": {RnsModulus
                     vectors}, "rns_pack": pack() bundle, "comb_window",
                     "comb_rns" (optional)},
             "priv": {"sq_p", "sq_q", "p_ctx", "q_ctx": {MontCtx leaves},
                      "rns_p", "rns_q": {RnsModulus vectors},
                      "pack_p", "pack_q": pack() bundles,
                      "rsched_p", "rsched_q", "rns_sched_window",
                      Cp_lo..Cq_hi, f2_p, ..., q_limbs,
                      "dec_window", "dig_p", "dig_q" (optional)}}
    The port's host builders run first; every array given replaces the
    one they made.  The RNS fields are read when the private context
    uses the RNS engine."""
    dev = resolve(device)
    pd, vd = state["pub"], state["priv"]
    pub = PublicContext(state["n"], state["bits"], True, state["hs"],
                        state["randbits"], device=dev)
    mont = lambda d: mg.MontCtx.from_arrays(
        {f: d.get(f) for f in _MONT_FIELDS}, dev)
    pub.ctx = mont(pd["ctx"])
    pub.comb_window = int(pd["comb_window"])
    base, _ = pub.rns_plan()
    pub._rns = (base, _rns.RnsModulus.from_arrays(
        pub.nsquare, pd["rns_key"], dev, packed=pd["rns_pack"]))
    if pd.get("comb_rns") is not None:
        pub._comb_rns = to_device(pd["comb_rns"], dev)
    priv = PrivateContext(pub, state["p"], state["q"])
    for f in ("sq_p", "sq_q", "p_ctx", "q_ctx"):
        setattr(priv, "_" + f, mont(vd[f]))
    if priv.use_rns:
        priv.rns_p = _rns.RnsModulus.from_arrays(
            priv.p * priv.p, vd["rns_p"], dev, packed=vd["pack_p"])
        priv.rns_q = _rns.RnsModulus.from_arrays(
            priv.q * priv.q, vd["rns_q"], dev, packed=vd["pack_q"])
        priv.rns_sched_window = int(vd["rns_sched_window"])
        priv.rsched_p = np.asarray(vd["rsched_p"], dtype=np.int32)
        priv.rsched_q = np.asarray(vd["rsched_q"], dtype=np.int32)
    if vd.get("dec_window") is not None:
        priv.dec_window = int(vd["dec_window"])
    for f in ("dig_p", "dig_q"):
        if vd.get(f) is not None:
            setattr(priv, f, np.asarray(vd[f], dtype=np.int32).reshape(-1))
    for f in _PRIV_PLANES:
        setattr(priv, f, torch.from_numpy(
            np.asarray(vd[f]).astype(np.int64)).to(dev))
    for f in _PRIV_LIMBS:
        setattr(priv, f, to_device(vd[f], dev))
    return pub, priv
