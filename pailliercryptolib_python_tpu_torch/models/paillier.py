"""Paillier / DJN scheme layer: keygen, the public context (encrypt,
re-randomization, HE add, sum, ct*pt) and the private context (CRT
decrypt), on torch tensors.

Counterpart of ``pailliercryptolib_python_tpu/models/paillier.py``.
Keygen sieves on the host; the base-2 Miller-Rabin round runs on the
host or, with ``keygen_device``, over all survivors of a window at once
on the device (``device_mr_base2``: kernels K10 and K9).  DJN encryption
and re-randomization take the RNS comb (kernel K1 per window on CUDA) or
the limb comb (``encrypt_engine="limb"``, and every key past the RNS
bound: one K3 or K9 product per window); a plain-Paillier key multiplies
by r^n (K4, or K10 without mm3 weights).  ct*pt runs the per-element RNS
chain (K5) for exponents of 8 or more 4-bit windows, the limb modexp (K4
or K10) below; the exponent alignment raises the shifted columns to 2^d
by d squarings (K16).  Decryption reduces into the p^2/q^2 domains (stage 1),
exponentiates (stage 2: per CRT half the RNS sliding-window chain K2 or,
with ``decrypt_engine="limb"``, the shared-exponent limb modexp K7; on
contexts without mm3 weights the fused per-element chain over
[p^2]*B ++ [q^2]*B, K10) and recombines (stage 3).  Every shared-modulus
product is K3 (K9 without weights).  The private context also carries the
fixed-window RNS digits (``rdig_p``, ``rdig_q``) for
``rns.rns_crt_exp_half`` (K6).  The comb tables of all live keys are held
under ``comb_hbm_budget_bytes`` by ``utils.config.comb_registry``.

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
from .. import kernels
from ..ops.limb import (LIMB_BITS, LIMB_DTYPE, big_mul, cond_sub, h2d,
                        int_to_limbs, ints_to_limbs, limbs_for_bits,
                        limbs_to_ints, normalize, sub_mod_base, to_device)
from ..ops import mont3 as _m3
from ..ops import montgomery as mg
from ..ops import rns as _rns
from ..ops import rns_kernels as _rk
from ..ops.reduction import exact_div, tree_fold
from ..utils import config as _config
from ..utils import profiling
from ..utils.profiling import annotate

WINDOW = 4          # per-element modexp window (ct*pt)
RNS_MAX_MBITS = 14000


def pad_batch(b: int) -> int:
    """Batch padding granularity (8 below 128 columns, then 128)."""
    if b <= 8:
        return 8
    step = 8 if b < 128 else 128
    return -(-b // step) * step


def _rns_mbits(bits: int) -> int | None:
    """RNS base size for a modulus of `bits` bits (rounded to 16 so keys
    share cached bases), or None past the engine's channel-count bound."""
    mbits = -(-bits // 16) * 16
    return mbits if mbits <= RNS_MAX_MBITS else None


# ---------------------------------------------------------------------------
# Keygen: OS entropy, native trial-division sieve, Miller-Rabin (host, or
# the base-2 round device-batched).
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


def device_mr_base2(cands: list, device=None) -> np.ndarray:
    """One base-2 Miller-Rabin round for a batch of odd candidates on the
    device: bool[len(cands)], True iff 2^d == +-1 or a square of it
    reaches c-1 (d = (c-1)/2^tz).  Each candidate is its own modulus
    (``MontCtx.for_moduli``): one per-element modexp chain (K10) for
    every 2^d, then the squaring ladder (K9) with per-column masks.
    Padding columns repeat the last candidate and are dropped."""
    dev = resolve(device)
    B = len(cands)
    bits = max(int(c).bit_length() for c in cands)
    Bp = pad_batch(B)
    cands_p = list(cands) + [cands[-1]] * (Bp - B)
    L = limbs_for_bits(bits + 2)
    ctx = mg.MontCtx.for_moduli(cands_p, L, dev)
    tz = np.array([((c - 1) & -(c - 1)).bit_length() - 1
                   for c in cands_p], dtype=np.int32)
    ds = [(c - 1) >> int(t) for c, t in zip(cands_p, tz)]
    digits = mg.exponent_digits(ds, max(1, -(-bits // WINDOW)), WINDOW)
    limbs = lambda vals: to_device(ints_to_limbs(vals, L), dev)
    x = mg.mont_exp(mg.to_mont(limbs([2] * Bp), ctx), digits, ctx,
                    window=WINDOW)
    one = limbs([1] * Bp)
    nm1 = limbs([c - 1 for c in cands_p])
    tz_dev = torch.from_numpy(tz).to(dev)
    eq = lambda a, b: (a == b).all(dim=0)
    xc = mg.from_mont(x, ctx)
    ok = eq(xc, one) | eq(xc, nm1)
    for i in range(1, int(tz.max())):
        x = mg.mont_mul(x, x, ctx)
        ok = ok | (eq(mg.from_mont(x, ctx), nm1) & (i < tz_dev))
    return ok.cpu().numpy()[:B]


def _primes_from_window(base: int, mask, bits: int, bulk: bool,
                        device=None) -> int | None:
    """First prime among the sieve survivors of one window, or None.
    bulk: the base-2 round for all survivors at once (device_mr_base2),
    then the host rounds for those that pass."""
    cands = []
    for j in range(len(mask)):
        if not mask[j]:
            continue
        cand = base + 2 * j
        if cand.bit_length() != bits:
            break
        cands.append(cand)
    if not cands:
        return None
    if bulk:
        passed = device_mr_base2(cands, device)
        cands = [c for c, ok in zip(cands, passed) if ok]
    for c in cands:
        if is_probable_prime(c):
            return c
    return None


def generate_prime(bits: int, device=None) -> int:
    """Random `bits`-bit prime: windowed sieve + Miller-Rabin.  The
    base-2 round runs device-batched (device_mr_base2 on `device`) when
    keygen_device is "1", or "auto" on a CUDA device at >= 1024 bits."""
    from .. import native
    cfg = _config.get_config().keygen_device
    bulk = cfg == "1" or (cfg == "auto" and resolve(device).type == "cuda"
                          and bits >= 1024)
    window = 2048
    while True:
        base = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        mask = native.sieve_window(base, window, _SMALL_PRIMES)
        got = _primes_from_window(base, mask, bits, bulk, device)
        if got is not None:
            return got


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


def _prime_worker_init() -> None:
    """Pool workers never open the card: the port's default device is
    the CPU there, so a worker's bulk base-2 round runs the plain twins."""
    from ..device import set_device
    set_device("cpu")


def _prime_pool():
    """Persistent 2-worker spawn pool for concurrent p/q searches
    (CPython's bigint pow holds the GIL).  Workers run on the CPU only."""
    global _PRIME_POOL
    if _PRIME_POOL is None:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        pool = ProcessPoolExecutor(2, mp_context=mp.get_context("spawn"),
                                   initializer=_prime_worker_init)
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


def generate_key_ints(n_length: int = 1024, enable_DJN: bool = True,
                      device=None) -> dict:
    """Raw key material as Python ints: p, q of n_length/2 bits with
    n = p*q of exactly n_length bits; DJN adds hs = h^n mod n^2 with
    h = -x^2 mod n and randbits = n_length // 2.  A serial search runs
    its device-batched base-2 round (keygen_device) on `device`; pool
    workers run theirs on the CPU."""
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
            p = generate_prime(half, device)
            q = generate_prime(half, device)
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
        # hs = h^n mod n^2 through CRT (exponents reduce mod p(p-1),
        # q(q-1)): two half-width pows, run side by side in the pool when
        # the primes came from it, serially if the pool raises
        psq, qsq = p * p, q * q
        args_p = (h % psq, n % (p * (p - 1)), psq)
        args_q = (h % qsq, n % (q * (q - 1)), qsq)
        if use_pool:
            try:
                pool = _prime_pool()
                fp = pool.submit(pow, *args_p)
                fq = pool.submit(pow, *args_q)
                hp, hq = fp.result(), fq.result()
            except (OSError, RuntimeError, EOFError):
                hp, hq = pow(*args_p), pow(*args_q)
        else:
            hp, hq = pow(*args_p), pow(*args_q)
        qinv = pow(qsq, -1, psq)
        out["hs"] = (hq + qsq * ((qinv * (hp - hq)) % psq)) % nsq
        out["randbits"] = half
    return out


# ---------------------------------------------------------------------------
# Public (encryption) context.
# ---------------------------------------------------------------------------

class PublicContext:
    """Device state for one public key: the Montgomery context mod n^2,
    the RNS base/key of n^2, and the lazily built comb tables of the two
    encrypt engines (the RNS comb, the limb comb).

    The engine is chosen per call (``_rns_enc_plan``): RNS unless
    ``encrypt_engine="limb"``, n^2 is past the RNS bound, or the RNS comb
    exceeds half of ``comb_hbm_budget_bytes``.  One deliberate difference
    from the JAX package: its "auto" takes the limb comb on its CPU
    backend (a host-speed heuristic); here "auto" is RNS on every device,
    so CPU and CUDA runs take the same route."""

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
        self._comb = None           # lazy (n_win, L, 2^w) limb comb
        self._n_digits = None       # lazy digits of n (plain r^n)
        if (self.enable_DJN and cfg.encrypt_engine != "limb"
                and self.rns_plan() is not None):
            # the RNS engine carries this key: shrink the window until
            # the RNS comb fits half the budget
            CH = self.rns_plan()[0].CH
            cap = cfg.comb_hbm_budget_bytes // 2
            w = self.comb_window
            while w > 2 and -(-self.randbits // w) * CH * (1 << w) * 4 > cap:
                w -= 1
            self.comb_window = w

    def rns_plan(self):
        """(RnsBase, RnsModulus) of n^2, or None past the RNS bound."""
        if _rns_mbits(2 * self.bits + 2) is None:
            return None
        return self._rns_base_key()

    def _rns_enc_plan(self):
        """(base, key) of the RNS encrypt engine, or None for the limb
        comb: encrypt_engine="limb", n^2 past the RNS bound (no ct*pt
        plan), or an RNS comb over half of comb_hbm_budget_bytes."""
        cfg = _config.get_config()
        if cfg.encrypt_engine == "limb":
            return None
        plan = self._rns_mul_plan()
        if plan is None:
            return None
        n_win = -(-self.randbits // self.comb_window)
        if n_win * plan[0].CH * (1 << self.comb_window) * 4 \
                > cfg.comb_hbm_budget_bytes // 2:
            return None
        return plan[0], plan[1]

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
            self._rns_mul = False
            if ok and self.rns_plan() is not None:
                self._rns_mul = (*self._rns_base_key(), WINDOW)
        return self._rns_mul or None

    @property
    def comb_rns(self) -> torch.Tensor:
        """(n_win, CH, 2^w) int32 states of hs^(d * 2^(w*j)) * M."""
        if self._comb_rns is None:
            if not self.enable_DJN:
                raise ValueError("comb_rns: DJN disabled for this key")
            if self.rns_plan() is None:
                raise ValueError("comb_rns: n^2 is past the RNS bound")
            base, key = self.rns_plan()
            lad = to_device(self._host_pow2_ladder(), self.device)
            self._comb_rns = _build_comb_rns(
                lad, base, key, w=self.comb_window,
                n_win=-(-self.randbits // self.comb_window),
                randbits=self.randbits)
            self._register_tables()
        else:
            _config.comb_registry.touch(self)
        return self._comb_rns

    @property
    def comb_table(self) -> torch.Tensor:
        """(n_win, L, 2^w) limb comb of the limb encrypt engine:
        T[j][d] = hs^(d * 2^(w*j)) * R mod n^2, built on the device from
        the host pow2 ladder (products K3, or K9 without weights)."""
        if self._comb is None:
            if not self.enable_DJN:
                raise ValueError("comb_table: DJN disabled for this key")
            lad = to_device(self._host_pow2_ladder().T[:, :, None],
                            self.device)            # (randbits, L, 1)
            self._comb = mg.build_comb_table(lad, self.ctx,
                                             self.comb_window)
            self._register_tables()
        else:
            _config.comb_registry.touch(self)
        return self._comb

    def _register_tables(self) -> None:
        """(Re-)register the bytes of the comb tables that exist now (the
        limb comb, the RNS comb or both) with the LRU registry, which may
        tell less recently used keys to drop theirs."""
        total = sum(t.numel() * t.element_size()
                    for t in (self._comb, self._comb_rns) if t is not None)
        if total:
            _config.comb_registry.register(self, total)

    def _drop_comb(self) -> None:
        """Drop both comb tables (the registry's eviction; rebuilt at
        next use)."""
        self._comb = None
        self._comb_rns = None

    def free(self) -> None:
        """Retire the key: drop its comb tables and leave the registry."""
        self._drop_comb()
        _config.comb_registry.unregister(self)

    @property
    def n_exp_digits(self) -> np.ndarray:
        """(n_win_ct,) MSB-first 4-bit digits of n (plain r^n), host."""
        if self._n_digits is None:
            self._n_digits = np.ascontiguousarray(mg.exponent_digits(
                [self.n], self.n_win_ct, WINDOW)[:, 0].astype(np.int32))
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
        with annotate("pct.paillier.pack"):
            B = pad_to or pad_batch(len(encodings))
            Lb = self.transfer_limbs(
                max((int(e).bit_length() for e in encodings), default=1))
            arr = ints_to_limbs(
                list(encodings) + [0] * (B - len(encodings)), Lb)
            out = torch.zeros((self.Ln, B), dtype=LIMB_DTYPE,
                              device=self.device)
            out[:Lb] = to_device(arr, self.device)
            return out

    def sample_obfuscator_digits(self, b: int) -> np.ndarray:
        """Random DJN exponents r < 2^randbits from OS entropy, as
        (n_win, pad_batch(b)) LSB-first base-2^comb_window digits."""
        with annotate("pct.paillier.entropy"):
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

    def _dev_digits(self, digits: np.ndarray) -> torch.Tensor:
        return to_device(digits, self.device)

    def obfuscate(self, ct_mont: torch.Tensor) -> torch.Tensor:
        """Multiply in a fresh obfuscator (re-randomization).  DJN: the
        comb chain with fresh digits (RNS: K1; limb: K3/K9); plain
        Paillier: r^n with r uniform in [1, n) per column (K4/K10), then
        one product."""
        B = ct_mont.shape[1]
        if self.enable_DJN:
            digits = self.sample_obfuscator_digits(B)
            plan = self._rns_enc_plan()
            with annotate("pct.paillier.comb"):
                if plan is None:
                    return _obfuscate_djn(ct_mont, digits, self.comb_table,
                                          self.ctx)
                base, key = plan
                return _rns.rns_comb_product(
                    ct_mont, self.comb_rns, self._dev_digits(digits), base,
                    key, self.ctx, self.L, mont_input=True)
        rs = [secrets.randbelow(self.n - 1) + 1 for _ in range(B)]
        r_m = mg.to_mont(to_device(ints_to_limbs(rs, self.L), self.device),
                         self.ctx)
        obf = mg.mont_exp(r_m, np.broadcast_to(self.n_exp_digits[:, None],
                                               (self.n_win_ct, B)),
                          self.ctx, window=WINDOW)
        return mg.mont_mul(ct_mont, obf, self.ctx)

    def encrypt(self, encodings: list, apply_obfuscator: bool = True,
                pad_to: int | None = None) -> torch.Tensor:
        """Encodings (ints mod n) -> Montgomery ciphertexts (L, B_pad).
        DJN obfuscation takes the RNS comb or the limb comb
        (``_rns_enc_plan``); a plain-Paillier key encrypts raw and then
        obfuscates with r^n.  The device work is only enqueued (host
        arrays go up through pinned memory, nothing is read back), so a
        caller that chunks a batch overlaps the next chunk's host stage
        with this chunk's device stage."""
        m = self.encodings_to_device(encodings, pad_to)
        if apply_obfuscator and self.enable_DJN:
            digits = self.sample_obfuscator_digits(m.shape[1])
            plan = self._rns_enc_plan()
            with annotate("pct.paillier.comb"):
                if plan is None:
                    return _encrypt_djn(m, digits, self.comb_table,
                                        self.n_limbs, self.ctx, self.L)
                base, key = plan
                raw = _encrypt_raw_canonical(m, self.n_limbs, self.L)
                return _rns.rns_comb_product(raw, self.comb_rns,
                                             self._dev_digits(digits),
                                             base, key, self.ctx, self.L)
        ct = self.encrypt_raw(m)
        if apply_obfuscator:
            ct = self.obfuscate(ct)
        return ct

    def host_encrypt(self, encodings: list,
                     apply_obfuscator: bool = True) -> list:
        """Encrypt on the host with Python bigints: canonical ciphertext
        ints, the same scheme as the device path with fresh obfuscators
        from OS entropy.  The host leg of the hybrid split
        (``api._hybrid_split_encrypt``), run in a worker thread while the
        device encrypts the rest of the batch."""
        nsq = self.nsquare
        out = []
        for m in encodings:
            c = (1 + int(m) * self.n) % nsq
            if apply_obfuscator:
                if self.enable_DJN:
                    r = secrets.randbits(self.randbits)
                    c = c * pow(self.hs, r, nsq) % nsq
                else:
                    r = secrets.randbelow(self.n - 1) + 1
                    c = c * pow(r, self.n, nsq) % nsq
            out.append(c)
        return out

    def add_ct(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """HE addition: ciphertext product mod n^2 (kernel K3)."""
        with annotate("pct.paillier.add"):
            return mg.mont_mul(a, b, self.ctx)

    def mul_pt(self, ct: torch.Tensor, exponents: list, *,
               full: bool | None = None) -> torch.Tensor:
        """HE ct*pt: ct^e per column, exponents >= 0.

        RNS route (kernel K5) when the plan is on and the widest exponent
        needs 8 or more 4-bit windows: the window count is bucketed to
        max(4, next power of two), capped at ceil(bits/4).  Limb route
        (kernel K4, K10 without mm3 weights) otherwise, over the
        ceil(maxbits/4) windows the widest exponent needs.  Either way
        the host builds and uploads digits for the windows run only.
        With `full` (None reads fixed_shape_ops; ``sharded_mul_pt`` passes
        True, so every rank runs the same chain) both run the full mod-n
        window count and every exponent takes the RNS route when the plan
        is on.  While a profiler is active the launch is counted in
        ``profiling.COUNTERS``."""
        with annotate("pct.paillier.ctpt"):
            B = ct.shape[1]
            exps = list(exponents) + [0] * (B - len(exponents))
            if full is None:
                full = _config.get_config().fixed_shape_ops
            bits = [int(e).bit_length() for e in exps]
            maxbits = max(bits, default=1)
            rplan = self._rns_mul_plan()
            if rplan is not None and not full and -(-maxbits // WINDOW) < 8:
                rplan = None
            if rplan is not None:
                base, key, w = rplan
                nw_full = -(-self.bits // w)
                needed = max(1, -(-maxbits // w))
                nw = nw_full if full else min(
                    nw_full, max(4, 1 << max(0, needed - 1).bit_length()))
                profiling.count_exp(bits, w, nw)
                with annotate("pct.paillier.digits"):
                    digits = mg.exponent_digits(exps, nw, w)
                # K5's wrapper copies the digits up after the RNS entry is
                # enqueued, so that copy's host work overlaps the entry
                return _rns.rns_pow_elem(ct, digits, base, key, self.ctx, w,
                                         self.L)
            n_win = (self.n_win_ct if full
                     else max(1, -(-maxbits // WINDOW)))
            profiling.count_exp(bits, WINDOW, n_win)
            with annotate("pct.paillier.digits"):
                digits = kernels.digit_tensor(
                    mg.exponent_digits(exps, n_win, WINDOW), WINDOW,
                    ct.device)
            return mg.mont_exp(ct, digits, self.ctx, window=WINDOW)

    def scale_pow2(self, ct: torch.Tensor, diffs) -> torch.Tensor:
        """ct^(2^d) per column for d = diffs[j] >= 0 (host integers, at
        most B of them): the exponent alignment of ``+``, ``sum`` and
        ``@``.  The columns with d > 0, ordered by d descending so that
        the columns of a warp share one d, run d squarings each in one
        chain (kernel K16, its shape chosen at the chain's mean width,
        ``mont3.sqr_chain_width``); the others, padding included, are
        not touched.  Under fixed_shape_ops, and past K16's widest modulus,
        one ct*pt by 2^d over the batch (``mul_pt``), whose launch shape
        does not follow the data.  While a profiler is active the chain
        is counted (``profiling.count_align``)."""
        with annotate("pct.paillier.align"):
            d = np.asarray(diffs, dtype=np.int64)
            if (_config.get_config().fixed_shape_ops
                    or self.L > mg.MontCtx.MXU_MAX_LIMBS):
                return self.mul_pt(ct, [1 << int(x) if x > 0 else 1
                                        for x in d])
            cols = np.flatnonzero(d > 0)
            if not cols.size:
                return ct
            cols = cols[np.argsort(-d[cols])]
            d = d[cols]
            profiling.count_align(d, self.L)
            return _m3.mm3_sqr_chain(ct, cols, d, self.ctx)

    def gather_batch(self, ct: torch.Tensor, idx) -> torch.Tensor:
        """out[:, j] = ct[:, idx[j]], padded to pad_batch(len(idx))."""
        with annotate("pct.paillier.gather"):
            full = np.zeros(pad_batch(len(idx)), dtype=np.int64)
            full[:len(idx)] = np.asarray(idx, dtype=np.int64)
            return torch.index_select(ct, 1, h2d(torch.from_numpy(full),
                                                 ct.device))

    def tree_reduce(self, ct: torch.Tensor, b: int) -> torch.Tensor:
        """HE sum of the first b ciphertexts, total in column 0."""
        return self.segment_tree_reduce(ct, 1, b)

    def segment_tree_reduce(self, ct: torch.Tensor, groups: int,
                            seg: int) -> torch.Tensor:
        """HE sums of `groups` contiguous segments of length `seg`;
        returns (L, pad_batch(groups)) with the group sums in order."""
        with annotate("pct.paillier.reduce"):
            arr = tree_fold(ct, self.ctx, groups, seg)
            out = self.ctx.one.to(LIMB_DTYPE).expand(
                self.L, pad_batch(groups)).clone()
            out[:, :groups] = arr
            return out

    def pad_columns(self, ct: torch.Tensor, b: int) -> torch.Tensor:
        """ct with its columns padded to pad_batch(b) by the Montgomery
        one (an encryption of zero)."""
        short = pad_batch(b) - ct.shape[1]
        if short <= 0:
            return ct
        return torch.cat([ct, self.ctx.one.to(ct.dtype).expand(
            ct.shape[0], short)], dim=1)

    def invert_columns(self, ct: torch.Tensor, flags) -> torch.Tensor:
        """ct with the columns flagged in `flags` (host bools, at most B)
        inverted mod n^2: gathered, inverted by the product tree with a
        host root (K3 on CUDA; the root's read-back is the one host
        synchronization), scattered back.  Under fixed_shape_ops the whole
        batch is inverted and the flagged columns are picked by a mask,
        so nothing depends on the sign pattern."""
        if _config.get_config().fixed_shape_ops:
            inv = mg.mont_inv_tree_hostroot(ct, self.ctx, self.nsquare)
            mask = np.zeros(ct.shape[1], dtype=bool)
            mask[:len(flags)] = flags
            return torch.where(h2d(torch.from_numpy(mask), ct.device)[
                None, :], inv, ct)
        idx = np.nonzero(flags)[0]
        inv = mg.mont_inv_tree_hostroot(self.gather_batch(ct, idx),
                                        self.ctx, self.nsquare)
        out = ct.clone()
        out[:, h2d(torch.from_numpy(idx), ct.device)] = inv[:, :len(idx)]
        return out

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


def _encrypt_raw_canonical(m_limbs, n_limbs, L):
    """(1 + m*n) mod n^2 as canonical limbs (the RNS encrypt input)."""
    mn = big_mul(m_limbs, n_limbs, out_limbs=L).to(torch.int64)
    mn[0] += 1
    return normalize(mn)


def _obfuscate_djn(ct_mont, digits, comb, ctx):
    """ct * hs^r through the limb comb: one gather and one product per
    window, no squarings (``mont_exp_fixed_base`` with acc0 = ct)."""
    return mg.mont_exp_fixed_base(comb, digits, ctx, acc0=ct_mont)


def _encrypt_djn(m_limbs, digits, comb, n_limbs, ctx, L):
    """The limb encrypt: (1 + m*n) into the Montgomery domain, then the
    comb obfuscator."""
    ct = mg.to_mont(_encrypt_raw_canonical(m_limbs, n_limbs, L), ctx)
    return _obfuscate_djn(ct, digits, comb, ctx)


# ---------------------------------------------------------------------------
# Private (decryption) context: CRT decrypt.
# ---------------------------------------------------------------------------

class PrivateContext:
    """CRT decryption for one key, on the public context's device.  The
    stage-2 engine is read from ``decrypt_engine`` when the context is
    built: "auto"/"rns" the RNS chain (K2), anything else the limb
    engine: the shared-exponent modexp per CRT half (K7) on p^2/q^2
    contexts with mm3 weights, else one fused per-element chain over
    [p^2]*B ++ [q^2]*B (``_crt_stage_exp``, K10).  An RNS context also
    holds the fixed-window digits of p-1, q-1 at ``rns_exp_window``
    (``rdig_p``, ``rdig_q``: ``rns.rns_crt_exp_half``, K6).  The digits
    and schedules are host arrays; ``device_digits`` keeps each on the
    device once it is first used there."""

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
        # fused per-element engine: (n_win, 2) host digits of p-1 | q-1
        self.n_win_dec = -(-ebits // WINDOW)
        self.exp_digits_pq = np.ascontiguousarray(mg.exponent_digits(
            [p - 1, q - 1], self.n_win_dec, WINDOW).astype(np.int32))
        self._sq_ctx_cache = {}
        self._dev_digits = {}
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
            mbits = _rns_mbits(max(psq.bit_length(), qsq.bit_length()))
            if mbits is None:
                raise NotImplementedError(
                    f"p^2 of {max(psq.bit_length(), qsq.bit_length())} "
                    f"bits exceeds the RNS engine's bound ({RNS_MAX_MBITS} "
                    f"bits): use decrypt_engine='limb'")
            self.rns_base = _rns.RnsBase.for_bits(mbits, dev)
            self.rns_p = _rns.RnsModulus.build(self.rns_base, psq, Lh)
            self.rns_q = _rns.RnsModulus.build(self.rns_base, qsq, Lh)
            self.rns_window = _config.get_config().rns_exp_window
            digr = mg.exponent_digits([p - 1, q - 1],
                                      -(-ebits // self.rns_window),
                                      self.rns_window)
            self.rdig_p = np.ascontiguousarray(digr[:, 0].astype(np.int32))
            self.rdig_q = np.ascontiguousarray(digr[:, 1].astype(np.int32))
            self.rns_sched_window = (_rk.plan_sched(self.rns_base.CH)
                                     or self.rns_window)
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

    def device_digits(self, name: str, B: int = 0) -> torch.Tensor:
        """The host digits or schedule `name` (``dig_p``, ``dig_q``,
        ``rdig_p``, ``rdig_q``, ``rsched_p``, ``rsched_q``; for
        ``exp_digits_pq`` its (n_win, 2B) columns at batch B) on this
        context's device: range-checked on the host and copied once,
        without a host synchronization, and again only when the host
        array is replaced."""
        arr = getattr(self, name)
        hit = self._dev_digits.get(name)
        if hit is not None and hit[0] is arr and hit[1] == B:
            return hit[2]
        dev = self.pub.device
        if name.startswith("rsched"):
            t = _rk.schedule_tensor(arr, self.rns_sched_window, dev)
        elif name.startswith("rdig"):
            t = kernels.digit_tensor(arr, self.rns_window, dev)
        elif name.startswith("dig"):
            t = kernels.digit_tensor(arr, self.dec_window, dev)
        else:
            t = kernels.digit_tensor(_pq_digits(arr, self.n_win_dec, B),
                                     WINDOW, dev)
        self._dev_digits[name] = (arr, B, t)
        return t

    def _sq_ctx(self, B: int) -> mg.MontCtx:
        """Per-element context over [p^2]*B ++ [q^2]*B (cached by B)."""
        if B not in self._sq_ctx_cache:
            self._sq_ctx_cache[B] = mg.MontCtx.for_moduli(
                [self.p * self.p] * B + [self.q * self.q] * B, self.Lh,
                self.pub.device)
        return self._sq_ctx_cache[B]

    def decrypt_to_ints(self, ct_mont: torch.Tensor, b: int) -> list:
        """Montgomery ciphertexts mod n^2 -> plaintext ints."""
        return limbs_to_ints(self.decrypt_device(ct_mont))[:b]

    def decrypt_device(self, ct_mont: torch.Tensor) -> torch.Tensor:
        """Montgomery ciphertexts mod n^2 -> canonical plaintext limbs
        (Ln, B) on the device."""
        with annotate("pct.paillier.crt_reduce"):
            base_m = _crt_stage_reduce(ct_mont, self)
        with annotate("pct.paillier.crt_exp"):
            u = self._stage_exp(base_m)
        with annotate("pct.paillier.crt_recombine"):
            return _crt_stage_recombine(u, self)

    def _stage_exp(self, base_m: torch.Tensor) -> torch.Tensor:
        """Stage 2 on this context's engine: (Lh, 2B) -> canonical
        c^(p-1) mod p^2 | c^(q-1) mod q^2."""
        parts = [run() for run in self._stage2(base_m).values()]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _stage2(self, base_m: torch.Tensor) -> dict:
        """Stage 2 as named thunks whose results, in order, make its
        output: on the RNS route both CRT halves' sliding-window chains
        in one K2 launch, enter and exit included, which the p half's
        thunk runs and whose q half the q half's thunk reads; with mm3
        weights, per CRT half the limb engine's shared-exponent chain
        (K7); else one fused per-element chain over both halves (K10)."""
        B = base_m.shape[1] // 2
        halves = (("p", base_m[:, :B], self._sq_p),
                  ("q", base_m[:, B:], self._sq_q))
        if self.use_rns:
            pair = []

            def both_halves():
                pair[:] = _rns.rns_crt_exp_sched_pair(
                    base_m[:, :B], base_m[:, B:],
                    self.device_digits("rsched_p"),
                    self.device_digits("rsched_q"), self.rns_base,
                    self.rns_p, self.rns_q, self._sq_p, self._sq_q,
                    self.rns_sched_window, self.Lh)
                return pair[0]
            return {"stage2_rns_p_half": both_halves,
                    "stage2_rns_q_half": lambda: pair[1]}
        if self._sq_p.wmu is not None:
            return {f"stage2_exp_{w}_half": (
                lambda w=w, v=v, sq=sq: _crt_stage_exp_half(
                    v, sq, self.device_digits("dig_" + w), self.dec_window))
                for w, v, sq in halves}
        return {"stage2_exp": lambda: _crt_stage_exp(
            base_m, self._sq_ctx(B), self.exp_digits_pq, self.n_win_dec,
            self.device_digits("exp_digits_pq", B))}

    def profile_stages(self, ct_mont: torch.Tensor, b: int) -> dict:
        """Per-stage thunks of the decrypt, each on the inputs the decrypt
        itself would hand it, for callers that time them one by one.  On
        a CUDA context every thunk ends in ``torch.cuda.synchronize()``,
        so its wall time is the stage's."""
        cuda = ct_mont.is_cuda

        def synced(fn):
            def run():
                out = fn()
                if cuda:
                    torch.cuda.synchronize()
                return out
            return run

        base_m = _crt_stage_reduce(ct_mont, self)
        u = self._stage_exp(base_m)
        m = _crt_stage_recombine(u, self)
        stages = {
            "stage1_reduce": lambda: _crt_stage_reduce(ct_mont, self),
            **self._stage2(base_m),
            "stage3_recombine": lambda: _crt_stage_recombine(u, self),
            "stage4_d2h": lambda: m.cpu().numpy(),
            "stage5_to_ints": lambda: limbs_to_ints(m)[:b],
        }
        return {k: synced(f) for k, f in stages.items()}


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


def _pq_digits(exp_digits_pq, n_win_dec: int, B: int) -> np.ndarray:
    """(n_win, 2) host digits of p-1 | q-1 -> their (n_win, 2B) columns."""
    e = np.asarray(exp_digits_pq)
    return np.concatenate([np.broadcast_to(e[:, 0:1], (n_win_dec, B)),
                           np.broadcast_to(e[:, 1:2], (n_win_dec, B))],
                          axis=1)


def _crt_stage_exp(base_m, sq_ctx, exp_digits_pq, n_win_dec, digits=None):
    """Stage 2 fused: one 2B-wide per-element modexp (kernel K10 on CUDA)
    over [p^2]*B ++ [q^2]*B with the exponents p-1 | q-1 (host digits
    (n_win, 2), or their columns as ``PrivateContext.device_digits``
    keeps them), and the Montgomery exit (canonical)."""
    if digits is None:
        digits = _pq_digits(exp_digits_pq, n_win_dec, base_m.shape[1] // 2)
    u = mg.mont_exp(base_m, digits, sq_ctx, window=WINDOW)
    return mg.from_mont(u, sq_ctx)


def _crt_stage_recombine(u, s: PrivateContext):
    """Stage 3: L-function by exact Hensel division, the h-multiplies and
    Garner recombination m = m_p + p*((m_q - m_p) * p^-1 mod q)."""
    Lh, Lq, Ln = s.Lh, s.Lq, s.pub.Ln
    B = u.shape[1] // 2
    one_arr = torch.zeros((Lh, 1), dtype=LIMB_DTYPE, device=u.device)
    one_arr[0].fill_(1)             # a kernel, not a host copy
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
                     "comb_rns", "comb" (optional)},
             "priv": {"sq_p", "sq_q", "p_ctx", "q_ctx": {MontCtx leaves},
                      "rns_p", "rns_q": {RnsModulus vectors},
                      "pack_p", "pack_q": pack() bundles,
                      "rsched_p", "rsched_q", "rns_sched_window",
                      "rdig_p", "rdig_q", "rns_window" (optional),
                      Cp_lo..Cq_hi, f2_p, ..., q_limbs,
                      "dec_window", "dig_p", "dig_q",
                      "exp_digits_pq" (optional)}}
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
    if pub.rns_plan() is not None:
        base, _ = pub.rns_plan()
        pub._rns = (base, _rns.RnsModulus.from_arrays(
            pub.nsquare, pd["rns_key"], dev, packed=pd["rns_pack"]))
    if pd.get("comb_rns") is not None:
        pub._comb_rns = to_device(pd["comb_rns"], dev)
    if pd.get("comb") is not None:
        pub._comb = to_device(pd["comb"], dev)
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
        if vd.get("rns_window") is not None:
            priv.rns_window = int(vd["rns_window"])
        for f in ("rdig_p", "rdig_q"):
            if vd.get(f) is not None:
                setattr(priv, f, np.ascontiguousarray(
                    np.asarray(vd[f], dtype=np.int32).reshape(-1)))
    if vd.get("dec_window") is not None:
        priv.dec_window = int(vd["dec_window"])
    for f in ("dig_p", "dig_q"):
        if vd.get(f) is not None:
            setattr(priv, f, np.asarray(vd[f], dtype=np.int32).reshape(-1))
    if vd.get("exp_digits_pq") is not None:
        priv.exp_digits_pq = np.ascontiguousarray(
            np.asarray(vd["exp_digits_pq"], dtype=np.int32))
        priv.n_win_dec = priv.exp_digits_pq.shape[0]
    for f in _PRIV_PLANES:
        setattr(priv, f, torch.from_numpy(
            np.asarray(vd[f]).astype(np.int64)).to(dev))
    for f in _PRIV_LIMBS:
        setattr(priv, f, to_device(vd[f], dev))
    return pub, priv
