"""ctypes binding of the repo's native BLS12-381 library.

The port's own copy of the JAX package's ``crypto/bls/native.py``.  The
library is ``native/bls381/bls381.cpp``, built at first use by
:func:`..ops._build.build_host` into the port's ``_build/`` (never into
``native/build/``).  It accelerates the host's hot operations: pairing
product checks, G1/G2 scalar multiplication, Fq exponentiation, batched
hash-to-G2, batched point decompression with the subgroup check, the
whole RLC batch check, and the final exponentiation with the identity test
over a batch of Fq12 values (the hybrid pairing tail of
:mod:`...ops.bls_pairing`).  The pure-Python modules stay as the oracle.

The library is used only after a differential self-check against the
pure-Python path (:func:`load`).  A failed build, load or self-check raises
:class:`NativeError`: nothing falls back quietly.  ``BLS_DISABLE_NATIVE=1``
(the JAX package's switch) selects the pure-Python path everywhere.
Nothing is built or loaded at import.

Boundary format: big-endian 48-byte field elements, affine ``x||y`` points,
Fq12 values as their 12 base-field coefficients in tower order.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

__all__ = [
    "Library",
    "NativeError",
    "enabled",
    "final_exp_is_one",
    "g1_decompress_batch",
    "g1_mul",
    "g2_decompress_batch",
    "g2_mul",
    "fp_powmod",
    "hash_to_g2_batch",
    "library",
    "load",
    "pairing_check",
    "pure_python",
    "rlc_verify",
]


class NativeError(RuntimeError):
    """The native library failed to build, load or pass its self-check."""


_lock = threading.Lock()
_loaded: Library | None = None
_local = threading.local()


def enabled() -> bool:
    """Whether the host hooks take the native library: not under
    ``BLS_DISABLE_NATIVE`` and not inside :func:`pure_python`."""
    return not os.environ.get("BLS_DISABLE_NATIVE") and not getattr(_local, "pure", False)


@contextlib.contextmanager
def pure_python():
    """Run the calling thread's host hooks on the pure-Python path (the
    self-check's oracle, and the modules' import-time checks, which must
    build nothing)."""
    prev = getattr(_local, "pure", False)
    _local.pure = True
    try:
        yield
    finally:
        _local.pure = prev


# ------------------------------------------------------------- converters

def _g1_bytes(pt) -> bytes:
    x, y = pt
    return x.to_bytes(48, "big") + y.to_bytes(48, "big")


def _g2_bytes(pt) -> bytes:
    (x0, x1), (y0, y1) = pt
    return (
        x0.to_bytes(48, "big") + x1.to_bytes(48, "big")
        + y0.to_bytes(48, "big") + y1.to_bytes(48, "big")
    )


def _g1_from(buf: bytes):
    return (int.from_bytes(buf[:48], "big"), int.from_bytes(buf[48:], "big"))


def _g2_from(buf: bytes):
    return (
        (int.from_bytes(buf[:48], "big"), int.from_bytes(buf[48:96], "big")),
        (int.from_bytes(buf[96:144], "big"), int.from_bytes(buf[144:], "big")),
    )


def _scalar_bytes(k: int) -> bytes:
    return k.to_bytes(max(1, (k.bit_length() + 7) // 8), "big")


class Library:
    """The loaded library's entry points, with their ctypes signatures."""

    def __init__(self, cdll: ctypes.CDLL):
        c = ctypes
        self._lib = cdll
        cdll.bls381_init.restype = None
        cdll.bls381_init.argtypes = []
        cdll.bls381_pairing_check.restype = c.c_int
        cdll.bls381_pairing_check.argtypes = [c.c_char_p, c.c_char_p, c.c_size_t]
        for name in ("bls381_g1_mul", "bls381_g2_mul"):
            fn = getattr(cdll, name)
            fn.restype = None
            fn.argtypes = [c.c_char_p, c.c_char_p, c.c_char_p, c.c_size_t, c.POINTER(c.c_int)]
        cdll.bls381_fp_powmod.restype = None
        cdll.bls381_fp_powmod.argtypes = [c.c_char_p, c.c_char_p, c.c_char_p, c.c_size_t]
        cdll.bls381_hash_to_g2_batch.restype = None
        cdll.bls381_hash_to_g2_batch.argtypes = [
            c.c_char_p,                  # msgs, concatenated
            c.POINTER(c.c_size_t),       # per-message lengths
            c.c_size_t,                  # n
            c.c_char_p, c.c_size_t,      # dst
            c.c_char_p,                  # out: n * 192 bytes
            c.c_int,                     # nthreads (0 = auto)
        ]
        cdll.bls381_rlc_verify.restype = c.c_int
        cdll.bls381_rlc_verify.argtypes = [
            c.c_char_p,                  # pks: n * 96
            c.c_char_p,                  # sigs: n * 192
            c.c_char_p,                  # coeffs: n * coeff_len
            c.c_size_t,                  # coeff_len
            c.POINTER(c.c_int32),        # group id per entry
            c.c_size_t,                  # n entries
            c.c_char_p,                  # h_points: n_groups * 192
            c.c_size_t,                  # n_groups
            c.c_int,                     # nthreads (0 = auto)
        ]
        cdll.bls381_final_exp_is_one.restype = c.c_int
        cdll.bls381_final_exp_is_one.argtypes = [
            c.c_char_p,                  # fq12s: n * 576
            c.c_size_t,                  # n
            c.c_char_p,                  # out: one verdict byte each
        ]
        for name in ("bls381_g1_decompress_batch", "bls381_g2_decompress_batch"):
            fn = getattr(cdll, name)
            fn.restype = None
            fn.argtypes = [
                c.c_char_p,              # in: n * insz compressed
                c.c_size_t,              # n
                c.c_char_p,              # out: n * outsz affine
                c.c_char_p,              # ok flags (1 point, 0 invalid, 2 infinity)
                c.c_int,                 # subgroup_check
                c.c_int,                 # nthreads (0 = auto)
            ]
        cdll.bls381_init()

    def pairing_check(self, pairs) -> bool:
        """prod e(P_i, Q_i) == 1 over affine (g1, g2) pairs (no Nones)."""
        g1buf = b"".join(_g1_bytes(p) for p, _ in pairs)
        g2buf = b"".join(_g2_bytes(q) for _, q in pairs)
        return bool(self._lib.bls381_pairing_check(g1buf, g2buf, len(pairs)))

    def _mul(self, fn, size: int, to_bytes, from_bytes, pt, scalar: int):
        if pt is None or scalar == 0:
            return None
        k = _scalar_bytes(scalar)
        out = ctypes.create_string_buffer(size)
        is_inf = ctypes.c_int()
        fn(out, to_bytes(pt), k, len(k), ctypes.byref(is_inf))
        return None if is_inf.value else from_bytes(out.raw)

    def g1_mul(self, pt, scalar: int):
        """``scalar * pt`` without reducing the scalar; ``None`` is infinity."""
        return self._mul(self._lib.bls381_g1_mul, 96, _g1_bytes, _g1_from, pt, scalar)

    def g2_mul(self, pt, scalar: int):
        return self._mul(self._lib.bls381_g2_mul, 192, _g2_bytes, _g2_from, pt, scalar)

    def fp_powmod(self, base: int, exp: int) -> int:
        """``base^exp mod p`` (``exp >= 0``), Montgomery exponentiation."""
        from .fields import P

        e = _scalar_bytes(exp)
        out = ctypes.create_string_buffer(48)
        self._lib.bls381_fp_powmod(out, (base % P).to_bytes(48, "big"), e, len(e))
        return int.from_bytes(out.raw, "big")

    def hash_to_g2_batch(self, msgs: list[bytes], dst: bytes) -> list:
        """hash_to_g2 of each message, across a C++ thread pool."""
        n = len(msgs)
        if n == 0:
            return []
        lens = (ctypes.c_size_t * n)(*[len(m) for m in msgs])
        out = ctypes.create_string_buffer(192 * n)
        self._lib.bls381_hash_to_g2_batch(b"".join(msgs), lens, n, dst, len(dst), out, 0)
        raw = out.raw  # one copy: .raw copies the whole buffer on every access
        return [_g2_from(raw[i * 192 : (i + 1) * 192]) for i in range(n)]

    def final_exp_is_one(self, fq12s) -> list[bool]:
        """Whether the final exponentiation of each host Fq12 ``((c0, c1,
        c2), (c0, c1, c2))`` of Fq2 pairs is one: a serial loop in C++."""
        n = len(fq12s)
        if n == 0:
            return []
        buf = b"".join(c.to_bytes(48, "big") for f in fq12s for c6 in f for c2 in c6 for c in c2)
        out = ctypes.create_string_buffer(n)
        rc = self._lib.bls381_final_exp_is_one(buf, n, out)
        if rc != 0:
            raise NativeError(f"bls381_final_exp_is_one returned {rc}")
        return [b == 1 for b in out.raw]

    def _decompress(self, fn, insz: int, outsz: int, from_bytes, blobs, subgroup_check: bool):
        # per-item contract: a wrong-length blob is that item's invalidity
        # (False), as on the pure-Python path
        raw = [bytes(b) for b in blobs]
        res: list = [False] * len(raw)
        keep = [i for i, b in enumerate(raw) if len(b) == insz]
        if not keep:
            return res
        m = len(keep)
        out = ctypes.create_string_buffer(outsz * m)
        ok = ctypes.create_string_buffer(m)
        fn(b"".join(raw[i] for i in keep), m, out, ok, 1 if subgroup_check else 0, 0)
        # one copy each: .raw copies the whole buffer on every access
        points, flags = out.raw, ok.raw
        for j, i in enumerate(keep):
            flag = flags[j]
            if flag == 1:
                res[i] = from_bytes(points[j * outsz : (j + 1) * outsz])
            elif flag == 2:
                res[i] = None  # the canonical infinity encoding
        return res

    def g1_decompress_batch(self, blobs, subgroup_check: bool = True) -> list:
        """Per item: affine point | ``None`` (infinity) | ``False`` (invalid)."""
        return self._decompress(self._lib.bls381_g1_decompress_batch, 48, 96, _g1_from,
                                blobs, subgroup_check)

    def g2_decompress_batch(self, blobs, subgroup_check: bool = True) -> list:
        return self._decompress(self._lib.bls381_g2_decompress_batch, 96, 192, _g2_from,
                                blobs, subgroup_check)

    def rlc_verify(self, entries, h_points, group_ids, coeff_bits: int) -> bool:
        """One RLC pairing-product check in C++:

            prod_g e(sum_{i in g} r_i pk_i, H_g) * e(-g1, sum_i r_i sig_i) == 1

        ``entries``: ``[(pk, sig, r)]``; ``h_points``: one G2 point per
        group; ``group_ids``: each entry's group.  Points must be on the
        curve and subgroup-checked by the caller."""
        n = len(entries)
        if n == 0:
            return True
        coeff_len = (coeff_bits + 7) // 8
        pks = b"".join(_g1_bytes(pk) for pk, _, _ in entries)
        sigs = b"".join(_g2_bytes(sig) for _, sig, _ in entries)
        coeffs = b"".join(r.to_bytes(coeff_len, "big") for _, _, r in entries)
        gids = (ctypes.c_int32 * n)(*group_ids)
        hbuf = b"".join(_g2_bytes(h) for h in h_points)
        return bool(self._lib.bls381_rlc_verify(pks, sigs, coeffs, coeff_len, gids, n, hbuf,
                                                len(h_points), 0))


def _self_check(lib: Library) -> None:
    """Every entry point against the pure-Python path on fixed inputs (the
    RLC check on a valid and a tampered set, the final exponentiation of a
    Miller product that pairs to one and of one that does not); raises
    :class:`NativeError` on the first disagreement."""
    from . import curve as C
    from .fields import P, fq12_is_one, fq12_mul
    from .hash_to_curve import DST_POP, hash_to_g2
    from .pairing import final_exponentiation, miller_loop, pairing_check

    def expect(ok: bool, what: str) -> None:
        if not ok:
            raise NativeError(f"native self-check failed: {what}")

    with pure_python():
        base, exp = 0xDEADBEEF, (P + 1) // 4
        expect(lib.fp_powmod(base, exp) == pow(base, exp, P), "fp_powmod")
        a, b = 0x1234567890ABCDEF, 0xFEDCBA987654321
        p1 = C.g1.multiply_raw(C.G1_GENERATOR, a)
        q1 = C.g2.multiply_raw(C.G2_GENERATOR, b)
        expect(lib.g1_mul(C.G1_GENERATOR, a) == p1, "g1_mul")
        expect(lib.g2_mul(C.G2_GENERATOR, b) == q1, "g2_mul")
        expect(lib.g1_mul(C.G1_GENERATOR, C.R) is None, "g1_mul by the group order")
        msg = b"native self-check"
        h = hash_to_g2(msg, DST_POP)
        expect(lib.hash_to_g2_batch([msg], DST_POP) == [h], "hash_to_g2_batch")
        g1_blobs = [C.g1_to_bytes(p1), C.g1_to_bytes(None), b"\x00" * 48, b"\x01"]
        expect(lib.g1_decompress_batch(g1_blobs) == C._from_bytes_batch(
            C.g1_from_bytes, g1_blobs, True), "g1_decompress_batch")
        g2_blobs = [C.g2_to_bytes(q1), C.g2_to_bytes(None), b"\x00" * 96]
        expect(lib.g2_decompress_batch(g2_blobs) == C._from_bytes_batch(
            C.g2_from_bytes, g2_blobs, True), "g2_decompress_batch")
        pairs = [(p1, C.G2_GENERATOR), (C.g1.affine_neg(C.G1_GENERATOR), q1)]
        expect(lib.pairing_check(pairs) == pairing_check(pairs), "pairing_check")
        good = [(p1, C.g2.multiply_raw(h, a), 5)]
        expect(lib.rlc_verify(good, [h], [0], 64), "rlc_verify of a valid set")
        bad = [(p1, C.g2.multiply_raw(h, a + 1), 5)]
        expect(not lib.rlc_verify(bad, [h], [0], 64), "rlc_verify of a tampered set")
        f = miller_loop(p1, q1)
        products = [fq12_mul(f, miller_loop(C.g1.affine_neg(p1), q1)), fq12_mul(f, f)]
        want = [fq12_is_one(final_exponentiation(m)) for m in products]
        expect(want == [True, False] and lib.final_exp_is_one(products) == want,
               "final_exp_is_one")


def load(path=None) -> Library:
    """Build (unless ``path`` is given), load and self-check the library."""
    from ...ops import _build

    try:
        path = path or _build.build_host("bls381")
        cdll = ctypes.CDLL(str(path))
        lib = Library(cdll)
    except (OSError, AttributeError, RuntimeError) as e:
        raise NativeError(f"native BLS library unavailable: {e}") from e
    _self_check(lib)
    return lib


def library() -> Library:
    """The process's checked library, built and loaded on first use."""
    global _loaded
    if _loaded is None:
        with _lock:
            if _loaded is None:
                _loaded = load()
    return _loaded


# ------------------------------------------------------------- operations

def pairing_check(pairs) -> bool:
    return library().pairing_check(pairs)


def g1_mul(pt, scalar: int):
    return library().g1_mul(pt, scalar)


def g2_mul(pt, scalar: int):
    return library().g2_mul(pt, scalar)


def fp_powmod(base: int, exp: int) -> int:
    return library().fp_powmod(base, exp)


def hash_to_g2_batch(msgs: list[bytes], dst: bytes) -> list:
    return library().hash_to_g2_batch(msgs, dst)


def final_exp_is_one(fq12s) -> list[bool]:
    return library().final_exp_is_one(fq12s)


def g1_decompress_batch(blobs, subgroup_check: bool = True) -> list:
    return library().g1_decompress_batch(blobs, subgroup_check)


def g2_decompress_batch(blobs, subgroup_check: bool = True) -> list:
    return library().g2_decompress_batch(blobs, subgroup_check)


def rlc_verify(entries, h_points, group_ids, coeff_bits: int) -> bool:
    return library().rlc_verify(entries, h_points, group_ids, coeff_bits)
