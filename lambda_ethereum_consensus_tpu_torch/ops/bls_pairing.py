"""Batched BLS12-381 optimal-ate pairing over limb planes (PyTorch).

The port's counterpart of the JAX package's ``ops/bls_pairing.py`` plane
instantiation: the Miller loop and the masked product over the grouping axis
on the operands' device, then one of two tails, one boolean per check coming
back (:func:`make_pairing_ops` ``check_tail``):

- the hybrid tail (the reference's ``_tail_hybrid``, ``bls_pairing.py:356``):
  the masked products pulled to the host in one copy, the final
  exponentiation and identity test in the native library's
  ``final_exp_is_one`` (pure Python where :func:`..crypto.bls.native.enabled`
  is off);
- the composed tail (the reference's composed mode, ``bls_pairing.py:396``):
  the final exponentiation and identity test on the device too, about 2,900
  field-kernel calls whatever the number of checks.

The tail is chosen by the number of checks alone, before anything launches:
below :data:`DEVICE_TAIL_MIN` the hybrid tail, from it on the composed one,
on every device.  Neither falls back to the other: a native build, load or
self-check failure raises ``NativeError``, a kernel fault ``RuntimeError``.

Same line-slot convention and formulas as the reference: the line through
the running twist point, evaluated at P = (px, py) and scaled by xi, lives at
tower slots w^0 / w^3 / w^5,

    l = (py*xi) * w^0 + (lambda*x_r - y_r) * w^3 + (-lambda*px) * w^5,

with denominators cleared into homogeneous projective coordinates (EFD
dbl-2007-bl and madd-1998-cmo), so every Miller value equals the
reference's limb for limb.  The loop is a Python loop over the static bits of
|x| that runs the add step only on set bits; independent Fq2 products of a
step share one field call.  Inputs must be subgroup-checked points of prime
order with infinities masked by the caller, exactly as there.

The host-facing API (:func:`miller_loop_batch`, :func:`pairing_product_is_one`,
:func:`pairing_products_are_one`) pads batches to powers of two with the
generator pair, masks the padding to the identity, and runs on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..crypto.bls import native
from ..crypto.bls.curve import G1_GENERATOR, G2_GENERATOR
from ..crypto.bls.fields import BLS_X, BLS_X_IS_NEG, fq12_is_one
from ..crypto.bls.pairing import final_exponentiation
from . import bls_fq12 as FQ
from .bls_g1 import _limbs_batch, _planes
from .ladder import _many
from .sha256 import resolve_device

__all__ = [
    "DEVICE_TAIL_MIN",
    "FINAL_EXP_LAUNCHES",
    "get_pairing_ops",
    "make_pairing_ops",
    "miller_loop_batch",
    "pairing_product_is_one",
    "pairing_products_are_one",
]

# MSB-first bits of |x| after the leading 1 (63 entries), shared by the
# Miller loop and a^x — identical to the host loop order.
_X_BITS = [int(b) for b in bin(BLS_X)[3:]]

# The Miller loop and pow_x conjugate unconditionally for the negative BLS
# parameter (the host path branches on the flag).
assert BLS_X_IS_NEG, "device pairing assumes the negative BLS12-381 parameter"

# checks from which a batch's tail runs on the device (the composed tail);
# below it the hybrid tail finishes on the host.  The smallest batch at
# which the composed tail was at or below the hybrid on an H100 (PERF.md,
# the median of six runs: 0.37 against 0.43 s at 128 checks, 0.38
# against 0.22 s at 64).  The host's final exponentiation is a serial loop
# of ~3.7 ms a check; the composed tail ~0.3-0.5 s at any number of checks.
# Every caller in the port passes one or a few checks a call, except a
# bisection level, which passes two for each range that failed above it:
# only a drain or set blaming at least 64 forged items reaches 128.
DEVICE_TAIL_MIN = 128

# field-kernel launches of the composed tail's final exponentiation, the
# same at any number of checks: what the hybrid tail saves a call
FINAL_EXP_LAUNCHES = {"mul_mod": 743, "add_mod": 1771, "sub_mod": 379}


def _tail_hybrid(products: torch.Tensor) -> torch.Tensor:
    """Masked products ``(32, 2, 3, 2, batch...)`` on any device -> a CPU
    bool tensor of the batch shape: one copy to the host, then the final
    exponentiation and identity test of each product in the native library
    (pure Python where native is off)."""
    values = FQ.fq12_batch_from_limbs(products.cpu().numpy())
    if native.enabled():
        ok = native.final_exp_is_one(values)
    else:
        ok = [fq12_is_one(final_exponentiation(v)) for v in values]
    return torch.tensor(ok, dtype=torch.bool).reshape(products.shape[4:])


def make_pairing_ops(device: torch.device) -> dict:
    ops = FQ.get_fq12_plane_ops(device)
    lay = ops["layout"]
    add, sub, neg = ops["add"], ops["sub"], ops["neg"]
    f2many = ops["fq2_mul_many"]
    f2xi = ops["fq2_mul_by_xi"]
    f12m, f12sq = ops["fq12_mul"], ops["fq12_sq"]
    f12conj, f12inv = ops["fq12_conj"], ops["fq12_inv"]
    f12frob = ops["fq12_frobenius"]
    mul035 = ops["fq12_mul_by_035"]

    def adds(*pairs):
        return _many(add, pairs)

    def subs(*pairs):
        return _many(sub, pairs)

    def line(s_z, w3_z, py, px):
        """(xi * s_z * py, -(w3_z * px)): the w^0 and w^5 line slots."""
        scaled = ops["mul"](torch.stack(torch.broadcast_tensors(f2xi(s_z), w3_z), dim=1),
                            torch.stack(torch.broadcast_tensors(py, px), dim=1).unsqueeze(2))
        return scaled[:, 0], neg(scaled[:, 1])

    def dbl_step(f, X, Y, Z, px, py):
        """Projective doubling + line (EFD dbl-2007-bl, a = 0); the line is
        taken at the pre-update point, scaled by (2y) * Z^3."""
        XX, t = f2many([(X, X), (Y, Z)])
        XX2, s = adds((XX, XX), (t, t))
        w3 = add(XX2, XX)
        ss, Rr, sZ = f2many([(s, s), (Y, s), (s, Z)])
        sss, RR, B1, w3w3, Xw3, w3Z = f2many(
            [(s, ss), (Rr, Rr), (X, Rr), (w3, w3), (X, w3), (w3, Z)]
        )
        B, RR2 = adds((B1, B1), (RR, RR))
        l3 = sub(Xw3, Rr)
        h = sub(w3w3, add(B, B))
        Bh = sub(B, h)
        Xn, w3Bh = f2many([(h, s), (w3, Bh)])
        Yn = sub(w3Bh, RR2)
        l0, l5 = line(sZ, w3Z, py, px)
        return mul035(f, l0, l3, l5), Xn, Yn, sss

    def add_step(f, X, Y, Z, qx, qy, px, py):
        """Mixed addition of the affine base Q + line (EFD madd-1998-cmo),
        line scaled by (qx - x_r) * Z."""
        qyZ, qxZ = f2many([(qy, Z), (qx, Z)])
        u, v = subs((qyZ, Y), (qxZ, X))
        uu, vv, vZ, uZ, uX, vY = f2many([(u, u), (v, v), (v, Z), (u, Z), (u, X), (v, Y)])
        vvv, Rm, uuZ = f2many([(v, vv), (vv, X), (uu, Z)])
        A = sub(sub(uuZ, vvv), add(Rm, Rm))
        l3 = sub(uX, vY)
        Xn, uRA, vvvY, Zn = f2many([(v, A), (u, sub(Rm, A)), (vvv, Y), (vvv, Z)])
        Yn = sub(uRA, vvvY)
        l0, l5 = line(vZ, uZ, py, px)
        return mul035(f, l0, l3, l5), Xn, Yn, Zn

    def miller(px, py, qx, qy):
        """Batched Miller loop: Fp ``px/py`` ``(32, B...)`` and Fq2 twist
        coordinates ``qx/qy`` ``(32, 2, B...)``; returns f ``(32, 2, 3, 2, B...)``."""
        f = ops["fq12_one"](lay.fq_batch_shape(px))
        X, Y = qx, qy
        Z = lay.fq2_like((1, 0), qx)
        for bit in _X_BITS:
            f = f12sq(f)
            f, X, Y, Z = dbl_step(f, X, Y, Z, px, py)
            if bit:
                f, X, Y, Z = add_step(f, X, Y, Z, qx, qy, px, py)
        return f12conj(f)  # negative BLS parameter

    def pow_x_abs(a):
        """a^|x| by square-and-multiply over the static parameter bits."""
        acc = a
        for bit in _X_BITS:
            acc = f12sq(acc)
            if bit:
                acc = f12m(acc, a)
        return acc

    def pow_x(a):
        # on the cyclotomic subgroup conjugation is inversion: a^-|x|
        return f12conj(pow_x_abs(a))

    def masked_product(f, mask):
        """Fq12 batch with a K grouping axis innermost + live mask -> product
        over K (pairwise halving); masked lanes become the identity."""
        one = ops["fq12_one"](lay.batch_shape(f))
        f = torch.where(lay.expand_mask(mask), f, one)
        k = lay.ksize(f)
        while k > 1:
            if k % 2:
                pad_shape = (*lay.batch_shape(f)[:-1], 1)
                f = lay.kconcat([f, ops["fq12_one"](pad_shape)])
                k += 1
            f = f12m(lay.kslice(f, slice(0, None, 2)), lay.kslice(f, slice(1, None, 2)))
            k //= 2
        return lay.kslice(f, 0)

    def final_exp(f):
        """Easy part, then the cubed hard part — the host addition chain
        (``crypto/bls/pairing.py``)."""
        t = f12m(f12conj(f), f12inv(f))
        m = f12m(f12frob(f12frob(t)), t)
        a = f12m(pow_x(m), f12conj(m))
        b = f12m(pow_x(a), f12conj(a))
        c = f12m(pow_x(b), f12frob(b))
        d = f12m(f12m(pow_x(pow_x(c)), f12frob(f12frob(c))), f12conj(c))
        return f12m(d, f12m(f12sq(m), m))

    def check_tail(f, mask):
        """Miller outputs grouped ``(..., K)`` + live mask -> one bool per
        group: the masked product on the device, then the final
        exponentiation and == 1 on the host below :data:`DEVICE_TAIL_MIN`
        groups (a CPU tensor), on the device from it on."""
        product = masked_product(f, mask)
        if math.prod(mask.shape[:-1]) < DEVICE_TAIL_MIN:
            return _tail_hybrid(product)
        return ops["fq12_is_one"](pairing["final_exp"](product))

    pairing = {"miller": miller, "check_tail": check_tail, "final_exp": final_exp}
    return pairing


_OPS: dict = {}


def get_pairing_ops(device: torch.device | str) -> dict:
    dev = torch.device(device)
    if dev not in _OPS:
        _OPS[dev] = make_pairing_ops(dev)
    return _OPS[dev]


def pack_pairs(pairs) -> tuple:
    """[(G1 affine, G2 affine)] -> (px, py, qx, qy) numpy planes."""
    from .bls_g2 import fq2_limbs_batch

    px = _limbs_batch([p[0] for p, _ in pairs]).T.copy()
    py = _limbs_batch([p[1] for p, _ in pairs]).T.copy()
    qx = np.ascontiguousarray(fq2_limbs_batch([q[0] for _, q in pairs]).transpose(2, 1, 0))
    qy = np.ascontiguousarray(fq2_limbs_batch([q[1] for _, q in pairs]).transpose(2, 1, 0))
    return px, py, qx, qy


def _pow2_pad(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


def _pad_pairs(pairs, target: int) -> list:
    """Pad with the generator pair: padded lanes are masked to the identity
    after the Miller loop, so their value never matters."""
    return list(pairs) + [(G1_GENERATOR, G2_GENERATOR)] * (target - len(pairs))


def _miller_planes(pairs, device: torch.device) -> torch.Tensor:
    return get_pairing_ops(device)["miller"](*[_planes(x, device) for x in pack_pairs(pairs)])


def miller_loop_batch(pairs, device: str | torch.device | None = None) -> list:
    """Batched Miller loops on ``device`` (default: the card) -> host Fq12
    tuples.  ``pairs``: affine, non-infinity, subgroup-checked (P in G1, Q
    in G2)."""
    dev = resolve_device(device)
    if not pairs:
        return []
    n = len(pairs)
    f = _miller_planes(_pad_pairs(pairs, _pow2_pad(n)), dev)
    return FQ.fq12_batch_from_limbs(f[..., :n].cpu().numpy())


def pairing_product_is_one(pairs, device: str | torch.device | None = None) -> bool:
    """Single check: prod e(P_i, Q_i) == 1, on ``device``."""
    return pairing_products_are_one([pairs], device)[0]


def pairing_products_are_one(checks, device: str | torch.device | None = None) -> list[bool]:
    """Batched pairing-product checks, one bool per inner pair list: the
    Miller loops and masked products on ``device`` (default: the card),
    then the tail ``check_tail`` picks by the padded number of checks."""
    dev = resolve_device(device)
    if not checks:
        return []
    kmax = _pow2_pad(max(len(c) for c in checks))
    g = _pow2_pad(len(checks))
    flat = []
    mask = np.zeros((g, kmax), bool)
    for i in range(g):
        chk = checks[i] if i < len(checks) else []
        mask[i, : len(chk)] = True
        flat.extend(_pad_pairs(chk, kmax))
    f = _miller_planes(flat, dev)
    f = f.reshape(*f.shape[:-1], g, kmax)
    ok = get_pairing_ops(dev)["check_tail"](f, torch.from_numpy(mask).to(dev))
    return [bool(v) for v in ok.cpu().tolist()[: len(checks)]]
