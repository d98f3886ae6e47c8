"""Field-generic Jacobian point ops and the double-and-add ladder (PyTorch).

The port's counterpart of the JAX package's ``ops/ladder.py``
``make_jacobian_ops``, shared by G1 (Fq) and G2 (Fq2, on the twist).  The
formulas are the reference's, step for step, so every Jacobian coordinate
comes out as the same canonical limbs; what differs is the grouping:
independent products (and independent sums) of one step are stacked into one
field call (``field["mul_many"]``, :func:`_many`), and the ladder is a
Python loop over the bit rows rather than a ``lax.scan``.  Nothing branches
on data: the doubling, cancellation and identity cases are all computed and
selected with ``torch.where``, infinity travels as a boolean flag.
"""

from __future__ import annotations

import torch


def _many(op, pairs):
    """``[op(a, b) for a, b in pairs]`` as one call over a stacked axis."""
    xs = torch.broadcast_tensors(*[t for ab in pairs for t in ab])
    out = op(torch.stack(xs[0::2], dim=1), torch.stack(xs[1::2], dim=1))
    return out.unbind(1)


def make_jacobian_ops(field: dict) -> dict:
    """``field``: ``mul_many`` (independent products in one call), ``add`` and
    ``sub`` over elements, ``one``/``zero`` constants, ``eq(a, b) -> mask``,
    ``flags(bx)`` (the all-False infinity flags of a base).  Elements carry
    the batch on their trailing axes, so masks broadcast against them as they
    are.

    Returns ``{"jac_add", "jac_double", "ladder"}`` over ``(x, y, z, inf)``
    tuples, as the reference.
    """
    mul_many = field["mul_many"]
    add, sub = field["add"], field["sub"]
    eq = field["eq"]
    one, zero = field["one"], field["zero"]
    flags0 = field["flags"]

    def adds(*pairs):
        return _many(add, pairs)

    def subs(*pairs):
        return _many(sub, pairs)

    def jac_double(pt):
        x, y, z, inf = pt
        a, b, yz = mul_many([(x, x), (y, y), (y, z)])
        (c,) = mul_many([(b, b)])
        xb, a2, z3 = adds((x, b), (a, a), (yz, yz))
        (xb2,) = mul_many([(xb, xb)])
        e, ac, c2 = adds((a2, a), (a, c), (c, c))
        (f,) = mul_many([(e, e)])
        t = sub(xb2, ac)  # (x + b)^2 - a - c
        d, c4 = adds((t, t), (c2, c2))
        d2, c8 = adds((d, d), (c4, c4))
        x3 = sub(f, d2)
        (edx,) = mul_many([(e, sub(d, x3))])
        y3 = sub(edx, c8)
        # y == 0 doubling would be the identity; neither G1 nor the G2 twist
        # has 2-torsion, so that only happens at infinity, already flagged
        return (x3, y3, z3, inf)

    def jac_add(p, q):
        """Complete addition: generic add, doubling and identity cases all
        computed and selected branch-free."""
        x1, y1, z1, inf1 = p
        x2, y2, z2, inf2 = q
        z1z1, z2z2, y1z2, y2z1, z1z2 = mul_many(
            [(z1, z1), (z2, z2), (y1, z2), (y2, z1), (z1, z2)]
        )
        u1, u2, s1, s2 = mul_many([(x1, z2z2), (x2, z1z1), (y1z2, z2z2), (y2z1, z1z1)])
        h, sd = subs((u2, u1), (s2, s1))
        h2, rr, zz2 = adds((h, h), (sd, sd), (z1z2, z1z2))
        i, rr_sq, z3 = mul_many([(h2, h2), (rr, rr), (zz2, h)])
        j, v = mul_many([(h, i), (u1, i)])
        (s1j,) = mul_many([(s1, j)])
        (v2,) = adds((v, v))
        jv2, s1j2 = adds((j, v2), (s1j, s1j))
        x3 = sub(rr_sq, jv2)  # rr^2 - j - 2v
        (rvx,) = mul_many([(rr, sub(v, x3))])
        y3 = sub(rvx, s1j2)  # rr (v - x3) - 2 s1 j

        same_x = eq(u1, u2)
        same_y = eq(s1, s2)
        dx, dy, dz, _ = jac_double(p)

        # doubling case (P == Q), cancellation case (P == -Q -> infinity)
        dbl = same_x & same_y
        out_x = torch.where(dbl, dx, x3)
        out_y = torch.where(dbl, dy, y3)
        out_z = torch.where(dbl, dz, z3)
        out_inf = same_x & ~same_y
        # identity operands
        out_x = torch.where(inf1, x2, torch.where(inf2, x1, out_x))
        out_y = torch.where(inf1, y2, torch.where(inf2, y1, out_y))
        out_z = torch.where(inf1, z2, torch.where(inf2, z1, out_z))
        out_inf = torch.where(inf1, inf2, torch.where(inf2, inf1, out_inf))
        return (out_x, out_y, out_z, out_inf)

    def _step(acc, bit, base):
        acc = jac_double(acc)
        added = jac_add(acc, base)
        take = bit.to(torch.bool)
        return (
            torch.where(take, added[0], acc[0]),
            torch.where(take, added[1], acc[1]),
            torch.where(take, added[2], acc[2]),
            torch.where(take, added[3], acc[3]),
        )

    def ladder(base_xy, bits):
        """Affine bases ``(bx, by)`` and MSB-first bit rows ``(nbits, B...)``
        -> the Jacobian products ``(X, Y, Z, inf)``."""
        bx, by = base_xy
        inf0 = flags0(bx)
        base = (bx, by, one.expand(bx.shape), inf0)
        acc = (
            torch.zeros_like(bx),
            torch.zeros_like(by),
            zero.expand(bx.shape),
            torch.ones_like(inf0),
        )
        for i in range(bits.shape[0]):
            acc = _step(acc, bits[i], base)
        return acc

    return {"jac_add": jac_add, "jac_double": jac_double, "ladder": ladder}
