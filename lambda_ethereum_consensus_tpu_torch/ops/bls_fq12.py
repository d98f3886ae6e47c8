"""Fq2/Fq6/Fq12 tower arithmetic over limb planes (PyTorch).

The port's counterpart of the JAX package's ``ops/bls_fq12.py`` plane tower
(``_PlaneLayout`` and ``make_fq12_ops`` over ``make_plane_ops``).  Same
construction as the host tower in ``crypto/bls/fields.py`` — xi = 1 + u,
v^3 = xi, w^2 = v — and the same layout: limb planes outermost, batch last,

    Fq ``(32, B...)``, Fq2 ``(32, 2, B...)``, Fq6 ``(32, 3, 2, B...)``,
    Fq12 ``(32, 2, 3, 2, B...)``,

tower components always on axis 1.  Every base-field op is one call of a
field kernel (:mod:`.bigint_pallas`), and each call is exact, so an element
comes out as the same canonical limbs whatever formula produced it.  The
tower uses that freedom to cut launches: independent base ops are stacked on
a component axis and go through ONE call.  A product of two tower elements is
a :class:`_Plan` — gather both operands' components, one ``mul_mod`` call for
every component product, then signed sums as a halving tree of ``add_mod``
calls and one ``sub_mod``.  An Fq12 product is the degree-5 polynomial product
over Fq2 in ``w`` with ``w^6 = xi`` folded in: 144 base products, 7 calls
(the JAX tower issues about 90).

Inversion bottoms out in a Fermat power ``a^(p-2)`` over the static exponent
bits (a Python loop that skips the zero bits); the square and the conditional
product of each bit share one call.  Frobenius constants are taken
numerically from the host field module.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto.bls import fields as F
from . import bigint as BI
from .bigint_pallas import make_plane_ops

__all__ = [
    "fq2_to_limbs",
    "fq12_batch_from_limbs",
    "fq12_to_limbs",
    "get_fq12_plane_ops",
    "make_fq12_ops",
]

_N = BI.NLIMBS


def fq2_to_limbs(a) -> np.ndarray:
    """Host Fq2 pair -> (2, 32) limbs."""
    return np.stack([BI.to_limbs(a[0]), BI.to_limbs(a[1])])


def fq12_to_limbs(f) -> np.ndarray:
    """Host Fq12 tuple -> (2, 3, 2, 32) limbs."""
    return np.stack([np.stack([fq2_to_limbs(c) for c in half]) for half in f])


def fq12_batch_from_limbs(arr) -> list:
    """``(32, 2, 3, 2, batch...)`` plane Fq12 batch -> list of host tuples."""
    from .bls_g1 import _ints_batch

    arr = np.asarray(arr)
    flat = arr.reshape(_N, 12, -1)
    n = flat.shape[-1]
    ints = [_ints_batch(np.ascontiguousarray(flat[:, c].T)) for c in range(12)]
    return [
        tuple(
            tuple((ints[(i * 3 + j) * 2][e], ints[(i * 3 + j) * 2 + 1][e]) for j in range(3))
            for i in range(2)
        )
        for e in range(n)
    ]


def _bits_lsb(e: int) -> list[int]:
    return [(e >> i) & 1 for i in range(e.bit_length())]


class _Plan:
    """Signed sums of component products, run as one ``mul_mod`` call, a
    halving tree of ``add_mod`` calls and (where any term is negative) one
    ``sub_mod`` call.

    ``outputs[o]`` lists ``(sign, left_component, right_component)`` terms;
    operands are ``(32, n_components, B...)`` and the result is
    ``(32, len(outputs), B...)``.  Each output's terms are padded with a zero
    product to one width and summed pairwise, one ``add_mod`` call a level.
    ``square=True`` promises left == right and shares the products of
    swapped component pairs.
    """

    def __init__(self, outputs: list, square: bool = False):
        pairs: dict[tuple[int, int], int] = {}
        pos, neg = [], []
        for terms in outputs:
            plus, minus = [], []
            for sign, li, ri in terms:
                key = (min(li, ri), max(li, ri)) if square else (li, ri)
                idx = pairs.setdefault(key, len(pairs))
                (plus if sign > 0 else minus).append(idx)
            pos.append(plus)
            neg.append(minus)
        self.n_out = len(outputs)
        self.n_prod = len(pairs)
        self.signed = any(neg)
        self.width = max(max(len(t) for t in pos + neg), 1)
        zero = self.n_prod  # index of the appended zero component
        rows = pos + (neg if self.signed else [])
        self.gather = [r + [zero] * (self.width - len(r)) for r in rows]
        self.left = [li for li, _ in pairs]
        self.right = [ri for _, ri in pairs]
        self._idx: dict = {}

    def _index(self, device):
        idx = self._idx.get(device)
        if idx is None:
            as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
            idx = self._idx[device] = (
                as_t(self.left),
                as_t(self.right),
                as_t([i for row in self.gather for i in row]),
            )
        return idx

    def run(self, base: dict, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        mul, add, sub = base["mul_mod"], base["add_mod"], base["sub_mod"]
        li, ri, gi = self._index(left.device)
        prod = mul(left.index_select(1, li), right.index_select(1, ri))
        tail = prod.shape[2:]
        prod = torch.cat([prod, prod.new_zeros((_N, 1, *tail))], dim=1)
        rows = len(self.gather)
        acc = prod.index_select(1, gi).view(_N, rows, self.width, *tail)
        width = self.width
        while width > 1:
            half = width // 2
            summed = add(acc[:, :, :half], acc[:, :, half : 2 * half])
            acc = torch.cat([summed, acc[:, :, 2 * half :]], dim=2) if width % 2 else summed
            width -= half
        acc = acc[:, :, 0]
        if self.signed:
            return sub(acc[:, : self.n_out], acc[:, self.n_out :])
        return acc


def _fq2_product_terms(l0: int, l1: int, r0: int, r1: int, by_xi: bool) -> tuple:
    """Terms of ``(a0 + a1 u)(b0 + b1 u)``, times xi = 1 + u if asked, as
    (real, imaginary) lists over the four component products."""
    p00, p11, p01, p10 = (l0, r0), (l1, r1), (l0, r1), (l1, r0)
    re = [(1, *p00), (-1, *p11)]
    im = [(1, *p01), (1, *p10)]
    if by_xi:  # (re + im u)(1 + u) = (re - im) + (re + im) u
        return re + [(-s, *p) for s, *p in im], re + im
    return re, im


@functools.cache
def _fq2_mul_plan(k: int, square: bool = False) -> _Plan:
    """``k`` independent Fq2 products; operands ``(32, 2k, B...)``."""
    outs = []
    for e in range(k):
        re, im = _fq2_product_terms(2 * e, 2 * e + 1, 2 * e, 2 * e + 1, False)
        outs += [re, im]
    return _Plan(outs, square)


def _tower_plan(powers_l: list, powers_r: list, slot_of_power: dict, n: int,
                square: bool = False) -> _Plan:
    """Product of two polynomials over Fq2 in a generator g with g^n = xi.
    ``powers_l[s]`` is the power of g held in left slot s (components 2s,
    2s+1); the output has one slot per power 0..n-1 (``slot_of_power``)."""
    outs = [[[], []] for _ in range(n)]
    for sl, kl in enumerate(powers_l):
        for sr, kr in enumerate(powers_r):
            k = kl + kr
            re, im = _fq2_product_terms(2 * sl, 2 * sl + 1, 2 * sr, 2 * sr + 1, k >= n)
            slot = slot_of_power[k % n]
            outs[slot][0] += re
            outs[slot][1] += im
    return _Plan([part for slot in outs for part in slot], square)


# Fq12 slot (i, j) of the (2, 3) component block holds w^(i + 2j).
_W_POWER = [i + 2 * j for i in range(2) for j in range(3)]  # slot s = 3i + j
_W_SLOT = {k: s for s, k in enumerate(_W_POWER)}


@functools.cache
def _fq12_plan(square: bool = False) -> _Plan:
    return _tower_plan(_W_POWER, _W_POWER, _W_SLOT, 6, square)


@functools.cache
def _fq12_sparse_plan() -> _Plan:
    """f * (l0 + l3 w^3 + l5 w^5); right operand slots are (l0, l3, l5)."""
    return _tower_plan(_W_POWER, [0, 3, 5], _W_SLOT, 6)


@functools.cache
def _fq6_plan(square: bool = False) -> _Plan:
    return _tower_plan([0, 1, 2], [0, 1, 2], {0: 0, 1: 1, 2: 2}, 3, square)


@functools.cache
def _conj_mul_plan(k: int) -> _Plan:
    """``conj(a_e) * g_e`` for k independent Fq2 pairs:
    (a0 - a1 u)(g0 + g1 u) = (a0 g0 + a1 g1) + (a0 g1 - a1 g0) u."""
    outs = []
    for e in range(k):
        a0, a1, g0, g1 = 2 * e, 2 * e + 1, 2 * e, 2 * e + 1
        outs += [[(1, a0, g0), (1, a1, g1)], [(1, a0, g1), (-1, a1, g0)]]
    return _Plan(outs)


class _PlaneLayout:
    """Limb planes outermost, batch last; components always on axis 1."""

    def __init__(self, device: torch.device):
        self.device = device

    def stack(self, parts):
        return torch.stack(torch.broadcast_tensors(*parts), dim=1)

    def fq2_like(self, c, like):
        """Fq2 constant broadcast to ``like`` (any number of batch axes)."""
        arr = torch.tensor(fq2_to_limbs(c).T.copy(), device=like.device)  # (32, 2)
        return arr.view(_N, 2, *([1] * (like.dim() - 2))).expand(like.shape)

    def one_fq12(self):
        one = np.zeros((_N, 2, 3, 2), np.int32)
        one[:, 0, 0, 0] = BI.to_limbs(1)
        return torch.tensor(one, device=self.device)

    def broadcast_fq12(self, const, batch_shape):
        c = const.view(const.shape + (1,) * len(batch_shape))
        return c.expand(const.shape + tuple(batch_shape))

    def batch_shape(self, f):
        return tuple(f.shape[4:])

    def fq_batch_shape(self, a):
        return tuple(a.shape[1:])

    def expand_mask(self, m):
        return m  # trailing batch axes: masks broadcast as they are

    def kslice(self, f, sl):
        return f[..., sl]

    def kconcat(self, parts):
        return torch.cat(parts, dim=-1)

    def ksize(self, f):
        return f.shape[-1]


def make_fq12_ops(device: torch.device) -> dict:
    """The plane tower's ops dict over the field kernels, constants on
    ``device``."""
    base = make_plane_ops()
    mul, add, sub = base["mul_mod"], base["add_mod"], base["sub_mod"]
    lay = _PlaneLayout(device)

    def neg(a):
        return sub(torch.zeros_like(a), a)

    def _batch(a, comps):
        # batch axes of a tower element whose component block has `comps`
        # base components: everything after axis 0 and the block
        k, size = 1, 1
        while size < comps:
            size *= a.shape[k]
            k += 1
        return a.shape[k:]

    def _run(plan, a, b, comps_a, comps_b, out_shape):
        ba, bb = _batch(a, comps_a), _batch(b, comps_b)
        left = a.reshape(_N, comps_a, *ba)
        right = b.reshape(_N, comps_b, *bb)
        out = plan.run(base, left, right)
        return out.reshape(_N, *out_shape, *out.shape[2:])

    # ------------------------------------------------------------- Fq2
    def fq2(c0, c1):
        return lay.stack([c0, c1])

    def fq2_mul(a, b):
        return _run(_fq2_mul_plan(1), a, b, 2, 2, (2,))

    def fq2_sq(a):
        return _run(_fq2_mul_plan(1, True), a, a, 2, 2, (2,))

    def fq2_mul_many(pairs):
        """Independent Fq2 products in one plan: ``[(a, b), ...]``."""
        xs = torch.broadcast_tensors(*[t for ab in pairs for t in ab])
        left = torch.stack(xs[0::2], dim=1)  # (32, k, 2, B...)
        right = torch.stack(xs[1::2], dim=1)
        k = len(pairs)
        out = _run(_fq2_mul_plan(k), left, right, 2 * k, 2 * k, (k, 2))
        return out.unbind(1)

    def fq2_conj(a):
        return fq2(a[:, 0], neg(a[:, 1]))

    def fq2_mul_by_xi(a):
        # xi = 1 + u: (a0 - a1, a0 + a1)
        return fq2(sub(a[:, 0], a[:, 1]), add(a[:, 0], a[:, 1]))

    _pm2_bits = _bits_lsb(F.P - 2)

    def fp_inv(a):
        """a^(p-2) (0 -> 0): LSB-first square-and-multiply; the square and
        the product of a set bit go through one call."""
        result, pw = None, a
        n = len(_pm2_bits)
        for i, bit in enumerate(_pm2_bits):
            last = i + 1 == n
            if bit and result is None:
                result = pw
                if not last:
                    pw = mul(pw, pw)
            elif bit and not last:
                both = mul(torch.stack([result, pw], dim=1), torch.stack([pw, pw], dim=1))
                result, pw = both[:, 0], both[:, 1]
            elif bit:
                result = mul(result, pw)
            elif not last:
                pw = mul(pw, pw)
        return result

    def fq2_inv(a):
        sq = mul(a, a)
        ninv = fp_inv(add(sq[:, 0], sq[:, 1]))
        t = mul(a, ninv.unsqueeze(1))
        return fq2(t[:, 0], neg(t[:, 1]))

    # ------------------------------------------------------------- Fq6
    def fq6(c0, c1, c2):
        return lay.stack([c0, c1, c2])

    def fq6_sub(a, b):
        return sub(a, b)

    def fq6_neg(a):
        return neg(a)

    def fq6_mul(a, b):
        return _run(_fq6_plan(), a, b, 6, 6, (3, 2))

    def fq6_sq(a):
        return _run(_fq6_plan(True), a, a, 6, 6, (3, 2))

    def fq6_mul_by_v(a):
        return fq6(fq2_mul_by_xi(a[:, 2]), a[:, 0], a[:, 1])

    def fq6_inv(a):
        a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
        s0, s2, s1, m12, m01, m02 = fq2_mul_many(
            [(a0, a0), (a2, a2), (a1, a1), (a1, a2), (a0, a1), (a0, a2)]
        )
        c0 = sub(s0, fq2_mul_by_xi(m12))
        c1 = sub(fq2_mul_by_xi(s2), m01)
        c2 = sub(s1, m02)
        t21, t12, t00 = fq2_mul_many([(a2, c1), (a1, c2), (a0, c0)])
        t = add(fq2_mul_by_xi(add(t21, t12)), t00)
        tinv = fq2_inv(t)
        return fq6(*fq2_mul_many([(c0, tinv), (c1, tinv), (c2, tinv)]))

    # ------------------------------------------------------------- Fq12
    def fq12(c0, c1):
        return lay.stack([c0, c1])

    def fq12_mul(a, b):
        return _run(_fq12_plan(), a, b, 12, 12, (2, 3, 2))

    def fq12_sq(a):
        return _run(_fq12_plan(True), a, a, 12, 12, (2, 3, 2))

    def fq12_mul_by_035(f, l0, l3, l5):
        """f * (l0 + l3 w^3 + l5 w^5) for Fq2 line coefficients."""
        line = torch.stack(torch.broadcast_tensors(l0, l3, l5), dim=1)  # (32, 3, 2, B...)
        return _run(_fq12_sparse_plan(), f, line, 12, 6, (2, 3, 2))

    def fq12_conj(a):
        return fq12(a[:, 0], neg(a[:, 1]))

    def fq12_inv(a):
        # (a0 + a1 w)^-1 = (a0 - a1 w) / (a0^2 - v a1^2); the two Fq6 squares
        # and the two final products each share a call on a trailing axis
        halves = torch.stack([a[:, 0], a[:, 1]], dim=-1)
        sq = fq6_sq(halves)
        tinv = fq6_inv(fq6_sub(sq[..., 0], fq6_mul_by_v(sq[..., 1])))
        prods = fq6_mul(halves, tinv.unsqueeze(-1))
        return fq12(prods[..., 0], fq6_neg(prods[..., 1]))

    # --------------------------------------------------- Frobenius maps
    # frob(c_k w^k) = conj(c_k) * xi^(k (p-1) / 6) w^k; the gammas are taken
    # numerically from the host field module, per slot (i, j):
    # gamma12^i * gamma6_1^j.
    gammas = []
    for i in range(2):
        for j in range(3):
            g = F.FQ2_ONE
            if i:
                g = F.fq2_mul(g, F._GAMMA12)
            for _ in range(j):
                g = F.fq2_mul(g, F._GAMMA6_1)
            gammas.append(g)
    gamma_planes = torch.tensor(
        np.stack([fq2_to_limbs(g) for g in gammas]).reshape(12, _N).T.copy(), device=device
    )  # (32, 12)

    def fq12_frobenius(a):
        tail = a.shape[4:]
        g = gamma_planes.view(_N, 12, *([1] * len(tail)))
        return _run(_conj_mul_plan(6), a, g, 12, 12, (2, 3, 2))

    one_fq12 = lay.one_fq12()

    def fq12_one(batch_shape=()):
        return lay.broadcast_fq12(one_fq12, batch_shape)

    def fq12_is_one(a):
        """Boolean mask over the batch axes."""
        target = fq12_one(lay.batch_shape(a))
        return torch.all((a == target).reshape(_N * 12, *a.shape[4:]), dim=0)

    return {
        "fq2_mul": fq2_mul,
        "fq2_sq": fq2_sq,
        "fq2_mul_many": fq2_mul_many,
        "fq2_conj": fq2_conj,
        "fq2_mul_by_xi": fq2_mul_by_xi,
        "fq2_inv": fq2_inv,
        "fp_inv": fp_inv,
        "fq6_mul": fq6_mul,
        "fq6_mul_by_v": fq6_mul_by_v,
        "fq6_sub": fq6_sub,
        "fq6_sq": fq6_sq,
        "fq6_inv": fq6_inv,
        "fq12_mul": fq12_mul,
        "fq12_sq": fq12_sq,
        "fq12_mul_by_035": fq12_mul_by_035,
        "fq12_conj": fq12_conj,
        "fq12_inv": fq12_inv,
        "fq12_frobenius": fq12_frobenius,
        "fq12_one": fq12_one,
        "fq12_is_one": fq12_is_one,
        "mul": mul,
        "add": add,
        "sub": sub,
        "neg": neg,
        "layout": lay,
    }


_FQ12_PLANE_OPS: dict = {}


def get_fq12_plane_ops(device: torch.device | str) -> dict:
    """The plane tower for ``device`` (built once per device)."""
    dev = torch.device(device)
    ops = _FQ12_PLANE_OPS.get(dev)
    if ops is None:
        ops = _FQ12_PLANE_OPS[dev] = make_fq12_ops(dev)
    return ops
