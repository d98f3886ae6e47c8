"""Chained device RLC batch verification (one chain of device stages per call).

The port's counterpart of the JAX package's ``ops/bls_batch.py``
(single-device parts).  The host packs limb planes once and pulls back one
boolean per check:

    ladders (r_i * pk_i, r_i * sig_i)           [RLC-width plane ladders]
    -> gather into (check, group, slot) rectangles
    -> Jacobian tree reductions (group pk sums, per-check sig sum)
    -> batched Fermat normalization (Jacobian -> affine, no host inversion)
    -> Miller loop over (check, group+1) pairs    [ops/bls_pairing]
    -> masked per-check product
    -> final exponentiation, == 1                 [the pairing tail]

The tail is :mod:`.bls_pairing`'s ``check_tail``: below its
``DEVICE_TAIL_MIN`` checks the masked products come to the host in one copy
and the native library finishes them (the hybrid tail), from it on the
final exponentiation runs on the device too (the composed tail).  Every
field operation on the device is a call of one of the three field kernels
(:mod:`.bigint_pallas`).  Grouping by message, infinity masking and
dead-slot padding are the reference's: a group or signature sum that reduces
to infinity contributes e(inf, Q) = 1, realised by masking its Miller slot to
the Fq12 identity.  Tree reductions are the reference's pairwise halving
(``_tree_reduce_j``), so every intermediate Jacobian limb is comparable with
the reference's.  Flat batches are padded to a multiple of 8 with at least
one dead lane (the reference's 1024-lane quantum is a TPU tile size).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls import curve as C
from . import bigint as BI
from .bls_fq12 import get_fq12_plane_ops
from .bls_g1 import _limbs_batch, _scalar_bits_batch, g1_jacobian_ops
from .bls_g2 import fq2_limbs_batch, g2_jacobian_ops
from .bls_pairing import get_pairing_ops
from .rlc import COEFF_BITS
from .sha256 import resolve_device

__all__ = [
    "DeviceCommitteeCache",
    "RegistryPlaneStore",
    "aggregate_g1_chain",
    "chain_verify",
    "chain_verify_cached",
    "get_chain_ops",
    "get_plane_store",
    "plane_store_stats",
]

_QUANTUM = 8


def _pow2(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


def _g1_planes(points) -> tuple[np.ndarray, np.ndarray]:
    """[(x, y)] -> two (32, N) plane arrays."""
    bx = _limbs_batch([p[0] for p in points])
    by = _limbs_batch([p[1] for p in points])
    return np.ascontiguousarray(bx.T), np.ascontiguousarray(by.T)


def _g2_planes(points) -> tuple[np.ndarray, np.ndarray]:
    """[((x0,x1),(y0,y1))] -> two (32, 2, N) plane arrays."""
    bx = fq2_limbs_batch([p[0] for p in points])
    by = fq2_limbs_batch([p[1] for p in points])
    return (
        np.ascontiguousarray(bx.transpose(2, 1, 0)),
        np.ascontiguousarray(by.transpose(2, 1, 0)),
    )


def make_chain_ops(device: torch.device) -> dict:
    """The chained-stage functions over tensors on ``device``."""
    fq = get_fq12_plane_ops(device)
    g1j = g1_jacobian_ops(device)
    g2j = g2_jacobian_ops(device)
    pairing = get_pairing_ops(device)
    one_plane = torch.tensor(BI.to_limbs(1), device=device)  # (32,)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)

    def ladder_g1(bx, by, kbits, live):
        X, Y, Z, inf = g1j["ladder"]((bx, by), kbits)
        return X, Y, Z, inf | ~live

    def ladder_g2(bx, by, kbits, live):
        X, Y, Z, inf = g2j["ladder"]((bx, by), kbits)
        return X, Y, Z, inf | ~live

    def norm_g1(X, Y, Z):
        """Jacobian -> affine via batched Fermat inversion (z=0 -> (0,0))."""
        zi = fq["fp_inv"](Z)
        zi2 = fq["mul"](zi, zi)
        zi3 = fq["mul"](zi2, zi)
        xy = fq["mul"](torch.stack([X, Y], dim=1), torch.stack([zi2, zi3], dim=1))
        return xy[:, 0], xy[:, 1]

    def norm_g2(X, Y, Z):
        zi = fq["fq2_inv"](Z)
        (zi2,) = fq["fq2_mul_many"]([(zi, zi)])
        (zi3,) = fq["fq2_mul_many"]([(zi2, zi)])
        return fq["fq2_mul_many"]([(X, zi2), (Y, zi3)])

    # -G1 generator, the fixed P of the signature-sum pair.
    _ng = C.g1.affine_neg(C.G1_GENERATOR)
    neg_g1_x = t(BI.to_limbs(_ng[0])[:, None, None])  # (32, 1, 1)
    neg_g1_y = t(BI.to_limbs(_ng[1])[:, None, None])

    def tree_reduce(jac, pt):
        """Pairwise halving over the last axis (power-of-two length)."""
        X, Y, Z, inf = pt
        while X.shape[-1] > 1:
            a = (X[..., ::2], Y[..., ::2], Z[..., ::2], inf[..., ::2])
            b = (X[..., 1::2], Y[..., 1::2], Z[..., 1::2], inf[..., 1::2])
            X, Y, Z, inf = jac["jac_add"](a, b)
        return X[..., 0], Y[..., 0], Z[..., 0], inf[..., 0]

    def _ones_like(bx):
        return one_plane.view(32, *([1] * (bx.dim() - 1))).expand(bx.shape)

    def prep(jac1, jac2, idx_g1, idx_sig, h_x, h_y, static_live):
        """Gather + reduce + normalize + pack the Miller batch.

        jac1/jac2: ladder outputs over the flat entry batch.  idx_g1:
        (c, m1, s) entry indices per (check, group, slot); idx_sig: (c, e)
        per (check, slot); dead slots point at an entry whose inf flag is
        set.  h_x/h_y: (32, 2, c, m1) hashed message points; static_live:
        (c, m) host liveness (m = m1 + 1, slot m-1 is the signature pair).
        """
        c, m1, s = idx_g1.shape
        X, Y, Z, inf = jac1
        flat = idx_g1.reshape(-1)
        g = (
            X.index_select(1, flat).reshape(32, c, m1, s),
            Y.index_select(1, flat).reshape(32, c, m1, s),
            Z.index_select(1, flat).reshape(32, c, m1, s),
            inf.index_select(0, flat).reshape(c, m1, s),
        )
        group_jac = tree_reduce(g1j, g)  # (32, c, m1), (c, m1)

        X2, Y2, Z2, inf2 = jac2
        e = idx_sig.shape[1]
        flat2 = idx_sig.reshape(-1)
        s2 = (
            X2.index_select(2, flat2).reshape(32, 2, c, e),
            Y2.index_select(2, flat2).reshape(32, 2, c, e),
            Z2.index_select(2, flat2).reshape(32, 2, c, e),
            inf2.index_select(0, flat2).reshape(c, e),
        )
        sig_jac = tree_reduce(g2j, s2)  # (32, 2, c), (c,)
        return finish(group_jac, sig_jac, h_x, h_y, static_live)

    def finish(group_jac, sig_jac, h_x, h_y, static_live):
        """Normalize reduced Jacobians and pack the (c, m) Miller batch:
        groups in slots 0..m1-1, the signature pair last."""
        gX, gY, gZ, ginf = group_jac
        sX, sY, sZ, sinf = sig_jac
        c = gX.shape[1]
        px_g, py_g = norm_g1(gX, gY, gZ)
        qx_s, qy_s = norm_g2(sX, sY, sZ)
        px = torch.cat([px_g, neg_g1_x.expand(32, c, 1)], -1)
        py = torch.cat([py_g, neg_g1_y.expand(32, c, 1)], -1)
        qx = torch.cat([h_x, qx_s[..., None]], -1)
        qy = torch.cat([h_y, qy_s[..., None]], -1)
        inf_all = torch.cat([ginf, sinf[:, None]], -1)  # (c, m)
        mask = static_live & ~inf_all
        return px, py, qx, qy, mask

    def committee_sums(rx, ry, idx, inf):
        """Full-committee pubkey sums from the device registry.

        ``rx/ry``: (32, N) registry planes.  ``idx``: (C, kp) member indices
        (kp pow2-padded; padded slots carry ``inf`` True).  Returns affine
        (32, C) sums (the once-per-epoch precompute)."""
        c, kp = idx.shape
        gx = rx.index_select(1, idx.reshape(-1)).reshape(32, c, kp)
        gy = ry.index_select(1, idx.reshape(-1)).reshape(32, c, kp)
        X, Y, Z, _ = tree_reduce(g1j, (gx, gy, _ones_like(gx), inf))
        return norm_g1(X, Y, Z)

    def agg_corrected(rx, ry, sum_x, sum_y, comm_ids, miss_idx, miss_inf):
        """Per-entry aggregate pubkeys as ``full_sum - missing_members``:
        ``miss_idx`` (E, mm) registry indices of NON-participating members
        (dead slots flagged in ``miss_inf``), ``comm_ids`` (E,).  Returns
        affine (32, E) points plus an (E,) infinity mask."""
        e, mm = miss_idx.shape
        gx = rx.index_select(1, miss_idx.reshape(-1)).reshape(32, e, mm)
        gy = ry.index_select(1, miss_idx.reshape(-1)).reshape(32, e, mm)
        X, Y, Z, minf = tree_reduce(g1j, (gx, gy, _ones_like(gx), miss_inf))
        fx = sum_x.index_select(1, comm_ids)  # (32, E)
        fy = sum_y.index_select(1, comm_ids)
        full = (fx, fy, _ones_like(fx), torch.zeros((e,), dtype=torch.bool, device=device))
        # -missing: Jacobian negation is (X, -Y, Z)
        X3, Y3, Z3, inf3 = g1j["jac_add"](full, (X, fq["neg"](Y), Z, minf))
        ax, ay = norm_g1(X3, Y3, Z3)
        return ax, ay, inf3

    def aggregate_g1(bx, by, inf):
        X, Y, Z, _ = tree_reduce(g1j, (bx, by, _ones_like(bx), inf))
        return norm_g1(X, Y, Z)

    return {
        "device": device,
        "tensor": t,
        "ladder_g1": ladder_g1,
        "ladder_g2": ladder_g2,
        "committee_sums": committee_sums,
        "agg_corrected": agg_corrected,
        "prep": prep,
        "aggregate_g1": aggregate_g1,
        "miller": pairing["miller"],
        "check_tail": pairing["check_tail"],
    }


_CHAIN_OPS: dict = {}


def _indexed_device(device) -> torch.device:
    """``resolve_device`` with the current card's index filled in, so that
    ``"cuda"`` and ``"cuda:0"`` key one entry."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def get_chain_ops(device: str | torch.device | None = None) -> dict:
    """The chain's stage functions on ``device`` (default: the card)."""
    dev = _indexed_device(device)
    if dev not in _CHAIN_OPS:
        _CHAIN_OPS[dev] = make_chain_ops(dev)
    return _CHAIN_OPS[dev]


def _entry_budget(n: int) -> tuple[int, int]:
    """Padded flat-entry batch size and the canonical dead-slot index:
    B > n always, and index n is a dead slot (live=False -> inf)."""
    return (n // _QUANTUM + 1) * _QUANTUM, n


def chain_verify(
    checks, device: str | torch.device | None = None, coeff_bits: int = COEFF_BITS
) -> list[bool]:
    """Verify C independent RLC pairing-product checks in one device chain.

    Each check is ``(entries, h_points, group_ids)``: ``entries`` lists
    ``(pk_xy, sig_xy, coeff)`` — G1 affine int pair, G2 affine Fq2 pair, RLC
    coefficient in [1, 2^coeff_bits); ``h_points`` the G2 message points, one
    per group; ``group_ids`` each entry's group.  Returns one bool per check:
    prod_g e(sum_{i in g} r_i pk_i, H_g) * e(-g1, sum_i r_i sig_i) == 1.
    Points must be on-curve and subgroup-checked, infinities filtered.
    """
    if not checks:
        return []
    ops = get_chain_ops(device)
    t = ops["tensor"]
    flat_pk, flat_sig, flat_coeff = [], [], []
    for entries, _, _ in checks:
        for pk, sig, coeff in entries:
            flat_pk.append(pk)
            flat_sig.append(sig)
            flat_coeff.append(coeff)
    n = len(flat_pk)
    b, dead = _entry_budget(n)

    # flat entry planes, padded with the generator at dead slots
    pad = b - n
    pkx, pky = _g1_planes(flat_pk + [C.G1_GENERATOR] * pad)
    sgx, sgy = _g2_planes(flat_sig + [C.G2_GENERATOR] * pad)
    kbits = t(_scalar_bits_batch(flat_coeff + [1] * pad, coeff_bits).T)
    live = np.zeros(b, bool)
    live[:n] = True
    live = t(live)
    jac1 = ops["ladder_g1"](t(pkx), t(pky), kbits, live)
    jac2 = ops["ladder_g2"](t(sgx), t(sgy), kbits, live)
    return _run_checks_tail(ops, jac1, jac2, checks, dead)


def _run_checks_tail(ops, jac1, jac2, checks, dead: int) -> list[bool]:
    """The shared back half of every chained verify: gather the laddered
    entries into (check, group, slot) rectangles, reduce, Miller, and the
    pairing tail (hybrid or composed by the number of checks) — one boolean
    per check.  ``checks`` supplies only the
    layout (entry counts, h_points, group_ids)."""
    t = ops["tensor"]
    n_checks = len(checks)
    offsets, off = [], 0
    for entries, _, _ in checks:
        offsets.append(off)
        off += len(entries)

    max_groups = max(max((len(h) for _, h, _ in checks), default=1), 1)
    m1 = _pow2(max_groups + 1) - 1  # groups per check; slot m1 is the sig pair
    max_slot = 1
    for _, h_points, group_ids in checks:
        counts = [0] * len(h_points)
        for g in group_ids:
            counts[g] += 1
        if counts:
            max_slot = max(max_slot, max(counts))
    s = _pow2(max_slot)
    e = _pow2(max((len(c[0]) for c in checks), default=1) or 1)

    idx_g1 = np.full((n_checks, m1, s), dead, np.int64)
    idx_sig = np.full((n_checks, e), dead, np.int64)
    static_live = np.zeros((n_checks, m1 + 1), bool)
    for ci, (entries, h_points, group_ids) in enumerate(checks):
        fill = [0] * len(h_points)
        for ei, g in enumerate(group_ids):
            idx_g1[ci, g, fill[g]] = offsets[ci] + ei
            fill[g] += 1
        idx_sig[ci, : len(entries)] = offsets[ci] + np.arange(len(entries))
        static_live[ci, : len(h_points)] = [c > 0 for c in fill]
        static_live[ci, m1] = len(entries) > 0

    # hashed message points as (32, 2, C, m1); dead slots reuse the
    # generator (masked out after the Miller loop)
    h_points_padded = []
    for _, h_points, _ in checks:
        h_points_padded.extend(list(h_points) + [C.G2_GENERATOR] * (m1 - len(h_points)))
    hx, hy = _g2_planes(h_points_padded)
    px, py, qx, qy, mask = ops["prep"](
        jac1,
        jac2,
        t(idx_g1),
        t(idx_sig),
        t(hx.reshape(32, 2, n_checks, m1)),
        t(hy.reshape(32, 2, n_checks, m1)),
        t(static_live),
    )
    # the Miller loop keeps the (C, m) batch shape; the group axis is
    # innermost, which is what the masked product reduces
    f = ops["miller"](px, py, qx, qy)
    ok = ops["check_tail"](f, mask)
    return [bool(v) for v in ok.cpu().tolist()]


def chain_verify_cached(
    cache: "DeviceCommitteeCache", checks, coeff_bits: int = COEFF_BITS
) -> list[bool]:
    """:func:`chain_verify` with aggregate pubkeys taken from the epoch
    committee cache (on the cache's device) instead of host-packed points —
    the node-path drain.

    Each check is ``(entries, h_points, group_ids)`` where an entry is
    ``(comm_id, miss_members, sig_xy, coeff)``: the committee index into the
    cache, the registry indices of NON-participating members (at most
    ``cache.mmax``), and the signature and coefficient as in
    :func:`chain_verify`.  The aggregate pubkey ``full_sum[comm_id] -
    sum(missing)`` is computed on the device and flows straight into the
    ladder.  Callers pre-reject empty-participation entries.
    """
    if not checks:
        return []
    ops = cache._ops
    t = ops["tensor"]
    mmax = cache.mmax
    flat = [entry for entries, _, _ in checks for entry in entries]
    n = len(flat)
    b, dead = _entry_budget(n)
    pad = b - n

    cid = np.zeros(b, np.int64)
    miss_idx = np.zeros((b, mmax), np.int64)
    miss_inf = np.ones((b, mmax), bool)
    for i, (comm_id, miss, _, _) in enumerate(flat):
        mc = len(miss)
        if mc > mmax:
            raise ValueError(f"entry {i}: {mc} missing members exceeds cache capacity {mmax}")
        cid[i] = comm_id
        miss_idx[i, :mc] = miss
        miss_inf[i, :mc] = False

    sgx, sgy = _g2_planes([sig for _, _, sig, _ in flat] + [C.G2_GENERATOR] * pad)
    kbits = t(_scalar_bits_batch([coeff for _, _, _, coeff in flat] + [1] * pad, coeff_bits).T)
    live = np.zeros(b, bool)
    live[:n] = True
    live = t(live)

    agg_x, agg_y, agg_inf = cache.aggregate(cid, miss_idx, miss_inf)
    # an infinity aggregate kills only the G1 lane: the check keeps a
    # signature term with no matching pubkey term, so it FAILS and bisection
    # blames the entry (the spec verdict for an infinity aggregate pubkey)
    jac1 = ops["ladder_g1"](agg_x, agg_y, kbits, live & ~agg_inf)
    jac2 = ops["ladder_g2"](t(sgx), t(sgy), kbits, live)
    return _run_checks_tail(ops, jac1, jac2, checks, dead)


def aggregate_g1_chain(points_planes, device: str | torch.device | None = None):
    """Tree-reduce G1 points on the device: ``(32, ..., K)`` -> affine
    ``(32, ...)``.  The reduce axis is padded to a power of two with
    infinity entries; lanes that reduce to infinity come back as (0, 0)."""
    ops = get_chain_ops(device)
    t = ops["tensor"]
    bx, by = (np.asarray(v) for v in points_planes)
    k = bx.shape[-1]
    kp = _pow2(k)
    pad = [(0, 0)] * (bx.ndim - 1) + [(0, kp - k)]
    bx, by = np.pad(bx, pad), np.pad(by, pad)
    inf = np.zeros(bx.shape[1:], bool)
    inf[..., k:] = True
    return ops["aggregate_g1"](t(bx), t(by), t(inf))


class RegistryPlaneStore:
    """One device copy of a chain's registry pubkey planes (unsharded).

    Capacity is padded to power-of-two column counts.  Growth within
    capacity writes only the new columns into the existing buffer, in place
    (a cache holding the buffer only ever addresses columns it knew, so it
    is unaffected); growth past capacity allocates a doubled buffer and
    copies the resident prefix on the device.  A mutated prefix (compared
    against the retained host reference) drops the buffer and bumps
    ``version``; caches built against the old buffer keep it.
    """

    def __init__(self, device: str | torch.device | None = None, min_capacity: int = 1024):
        self.device = resolve_device(device)
        self._min_cap = max(1, int(min_capacity))
        self.count = 0  # live registry columns
        self.capacity = 0  # allocated columns (power of two)
        self.rx = None  # (32, capacity) int32 on the device
        self.ry = None
        self.version = 0  # bumped on prefix invalidation
        self.uploaded_cols = 0  # host->device columns shipped
        self._host_rx = None
        self._host_ry = None

    def update(self, rx, ry):
        """Grow the device planes to cover the host planes ``(rx, ry)``
        (numpy, (32, n)); returns the full-capacity ``(rx, ry)`` buffers."""
        rx = np.asarray(rx)
        ry = np.asarray(ry)
        n = rx.shape[1]
        k = min(n, self.count)
        if k and not (
            np.array_equal(rx[:, :k], self._host_rx[:, :k])
            and np.array_equal(ry[:, :k], self._host_ry[:, :k])
        ):
            self.rx = self.ry = None
            self.count = self.capacity = 0
            self._host_rx = self._host_ry = None
            self.version += 1
        if n <= self.count:
            return self.rx, self.ry
        new_x = torch.as_tensor(np.ascontiguousarray(rx[:, self.count : n]), device=self.device)
        new_y = torch.as_tensor(np.ascontiguousarray(ry[:, self.count : n]), device=self.device)
        if n > self.capacity:
            cap = _pow2(max(n, self._min_cap))
            grown_x = torch.zeros((32, cap), dtype=torch.int32, device=self.device)
            grown_y = torch.zeros((32, cap), dtype=torch.int32, device=self.device)
            if self.count:
                grown_x[:, : self.count] = self.rx[:, : self.count]
                grown_y[:, : self.count] = self.ry[:, : self.count]
            self.rx, self.ry, self.capacity = grown_x, grown_y, cap
        self.rx[:, self.count : n] = new_x
        self.ry[:, self.count : n] = new_y
        self.uploaded_cols += n - self.count
        self.count = n
        self._host_rx, self._host_ry = rx, ry
        return self.rx, self.ry

    @property
    def resident_bytes(self) -> int:
        """Device bytes of the two plane buffers (capacity, not count)."""
        return 0 if self.rx is None else 2 * self.rx.numel() * self.rx.element_size()


# one store per (chain, device): genesis_validators_root is the chain
# identity the host-side planes cache keys on
_PLANE_STORES: dict = {}


def get_plane_store(chain_key: bytes, device: str | torch.device | None = None) -> RegistryPlaneStore:
    """The per-chain shared :class:`RegistryPlaneStore` on ``device``
    (default: the card), created on first use."""
    dev = _indexed_device(device)
    key = (bytes(chain_key), dev)
    store = _PLANE_STORES.get(key)
    if store is None:
        store = _PLANE_STORES[key] = RegistryPlaneStore(dev)
    return store


def plane_store_stats() -> dict:
    """Totals over every live plane store: count, device bytes, columns
    shipped host to device."""
    stores = list(_PLANE_STORES.values())
    return {
        "stores": len(stores),
        "resident_bytes": sum(s.resident_bytes for s in stores),
        "uploaded_cols": sum(s.uploaded_cols for s in stores),
    }


class DeviceCommitteeCache:
    """Epoch-scoped device-resident committee aggregate pubkeys.

    Committee membership is fixed per epoch, so each committee's FULL pubkey
    sum is computed once (chunked gather + Jacobian tree reduce on the
    device) and each drain pays only a small correction per aggregate:

        agg_pk[entry] = full_sum[committee] - sum(non-participating members)

    ``registry_planes`` is a :class:`RegistryPlaneStore` (the cache holds a
    reference to its one device buffer) or a raw ``(rx, ry)`` pair of
    ``(32, N)`` planes, numpy or tensors, copied to ``device``.
    """

    def __init__(
        self,
        registry_planes,
        committees,
        device: str | torch.device | None = None,
        chunk: int = 256,
        lengths=None,
        mmax: int | None = None,
    ):
        if isinstance(registry_planes, RegistryPlaneStore):
            store = registry_planes
            if device is not None and resolve_device(device) != store.device:
                raise ValueError(f"device {device} conflicts with the plane store's {store.device}")
            if store.rx is None:
                raise ValueError("plane store is empty; update() it first")
            self.plane_store = store
            self._plane_version = store.version
            self._ops = get_chain_ops(store.device)
            self.rx, self.ry = store.rx, store.ry
        else:
            self.plane_store = None
            self._plane_version = None
            self._ops = get_chain_ops(device)
            rx, ry = registry_planes
            self.rx = torch.as_tensor(rx, device=self._ops["device"])
            self.ry = torch.as_tensor(ry, device=self._ops["device"])
        self.device = self._ops["device"]
        t = self._ops["tensor"]
        committees = np.asarray(committees, np.int64)
        n_comm, k = committees.shape
        kp = _pow2(k)
        # correction capacity: 12.5% of the committee by default
        self.mmax = mmax if mmax is not None else _pow2(max(k // 8, 2))
        chunk = min(chunk, _pow2(n_comm))
        cpad = (n_comm + chunk - 1) // chunk * chunk
        idx = np.zeros((cpad, kp), np.int64)
        idx[:n_comm, :k] = committees
        inf = np.ones((cpad, kp), bool)
        if lengths is None:
            inf[:n_comm, :k] = False
        else:
            # ragged committees: member slots beyond each row's length stay
            # flagged infinity so they never enter the sum
            lengths = np.asarray(lengths, np.int64)
            if lengths.shape != (n_comm,):
                raise ValueError("lengths must be (n_committees,)")
            inf[:n_comm, :k] = np.arange(k)[None, :] >= lengths[:, None]
        sums_x, sums_y = [], []
        for i in range(0, cpad, chunk):
            sx, sy = self._ops["committee_sums"](
                self.rx, self.ry, t(idx[i : i + chunk]), t(inf[i : i + chunk])
            )
            sums_x.append(sx)
            sums_y.append(sy)
        self.sum_x = torch.cat(sums_x, dim=1)[:, :n_comm]
        self.sum_y = torch.cat(sums_y, dim=1)[:, :n_comm]

    def _refresh_planes(self) -> None:
        """Adopt the store's current buffer after growth rebound it (the
        prefix is unchanged); keep the old one after an invalidation."""
        s = self.plane_store
        if s is not None and s.rx is not None and s.version == self._plane_version:
            self.rx, self.ry = s.rx, s.ry

    def aggregate(self, comm_ids, miss_idx, miss_inf):
        """Affine aggregate pubkey planes for one drain's entries:
        ``(x_planes, y_planes, inf_mask)``.  Empty-participation entries
        come back flagged infinity and MUST be marked dead by the caller."""
        t = self._ops["tensor"]
        self._refresh_planes()
        return self._ops["agg_corrected"](
            self.rx,
            self.ry,
            self.sum_x,
            self.sum_y,
            t(np.asarray(comm_ids, np.int64)),
            t(np.asarray(miss_idx, np.int64)),
            t(np.asarray(miss_inf, bool)),
        )
