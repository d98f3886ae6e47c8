"""KZG polynomial commitments (EIP-4844) on the device G1 ladder.

The port's counterpart of the JAX package's ``da/kzg.py``.  A blob is
``FIELD_ELEMENTS_PER_BLOB`` scalars read as a polynomial in *evaluation
form* over the bit-reversal-ordered roots-of-unity domain; its commitment is
one multi-scalar multiplication against the Lagrange-form trusted setup

    C = sum_i  blob_i * [L_i(tau)] G1

so every MSM's scalar products run as one G1 plane ladder on the card
(:func:`..ops.bls_g1.g1_ladder`) over the live terms only, chunked past
:data:`MSM_CHUNK` lanes; the products are summed on the host.  Proof
verification is
pairing-based:

    e(C - [y] G1, G2)  ==  e(Q, [tau - z] G2)

and a batch of B blob proofs folds under a Fiat-Shamir random linear
combination into ONE pairing check: with per-item challenges ``z_i``,
claimed values ``y_i`` and 128-bit fold coefficients ``r_i``,

    C' = sum_i r_i (C_i - [y_i] G1 + [z_i] Q_i),   Q' = sum_i r_i Q_i
    e(C', G2) * e(-Q', [tau] G2)  ==  1

where the ``3B + 1`` products of C' and Q' come out of one ladder dispatch.
Every path is bit-exact against the pure-host oracle (``g1.multiply`` per
term, ``_msm(..., host=True)``): affine coordinates are unique, so equal group math
means equal verdicts and equal compressed bytes.  The pairings run on the
host (:func:`..crypto.bls.pairing.pairing_check`).

Telemetry, as in the JAX package: the ``kzg_verify`` span around each
verification's folding and pairing check, ``kzg_blobs_verified_total``
by result (``ok``/``reject``), and ``kzg_msm_total`` terms by path
(``device``: the card's ladder; ``host``: the host oracle).

**Trusted setup**: :func:`dev_setup` derives tau from SHA-256 — a DEV-ONLY
insecure ceremony (tau is public!) that makes commitments reproducible
across processes and needs no download; :func:`load_trusted_setup` ingests
real Lagrange-form points.

Not carried over from the JAX package: ``GRAFT_KZG_SHARD`` (a round-robin
split of each MSM, the single-host stand-in for a multi-chip MSM), the drop
to the host oracle on a device fault (a device error raises), and the
``kzg_msm`` shape buckets that padded each dispatch to a precompiled TPU
program's size (the CUDA kernels take any lane count).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Sequence

from ..crypto.bls import curve as C
from ..crypto.bls.fields import R
from ..crypto.bls.pairing import pairing_check
from ..ops.bls_g1 import SCALAR_BITS, batch_inv_mod, g1_affine, g1_ladder
from ..ops.sha256 import resolve_device
from ..telemetry import inc, span

__all__ = [
    "KzgError",
    "MSM_CHUNK",
    "TrustedSetup",
    "blob_to_commitment",
    "blob_to_field_elements",
    "compute_blob_proof",
    "compute_proof",
    "dev_setup",
    "load_trusted_setup",
    "trusted_setup",
    "verify_blob_batch",
    "verify_blob_proof",
    "verify_proof",
    "versioned_hash",
    "warm_kzg_programs",
]

#: One field element per 32-byte big-endian chunk of a blob.
BYTES_PER_FIELD_ELEMENT = 32

#: EIP-4844 versioned-hash discriminator byte.
VERSIONED_HASH_VERSION_KZG = b"\x01"

#: The most lanes one ladder dispatch takes: a mainnet-width blob's MSM.
#: Longer MSMs run in chunks of this size, which bounds device memory.
MSM_CHUNK = 4096

# the JAX package's domain separators, byte for byte: commitments, challenges
# and fold coefficients must agree across the two packages
_DST_SETUP = b"lambda_ethereum_consensus_tpu/da-kzg/dev-setup/v1"
_DST_CHALLENGE = b"lambda_ethereum_consensus_tpu/da-kzg/challenge/v1"
_DST_RLC = b"lambda_ethereum_consensus_tpu/da-kzg/rlc/v1"


class KzgError(ValueError):
    """Malformed blob / commitment / setup input."""


# ---------------------------------------------------------------- domain


def _bit_reversal_permutation(width: int) -> list[int]:
    bits = width.bit_length() - 1
    return [int(format(i, f"0{bits}b")[::-1], 2) for i in range(width)]


def _roots_of_unity(width: int) -> list[int]:
    """The order-``width`` subgroup of Fr* in bit-reversal order (the
    EIP-4844 evaluation domain).  7 generates Fr*, so ``7^((R-1)/w)`` is a
    primitive w-th root for any w dividing the 2^32 2-adicity."""
    omega = pow(7, (R - 1) // width, R)
    if pow(omega, width, R) != 1 or pow(omega, width // 2, R) != R - 1:
        raise KzgError(f"no primitive root of unity of order {width}")
    natural = []
    acc = 1
    for _ in range(width):
        natural.append(acc)
        acc = acc * omega % R
    return [natural[i] for i in _bit_reversal_permutation(width)]


# --------------------------------------------------------- trusted setup


@dataclass(frozen=True)
class TrustedSetup:
    """Lagrange-form setup: ``g1_lagrange[i] = [L_i(tau)] G1`` over the
    bit-reversal-ordered domain, plus ``g2_tau = [tau] G2``."""

    width: int
    domain: tuple  # bit-reversal-ordered roots of unity (ints mod R)
    g1_lagrange: tuple  # affine G1 int pairs, one per domain position
    g2_tau: object  # affine G2 point


def _check_width(width: int) -> None:
    if width < 2 or width & (width - 1):
        raise KzgError(f"setup width {width} is not a power of two >= 2")


def load_trusted_setup(g1_lagrange: Sequence[bytes], g2_tau: bytes) -> TrustedSetup:
    """Ingest ceremony output: compressed Lagrange G1 points (one per
    evaluation position, width a power of two) and ``[tau] G2``."""
    width = len(g1_lagrange)
    _check_width(width)
    try:
        points = [C.g1_from_bytes(b) for b in g1_lagrange]
        tau_g2 = C.g2_from_bytes(g2_tau)
    except C.DeserializationError as exc:
        raise KzgError(f"invalid setup point: {exc}") from exc
    if any(pt is None for pt in points) or tau_g2 is None:
        raise KzgError("setup contains the point at infinity")
    return TrustedSetup(
        width=width, domain=tuple(_roots_of_unity(width)), g1_lagrange=tuple(points),
        g2_tau=tau_g2,
    )


def _dev_tau(width: int) -> int:
    """The dev setup's tau: SHA-256 of a counter, the first value that is
    nonzero and off the domain (tau in the domain would zero a Lagrange
    denominator)."""
    ctr = 0
    while True:
        digest = hashlib.sha256(
            _DST_SETUP + width.to_bytes(8, "big") + ctr.to_bytes(4, "big")
        ).digest()
        tau = int.from_bytes(digest, "big") % R
        if tau != 0 and pow(tau, width, R) != 1:
            return tau
        ctr += 1


def _lagrange_at(tau: int, domain) -> list[int]:
    """``L_i(tau) = d_i (tau^w - 1) / (w (tau - d_i))`` over the domain."""
    width = len(domain)
    zw = (pow(tau, width, R) - 1) % R
    denoms = [width * (tau - d) % R for d in domain]
    return [d * zw % R * inv % R for d, inv in zip(domain, batch_inv_mod(denoms, R))]


_DEV_SETUPS: dict[int, TrustedSetup] = {}


def dev_setup(width: int) -> TrustedSetup:
    """Deterministic DEV-ONLY setup (tau is SHA-256-derived and thus public
    — fine for devnets and tests, never for value).  Cached per width; the
    points are ``width`` host scalar multiplications on first use."""
    setup = _DEV_SETUPS.get(width)
    if setup is not None:
        return setup
    _check_width(width)
    domain = _roots_of_unity(width)
    tau = _dev_tau(width)
    setup = TrustedSetup(
        width=width,
        domain=tuple(domain),
        g1_lagrange=tuple(C.g1.multiply(C.G1_GENERATOR, s) for s in _lagrange_at(tau, domain)),
        g2_tau=C.g2.multiply(C.G2_GENERATOR, tau),
    )
    _DEV_SETUPS[width] = setup
    return setup


def trusted_setup(spec=None) -> TrustedSetup:
    """The active spec's setup (``FIELD_ELEMENTS_PER_BLOB`` wide)."""
    if spec is None:
        from ..config import get_chain_spec

        spec = get_chain_spec()
    return dev_setup(int(spec.FIELD_ELEMENTS_PER_BLOB))


# ------------------------------------------------------------- MSM plane


def _mul_batch_device(pairs: list, nbits: int, device=None) -> list:
    """``[k_i * P_i]`` through the G1 plane ladder on ``device`` (default:
    the card); ``None`` for zero-scalar and infinity terms, which never
    reach the ladder."""
    dev = resolve_device(device)
    out: list = [None] * len(pairs)
    live = [i for i, (pt, k) in enumerate(pairs) if pt is not None and k % R != 0]
    for at in range(0, len(live), MSM_CHUNK):
        chunk = live[at : at + MSM_CHUNK]
        pts = [pairs[i][0] for i in chunk]
        ks = [pairs[i][1] % R for i in chunk]
        for i, pt in zip(chunk, g1_affine(g1_ladder(pts, ks, nbits, dev))):
            out[i] = pt
    return out


def _mul_batch(pairs: list, device=None, nbits: int = SCALAR_BITS, host: bool = False) -> list:
    """Per-pair scalar products: the device ladder, or the host oracle
    (``host=True``).  Width guards raise :class:`KzgError` first."""
    if not pairs:
        return []
    if nbits % 8:
        raise KzgError(f"ladder width must be a multiple of 8, got {nbits}")
    if any(k % R >> nbits for _, k in pairs):
        raise KzgError(f"scalar wider than the {nbits}-bit ladder")
    if host:
        inc("kzg_msm_total", len(pairs), path="host")
        return [C.g1.multiply(pt, k) if pt is not None else None for pt, k in pairs]
    out = _mul_batch_device(pairs, nbits, device)
    inc("kzg_msm_total", len(pairs), path="device")
    return out


def _g1_sum(points):
    """Sum of affine G1 points (None = identity), accumulated in Jacobian
    coordinates with one inversion at the end; affine coordinates are
    unique, so this is the same point as a chain of affine additions."""
    acc = C.g1.to_jacobian(None)
    for pt in points:
        if pt is not None:
            acc = C.g1.jac_add(acc, C.g1.to_jacobian(pt))
    return C.g1.from_jacobian(acc)


def _msm(points, scalars, device=None, nbits: int = SCALAR_BITS, host: bool = False):
    """``sum_i k_i * P_i`` (None = identity)."""
    return _g1_sum(_mul_batch(list(zip(points, scalars)), device, nbits, host))


def warm_kzg_programs(device=None) -> float:
    """One 8-bit, one-lane dispatch on ``device`` (default: the card), so
    that a slot's first sidecar batch finds the kernels built and loaded.
    Returns the seconds it took."""
    t0 = time.perf_counter()
    _mul_batch_device([(C.G1_GENERATOR, 1)], 8, device)
    return time.perf_counter() - t0


# ------------------------------------------------------------ polynomial


def blob_to_field_elements(blob: bytes, width: int) -> list[int]:
    """Split a blob into its ``width`` 32-byte big-endian field elements;
    non-canonical chunks (>= R) reject, as on gossip."""
    if len(blob) != width * BYTES_PER_FIELD_ELEMENT:
        raise KzgError(f"blob is {len(blob)} bytes, expected {width * BYTES_PER_FIELD_ELEMENT}")
    out = []
    for i in range(width):
        v = int.from_bytes(
            blob[i * BYTES_PER_FIELD_ELEMENT : (i + 1) * BYTES_PER_FIELD_ELEMENT], "big"
        )
        if v >= R:
            raise KzgError(f"blob field element {i} is non-canonical")
        out.append(v)
    return out


def _eval_at(evals: list[int], z: int, domain) -> int:
    """Evaluate the polynomial given in evaluation form at ``z``: the
    barycentric formula out of the domain, the stored value in it."""
    z %= R
    for i, d in enumerate(domain):
        if z == d:
            return evals[i]
    width = len(domain)
    zw = (pow(z, width, R) - 1) % R
    invs = batch_inv_mod([(z - d) % R for d in domain], R)
    s = 0
    for e, d, inv in zip(evals, domain, invs):
        s = (s + e * d % R * inv) % R
    return zw * pow(width, R - 2, R) % R * s % R


def _quotient_evals(evals: list[int], z: int, y: int, domain) -> list[int]:
    """Evaluation form of ``(p(X) - y) / (X - z)`` over the domain, with the
    special-index formula when z IS a domain point."""
    width = len(domain)
    try:
        m = domain.index(z % R)
    except ValueError:
        m = None
    if m is None:
        invs = batch_inv_mod([(d - z) % R for d in domain], R)
        return [(e - y) % R * inv % R for e, inv in zip(evals, invs)]
    q = [0] * width
    others = [j for j in range(width) if j != m]
    inv_jm = batch_inv_mod([(domain[j] - domain[m]) % R for j in others], R)
    inv_dm = pow(domain[m], R - 2, R)
    for j, inv in zip(others, inv_jm):
        q[j] = (evals[j] - y) % R * inv % R
        # the removable singularity at d_m:
        #   q_m = sum_{j!=m} (p_j - y) d_j / (d_m (d_m - d_j))
        #       = sum_{j!=m} -q_j d_j / d_m
        q[m] = (q[m] - q[j] * domain[j] % R * inv_dm) % R
    return q


# --------------------------------------------------------------- surface


def versioned_hash(commitment: bytes) -> bytes:
    """EIP-4844: ``0x01 || sha256(commitment)[1:]``."""
    if len(commitment) != 48:
        raise KzgError(f"commitment must be 48 bytes, got {len(commitment)}")
    return VERSIONED_HASH_VERSION_KZG + hashlib.sha256(commitment).digest()[1:]


def blob_to_commitment(blob: bytes, setup: TrustedSetup | None = None, device=None) -> bytes:
    """One MSM against the Lagrange setup on ``device`` (default: the
    card); 48-byte compressed G1 out."""
    setup = setup or trusted_setup()
    evals = blob_to_field_elements(blob, setup.width)
    return C.g1_to_bytes(_msm(setup.g1_lagrange, evals, device))


def _compute_challenge(blob: bytes, commitment: bytes, width: int) -> int:
    """Per-blob Fiat-Shamir evaluation point (EIP-4844-shaped)."""
    digest = hashlib.sha256(_DST_CHALLENGE + width.to_bytes(8, "big") + blob + commitment).digest()
    return int.from_bytes(digest, "big") % R


def compute_proof(
    blob: bytes, z: int, setup: TrustedSetup | None = None, device=None
) -> tuple[bytes, int]:
    """Opening proof for the blob polynomial at ``z``: the 48-byte quotient
    commitment (one MSM on ``device``) and the claimed value ``y = p(z)``."""
    setup = setup or trusted_setup()
    evals = blob_to_field_elements(blob, setup.width)
    y = _eval_at(evals, z, setup.domain)
    q = _quotient_evals(evals, z, y, setup.domain)
    return C.g1_to_bytes(_msm(setup.g1_lagrange, q, device)), y


def compute_blob_proof(
    blob: bytes, commitment: bytes, setup: TrustedSetup | None = None, device=None
) -> bytes:
    """The sidecar proof: an opening at the blob's own Fiat-Shamir
    challenge point (what :func:`verify_blob_proof` recomputes)."""
    setup = setup or trusted_setup()
    z = _compute_challenge(blob, commitment, setup.width)
    proof, _ = compute_proof(blob, z, setup, device)
    return proof


def verify_proof(
    commitment: bytes, z: int, y: int, proof: bytes, setup: TrustedSetup | None = None
) -> bool:
    """The per-proof pairing check ``e(C - [y]G1, G2) == e(Q, [tau-z]G2)``
    on the host; malformed or off-subgroup encodings reject like tampered
    ones."""
    setup = setup or trusted_setup()
    try:
        c_pt = C.g1_from_bytes(commitment)
        q_pt = C.g1_from_bytes(proof)
    except C.DeserializationError:
        return False
    with span("kzg_verify"):
        p_min_y = C.g1.affine_add(c_pt, C.g1.affine_neg(C.g1.multiply(C.G1_GENERATOR, y)))
        x_min_z = C.g2.affine_add(setup.g2_tau, C.g2.affine_neg(C.g2.multiply(C.G2_GENERATOR, z)))
        ok = pairing_check([(p_min_y, C.G2_GENERATOR), (C.g1.affine_neg(q_pt), x_min_z)])
    inc("kzg_blobs_verified_total", 1, result="ok" if ok else "reject")
    return ok


def verify_blob_proof(
    blob: bytes, commitment: bytes, proof: bytes, setup: TrustedSetup | None = None
) -> bool:
    """Single-sidecar verification: recompute the challenge, evaluate the
    blob there, run the per-proof pairing check (all on the host)."""
    setup = setup or trusted_setup()
    try:
        evals = blob_to_field_elements(blob, setup.width)
    except KzgError:
        return False
    z = _compute_challenge(blob, commitment, setup.width)
    y = _eval_at(evals, z, setup.domain)
    return verify_proof(commitment, z, y, proof, setup)


def _fold_scalars(commitments, zs, ys, proofs) -> list[int]:
    """Fiat-Shamir RLC coefficients: one 128-bit odd scalar per item, bound
    to the full transcript."""
    h = hashlib.sha256(_DST_RLC)
    for cb, z, y, pb in zip(commitments, zs, ys, proofs):
        h.update(cb)
        h.update(int(z).to_bytes(32, "big"))
        h.update(int(y).to_bytes(32, "big"))
        h.update(pb)
    seed = h.digest()
    return [
        int.from_bytes(hashlib.sha256(seed + j.to_bytes(4, "big")).digest()[:16], "big")
        | 1  # never zero: every item must stay bound
        for j in range(len(commitments))
    ]


def verify_blob_batch(
    blobs: Sequence[bytes],
    commitments: Sequence[bytes],
    proofs: Sequence[bytes],
    setup: TrustedSetup | None = None,
    device=None,
) -> bool:
    """B sidecars as ONE folded pairing check; a single tampered blob,
    commitment or proof fails the whole fold (callers bisect with
    :func:`verify_blob_proof`).  The ``3B + 1`` products of the C'/Q'
    accumulators are one ladder dispatch on ``device``."""
    if not (len(blobs) == len(commitments) == len(proofs)):
        raise KzgError(f"{len(blobs)} blobs / {len(commitments)} commitments / "
                       f"{len(proofs)} proofs")
    if not blobs:
        return True
    setup = setup or trusted_setup()
    n = len(blobs)
    try:
        c_pts = [C.g1_from_bytes(b) for b in commitments]
        q_pts = [C.g1_from_bytes(b) for b in proofs]
    except C.DeserializationError:
        inc("kzg_blobs_verified_total", n, result="reject")
        return False
    try:
        evals = [blob_to_field_elements(b, setup.width) for b in blobs]
    except KzgError:
        inc("kzg_blobs_verified_total", n, result="reject")
        return False
    zs = [_compute_challenge(b, cb, setup.width) for b, cb in zip(blobs, commitments)]
    ys = [_eval_at(e, z, setup.domain) for e, z in zip(evals, zs)]
    rs = _fold_scalars(commitments, zs, ys, proofs)
    with span("kzg_verify"):
        # C' = sum r_i C_i + sum (r_i z_i) Q_i - (sum r_i y_i) G1
        # Q' = sum r_i Q_i           -- all 3n+1 products in one dispatch
        pairs = (
            [(pt, r) for pt, r in zip(c_pts, rs)]
            + [(pt, r * z % R) for pt, r, z in zip(q_pts, rs, zs)]
            + [(C.G1_GENERATOR, (R - sum(r * y % R for r, y in zip(rs, ys)) % R) % R)]
            + [(pt, r) for pt, r in zip(q_pts, rs)]
        )
        prods = _mul_batch(pairs, device)
        c_fold = _g1_sum(prods[: 2 * n + 1])
        q_fold = _g1_sum(prods[2 * n + 1 :])
        ok = pairing_check([(c_fold, C.G2_GENERATOR), (C.g1.affine_neg(q_fold), setup.g2_tau)])
    inc("kzg_blobs_verified_total", n, result="ok" if ok else "reject")
    return ok
