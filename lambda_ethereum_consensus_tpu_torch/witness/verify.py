"""Batched multiproof verification: B proofs as one SHA-256 plane on the card.

A multiproof verifies as a short sequence of Merkle levels — sequential
in depth, embarrassingly parallel across proofs and across the ops
inside one level.  The batched plane exploits exactly that: all B
proofs' node values live in one batch-major ``(B, S, 32)`` uint8 buffer
(S slots per proof), and each round gathers the round's
``(left, right)`` pairs across the WHOLE batch, hashes them as one
level, and scatters the digests back.  The per-proof op schedules are
*data* (int32 index arrays from :func:`..multiproof.plan_rounds`), so
one plane serves any mix of index sets.

Three execution paths, all running the SAME plan (bit-exact by
construction; tests pin verdict equality on valid and corrupted proofs):

- **the plane** (:func:`_verify_plane`): the node buffer resident on
  ``device``, one :func:`..ops.sha256.sha256_nodes` call per round — on
  the card one launch of the hand-written SHA-256 kernel, on the CPU its
  plain PyTorch version — and one ``(B,)`` bool tensor read back.
- **the host plane** (:func:`_verify_plane_host`): the same padded index
  arrays driven through numpy gathers + ``hashlib_level``; an oracle.
- **the host oracle** (:func:`..multiproof.verify_host`): per-proof
  sequential execution, which answers below :data:`DEVICE_MIN` live
  proofs and for a proof too wide for any plane.

The port's copy of the JAX package's ``witness/verify.py``.  Left out:
the ``witness_verify`` shape buckets and ``aot_jit`` (the CUDA kernel
takes any node count, so a plane is exactly as wide as its batch), the
mesh-sharded plane, ``warm_witness_programs``, and the
``WITNESS_DEVICE_MIN`` / ``WITNESS_NO_DEVICE`` variables (the size route
is the constant :data:`DEVICE_MIN`; ``device="cpu"`` asks for the plain
version).  Without buckets, a batch is cut into planes of at most
:data:`MAX_PLANE_SLOTS` padded slots, the JAX package's footprint guard.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sha256 import resolve_device, sha256_nodes
from ..ssz.hash import hashlib_level
from ..telemetry import get_metrics
from .multiproof import ProofPlan, WitnessError, WitnessProof, plan_for, verify_host

__all__ = ["DEVICE_MIN", "MAX_PLANE_SLOTS", "MIN_PLANE_BATCH", "split_planes", "verify_batch"]

#: Below this many live proofs the per-proof oracle answers: a plane's
#: launches cost more than a handful of hashlib paths.
DEVICE_MIN = 8
#: Padded-plane footprint guard: a plane pads every proof to its widest
#: proof's pow2 slot count, and stays at or under this many slots
#: (64 MiB of nodes).
MAX_PLANE_SLOTS = 1 << 21
#: A proof that would not fit even a plane of this many proofs (the JAX
#: package's smallest bucket) goes to the per-proof oracle instead: one
#: adversarially wide proof must not multiply across a whole plane.
MIN_PLANE_BATCH = 64


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def split_planes(live: list, plans: list) -> tuple[list[list[int]], list[int]]:
    """Cut the positions ``live`` (in order) into planes whose
    ``len(plane) * pow2(max slots)`` stays within :data:`MAX_PLANE_SLOTS`,
    and set apart the positions too wide for a plane of
    :data:`MIN_PLANE_BATCH`.  Returns ``(planes, oracle)``."""
    planes: list[list[int]] = []
    oracle: list[int] = []
    cur: list[int] = []
    cur_slots = 0
    for i in live:
        slots = _pow2(plans[i].n_slots)
        if MIN_PLANE_BATCH * slots > MAX_PLANE_SLOTS:
            oracle.append(i)
            continue
        wide = max(cur_slots, slots)
        if cur and (len(cur) + 1) * wide > MAX_PLANE_SLOTS:
            planes.append(cur)
            cur, wide = [], slots
        cur.append(i)
        cur_slots = wide
    if cur:
        planes.append(cur)
    return planes, oracle


def verify_batch(proofs, expected_roots, device=None, metrics=None) -> list:
    """Verify B independent multiproofs; returns one bool per proof.

    ``expected_roots`` is a single 32-byte root (broadcast) or one per
    proof.  Proofs whose SHAPE is malformed (empty/duplicated/truncated
    index sets — anything :func:`..multiproof.plan_for` rejects) are
    verdict ``False`` without touching any plane; value corruption is
    caught by the root comparison inside the plane.  ``device=None`` runs
    the planes on the card (and raises without one); ``device="cpu"`` on
    the plain PyTorch version.  The ``witness_verify`` span times the
    planes and the oracle, and ``witness_verified_total`` counts verdicts
    by result, on ``metrics`` (default: the port's registry,
    :func:`..telemetry.get_metrics`; :data:`..serve_cache.SILENT` records
    nothing)."""
    n = len(proofs)
    if n == 0:
        return []
    dev = resolve_device(device)
    if isinstance(expected_roots, (bytes, bytearray)):
        expected_roots = [bytes(expected_roots)] * n
    if len(expected_roots) != n:
        raise WitnessError(f"{len(expected_roots)} roots for {n} proofs")
    m = get_metrics() if metrics is None else metrics
    verdicts: list[bool | None] = [None] * n
    plans: list[ProofPlan | None] = [None] * n
    for i, proof in enumerate(proofs):
        if not isinstance(proof, WitnessProof):
            verdicts[i] = False
            continue
        try:
            plans[i] = plan_for(proof)
        except WitnessError:
            verdicts[i] = False
    live = [i for i in range(n) if verdicts[i] is None]

    with m.span("witness_verify"):
        if len(live) < DEVICE_MIN:
            planes, oracle = [], live
        else:
            planes, oracle = split_planes(live, plans)
        for i in oracle:
            verdicts[i] = verify_host(proofs[i], expected_roots[i])
        for plane in planes:
            results = _verify_plane(_assemble(
                [proofs[i] for i in plane],
                [expected_roots[i] for i in plane],
                [plans[i] for i in plane],
            ), dev)
            for i, ok in zip(plane, results):
                verdicts[i] = bool(ok)
    ok_count = sum(1 for v in verdicts if v)
    if ok_count:
        m.inc("witness_verified_total", ok_count, result="ok")
    if n - ok_count:
        m.inc("witness_verified_total", n - ok_count, result="invalid")
    return [bool(v) for v in verdicts]


# ------------------------------------------------------------ assembly

# per-plan index templates: (lidx, ridx, oidx, mask) as (D_p, W_p) int32 /
# bool arrays in LOCAL slot numbers (scratch = 0), so batch assembly is a
# vectorized slice-assign per proof instead of a per-op Python loop
_TPL_CACHE: dict[tuple, tuple] = {}


def _plan_template(plan: ProofPlan) -> tuple:
    tpl = _TPL_CACHE.get(plan.leaf_gindices)
    if tpl is not None:
        return tpl
    d_p = len(plan.rounds)
    w_p = plan.max_round_ops
    lidx = np.zeros((d_p, w_p), np.int32)
    ridx = np.zeros((d_p, w_p), np.int32)
    oidx = np.zeros((d_p, w_p), np.int32)
    mask = np.zeros((d_p, w_p), bool)
    for d, ops in enumerate(plan.rounds):
        for w, (left, right, out) in enumerate(ops):
            lidx[d, w] = left
            ridx[d, w] = right
            oidx[d, w] = out
            mask[d, w] = True
    tpl = (lidx, ridx, oidx, mask)
    if len(_TPL_CACHE) > 256:
        _TPL_CACHE.clear()  # tiny arrays; plans repeat heavily in practice
    _TPL_CACHE[plan.leaf_gindices] = tpl
    return tpl


def _assemble(proofs, roots, plans) -> dict:
    """B proofs as one plane: a batch-major ``(B, S, 32)`` node buffer
    (S = the widest plan's pow2 slot count) and ``(D, B, W)`` local index
    arrays (D = the most rounds, W = the widest round), shared by the
    planes on the card, on the CPU and on the host.  Padded ops read and
    write slot 0, the scratch slot no live op reads."""
    n = len(proofs)
    slots = _pow2(max(p.n_slots for p in plans))
    rounds = max(len(p.rounds) for p in plans)
    width = max(max(p.max_round_ops for p in plans), 1)

    nodes = np.zeros((n, slots, 32), np.uint8)
    lidx = np.zeros((rounds, n, width), np.int32)
    ridx = np.zeros((rounds, n, width), np.int32)
    oidx = np.zeros((rounds, n, width), np.int32)
    mask = np.zeros((rounds, n, width), bool)
    root_idx = np.zeros((n,), np.int32)
    expected = np.zeros((n, 32), np.uint8)
    for b, (proof, root, plan) in enumerate(zip(proofs, roots, plans)):
        blob = b"".join(
            [bytes(c) for _g, c in proof.leaves]
            + [bytes(s) for s in proof.siblings]
        )
        vals = np.frombuffer(blob, np.uint8).reshape(-1, 32)
        nodes[b, 1 : 1 + vals.shape[0]] = vals
        tl, tr, to, tm = _plan_template(plan)
        d_p, w_p = tl.shape
        lidx[:d_p, b, :w_p] = tl
        ridx[:d_p, b, :w_p] = tr
        oidx[:d_p, b, :w_p] = to
        mask[:d_p, b, :w_p] = tm
        root_idx[b] = plan.root_slot
        expected[b] = np.frombuffer(bytes(root), np.uint8)
    return {
        "n": n,
        "slots": slots,
        "nodes": nodes,
        "lidx": lidx,
        "ridx": ridx,
        "oidx": oidx,
        "mask": mask,
        "root_idx": root_idx,
        "expected": expected,
    }


def _verify_plane_host(packed: dict) -> np.ndarray:
    """The host plane: the shared plan arrays driven through numpy
    gathers + ``hashlib_level`` — each round hashes the whole batch's live
    ops as one level, no per-proof Python loop."""
    batch, slots = packed["nodes"].shape[:2]
    nodes = packed["nodes"].reshape(batch * slots, 32).copy()
    rounds = packed["mask"].shape[0]
    bases = (np.arange(batch, dtype=np.int32) * slots)[None, :, None]
    flat = {
        k: (packed[k] + bases).reshape(rounds, -1)
        for k in ("lidx", "ridx", "oidx")
    }
    fmask = packed["mask"].reshape(rounds, -1)
    for d in range(rounds):
        m = fmask[d]
        if not m.any():
            continue
        left = flat["lidx"][d][m]
        right = flat["ridx"][d][m]
        blocks = np.concatenate([nodes[left], nodes[right]], axis=1)
        nodes[flat["oidx"][d][m]] = hashlib_level(blocks)
    got = nodes[packed["root_idx"] + bases[0, :, 0]]
    return (got == packed["expected"]).all(axis=1)[: packed["n"]]


def _verify_plane(packed: dict, device) -> np.ndarray:
    """The plane on ``device``: the node buffer and the index arrays cross
    once, each round is one gather, one ``torch.cat`` into a fresh
    ``(B·W, 64)`` tensor, one :func:`sha256_nodes` call and one scatter,
    and one ``(B,)`` bool tensor comes back.  Launches on the device's
    current stream, like every ``sha256_nodes`` call."""
    dev = torch.device(device)
    nodes = torch.from_numpy(packed["nodes"]).to(dev, copy=True)
    idx = torch.from_numpy(
        np.stack([packed["lidx"], packed["ridx"], packed["oidx"]])
    ).to(dev).long()
    batch, width = packed["lidx"].shape[1:]
    bidx = torch.arange(batch, device=dev)[:, None]
    for d in range(idx.shape[1]):
        left = nodes[bidx, idx[0, d]]
        right = nodes[bidx, idx[1, d]]
        blocks = torch.cat([left, right], dim=-1).reshape(batch * width, 64)
        nodes[bidx, idx[2, d]] = sha256_nodes(blocks).reshape(batch, width, 32)
    root_idx = torch.from_numpy(packed["root_idx"]).to(dev).long()
    got = nodes[bidx[:, 0], root_idx]
    expected = torch.from_numpy(packed["expected"]).to(dev)
    return (got == expected).all(dim=1).cpu().numpy()[: packed["n"]]
