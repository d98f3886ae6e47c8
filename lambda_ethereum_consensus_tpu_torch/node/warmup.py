"""Background warmer for node boot.

A booting node has host work to do (the anchor's root and write, the
store, the sidecar, the API) before gossip arrives, and the first drain of
a process pays what nothing paid before it: the kernels' build and load,
the chain's per-device constants, the CUDA context's first use of each
PyTorch operator.  So, on a thread started the moment the device backend
is installed, dispatch one full dummy drain at the expected production
shapes through the real op chain (committee sums, corrected aggregates, the
two RLC ladders, prep, Miller, the pairing tail) on zero planes, then one
resident-transition sweep, one witness plane, one duty-sign ladder and one
KZG ladder.  The values are garbage; every launch goes through the same
wrappers and kernels the node's paths use.  Each launch is host work too,
so the thread takes turns on the interpreter lock with the boot's own host
work rather than hiding behind it (``PERF.md``).

The port's copy of the JAX package's ``node/warmup.py``.  What differs:

- **The device.** Every warmer takes ``device`` (``None``: the card) and
  dispatches there through ``ops/bls_batch.get_chain_ops(device)``.
- **No shape buckets.** The CUDA kernels take any width, so nothing is
  registered for the scheduler to snap to, and there is no
  ``compile_context``.
- **No sharded warmer.** ``warm_sharded_programs`` waits for the port's
  multi-device code.  ``start_warmer`` takes no ``n_validators`` (no caller
  set it): the transition phase warms at ``shapes.n_validators``.
- **Device faults.** Every exception lands in ``stats["error"]`` as in the
  JAX package; a device fault (``faults.is_device_fault``) is also handed to
  ``on_fault``, which the node points at its fault rule, so ``stop()``
  raises it.
"""

from __future__ import annotations

import threading
import time

import torch

from ..faults import is_device_fault
from ..telemetry import observe

__all__ = [
    "DrainShapes",
    "start_warmer",
    "warm_drain_programs",
    "warm_duties",
    "warm_kzg",
    "warm_transition",
    "warm_witness",
]


class DrainShapes:
    """The shape key of one drain (see ``ops/bls_batch.py``): the registry's
    validators, the epoch's committees, the committee size, the flat
    entries (aggregates), the message groups and the checks of one
    drain."""

    def __init__(
        self,
        n_validators: int,
        n_committees: int,
        committee: int,
        entries: int,
        groups: int,
        checks: int = 1,
        coeff_bits: int | None = None,
    ):
        self.n_validators = n_validators
        self.n_committees = n_committees
        self.committee = committee
        self.entries = entries
        self.groups = groups
        self.checks = checks
        if coeff_bits is None:
            from ..ops.rlc import COEFF_BITS

            coeff_bits = COEFF_BITS
        self.coeff_bits = coeff_bits


def warm_drain_programs(shapes: DrainShapes, device=None) -> float:
    """Dispatch one dummy drain at ``shapes`` on ``device`` (default: the
    card); returns when every stage ran on the device, with the seconds it
    took."""
    from ..ops import bls_batch as BB

    t0 = time.perf_counter()
    ops = BB.get_chain_ops(device)
    dev = ops["device"]

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    b, _dead = BB._entry_budget(shapes.entries)
    kp = BB._pow2(shapes.committee)
    mmax = BB._pow2(max(shapes.committee // 8, 2))
    m1 = BB._pow2(shapes.groups + 1) - 1
    per_check = (shapes.entries + shapes.checks - 1) // shapes.checks
    s = BB._pow2(max(per_check // max(shapes.groups // shapes.checks, 1), 1))
    e = BB._pow2(per_check)

    zreg = zeros(32, shapes.n_validators)
    chunk = min(256, max(1, shapes.n_committees))
    ops["committee_sums"](zreg, zreg, zeros(chunk, kp, dtype=torch.int64),
                          zeros(chunk, kp, dtype=torch.bool))
    sx = zeros(32, shapes.n_committees)
    ax, ay, _ = ops["agg_corrected"](
        zreg, zreg, sx, sx,
        zeros(b, dtype=torch.int64),
        zeros(b, mmax, dtype=torch.int64),
        torch.ones((b, mmax), dtype=torch.bool, device=dev),
    )
    kb = zeros(shapes.coeff_bits, b)
    lv = zeros(b, dtype=torch.bool)
    jac1 = ops["ladder_g1"](ax, ay, kb, lv)
    jac2 = ops["ladder_g2"](zeros(32, 2, b), zeros(32, 2, b), kb, lv)
    px, py, qx, qy, mask = ops["prep"](
        jac1, jac2,
        zeros(shapes.checks, m1, s, dtype=torch.int64),
        zeros(shapes.checks, e, dtype=torch.int64),
        zeros(32, 2, shapes.checks, m1),
        zeros(32, 2, shapes.checks, m1),
        zeros(shapes.checks, m1 + 1, dtype=torch.bool),
    )
    f = ops["miller"](px, py, qx, qy)
    ops["check_tail"](f, mask).cpu()  # pull: the device has run every stage
    dt = time.perf_counter() - t0
    observe("warmup_phase_seconds", dt, phase="drain")
    return dt


def warm_transition(n_validators: int, device=None) -> float:
    """One resident-transition sweep at the registry's size
    (``state_transition/resident.py``) when the resident path is on for it;
    0 seconds otherwise."""
    from ..state_transition.resident import resident_enabled, warm_transition_programs

    if not resident_enabled(n_validators):
        return 0.0
    dt = warm_transition_programs(n_validators, device)
    observe("warmup_phase_seconds", dt, phase="transition")
    return dt


def warm_duties(device=None) -> float:
    """One 8-bit, one-lane duty-sign ladder (``ops/bls_sign.py``)."""
    from ..ops.bls_sign import warm_sign_programs

    dt = warm_sign_programs(device)
    observe("warmup_phase_seconds", dt, phase="duties")
    return dt


def warm_kzg(device=None) -> float:
    """One 8-bit, one-lane KZG MSM ladder (``da/kzg.py``)."""
    from ..da.kzg import warm_kzg_programs

    dt = warm_kzg_programs(device)
    observe("warmup_phase_seconds", dt, phase="kzg")
    return dt


def warm_witness(device=None) -> float:
    """One witness-verification plane at the canonical single-index serving
    shape (``witness/verify.py``), through its internals so that no
    ``witness_verify_seconds`` is observed."""
    from ..witness.verify import warm_witness_programs

    dt = warm_witness_programs(device)
    observe("warmup_phase_seconds", dt, phase="witness")
    return dt


def start_warmer(
    shapes: DrainShapes,
    stats: dict | None = None,
    device=None,
    on_fault=None,
) -> threading.Thread:
    """Run the drain, transition, witness, duty and KZG warmers on ``device``
    on a daemon thread, filling ``stats`` with each phase's seconds
    (``overlap_s``, ``transition_s``, ``witness_s``, ``duties_s``,
    ``kzg_s``).  A failure lands in ``stats["error"]`` (a silent cold start
    would corrupt the boot timeline's meaning); a device fault is also
    passed to ``on_fault``."""
    stats = stats if stats is not None else {}

    def run():
        try:
            stats["overlap_s"] = round(warm_drain_programs(shapes, device), 1)
            stats["transition_s"] = round(warm_transition(shapes.n_validators, device), 1)
            stats["witness_s"] = round(warm_witness(device), 1)
            stats["duties_s"] = round(warm_duties(device), 1)
            stats["kzg_s"] = round(warm_kzg(device), 1)
        except Exception as e:  # visible, never fatal to boot
            stats["error"] = f"{type(e).__name__}: {e}"
            if is_device_fault(e) and on_fault is not None:
                on_fault(e)

    t = threading.Thread(target=run, daemon=True, name="drain-warmer")
    t.start()
    return t
