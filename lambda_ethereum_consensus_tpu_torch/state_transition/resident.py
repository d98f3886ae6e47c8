"""Device-resident, delta-driven epoch processing.

The epoch boundary is the transition's O(n_validators) wall: rewards and
penalties, inactivity scores, slashing penalties and effective-balance
hysteresis all sweep the full registry.  The host path (epoch.py) runs
them as numpy expressions; this module runs the sweeps as torch ops on
*persistent device columns* — the hot ``BeaconState`` columns (balances,
inactivity scores, participation) live on the device across blocks, synced
at each boundary by the *delta* against a host mirror instead of a full
re-upload, and updated in place.

The port of the JAX package's ``state_transition/resident.py``.  Its six
jitted bodies become the plain functions below, over unpadded columns on
the plane's device (default: the card):

- :func:`epoch_sums` — ``sums``: five masked increment sums;
- :func:`sweep` — ``sweep``: inactivity updates, the three flag rewards
  and two flag penalties, each penalty saturating at 0 flag by flag, and
  the inactivity penalty last;
- :func:`hysteresis` — ``hysteresis``: the effective-balance update mask;
- :func:`scatter` and :func:`gather` — ``scatter2``, ``scatter1`` and
  ``gather2``: the delta writes and the slashing targets' read-back.

Numerics: the card has 64-bit integers, so balances and scores are
``int64`` columns and the JAX package's uint32 lo/hi limbs are gone (its
``scatter2``/``gather2`` wrote and read the two limbs of one balance; here
that is one column).  The per-flag reward/penalty amounts are pure
functions of a validator's effective-balance *increment count*, so the
host precomputes them as exact-python-int lookup tables and the sweep
gathers.  Representability is guarded, not assumed: the plane refuses
(and the caller runs the bit-exact host path) whenever an int64 sum or
product could overflow — the guards and their bounds are the ``_MAX_*``
constants below.  A device error raises; it never routes to the host.

Telemetry, as in the JAX package: ``resident_plane_validators`` after each
sync, ``resident_plane_sync_elems`` after each epoch on the plane.  Not
carried over: the shape buckets and pow2 padding (``_pad_pow2``,
``register_shape_bucket``), donation, the ``aot_jit`` cache, the
mesh-sharded kernels and the warm-up (with its ``warmup_phase_seconds``).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..config import ChainSpec, constants, get_chain_spec
from ..ops.sha256 import resolve_device
from ..telemetry import set_gauge
from .math import integer_squareroot

__all__ = [
    "ResidentEpochPlane",
    "ensure_plane",
    "epoch_sums",
    "gather",
    "hysteresis",
    "process_epoch_resident",
    "resident_enabled",
    "scatter",
    "sweep",
]

# Auto-attach threshold: below this registry size the host sweep is
# cheap enough (the JAX package's default crossover, kept so both route the
# same way).  GRAFT_RESIDENT_EPOCH=1/0 forces either way.
_MIN_VALIDATORS = 1 << 14

# int64 bounds the sweep relies on.  Balances below 2^62 plus three
# rewards below 2^60 each (and the spec's hysteresis thresholds, a few
# increments) stay below 2^63; scores below 2^30 leave room for the bias
# add, and with ``max_incr * mult < 2^33`` the inactivity product
# ``efb_incr * mult * score`` stays below 2^63.
_MAX_BAL = 1 << 62
_MAX_LUT = 1 << 60
_MAX_SCORE = 1 << 30
_MAX_MULT = 1 << 33


def resident_enabled(n_validators: int) -> bool:
    """Routing polarity for the resident epoch path."""
    raw = os.environ.get("GRAFT_RESIDENT_EPOCH", "").strip().lower()
    if raw in ("0", "false", "no", "off"):
        return False
    if raw in ("", "auto"):
        return n_validators >= _MIN_VALIDATORS
    return True


# --------------------------------------------------------------- bodies


def epoch_sums(efb_incr, part_prev, part_cur, active_prev, active_cur, slashed) -> torch.Tensor:
    """``[total_active, flag0, flag1, flag2, curr_target]`` increment sums
    (int64) over the unslashed participants of each flag."""
    unsl_prev = active_prev & ~slashed
    unsl_cur = active_cur & ~slashed
    masks = torch.stack([
        active_cur,
        unsl_prev & ((part_prev & 1) != 0),
        unsl_prev & ((part_prev & 2) != 0),
        unsl_prev & ((part_prev & 4) != 0),
        unsl_cur & ((part_cur & 2) != 0),
    ])
    return (masks * efb_incr).sum(dim=1)


def sweep(bal, scores, efb_incr, part_prev, eligible, active_prev, slashed,
          params, luts) -> None:
    """Inactivity updates and rewards/penalties, in place on ``bal`` and
    ``scores``.

    ``params``: ``(in_leak, do_epoch, bias, recovery, mult, shift)`` host
    ints; ``luts``: ``(5, max_incr + 1)`` int64 tables on the device, rows
    0-2 the flag rewards and rows 3-4 the source and target penalties.
    """
    in_leak, do_epoch, bias, recovery, mult, shift = params
    if not do_epoch:
        return
    unsl = active_prev & ~slashed
    part_t = unsl & ((part_prev & 2) != 0)

    # inactivity updates (spec order: before rewards, whose inactivity
    # penalty reads the UPDATED scores)
    s = scores
    s = torch.where(eligible & part_t, s - s.clamp(max=1), s)
    s = torch.where(eligible & ~part_t, s + bias, s)
    if not in_leak:
        s = torch.where(eligible, s - s.clamp(max=recovery), s)
    scores.copy_(s)

    # each flag applies its reward, then its penalty saturating at 0,
    # flag by flag: one clamp over the summed deltas would differ whenever
    # a balance hits 0 partway through
    b = bal
    for f in range(3):
        part_f = unsl & ((part_prev & (1 << f)) != 0)
        b = b + torch.where(eligible & part_f, luts[f][efb_incr], 0)
        if f != constants.TIMELY_HEAD_FLAG_INDEX:
            pen = torch.where(eligible & ~part_f, luts[3 + f][efb_incr], 0)
            b = (b - pen).clamp(min=0)
    # inactivity penalty: efb * score // (bias * quotient) as an exact
    # multiply-shift
    pen = torch.where(eligible & ~part_t, (efb_incr * mult * scores) >> shift, 0)
    bal.copy_((b - pen).clamp(min=0))


def hysteresis(bal, efb_incr, downward: int, upward: int, increment: int) -> torch.Tensor:
    """Validators whose effective balance moves: ``bal + down < efb`` or
    ``efb + up < bal``."""
    efb = efb_incr * increment
    return (bal + downward < efb) | (efb + upward < bal)


def scatter(col, idx, vals) -> None:
    """``col[idx] = vals`` in place (the delta sync's writes)."""
    col.index_put_((idx,), vals)


def gather(col, idx) -> torch.Tensor:
    """``col[idx]`` (the slashing targets' balances)."""
    return col.index_select(0, idx)


# ----------------------------------------------------------------- plane


class ResidentEpochPlane:
    """Persistent device residency for the hot BeaconState columns.

    One plane rides one state lineage (``state._resident_plane``, carried
    across freeze/thaw exactly like the incremental root engine).  Host
    lists stay the source of truth between epoch boundaries; at each
    boundary :meth:`sync` ships only the indices blocks actually touched
    (diffed against the host mirror), and the sweeps update the resident
    columns in place.  ``n_validators`` is the registry size at attach;
    each sync sizes the columns to the registry it finds.
    """

    _STAMP_FIELDS = (
        "balances", "inactivity_scores",
        "previous_epoch_participation", "current_epoch_participation",
    )

    def __init__(self, n_validators: int, device=None):
        self.device = resolve_device(device)
        self.n = 0
        # host mirrors (what the device columns currently hold)
        self.mirror_bal = np.zeros(0, np.uint64)
        self.mirror_scores = np.zeros(0, np.int64)
        self.mirror_part_prev = np.zeros(0, np.uint8)
        self.mirror_part_cur = np.zeros(0, np.uint8)
        # device columns (filled on first sync): int64 balances and
        # scores, uint8 participation flags
        self.bal = None
        self.scores = None
        self.part_prev = None
        self.part_cur = None
        self.stats = {"syncs": 0, "sweeps": 0, "scatter_elems": 0, "fallbacks": 0}
        # delta-chain stamps: field -> (TrackedList instance, gen) the
        # mirrors matched last, so sync can narrow its mirror compare to
        # the indices mutated since (mutable.dirty_superset)
        self._stamps: dict = {}

    @property
    def device_bytes(self) -> int:
        """Bytes held by the resident columns (0 before the first sync)."""
        return sum(
            col.numel() * col.element_size()
            for col in (self.bal, self.scores, self.part_prev, self.part_cur)
            if col is not None
        )

    # ------------------------------------------------------------- sync

    def _put(self, arr: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr).astype(dtype)).to(self.device)

    def _stamp_deltas(self, state) -> None:
        """Record the exact TrackedList instances the mirrors now match
        (and their generations): the next sync narrows its mirror compare
        to the indices mutated since.  A list that is not a TrackedList
        stamps None and the next compare is full, which is always exact."""
        for field in self._STAMP_FIELDS:
            lst = getattr(state, field, None)
            gen = getattr(lst, "gen", None)
            self._stamps[field] = None if gen is None else (lst, gen)

    def _changed_idx(self, field: str, state, mirror: np.ndarray,
                     new: np.ndarray) -> np.ndarray:
        """Indices where the device column is stale.  The delta-chain
        stamp narrows the compare to a provable superset of the touched
        indices (mutable.dirty_superset); candidates are still value-
        compared against the mirror, so the result is exact either way."""
        hint = None
        st = self._stamps.get(field)
        lst = getattr(state, field, None)
        if st is not None and lst is not None and mirror.shape[0] == new.shape[0]:
            from .mutable import dirty_superset

            hint = dirty_superset(lst, st[0], st[1])
        if hint is None:
            return np.nonzero(mirror != new)[0]
        n = new.shape[0]
        cand = np.fromiter((i for i in hint if 0 <= i < n), np.int64)
        if cand.size == 0:
            return cand
        cand.sort()
        return cand[mirror[cand] != new[cand]]

    def _sync_col(self, field: str, col: str, state, mirror: np.ndarray,
                  new: np.ndarray, dtype) -> None:
        """One column's delta: a scatter of the changed indices, or a full
        upload when more than a quarter of the column moved."""
        changed = self._changed_idx(field, state, mirror, new)
        if changed.size == 0:
            return
        if changed.size > new.shape[0] // 4:
            setattr(self, col, self._put(new, dtype))
            return
        idx = torch.from_numpy(changed).to(self.device)
        scatter(getattr(self, col), idx, self._put(new[changed], dtype))
        self.stats["scatter_elems"] += int(changed.size)

    def sync(self, state, spec: ChainSpec) -> bool:
        """Bring the device columns up to date with ``state``; False when
        the state is outside the sweep's representable range (caller
        falls back to the host path)."""
        n = len(state.validators)
        balances = state.balances_array()
        scores = np.asarray(state.inactivity_scores, np.int64)
        part_prev = state.participation_array("previous")
        part_cur = state.participation_array("current")
        if n == 0 or int(balances.max(initial=0)) >= _MAX_BAL:
            return False
        if scores.size and (int(scores.max()) >= _MAX_SCORE or int(scores.min()) < 0):
            return False

        self.stats["syncs"] += 1
        if self.bal is None or self.n != n:
            self.bal = self._put(balances, np.int64)
            self.scores = self._put(scores, np.int64)
            self.part_prev = self._put(part_prev, np.uint8)
            self.part_cur = self._put(part_cur, np.uint8)
        else:
            self._sync_col("previous_epoch_participation", "part_prev", state,
                           self.mirror_part_prev, part_prev, np.uint8)
            self._sync_col("current_epoch_participation", "part_cur", state,
                           self.mirror_part_cur, part_cur, np.uint8)
            self._sync_col("balances", "bal", state, self.mirror_bal, balances, np.int64)
            self._sync_col("inactivity_scores", "scores", state,
                           self.mirror_scores, scores, np.int64)
        self.n = n
        self.mirror_bal = balances.copy()
        self.mirror_scores = scores.copy()
        self.mirror_part_prev = part_prev.copy()
        self.mirror_part_cur = part_cur.copy()
        self._stamp_deltas(state)
        set_gauge("resident_plane_validators", n)
        return True

    # ------------------------------------------------------- epoch steps

    def masks(self, reg: dict, prev_epoch: int, curr_epoch: int):
        active_prev = (reg["activation_epoch"] <= prev_epoch) & (
            prev_epoch < reg["exit_epoch"]
        )
        active_cur = (reg["activation_epoch"] <= curr_epoch) & (
            curr_epoch < reg["exit_epoch"]
        )
        eligible = active_prev | (
            reg["slashed"] & (prev_epoch + 1 < reg["withdrawable_epoch"])
        )
        return active_prev, active_cur, eligible, reg["slashed"]

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        """A per-epoch registry column (increments, masks) on the device."""
        dtype = np.bool_ if arr.dtype == np.bool_ else np.int64
        return self._put(arr, dtype)

    def epoch_sums(self, efb_incr, active_prev, active_cur, slashed) -> list[int]:
        """[total_active, flag0, flag1, flag2, curr_target] increment sums."""
        out = epoch_sums(efb_incr, self.part_prev, self.part_cur,
                         active_prev, active_cur, slashed)
        return [int(x) for x in out.cpu()]

    def sweep(self, efb_incr, eligible, active_prev, slashed, params, luts) -> None:
        """The rewards/inactivity sweep, in place on the resident columns."""
        lut = torch.tensor(luts, dtype=torch.int64, device=self.device)
        sweep(self.bal, self.scores, efb_incr, self.part_prev, eligible,
              active_prev, slashed, params, lut)
        self.stats["sweeps"] += 1

    def slash_fixup(self, targets: np.ndarray, efb_incr: np.ndarray,
                    adjusted_total: int, total_balance: int, increment: int) -> None:
        """Exact per-target slashing penalties: gather the (rare) target
        balances, do the >64-bit arithmetic in host ints, scatter back."""
        idx = torch.from_numpy(targets.astype(np.int64)).to(self.device)
        bal = gather(self.bal, idx).cpu().tolist()
        new = []
        for i, b in zip(targets, bal):
            penalty = int(efb_incr[i]) * adjusted_total // total_balance * increment
            new.append(max(0, b - penalty))
        scatter(self.bal, idx, torch.tensor(new, dtype=torch.int64, device=self.device))

    def hysteresis_mask(self, efb_incr, downward, upward, increment) -> np.ndarray:
        return hysteresis(self.bal, efb_incr, downward, upward, increment).cpu().numpy()

    def balances_to_host(self) -> np.ndarray:
        return self.bal.cpu().numpy().astype(np.uint64)

    def scores_to_host(self) -> np.ndarray:
        return self.scores.cpu().numpy()

    def rotate_participation(self) -> None:
        """Device-side mirror of the epoch participation reset: previous
        adopts current's column, current becomes zeros (no upload)."""
        self.part_prev = self.part_cur
        self.part_cur = torch.zeros(self.n, dtype=torch.uint8, device=self.device)
        self.mirror_part_prev = self.mirror_part_cur
        self.mirror_part_cur = np.zeros(self.n, np.uint8)


# -------------------------------------------------------- epoch sequence


def ensure_plane(state, spec: ChainSpec | None = None, device=None):
    """Attach a resident plane on ``device`` (default: the card) to the
    lineage when routing says so.  The device is resolved first, so this
    raises without a card even where routing keeps the host path."""
    dev = resolve_device(device)
    plane = getattr(state, "_resident_plane", None)
    if plane is not None:
        return plane
    n = len(state.validators)
    if not resident_enabled(n):
        return None
    plane = ResidentEpochPlane(n, dev)
    try:
        state._resident_plane = plane
    except AttributeError:  # frozen container: attach out-of-band
        object.__setattr__(state, "_resident_plane", plane)
    return plane


def _reward_tables(spec: ChainSpec, brpi: int, in_leak: bool,
                   active_incr: int, flag_incr: list[int]) -> list[list[int]] | None:
    """Exact per-increment reward/penalty tables for the sweep: rows 0-2
    are flag rewards, rows 3-4 are source/target penalties (the head flag
    carries no penalty).  ``None`` when any entry reaches ``_MAX_LUT``."""
    max_incr = spec.MAX_EFFECTIVE_BALANCE // spec.EFFECTIVE_BALANCE_INCREMENT
    denom = active_incr * constants.WEIGHT_DENOMINATOR
    luts: list[list[int]] = []
    for f, weight in enumerate(constants.PARTICIPATION_FLAG_WEIGHTS):
        row = []
        for j in range(max_incr + 1):
            v = 0 if in_leak else (j * brpi) * weight * flag_incr[f] // denom
            if v >= _MAX_LUT:
                return None
            row.append(v)
        luts.append(row)
    for f in (constants.TIMELY_SOURCE_FLAG_INDEX, constants.TIMELY_TARGET_FLAG_INDEX):
        weight = constants.PARTICIPATION_FLAG_WEIGHTS[f]
        row = []
        for j in range(max_incr + 1):
            v = (j * brpi) * weight // constants.WEIGHT_DENOMINATOR
            if v >= _MAX_LUT:
                return None
            row.append(v)
        luts.append(row)
    return luts


def _inactivity_factors(spec: ChainSpec) -> tuple[int, int] | None:
    """Reduce ``efb * score // (bias * quotient)`` to an exact
    multiply-shift ``(efb_incr * mult * score) >> shift``; ``None`` when
    the spec constants don't factor into a shift or the product could
    leave int64."""
    increment = spec.EFFECTIVE_BALANCE_INCREMENT
    denom = spec.INACTIVITY_SCORE_BIAS * spec.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
    g = math.gcd(increment, denom)
    mult, rest = increment // g, denom // g
    if rest & (rest - 1):  # must be a pure power of two (a shift)
        return None
    shift = rest.bit_length() - 1
    max_incr = spec.MAX_EFFECTIVE_BALANCE // increment
    if max_incr * mult >= _MAX_MULT or not 0 < shift < 63:
        return None
    return mult, shift


def process_epoch_resident(state, plane: ResidentEpochPlane,
                           spec: ChainSpec | None = None) -> bool:
    """The full epoch sequence through the resident plane.  Returns False
    (having changed nothing) when any guard refuses — the caller then runs
    the bit-exact host path.  A device error raises."""
    from . import accessors
    from .epoch import (
        process_eth1_data_reset,
        process_historical_summaries_update,
        process_participation_flag_updates,
        process_randao_mixes_reset,
        process_registry_updates,
        process_slashings_reset,
        process_sync_committee_updates,
        weigh_justification_and_finalization,
    )

    spec = spec or get_chain_spec()
    increment = spec.EFFECTIVE_BALANCE_INCREMENT
    factors = _inactivity_factors(spec)
    if factors is None:
        plane.stats["fallbacks"] += 1
        return False
    reg = state.registry()
    efb = reg["effective_balance"]
    if int(efb.max(initial=0)) > spec.MAX_EFFECTIVE_BALANCE or np.any(
        efb % np.uint64(increment)
    ):
        plane.stats["fallbacks"] += 1
        return False
    if not plane.sync(state, spec):
        plane.stats["fallbacks"] += 1
        return False

    efb_incr_host = (efb // np.uint64(increment)).astype(np.int64)
    curr_epoch = accessors.get_current_epoch(state, spec)
    prev_epoch = accessors.get_previous_epoch(state, spec)
    active_prev, active_cur, eligible, slashed = (
        plane.upload(m) for m in plane.masks(reg, prev_epoch, curr_epoch)
    )
    efb_incr = plane.upload(efb_incr_host)

    # device sums first, then EVERY remaining guard — no state mutation
    # may precede a possible False return, or the host fallback would
    # re-apply passes the resident path already ran
    sums = plane.epoch_sums(efb_incr, active_prev, active_cur, slashed)
    total_active = max(increment, sums[0] * increment)
    brpi = (
        increment * spec.BASE_REWARD_FACTOR // integer_squareroot(total_active)
    )
    flag_incr = [
        max(increment, sums[1 + f] * increment) // increment for f in range(3)
    ]
    # probe with in_leak=False (the LARGER table values; the leak
    # variant zeroes rewards) so the overflow guard can run before
    # justification mutates the state
    luts = _reward_tables(
        spec, brpi, False, total_active // increment, flag_incr
    )
    if luts is None:
        plane.stats["fallbacks"] += 1
        return False

    # (1) justification and finalization, from the device sums
    if curr_epoch > constants.GENESIS_EPOCH + 1:
        weigh_justification_and_finalization(
            state,
            total_active,
            max(increment, sums[2] * increment),
            max(increment, sums[4] * increment),
            spec,
        )

    # (2)+(3) inactivity updates + rewards/penalties, one sweep.  in_leak
    # reads the finalized checkpoint just/fin may have moved.
    in_leak = accessors.is_in_inactivity_leak(state, spec)
    do_epoch = curr_epoch != constants.GENESIS_EPOCH
    if in_leak:
        luts = _reward_tables(
            spec, brpi, True, total_active // increment, flag_incr
        )
    mult, shift = factors
    plane.sweep(
        efb_incr, eligible, active_prev, slashed,
        (in_leak, do_epoch, spec.INACTIVITY_SCORE_BIAS,
         spec.INACTIVITY_SCORE_RECOVERY_RATE, mult, shift),
        luts,
    )

    # (4) registry updates: sequential churn/queue logic, host exact
    process_registry_updates(state, spec)

    # (5) slashings: rare targets, exact >64-bit host arithmetic
    targets = np.nonzero(
        reg["slashed"]
        & (curr_epoch + spec.EPOCHS_PER_SLASHINGS_VECTOR // 2
           == reg["withdrawable_epoch"])
    )[0]
    if targets.size:
        adjusted_total = min(
            sum(state.slashings) * spec.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX,
            total_active,
        )
        plane.slash_fixup(targets, efb_incr_host, adjusted_total, total_active, increment)

    process_eth1_data_reset(state, spec)

    # (7) effective-balance hysteresis: device mask, host fixups.  The
    # mask reads the post-sweep/post-slashing resident balances.
    mask = plane.hysteresis_mask(
        efb_incr,
        increment // spec.HYSTERESIS_QUOTIENT * spec.HYSTERESIS_DOWNWARD_MULTIPLIER,
        increment // spec.HYSTERESIS_QUOTIENT * spec.HYSTERESIS_UPWARD_MULTIPLIER,
        increment,
    )
    balances = plane.balances_to_host()
    scores = plane.scores_to_host()
    for i in np.nonzero(mask)[0]:
        b = int(balances[i])
        state.update_validator(
            int(i),
            effective_balance=min(b - b % increment, spec.MAX_EFFECTIVE_BALANCE),
        )

    # the deltas flow back: balances/scores lists adopt the device
    # results (the incremental engine rebuilds those two columns), and
    # participation rotates structurally on all three tiers — host
    # lists, root-engine subtrees, resident columns.
    state.set_balances(balances)
    state.inactivity_scores = [int(s) for s in scores]
    plane.mirror_bal = balances.copy()
    plane.mirror_scores = scores.copy()

    process_slashings_reset(state, spec)
    process_randao_mixes_reset(state, spec)
    process_historical_summaries_update(state, spec)
    process_participation_flag_updates(state, spec)
    plane.rotate_participation()
    process_sync_committee_updates(state, spec)
    # mirrors now match the post-epoch lists again: re-stamp so the NEXT
    # boundary's sync narrows its compare to the block deltas in between
    plane._stamp_deltas(state)
    set_gauge("resident_plane_sync_elems", plane.stats["scatter_elems"])
    return True
