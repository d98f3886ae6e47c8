"""Priority ingest scheduler: the shared admission layer between gossip
arrival and the batched device verify paths.

The per-topic greedy drains (network/gossip.py round 4) had two failure
shapes the paper's economics cannot afford: under light load every topic
issued batch-of-1 device verifies (the fixed dispatch cost dominates —
arxiv 2302.00418: batch size IS the BLS verification economics), and
under overload each queue blindly IGNOREd its *newest* arrivals whether
they were blocks or duplicate subnet votes.  This package replaces the
independent drains with one scheduler over bounded **priority lanes**
(blocks > aggregates > subnet attestations > other):

- :mod:`.lanes` — the bounded FIFO lane: arrival-stamped items, a DRR
  deficit counter, and the two flush triggers (coalesce-target depth or
  per-lane deadline);
- :mod:`.policy` — the pure decision functions: batch snapping onto
  shape buckets, shed-victim selection (lowest-priority backlogged lane
  first), and the sliding-window degraded-mode signal;
- :mod:`.scheduler` — the asyncio drain loop: deficit-weighted service
  in priority order, deadline-based batch coalescing, admission-time
  load shedding, and the per-lane metric families.

The port's copy of the JAX package's ``pipeline`` package.  It differs in
two ways: a flush is never snapped onto shape buckets (the port has no AOT
registry), and a ``RuntimeError`` from a source (a kernel, native or CUDA
fault) ends the drain loop, with no restart, and
:meth:`IngestScheduler.stop` raises it.
"""

from .lanes import Lane, LaneConfig
from .policy import DegradedSignal, choose_shed_victim, snap_batch
from .scheduler import BATCH_SIZE_BUCKETS, IngestScheduler

__all__ = [
    "BATCH_SIZE_BUCKETS",
    "DegradedSignal",
    "IngestScheduler",
    "Lane",
    "LaneConfig",
    "choose_shed_victim",
    "snap_batch",
]
