"""Pipelined block replay: overlap host-side decode/prep with execution.

A replay loop is two alternating phases per block: host work (SSZ decode
of the next signed block, signing-root prep) and transition work (device
verify + state transition of the current one).  Serially they sum; the
block stream is known in advance, so the host phase of block N+1 can run
on a worker thread while block N executes — applied to the replay
drivers and usable by range-sync.

:func:`prefetched` is deliberately a one-worker, bounded-depth pipeline:
replay consumes blocks in order, so a single prefetch thread staying
``depth`` items ahead captures the full overlap without reordering or
unbounded memory.  Exceptions raised by ``prep`` surface at the
consumer's ``next()`` for the failing item, in order.

The port's copy of the JAX package's ``node/replay.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

__all__ = ["prefetched", "decode_signed_blocks"]

_SENTINEL = object()


def prefetched(
    items: Iterable[T], prep: Callable[[T], U], depth: int = 2
) -> Iterator[U]:
    """Yield ``prep(item)`` for each item, with ``prep`` running up to
    ``depth`` items ahead on a worker thread."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    out: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(entry) -> bool:
        # bounded-wait put: when the consumer abandons the generator
        # (transition raised, range-sync closed it), the stop flag frees
        # the worker instead of parking it on the full queue forever
        while not stop.is_set():
            try:
                out.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run() -> None:
        try:
            # one containment for BOTH failure sources — prep() and the
            # source iterable itself (a network-backed block stream can
            # raise mid-iteration): either is delivered in order at the
            # consumer's next(), never read as a clean end-of-stream
            try:
                for item in items:
                    if not _put(("ok", prep(item))):
                        return
            except BaseException as e:
                _put(("err", e))
                return
        finally:
            _put((_SENTINEL, None))

    worker = threading.Thread(target=run, daemon=True, name="replay-prefetch")
    worker.start()
    try:
        while True:
            kind, payload = out.get()
            if kind is _SENTINEL:
                return
            if kind == "err":
                raise payload
            yield payload
    finally:
        stop.set()
        # the stop flag frees the worker within one bounded-put timeout;
        # join so generator close means the thread is actually gone — an
        # unjoined prefetcher could still be calling prep() against
        # state the consumer is tearing down
        worker.join(timeout=2.0)


def decode_signed_blocks(raws: Iterable[bytes], spec=None, depth: int = 2):
    """Prefetch-decode a stream of SSZ-encoded ``SignedBeaconBlock`` bytes
    — the replay driver's host phase — one block ahead of execution."""
    from ..config import get_chain_spec
    from ..types.beacon import SignedBeaconBlock

    spec = spec or get_chain_spec()
    return prefetched(
        raws, lambda raw: SignedBeaconBlock.decode(raw, spec), depth=depth
    )
