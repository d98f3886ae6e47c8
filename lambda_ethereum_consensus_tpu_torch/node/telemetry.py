"""Metrics registry + Prometheus exposition — compatibility re-export.

The implementation lives in the package-level
:mod:`lambda_ethereum_consensus_tpu_torch.telemetry` so the layers below the
node runtime (``ssz``, ``ops``, ``network``, ``fork_choice``) can record
spans without importing through ``node/__init__`` — which pulls in the
whole runtime and would turn e.g. ``ssz/core.py -> node.telemetry`` into
a circular import.

The port's copy of the JAX package's ``node/telemetry.py``: the same nine
names.
"""

from ..telemetry import (  # noqa: F401
    DEFAULT_BUCKETS,
    BoundSpan,
    Metrics,
    get_metrics,
    inc,
    observe,
    set_gauge,
    span,
    telemetry_enabled,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "BoundSpan",
    "Metrics",
    "get_metrics",
    "inc",
    "observe",
    "set_gauge",
    "span",
    "telemetry_enabled",
]
