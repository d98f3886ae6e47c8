"""Which exceptions end a loop of the port: the device-fault rule.

The port surfaces a device fault and never retries it on the host.  A
``RuntimeError`` (a kernel, native or CUDA fault, ``torch.OutOfMemoryError``,
the store's ``KvError``) ends the drain, scan or tick loop it reaches and is
raised again from the loop's next entry point.  Every other exception is
contained per item, as in the JAX package.

The wire's errors (``network.port.PortError``, ``network.reqresp.ReqRespError``)
and the HTTP clients' (``api.engine.EngineApiError``,
``api.checkpoint_sync.CheckpointSyncError``) are ``RuntimeError`` subclasses
too, as in the JAX package, but a sidecar hiccup or an unreachable peer is no
device fault: they derive from :class:`WireError`, which
:func:`is_device_fault` excludes.  Every site that applies the rule asks this
one predicate.  The module imports nothing, so the sidecar process may load
it.
"""

from __future__ import annotations


class WireError(RuntimeError):
    """A failure of the network wire (sidecar, peer or req/resp framing):
    contained as the JAX package contains it, never a device fault."""


def is_device_fault(exc: BaseException) -> bool:
    """True for an exception that must end the loop it reaches."""
    return isinstance(exc, RuntimeError) and not isinstance(exc, WireError)
