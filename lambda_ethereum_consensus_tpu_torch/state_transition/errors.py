"""Shared exception types for the consensus core.

One hierarchy so callers can catch ``SpecError`` for any attacker-controlled
input that fails validation (the reference returns ``{:error, reason}``
tuples everywhere; here invalid input raises, and the fork-choice/network
layers catch ``SpecError`` to reject the message).
"""


class SpecError(ValueError):
    """Input failed consensus-spec validation."""


class OperationError(SpecError):
    """Invalid block operation."""


class StateTransitionError(SpecError):
    """Block failed the state transition."""
