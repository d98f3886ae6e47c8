"""libp2p wire-compatibility stack; the port's copy of the JAX package's
``network/libp2p/``, byte for byte on the wire (``tests/test_torch_libp2p*.py``).

The reference's networking is go-libp2p (ref:
native/libp2p_port/internal/reqresp/reqresp.go:30-46 — TCP transport,
noise security, mplex/yamux muxing, multistream-select negotiation).
This package implements those exact wire protocols from their public
specifications, so the node can speak to real libp2p peers instead of
only its own bespoke-frame kind:

- :mod:`identity`   — ed25519 peer identities, peer IDs, noise payload
- :mod:`multistream` — multistream-select 1.0 protocol negotiation
- :mod:`noise_transport` — libp2p-noise channel (XX + identity payload)
- :mod:`yamux`, :mod:`mplex` — /yamux/1.0.0 (preferred) and /mplex/6.7.0
- :mod:`host`       — the composed host: dial/listen/new_stream/handlers
- :mod:`gossipsub`  — gossipsub v1.1 on /meshsub/1.1.0

Host code only: nothing here imports ``torch``, and the sidecar process
that runs it does no device work.  Discovery (discv5) is not ported.
"""

from .host import Libp2pHost  # noqa: F401
from .identity import Identity, PeerId  # noqa: F401
