"""Protobuf messages of the sidecar's stdio control protocol (``port_pb2``),
of the bespoke wire's peer frames (``p2p_pb2``) and of gossipsub's RPC on
the libp2p wire (``gossipsub_pb2``)."""
