"""Protobuf messages of the sidecar's stdio control protocol (``port_pb2``)
and of its peer frames (``p2p_pb2``)."""
