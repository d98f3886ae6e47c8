# source: p2p.proto
"""Generated protocol buffer code, the port's copy of the JAX package's
``network/proto/p2p_pb2.py`` (made by ``tools/gen_proto.py``).  DO NOT EDIT.

One change: the file is added to a descriptor pool of its own, not to
protobuf's default pool, so this module and the JAX package's twin load
side by side in one process.  The wire bytes are the same.
"""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
# @@protoc_insertion_point(imports)

_POOL = _descriptor_pool.DescriptorPool()


DESCRIPTOR = _POOL.AddSerializedFile(b'\n\tp2p.proto\x12\rconsensus_p2p"\x85\x03\n\x08P2PFrame\x12%\n\x05hello\x18\x01 \x01(\x0b2\x14.consensus_p2p.HelloH\x00\x12*\n\x06gossip\x18\x02 \x01(\x0b2\x18.consensus_p2p.GossipMsgH\x00\x12!\n\x03req\x18\x03 \x01(\x0b2\x12.consensus_p2p.ReqH\x00\x12#\n\x04resp\x18\x04 \x01(\x0b2\x13.consensus_p2p.RespH\x00\x124\n\rpeer_exchange\x18\x05 \x01(\x0b2\x1b.consensus_p2p.PeerExchangeH\x00\x12)\n\x07goodbye\x18\x06 \x01(\x0b2\x16.consensus_p2p.GoodbyeH\x00\x12*\n\x08sub_opts\x18\x07 \x01(\x0b2\x16.consensus_p2p.SubOptsH\x00\x12%\n\x05graft\x18\x08 \x01(\x0b2\x14.consensus_p2p.GraftH\x00\x12%\n\x05prune\x18\t \x01(\x0b2\x14.consensus_p2p.PruneH\x00B\x03\n\x01f"R\n\x05Hello\x12\x0f\n\x07node_id\x18\x01 \x01(\x0c\x12\x13\n\x0bfork_digest\x18\x02 \x01(\t\x12\x13\n\x0blisten_port\x18\x03 \x01(\r\x12\x0e\n\x06topics\x18\x04 \x03(\t"+\n\x07SubOpts\x12\r\n\x05topic\x18\x01 \x01(\t\x12\x11\n\tsubscribe\x18\x02 \x01(\x08"\x16\n\x05Graft\x12\r\n\x05topic\x18\x01 \x01(\t"\x16\n\x05Prune\x12\r\n\x05topic\x18\x01 \x01(\t"S\n\tGossipMsg\x12\r\n\x05topic\x18\x01 \x01(\t\x12\x0f\n\x07payload\x18\x02 \x01(\x0c\x12&\n\x05trace\x18\x03 \x01(\x0b2\x17.consensus_p2p.TraceCtx";\n\x03Req\x12\x0e\n\x06req_id\x18\x01 \x01(\x0c\x12\x13\n\x0bprotocol_id\x18\x02 \x01(\t\x12\x0f\n\x07payload\x18\x03 \x01(\x0c"B\n\x04Resp\x12\x0e\n\x06req_id\x18\x01 \x01(\x0c\x12\x0f\n\x07payload\x18\x02 \x01(\x0c\x12\n\n\x02ok\x18\x03 \x01(\x08\x12\r\n\x05error\x18\x04 \x01(\t"\x1d\n\x0cPeerExchange\x12\r\n\x05addrs\x18\x01 \x03(\t"\x19\n\x07Goodbye\x12\x0e\n\x06reason\x18\x01 \x01(\x04"L\n\x08TraceCtx\x12\x0e\n\x06origin\x18\x01 \x01(\t\x12\x10\n\x08trace_id\x18\x02 \x01(\x04\x12\x0b\n\x03hop\x18\x03 \x01(\r\x12\x11\n\torigin_ts\x18\x04 \x01(\x01b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'p2p_pb2', globals())
# @@protoc_insertion_point(module_scope)
