# source: gossipsub.proto
"""Generated protocol buffer code, the port's copy of the JAX package's
``network/proto/gossipsub_pb2.py`` (gossipsub v1.1's RPC, as
go-libp2p-pubsub's ``pb/rpc.proto`` defines it).  DO NOT EDIT.

One change: the file is added to a descriptor pool of its own, not to
protobuf's default pool, so this module and the JAX package's twin load
side by side in one process.  The wire bytes are the same.
"""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
# @@protoc_insertion_point(imports)

_POOL = _descriptor_pool.DescriptorPool()


DESCRIPTOR = _POOL.AddSerializedFile(b'\n\x0fgossipsub.proto\x12\npubsub_rpc\"\x84\x01\n\x03RPC\x12*\n\rsubscriptions\x18\x01 \x03(\x0b\x32\x13.pubsub_rpc.SubOpts\x12$\n\x07publish\x18\x02 \x03(\x0b\x32\x13.pubsub_rpc.Message\x12+\n\x07\x63ontrol\x18\x03 \x01(\x0b\x32\x1a.pubsub_rpc.ControlMessage\"-\n\x07SubOpts\x12\x11\n\tsubscribe\x18\x01 \x01(\x08\x12\x0f\n\x07topicid\x18\x02 \x01(\t\"c\n\x07Message\x12\x0c\n\x04\x66rom\x18\x01 \x01(\x0c\x12\x0c\n\x04\x64\x61ta\x18\x02 \x01(\x0c\x12\r\n\x05seqno\x18\x03 \x01(\x0c\x12\r\n\x05topic\x18\x04 \x01(\t\x12\x11\n\tsignature\x18\x05 \x01(\x0c\x12\x0b\n\x03key\x18\x06 \x01(\x0c\"\xb4\x01\n\x0e\x43ontrolMessage\x12\'\n\x05ihave\x18\x01 \x03(\x0b\x32\x18.pubsub_rpc.ControlIHave\x12\'\n\x05iwant\x18\x02 \x03(\x0b\x32\x18.pubsub_rpc.ControlIWant\x12\'\n\x05graft\x18\x03 \x03(\x0b\x32\x18.pubsub_rpc.ControlGraft\x12\'\n\x05prune\x18\x04 \x03(\x0b\x32\x18.pubsub_rpc.ControlPrune\"5\n\x0c\x43ontrolIHave\x12\x10\n\x08topic_id\x18\x01 \x01(\t\x12\x13\n\x0bmessage_ids\x18\x02 \x03(\x0c\"#\n\x0c\x43ontrolIWant\x12\x13\n\x0bmessage_ids\x18\x01 \x03(\x0c\" \n\x0c\x43ontrolGraft\x12\x10\n\x08topic_id\x18\x01 \x01(\t\"V\n\x0c\x43ontrolPrune\x12\x10\n\x08topic_id\x18\x01 \x01(\t\x12#\n\x05peers\x18\x02 \x03(\x0b\x32\x14.pubsub_rpc.PeerInfo\x12\x0f\n\x07\x62\x61\x63koff\x18\x03 \x01(\x04\"7\n\x08PeerInfo\x12\x0f\n\x07peer_id\x18\x01 \x01(\x0c\x12\x1a\n\x12signed_peer_record\x18\x02 \x01(\x0c\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'gossipsub_pb2', globals())
# @@protoc_insertion_point(module_scope)
