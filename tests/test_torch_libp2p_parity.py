"""The port's libp2p wire layers against the JAX package's, byte for byte.

Varints and their errors, multistream messages, mplex and yamux frames,
base58, peer IDs and noise payloads from seeded ed25519 identities, eth2
message ids on valid and invalid snappy, gossipsub RPCs, the router's
constants and the identify message, each made by both packages from the
same inputs.  No sockets.  Tolerance: none — every value is bytes.
"""

import hashlib
import random

import pytest

pytest.importorskip(
    "cryptography",
    reason="libp2p identity/noise needs the optional 'cryptography' module",
)

from lambda_ethereum_consensus_tpu.network.libp2p import gossipsub as jgs
from lambda_ethereum_consensus_tpu.network.libp2p import host as jhost
from lambda_ethereum_consensus_tpu.network.libp2p import identity as jident
from lambda_ethereum_consensus_tpu.network.libp2p import mplex as jmplex
from lambda_ethereum_consensus_tpu.network.libp2p import multistream as jms
from lambda_ethereum_consensus_tpu.network.libp2p import varint as jvarint
from lambda_ethereum_consensus_tpu.network.libp2p import yamux as jyamux
from lambda_ethereum_consensus_tpu.network.proto import gossipsub_pb2 as jpb
from lambda_ethereum_consensus_tpu_torch.compression import compress
from lambda_ethereum_consensus_tpu_torch.network.libp2p import gossipsub as gs
from lambda_ethereum_consensus_tpu_torch.network.libp2p import host as host_mod
from lambda_ethereum_consensus_tpu_torch.network.libp2p import identity as ident
from lambda_ethereum_consensus_tpu_torch.network.libp2p import mplex, multistream, varint, yamux
from lambda_ethereum_consensus_tpu_torch.network.libp2p.host import Libp2pHost
from lambda_ethereum_consensus_tpu_torch.network.proto import gossipsub_pb2 as pb

TOPIC = "/eth2/bba4da96/beacon_block/ssz_snappy"
STATUS_PROTOCOL = "/eth2/beacon_chain/req/status/1/ssz_snappy"
PING_PROTOCOL = "/eth2/beacon_chain/req/ping/1/ssz_snappy"
SEEDS = [bytes([i]) * 32 for i in (1, 2, 7)] + [
    random.Random(9).randbytes(32), random.Random(10).randbytes(32)]


# ----------------------------------------------------------------- parity

def test_varint_equals_jax():
    for n in (0, 1, 127, 128, 300, 16383, 16384, 2**31 - 1, 2**32, 2**63 - 1):
        raw = varint.encode(n)
        assert raw == jvarint.encode(n), n
        assert varint.decode(b"\xff" + raw, 1) == jvarint.decode(b"\xff" + raw, 1) == \
            (n, len(raw) + 1)


def test_varint_errors_equal_jax():
    for data, shift in ((b"\x80\x80", 63), (b"\xff" * 10, 63), (b"\xff" * 6, 31)):
        with pytest.raises(varint.VarintError) as ours:
            varint.decode(data, 0, shift)
        with pytest.raises(jvarint.VarintError) as theirs:
            jvarint.decode(data, 0, shift)
        assert str(ours.value) == str(theirs.value)


def test_multistream_messages_equal_jax():
    for proto in ("/multistream/1.0.0", "na", "ls", "/noise", "/mplex/6.7.0", "/yamux/1.0.0",
                  "/meshsub/1.1.0", "/ipfs/id/1.0.0", STATUS_PROTOCOL, "/" + "x" * 200):
        assert multistream.encode_msg(proto) == jms.encode_msg(proto), proto


def test_mplex_frames_equal_jax():
    rng = random.Random(3)
    for _ in range(64):
        stream_id = rng.choice([0, 1, 5, 17, 1000, 2**20 + 3])
        flag = rng.randrange(7)
        data = rng.randbytes(rng.choice([0, 1, 30, 200]))
        assert mplex.encode_frame(stream_id, flag, data) == \
            jmplex.encode_frame(stream_id, flag, data)


def test_yamux_frames_equal_jax():
    rng = random.Random(4)
    types = (yamux.TYPE_DATA, yamux.TYPE_WINDOW, yamux.TYPE_PING, yamux.TYPE_GOAWAY)
    for _ in range(64):
        typ, flags = rng.choice(types), rng.randrange(16)
        stream_id, length = rng.randrange(2**32), rng.randrange(2**32)
        data = rng.randbytes(rng.choice([0, 3, 40]))
        assert yamux.encode_frame(typ, flags, stream_id, length, data) == \
            jyamux.encode_frame(typ, flags, stream_id, length, data)
    assert (yamux.INITIAL_WINDOW, yamux.MAX_FRAME_DATA, yamux.MAX_STREAM_BUFFER) == \
        (jyamux.INITIAL_WINDOW, jyamux.MAX_FRAME_DATA, jyamux.MAX_STREAM_BUFFER)


def test_base58_equals_jax():
    rng = random.Random(5)
    for _ in range(64):
        raw = b"\x00" * rng.randrange(3) + rng.randbytes(rng.randrange(40))
        text = ident.base58_encode(raw)
        assert text == jident.base58_encode(raw)
        assert ident.base58_decode(text) == jident.base58_decode(text) == raw


def test_peer_ids_and_noise_payloads_equal_jax():
    for seed in SEEDS:
        ours, theirs = ident.Identity.from_seed(seed), jident.Identity.from_seed(seed)
        assert ours.public_pb == theirs.public_pb
        assert ours.peer_id.bytes == theirs.peer_id.bytes
        assert ours.peer_id.pretty() == theirs.peer_id.pretty()
        assert ours.private_bytes() == theirs.private_bytes() == seed
        static_pub = hashlib.sha256(seed).digest()
        payload = ours.noise_payload(static_pub)  # ed25519 signatures are deterministic
        assert payload == theirs.noise_payload(static_pub)
        # each package verifies the other's payload and proves the same peer
        assert jident.verify_noise_payload(payload, static_pub).bytes == \
            ident.verify_noise_payload(theirs.noise_payload(static_pub), static_pub).bytes


def test_large_key_peer_id_equals_jax():
    for size in (43, 100, 300):
        pub = ident.encode_public_key_pb(0, b"\x05" * size)
        assert pub == jident.encode_public_key_pb(0, b"\x05" * size)
        assert ident.PeerId.from_public_key_pb(pub).bytes == \
            jident.PeerId.from_public_key_pb(pub).bytes


@pytest.mark.parametrize("kind", ["valid", "invalid", "empty"])
def test_eth2_msg_id_equals_jax(kind):
    payload = {"valid": compress(b"block-bytes-" * 40), "invalid": b"\xff\xfe\xfd not snappy",
               "empty": b""}[kind]
    for topic in (TOPIC, "/eth2/bba4da96/beacon_aggregate_and_proof/ssz_snappy", ""):
        assert gs.eth2_msg_id(topic, payload) == jgs.eth2_msg_id(topic, payload)


def _rpcs(module):
    """The same RPCs built with ``module``'s generated classes."""
    sub = module.RPC()
    s = sub.subscriptions.add()
    s.subscribe, s.topicid = True, TOPIC
    unsub = module.RPC()
    s = unsub.subscriptions.add()
    s.subscribe, s.topicid = False, "t"
    publish = module.RPC()
    for i in range(3):
        m = publish.publish.add()
        m.data, m.topic = bytes([i]) * (i * 50 + 1), TOPIC
    graft = module.RPC()
    graft.control.graft.add().topic_id = TOPIC
    prune = module.RPC()
    p = prune.control.prune.add()
    p.topic_id, p.backoff = TOPIC, 60
    p.peers.add().peer_id = b"\x00\x24" + b"\x01" * 36
    gossip = module.RPC()
    ih = gossip.control.ihave.add()
    ih.topic_id = TOPIC
    ih.message_ids.extend([bytes([i]) * 20 for i in range(5)])
    gossip.control.iwant.add().message_ids.extend([b"\x09" * 20])
    return {"subscribe": sub, "unsubscribe": unsub, "publish": publish, "graft": graft,
            "prune": prune, "ihave_iwant": gossip}


@pytest.mark.parametrize("kind", sorted(_rpcs(pb)))
def test_encode_rpc_equals_jax(kind):
    ours, theirs = _rpcs(pb)[kind], _rpcs(jpb)[kind]
    assert gs.encode_rpc(ours) == jgs.encode_rpc(theirs)
    assert pb.RPC.FromString(theirs.SerializeToString()) == ours


def test_gossipsub_constants_equal_jax():
    names = ("MESHSUB_PROTOCOL", "MAX_RPC", "D", "D_LO", "D_HI", "HEARTBEAT_S",
             "HISTORY_LENGTH", "HISTORY_GOSSIP", "SEEN_TTL_S", "FANOUT_TTL_S",
             "MAX_IHAVE_IDS", "MAX_IWANT_RETRANSMIT", "PRUNE_BACKOFF_S",
             "GRAFT_FLOOD_PENALTY", "GRAFT_FLOOD_GRACE_S", "MAX_PX_PEERS", "ACCEPT", "REJECT",
             "IGNORE", "ACCEPT_REWARD", "REJECT_PENALTY", "PRUNE_SCORE", "MAX_SCORE",
             "SCORE_DECAY", "BAN_DECAY")
    assert {n: getattr(gs, n) for n in names} == {n: getattr(jgs, n) for n in names}
    assert (gs.D, gs.D_LO, gs.D_HI, gs.HEARTBEAT_S) == (8, 6, 12, 0.7)
    assert host_mod.MUXER_PROTOCOLS == jhost.MUXER_PROTOCOLS == ["/yamux/1.0.0", "/mplex/6.7.0"]


@pytest.mark.parametrize("addrs", [[("127.0.0.1", 9000)], [("0.0.0.0", 9000)],
                                   [("10.1.2.3", 1), ("::1", 5), ("127.0.0.1", 65535)]],
                         ids=["loopback", "unspecified", "mixed"])
def test_identify_message_equals_jax(addrs, monkeypatch):
    """The identify protobuf from the same identity, listen addresses and
    protocols (``SIDECAR_EXTERNAL_IP`` unset for the JAX host: its
    default, under which both omit a listener bound to 0.0.0.0)."""
    monkeypatch.delenv("SIDECAR_EXTERNAL_IP", raising=False)
    ours = Libp2pHost(ident.Identity.from_seed(SEEDS[0]))
    theirs = jhost.Libp2pHost(jident.Identity.from_seed(SEEDS[0]))
    for host in (ours, theirs):
        host.listen_addrs.extend(addrs)
        for proto in (STATUS_PROTOCOL, PING_PROTOCOL, "/meshsub/1.1.0"):
            host.set_stream_handler(proto, None)
    assert ours._identify_message() == theirs._identify_message()
