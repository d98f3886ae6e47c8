"""The cases of the JAX package's ``tests/unit/test_libp2p_wire.py`` against
the port's libp2p modules.

The spec's byte fixtures (multistream, mplex, base58, ed25519 and sha2-256
peer IDs), the noise payload's binding to its static key, and over two port
hosts on loopback: a status request through the whole upgrade, an unserved
protocol answered ``na``, two interleaved requests on one connection, and
a dial of a non-libp2p listener failing cleanly.  Byte parity with the JAX
package is ``tests/test_torch_libp2p_parity.py``.  Every wait has a bound.
Tolerance: none.
"""

import asyncio
import hashlib
import struct

import pytest

pytest.importorskip(
    "cryptography",
    reason="libp2p identity/noise needs the optional 'cryptography' module",
)

from lambda_ethereum_consensus_tpu_torch.compression import compress
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec
from lambda_ethereum_consensus_tpu_torch.network import reqresp as rr
from lambda_ethereum_consensus_tpu_torch.network.libp2p import gossipsub as gs
from lambda_ethereum_consensus_tpu_torch.network.libp2p import identity as ident
from lambda_ethereum_consensus_tpu_torch.network.libp2p import mplex, multistream
from lambda_ethereum_consensus_tpu_torch.network.libp2p.host import Libp2pError, Libp2pHost
from lambda_ethereum_consensus_tpu_torch.types.p2p import StatusMessage

TOPIC = "/eth2/bba4da96/beacon_block/ssz_snappy"
STATUS_PROTOCOL = "/eth2/beacon_chain/req/status/1/ssz_snappy"
PING_PROTOCOL = "/eth2/beacon_chain/req/ping/1/ssz_snappy"


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


# ------------------------------------------------ the JAX tests' fixtures

def test_multistream_handshake_bytes():
    assert multistream.encode_msg("/multistream/1.0.0") == b"\x13/multistream/1.0.0\n"
    assert multistream.encode_msg("na") == b"\x03na\n"
    assert multistream.encode_msg("ls") == b"\x03ls\n"
    assert multistream.encode_msg("/noise") == b"\x07/noise\n"
    assert multistream.encode_msg("/mplex/6.7.0") == b"\x0d/mplex/6.7.0\n"


def test_multistream_eth2_protocol_line():
    encoded = multistream.encode_msg(STATUS_PROTOCOL)
    assert encoded[0] == len(STATUS_PROTOCOL) + 1  # single-byte varint
    assert encoded[1:] == STATUS_PROTOCOL.encode() + b"\n"


def test_mplex_frame_bytes():
    assert mplex.encode_frame(0, mplex.NEW_STREAM, b"0") == b"\x00\x010"
    assert mplex.encode_frame(5, mplex.MSG_INITIATOR, b"hi") == b"\x2a\x02hi"
    assert mplex.encode_frame(17, mplex.CLOSE_INITIATOR) == b"\x8c\x01\x00"
    assert mplex.encode_frame(1, mplex.MSG_RECEIVER, b"x")[0] == 1 << 3 | 1


def test_base58_known_vectors():
    cases = [
        (b"", ""),
        (b"\x00", "1"),
        (bytes.fromhex("626262"), "a3gV"),
        (bytes.fromhex("636363"), "aPEr"),
        (bytes.fromhex("73696d706c792061206c6f6e6720737472696e67"),
         "2cFupjhnEsSn59qHXstmK2ffpLv2"),
        (bytes.fromhex("00eb15231dfceb60925886b67d065299925915aeb172c06647"),
         "1NS17iag9jJgTHD1VXjvLCEnZuQ3rJDE9L"),
    ]
    for raw, text in cases:
        assert ident.base58_encode(raw) == text
        assert ident.base58_decode(text) == raw
    with pytest.raises(ident.IdentityError):
        ident.base58_decode("0OIl")


def test_ed25519_peer_id_structure():
    identity = ident.Identity.from_seed(b"\x01" * 32)
    pub = identity.public_pb
    assert pub[:4] == b"\x08\x01\x12\x20" and len(pub) == 36
    raw = identity.peer_id.bytes
    assert raw[:2] == b"\x00\x24" and raw[2:] == pub
    assert identity.peer_id.pretty().startswith("12D3KooW")
    assert ident.Identity.from_seed(b"\x01" * 32).peer_id == identity.peer_id


def test_sha256_peer_id_for_large_keys():
    pid = ident.PeerId.from_public_key_pb(ident.encode_public_key_pb(0, b"\x05" * 100))
    assert pid.bytes[:2] == b"\x12\x20" and len(pid.bytes) == 34


def test_noise_payload_roundtrip_and_binding():
    identity = ident.Identity()
    static_pub = b"\x07" * 32
    payload = identity.noise_payload(static_pub)
    assert ident.verify_noise_payload(payload, static_pub) == identity.peer_id
    with pytest.raises(ident.IdentityError):
        ident.verify_noise_payload(payload, b"\x08" * 32)
    other = ident.Identity()
    forged = (b"\x0a" + bytes([len(other.public_pb)]) + other.public_pb
              + payload[2 + len(identity.public_pb):])
    with pytest.raises(ident.IdentityError):
        ident.verify_noise_payload(forged, static_pub)


# ---------------------------------------------------- loopback, port hosts

def test_eth2_reqresp_over_real_libp2p_stack():
    """A status request and its answer over the whole upgrade (TCP,
    multistream, noise with identity payloads, the muxer, a negotiated
    stream); the server sees the protocol path and the dialer's proven
    peer id."""
    spec = minimal_spec()
    server_status = StatusMessage(fork_digest=b"\xba\xa4\xda\x96", finalized_root=b"\x11" * 32,
                                  finalized_epoch=7, head_root=b"\x22" * 32, head_slot=123)
    mine = StatusMessage(fork_digest=b"\xba\xa4\xda\x96", finalized_root=b"\x00" * 32,
                         finalized_epoch=0, head_root=b"\x00" * 32, head_slot=0)

    async def main():
        server, client = Libp2pHost(), Libp2pHost()
        seen = {}

        async def status_handler(stream, protocol, peer_id):
            seen.update(protocol=protocol, peer=peer_id,
                        request=rr.decode_request(await stream.read_all()))
            stream.write(rr.encode_response_chunk(rr.SUCCESS, server_status.encode(spec)))
            await stream.close_write()

        server.set_stream_handler(STATUS_PROTOCOL, status_handler)
        try:
            host, port = await server.listen()
            peer = await client.dial(host, port)
            assert peer == server.peer_id
            raw = await client.request(peer, STATUS_PROTOCOL, rr.encode_request(mine.encode(spec)))
        finally:
            await client.close()
            await server.close()
        return seen, rr.decode_response_chunks(raw), client.peer_id

    seen, chunks, client_id = run(main())
    assert seen["protocol"] == STATUS_PROTOCOL and seen["peer"] == client_id
    assert StatusMessage.decode(seen["request"], minimal_spec()).head_slot == 0
    [(result, _ctx, ssz)] = chunks
    got = StatusMessage.decode(ssz, minimal_spec())
    assert result == rr.SUCCESS and (got.head_slot, got.finalized_epoch) == (123, 7)


def test_unsupported_protocol_answers_na():
    async def main():
        server, client = Libp2pHost(), Libp2pHost()
        try:
            host, port = await server.listen()
            peer = await client.dial(host, port)
            with pytest.raises(Libp2pError):
                await client.new_stream(peer, [PING_PROTOCOL])
        finally:
            await client.close()
            await server.close()

    run(main())


def test_concurrent_streams_one_connection():
    async def main():
        server, client = Libp2pHost(), Libp2pHost()

        async def echo_handler(stream, protocol, peer_id):
            body = await stream.read_all()
            await asyncio.sleep(0.01 if body == b"slow" else 0)
            stream.write(b"echo:" + body)
            await stream.close_write()

        server.set_stream_handler(PING_PROTOCOL, echo_handler)
        try:
            host, port = await server.listen()
            peer = await client.dial(host, port)
            return await asyncio.gather(client.request(peer, PING_PROTOCOL, b"slow"),
                                        client.request(peer, PING_PROTOCOL, b"fast"))
        finally:
            await client.close()
            await server.close()

    assert run(main()) == [b"echo:slow", b"echo:fast"]


def test_dial_of_a_non_libp2p_endpoint_fails_cleanly():
    """A listener that answers garbage: the dial raises ``Libp2pError``
    with the socket closed, as the JAX host's does."""

    async def main():
        async def garbage(reader, writer):
            writer.write(b"\xff" * 64)
            await writer.drain()
            writer.close()

        server = await asyncio.start_server(garbage, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        client = Libp2pHost()
        try:
            with pytest.raises(Libp2pError, match=f"dial 127.0.0.1:{port}"):
                await client.dial("127.0.0.1", port, timeout=10)
            assert not client.connections
        finally:
            await client.close()
            server.close()

    run(main())


def test_msg_id_formula():
    """The post-Altair id recomputed with hashlib, on both snappy domains."""
    payload = b"block-bytes-here"
    expect = hashlib.sha256(b"\x01\x00\x00\x00" + struct.pack("<Q", len(TOPIC))
                            + TOPIC.encode() + payload).digest()[:20]
    assert gs.eth2_msg_id(TOPIC, compress(payload)) == expect
    garbage = b"\xff\xfe\xfd not snappy"
    expect = hashlib.sha256(b"\x00\x00\x00\x00" + struct.pack("<Q", len(TOPIC))
                            + TOPIC.encode() + garbage).digest()[:20]
    assert gs.eth2_msg_id(TOPIC, garbage) == expect
