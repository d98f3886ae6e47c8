"""multistream-select 1.0 — libp2p protocol negotiation.

Wire format (multistream-select spec; what go-libp2p runs before every
security/muxer/stream protocol — ref: reqresp.go:32-41 relies on it via
libp2p.New): each message is

    varint(len(line)) || line

where ``line`` is the protocol path terminated by ``\\n``.  A session
opens with both sides sending ``/multistream/1.0.0``; the dialer then
proposes protocols one at a time, the listener echoes the one it accepts
or answers ``na``.  ``ls`` asks for the supported list.

The functions operate over any (reader, writer) pair with
``readexactly``/``write``/``drain`` — raw TCP for the security protocol,
a noise channel for the muxer, an mplex stream for application protocols.

The port's copy of the JAX package's ``network/libp2p/multistream.py``; the
bytes it puts on the wire are the JAX module's.
"""

from __future__ import annotations

MULTISTREAM = "/multistream/1.0.0"
NA = "na"
LS = "ls"
MAX_LINE = 1024


class NegotiationError(Exception):
    pass


from . import varint


def encode_msg(proto: str) -> bytes:
    line = proto.encode() + b"\n"
    return varint.encode(len(line)) + line


async def read_msg(reader) -> str:
    try:
        length = await varint.read(reader, max_shift=31)
    except varint.VarintError as e:
        raise NegotiationError(str(e)) from None
    if length == 0 or length > MAX_LINE:
        raise NegotiationError(f"bad multistream message length {length}")
    line = await reader.readexactly(length)
    if not line.endswith(b"\n"):
        raise NegotiationError("multistream message not newline-terminated")
    return line[:-1].decode()


async def _send(writer, proto: str) -> None:
    writer.write(encode_msg(proto))
    await writer.drain()


async def select(reader, writer, protocols: list[str]) -> str:
    """Dialer side: negotiate the first mutually-supported protocol."""
    await _send(writer, MULTISTREAM)
    if await read_msg(reader) != MULTISTREAM:
        raise NegotiationError("peer is not multistream/1.0.0")
    for proto in protocols:
        await _send(writer, proto)
        answer = await read_msg(reader)
        if answer == proto:
            return proto
        if answer != NA:
            raise NegotiationError(f"unexpected answer {answer!r} to {proto!r}")
    raise NegotiationError(f"peer supports none of {protocols}")


async def handle(reader, writer, supported: list[str]) -> str:
    """Listener side: answer proposals until one matches ``supported``."""
    await _send(writer, MULTISTREAM)
    if await read_msg(reader) != MULTISTREAM:
        raise NegotiationError("peer is not multistream/1.0.0")
    while True:
        proposal = await read_msg(reader)
        if proposal == LS:
            # one message per protocol (the dialer-visible subset)
            for proto in supported:
                await _send(writer, proto)
            continue
        if proposal in supported:
            await _send(writer, proposal)
            return proposal
        await _send(writer, NA)
