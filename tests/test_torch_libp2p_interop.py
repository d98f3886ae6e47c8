"""A port ``Libp2pHost`` and a JAX ``Libp2pHost`` in one event loop.

Each direction of dial: the two hosts upgrade one TCP connection
(multistream, noise with identity payloads) and agree on yamux, or on mplex
when the dialer offers only mplex; a req/resp stream each way returns the
bytes the handler wrote.  Gossip each way: both routers subscribe and graft
each other, a publish reaches the other package's validator with the same
eth2 message id, and a REJECT costs the publisher REJECT_PENALTY in the
receiver's score without entering its message cache.  Every wait polls a
condition with a bound.  Tolerance: none.
"""

import asyncio
import time

import pytest

pytest.importorskip(
    "cryptography",
    reason="libp2p identity/noise needs the optional 'cryptography' module",
)

from lambda_ethereum_consensus_tpu.network.libp2p import gossipsub as jgs
from lambda_ethereum_consensus_tpu.network.libp2p import host as jhost
from lambda_ethereum_consensus_tpu_torch.compression import compress
from lambda_ethereum_consensus_tpu_torch.network.libp2p import gossipsub as gs
from lambda_ethereum_consensus_tpu_torch.network.libp2p import host as host_mod
from lambda_ethereum_consensus_tpu_torch.network.libp2p import varint

TOPIC = "/eth2/bba4da96/beacon_aggregate_and_proof/ssz_snappy"
ECHO = "/eth2/beacon_chain/req/ping/1/ssz_snappy"

PACKAGES = {"port": (host_mod, gs), "jax": (jhost, jgs)}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


async def until(cond, limit_s: float = 10.0) -> None:
    t_end = time.monotonic() + limit_s
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"condition not met within {limit_s} s")
        await asyncio.sleep(0.005)


async def _echo(stream, protocol, peer_id):
    body = await stream.read_all()
    stream.write(b"echo:" + body + b":" + peer_id.bytes)
    await stream.close_write()


async def _connected(dialer_pkg: str, routers: list | None = None):
    """(dialer host, listener host), the dialer of package ``dialer_pkg``,
    each serving ECHO, the listener having registered the dialer.  With
    ``routers``, each host gets its package's ``Gossipsub`` before the dial
    (appended: the dialer's, then the listener's)."""
    listener_pkg = "jax" if dialer_pkg == "port" else "port"
    dialer = PACKAGES[dialer_pkg][0].Libp2pHost()
    listener = PACKAGES[listener_pkg][0].Libp2pHost()
    for h in (dialer, listener):
        h.set_stream_handler(ECHO, _echo)
    if routers is not None:
        routers.append(PACKAGES[dialer_pkg][1].Gossipsub(dialer))
        routers.append(PACKAGES[listener_pkg][1].Gossipsub(listener))
    host, port = await listener.listen()
    peer = await dialer.dial(host, port)
    assert peer.bytes == listener.peer_id.bytes  # proven by the noise payload
    await until(lambda: any(p.bytes == dialer.peer_id.bytes for p in listener.connections))
    return dialer, listener


def _peer_in(host, other):
    return next(p for p in host.connections if p.bytes == other.peer_id.bytes)


async def _exchange(dialer, listener) -> tuple:
    """A request each way over the one connection."""
    there = await dialer.request(_peer_in(dialer, listener), ECHO, b"from the dialer", 10)
    back = await listener.request(_peer_in(listener, dialer), ECHO, b"from the listener", 10)
    return there, back


@pytest.mark.parametrize("dialer_pkg", ["port", "jax"], ids=["port_dials", "jax_dials"])
def test_hosts_agree_on_yamux_and_serve_each_other(dialer_pkg):
    async def main():
        dialer, listener = await _connected(dialer_pkg)
        try:
            kinds = (type(_conn(dialer, listener).muxer).__name__,
                     type(_conn(listener, dialer).muxer).__name__)
            there, back = await _exchange(dialer, listener)
            identify = await dialer.request(_peer_in(dialer, listener),
                                            host_mod.IDENTIFY_PROTOCOL, b"", 10)
            return kinds, there, back, identify, listener._identify_message(), dialer, listener
        finally:
            await dialer.close()
            await listener.close()

    kinds, there, back, identify, want_identify, dialer, listener = run(main())
    assert kinds == ("Yamux", "Yamux")
    assert there == b"echo:from the dialer:" + dialer.peer_id.bytes
    assert back == b"echo:from the listener:" + listener.peer_id.bytes
    assert identify == varint.encode(len(want_identify)) + want_identify


def _conn(host, other):
    return host.connections[_peer_in(host, other)]


@pytest.mark.parametrize("dialer_pkg", ["port", "jax"], ids=["port_dials", "jax_dials"])
def test_mplex_only_dialer_falls_back_to_mplex(dialer_pkg, monkeypatch):
    """The dialer offers only /mplex/6.7.0; the listener, which prefers
    yamux, answers it, and both ends run mplex."""
    module = PACKAGES[dialer_pkg][0]
    orig_select = module.ms_select

    async def select_restricted(reader, writer, protocols):
        if protocols == module.MUXER_PROTOCOLS:
            protocols = [module.MPLEX_PROTOCOL]
        return await orig_select(reader, writer, protocols)

    monkeypatch.setattr(module, "ms_select", select_restricted)

    async def main():
        dialer, listener = await _connected(dialer_pkg)
        try:
            kinds = (type(_conn(dialer, listener).muxer).__name__,
                     type(_conn(listener, dialer).muxer).__name__)
            return kinds, await _exchange(dialer, listener), dialer, listener
        finally:
            await dialer.close()
            await listener.close()

    kinds, (there, back), dialer, listener = run(main())
    assert kinds == ("Mplex", "Mplex")
    assert there == b"echo:from the dialer:" + dialer.peer_id.bytes
    assert back == b"echo:from the listener:" + listener.peer_id.bytes


@pytest.mark.parametrize("publisher_pkg", ["port", "jax"], ids=["port_publishes",
                                                                "jax_publishes"])
def test_gossip_between_packages_with_verdicts(publisher_pkg):
    async def main():
        routers: list = []
        pub_host, sub_host = await _connected(publisher_pkg, routers)
        pub, sub = routers
        got = []
        verdict = {"next": gs.ACCEPT}

        async def validator(topic, data, msg_id, peer_id):
            got.append((topic, data, msg_id, peer_id.bytes))
            return verdict["next"]

        sub.validator = validator
        pub_peer, sub_peer = _peer_in(sub_host, pub_host), _peer_in(pub_host, sub_host)
        try:
            await pub.subscribe(TOPIC)
            await sub.subscribe(TOPIC)
            await until(lambda: TOPIC in pub.peers[sub_peer].topics
                        and TOPIC in sub.peers[pub_peer].topics)
            await pub._maintain(TOPIC)
            await sub._maintain(TOPIC)
            await until(lambda: sub_peer in pub.mesh[TOPIC] and pub_peer in sub.mesh[TOPIC])
            good, bad = compress(b"an aggregate" * 20), compress(b"a forged aggregate")
            good_id = await pub.publish(TOPIC, good)
            await until(lambda: len(got) == 1 and good_id in sub.mcache)
            score_after_accept = sub.peers[pub_peer].score
            verdict["next"] = gs.REJECT
            bad_id = await pub.publish(TOPIC, bad)
            await until(lambda: len(got) == 2 and sub.peers[pub_peer].score < 0)
            return (got, good, good_id, bad, bad_id, score_after_accept,
                    sub.peers[pub_peer].score, bad_id in sub.mcache, bad_id in sub.seen,
                    pub_host.peer_id.bytes)
        finally:
            await pub_host.close()
            await sub_host.close()

    (got, good, good_id, bad, bad_id, accepted, rejected, cached, seen,
     publisher) = run(main())
    assert good_id == gs.eth2_msg_id(TOPIC, good) == jgs.eth2_msg_id(TOPIC, good)
    assert bad_id == gs.eth2_msg_id(TOPIC, bad) == jgs.eth2_msg_id(TOPIC, bad)
    assert got == [(TOPIC, good, good_id, publisher), (TOPIC, bad, bad_id, publisher)]
    assert accepted == gs.ACCEPT_REWARD
    assert rejected == pytest.approx(gs.ACCEPT_REWARD - gs.REJECT_PENALTY)
    assert seen and not cached
