"""The port's Engine API client and checkpoint sync against the JAX package's.

``generate_token`` is held byte for byte against the JAX function at fixed
instants; both packages' ``EngineApiClient``s talk to one loopback fake
execution engine (the JAX ``tests/unit/test_api.py`` one, which also checks
each request's JWT signature) and must send the same JSON-RPC bodies and
give the same answers, errors and verdicts, also through the port's
``process_execution_payload``; ``execution_payload_to_json`` is compared
whole on a payload with transactions and withdrawals.  Checkpoint sync
fetches the finalized state from a port ``BeaconApiServer`` (``device=
"cpu"``) served over a real socket, through both packages' clients: the
same bytes as the state served.  Tolerance: none.
"""

import base64
import hashlib
import hmac
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest
import torch

from lambda_ethereum_consensus_tpu.api import checkpoint_sync as jsync
from lambda_ethereum_consensus_tpu.api import engine as jengine
from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.types import beacon as jtypes
from lambda_ethereum_consensus_tpu_torch import faults, types
from lambda_ethereum_consensus_tpu_torch.api import checkpoint_sync, engine
from lambda_ethereum_consensus_tpu_torch.api.harness import serving_fixture, serving_thread
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.crypto import bls
from lambda_ethereum_consensus_tpu_torch.state_transition import accessors, misc, operations
from lambda_ethereum_consensus_tpu_torch.state_transition.errors import OperationError
from lambda_ethereum_consensus_tpu_torch.state_transition.genesis import build_genesis_state
from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut

SECRET = "aa" * 32
# block numbers the fake engine answers INVALID for
_INVALID = 13


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


@pytest.mark.parametrize("now", [0, 1, 1_700_000_000, 2**31 + 7])
@pytest.mark.parametrize("secret", [SECRET, "0x" + "5c" * 32, "01" * 16])
def test_generate_token_equal(now, secret):
    token = engine.generate_token(secret, now=now)
    assert token == jengine.generate_token(secret, now=now)
    header, claims, sig = token.split(".")
    assert json.loads(_unb64(claims)) == {"iat": now}
    want = hmac.new(bytes.fromhex(secret.removeprefix("0x")), f"{header}.{claims}".encode(),
                    hashlib.sha256).digest()
    assert _unb64(sig) == want


class _FakeEngine(BaseHTTPRequestHandler):
    """A JSON-RPC execution engine on loopback: records each request with
    whether its bearer token is an HS256 JWT under SECRET equal to
    ``generate_token(SECRET, iat)``."""

    requests: list = []

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        auth = self.headers.get("Authorization", "")
        jwt_ok = None
        if auth:
            token = auth.removeprefix("Bearer ")
            iat = json.loads(_unb64(token.split(".")[1]))["iat"]
            jwt_ok = token == jengine.generate_token(SECRET, now=iat)
        type(self).requests.append((body, jwt_ok))
        if body["method"] == "engine_exchangeCapabilities":
            result = {"result": ["engine_newPayloadV2"], "id": body["id"]}
        elif body["method"] == "engine_newPayloadV2":
            number = int(body["params"][0]["blockNumber"], 16)
            status = "INVALID" if number == _INVALID else "VALID"
            result = {"result": {"status": status}, "id": body["id"]}
        else:
            result = {"error": {"code": -32601, "message": "unknown"}, "id": body["id"]}
        out = json.dumps(result).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


@pytest.fixture
def fake_engine():
    server = HTTPServer(("127.0.0.1", 0), _FakeEngine)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    _FakeEngine.requests = []
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()
    t.join()


def _payloads(spec_port, spec_jax, number: int = 7):
    """The same execution payload in both packages: every field set,
    two transactions and two withdrawals."""
    fields = dict(
        parent_hash=b"\x01" * 32, fee_recipient=b"\x02" * 20, state_root=b"\x03" * 32,
        receipts_root=b"\x04" * 32, logs_bloom=bytes(range(256)), prev_randao=b"\x05" * 32,
        block_number=number, gas_limit=30_000_000, gas_used=21_000, timestamp=1_700_000_012,
        extra_data=b"graffiti", base_fee_per_gas=2**70 + 3, block_hash=b"\x06" * 32,
        transactions=[b"\xf8\x01", b"\x02" * 40])
    withdrawals = [(0, 5, b"\x07" * 20, 32_000_000_000), (1, 9, b"\x08" * 20, 1)]
    with use_chain_spec(spec_port):
        port = types.ExecutionPayload(**fields, withdrawals=[
            types.Withdrawal(index=i, validator_index=v, address=a, amount=m)
            for i, v, a, m in withdrawals])
    with jax_use_chain_spec(spec_jax):
        jax = jtypes.ExecutionPayload(**fields, withdrawals=[
            jtypes.Withdrawal(index=i, validator_index=v, address=a, amount=m)
            for i, v, a, m in withdrawals])
    return port, jax


def test_execution_payload_to_json_equal():
    port, jax = _payloads(minimal_spec(), jax_minimal_spec())
    got = engine.execution_payload_to_json(port)
    assert got == jengine.execution_payload_to_json(jax)
    assert got["blockNumber"] == "0x7" and len(got["withdrawals"]) == 2


def _drive(mod, endpoint, payload):
    """One client's calls; returns (answers, the requests it sent)."""
    start = len(_FakeEngine.requests)
    client = mod.EngineApiClient(endpoint=endpoint, jwt_secret_hex=SECRET)
    answers = [client.exchange_capabilities(["engine_newPayloadV2"]),
               client.new_payload(mod.execution_payload_to_json(payload)),
               client.verify_and_notify(payload)]
    with pytest.raises(mod.EngineApiError, match="engine error") as err:
        client.forkchoice_updated({"headBlockHash": "0x" + "00" * 32})
    answers.append(str(err.value))
    anonymous = mod.EngineApiClient(endpoint=endpoint)
    answers.append(anonymous.exchange_capabilities([]))
    return answers, _FakeEngine.requests[start:]


def test_engine_client_against_a_fake_engine(fake_engine):
    port_payload, jax_payload = _payloads(minimal_spec(), jax_minimal_spec())
    got, sent = _drive(engine, fake_engine, port_payload)
    want, want_sent = _drive(jengine, fake_engine, jax_payload)
    assert got == want
    assert got[0] == ["engine_newPayloadV2"] and got[1] == {"status": "VALID"} and got[2] is True
    assert sent == want_sent
    # every call with a secret carried a valid JWT; the anonymous one none
    assert [ok for _, ok in sent] == [True, True, True, True, None]
    assert [body["id"] for body, _ in sent] == [1, 2, 3, 4, 1]
    assert engine.OptimisticEngine().verify_and_notify(port_payload) is True


def test_engine_errors(fake_engine):
    """An error answer and an unreachable endpoint raise EngineApiError
    (a WireError: never read as a device fault); verify_and_notify answers
    False for an INVALID payload and for an unreachable engine."""
    port_payload, jax_payload = _payloads(minimal_spec(), jax_minimal_spec(), number=_INVALID)
    for mod, payload in ((engine, port_payload), (jengine, jax_payload)):
        assert mod.EngineApiClient(endpoint=fake_engine).verify_and_notify(payload) is False
        down = mod.EngineApiClient(endpoint="http://127.0.0.1:1", timeout=0.5)
        with pytest.raises(mod.EngineApiError, match="engine rpc failed"):
            down.exchange_capabilities([])
        assert down.verify_and_notify(payload) is False
    err = engine.EngineApiError("x")
    assert isinstance(err, RuntimeError) and not faults.is_device_fault(err)


def test_engine_is_the_transitions_execution_hook(fake_engine):
    """``process_execution_payload`` asks the client's verify_and_notify:
    VALID applies the payload header, INVALID raises."""
    with use_chain_spec(minimal_spec()) as spec:
        genesis = build_genesis_state(
            [bls.sk_to_pk((i + 1).to_bytes(32, "big")) for i in range(8)], spec=spec)
        client = engine.EngineApiClient(endpoint=fake_engine, jwt_secret_hex=SECRET)
        for number in (7, _INVALID):
            state = BeaconStateMut(genesis)
            payload = types.ExecutionPayload(
                parent_hash=bytes(state.latest_execution_payload_header.block_hash),
                prev_randao=accessors.get_randao_mix(state, 0, spec),
                timestamp=misc.compute_timestamp_at_slot(state, state.slot, spec),
                block_number=number, block_hash=b"\x09" * 32)
            body = types.BeaconBlockBody(execution_payload=payload)
            if number == _INVALID:
                with pytest.raises(OperationError, match="execution engine rejected"):
                    operations.process_execution_payload(state, body, client, spec)
            else:
                operations.process_execution_payload(state, body, client, spec)
                assert bytes(state.latest_execution_payload_header.block_hash) == b"\x09" * 32
    methods = [body["method"] for body, _ in _FakeEngine.requests]
    assert methods == ["engine_newPayloadV2"] * 2


# --------------------------------------------------------- checkpoint sync


def test_fetch_finalized_state_from_a_port_server():
    with serving_fixture(device="cpu") as (api, store, spec, _head):
        served = store.block_states[bytes(store.finalized_checkpoint.root)]
        with serving_thread(api) as base:
            got = checkpoint_sync.fetch_finalized_state(base + "/", spec=spec)
            with jax_use_chain_spec(jax_minimal_spec()) as jspec:
                jax_state = jsync.fetch_finalized_state(base, spec=jspec)
                jax_bytes = jax_state.encode(jspec)
        assert got.encode(spec) == served.encode(spec) == jax_bytes
        assert got.hash_tree_root(spec) == served.hash_tree_root(spec)


def test_checkpoint_sync_errors():
    with pytest.raises(checkpoint_sync.CheckpointSyncError, match="checkpoint fetch failed"):
        checkpoint_sync.fetch_finalized_state("http://127.0.0.1:1", timeout=0.5)
    with pytest.raises(jsync.CheckpointSyncError, match="checkpoint fetch failed"):
        jsync.fetch_finalized_state("http://127.0.0.1:1", timeout=0.5)
    err = checkpoint_sync.CheckpointSyncError("x")
    assert isinstance(err, RuntimeError) and not faults.is_device_fault(err)


def test_checkpoint_sync_refuses_bytes_that_are_no_state():
    """A server answering with bytes that do not decode as a BeaconState."""

    class _Junk(BaseHTTPRequestHandler):
        def do_GET(self):
            out = b"\x01\x02\x03"
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    server = HTTPServer(("127.0.0.1", 0), _Junk)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        with use_chain_spec(minimal_spec()) as spec:
            with pytest.raises(checkpoint_sync.CheckpointSyncError, match="invalid checkpoint"):
                checkpoint_sync.fetch_finalized_state(base, spec=spec)
        with jax_use_chain_spec(jax_minimal_spec()) as jspec:
            with pytest.raises(jsync.CheckpointSyncError, match="invalid checkpoint"):
                jsync.fetch_finalized_state(base, spec=jspec)
    finally:
        server.shutdown()
        server.server_close()
        t.join()


def test_sync_from_checkpoint_runs_off_the_loop():
    import asyncio

    with serving_fixture(device="cpu") as (api, store, spec, _head):
        served = store.block_states[bytes(store.finalized_checkpoint.root)]
        with serving_thread(api) as base:
            got = asyncio.run(checkpoint_sync.sync_from_checkpoint(base, spec))
        assert got.encode(spec) == served.encode(spec)
