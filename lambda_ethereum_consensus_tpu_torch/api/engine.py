"""Engine API JSON-RPC client (ref: lib/.../engine/{rpc.ex,jwt.ex,execution.ex}).

Each call mints a fresh HS256 JWT with an ``iat`` claim from the hex-encoded
shared secret (ref: jwt.ex:20); requests are JSON-RPC 2.0 POSTs.  Beyond the
reference's single implemented method (``engine_exchangeCapabilities``,
execution.ex:18) this client also exposes ``engine_newPayloadV2`` and
``engine_forkchoiceUpdatedV2``, and doubles as the ``execution_engine``
object the state transition accepts (``verify_and_notify``).

The port's copy of the JAX package's ``api/engine.py``.  Its one change:
:class:`EngineApiError` derives from :class:`~..faults.WireError` (still a
``RuntimeError``, as in the JAX package), so the port's device-fault rule
(:func:`~..faults.is_device_fault`) never reads an unreachable execution
engine as a fault of the card.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.error
import urllib.request

from ..faults import WireError


class EngineApiError(WireError):
    """An Engine API call that failed: transport, JSON or an error answer."""


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def generate_token(jwt_secret_hex: str, now: int | None = None) -> str:
    """HS256 JWT with an iat claim (ref: engine/jwt.ex:20)."""
    secret = bytes.fromhex(jwt_secret_hex.removeprefix("0x"))
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    claims = _b64url(
        json.dumps({"iat": int(now if now is not None else time.time())}).encode()
    )
    signing_input = header + b"." + claims
    sig = _b64url(hmac.new(secret, signing_input, hashlib.sha256).digest())
    return (signing_input + b"." + sig).decode()


class EngineApiClient:
    def __init__(
        self,
        endpoint: str = "http://0.0.0.0:8551",
        jwt_secret_hex: str = "",
        timeout: float = 10.0,
    ):
        self.endpoint = endpoint
        self.jwt_secret_hex = jwt_secret_hex
        self.timeout = timeout
        self._id = 0

    def rpc_call(self, method: str, params: list) -> object:
        """JSON-RPC 2.0 POST with a fresh JWT (ref: engine/rpc.ex:14-40)."""
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "method": method, "params": params, "id": self._id}
        ).encode()
        headers = {"Content-Type": "application/json"}
        if self.jwt_secret_hex:
            headers["Authorization"] = f"Bearer {generate_token(self.jwt_secret_hex)}"
        req = urllib.request.Request(self.endpoint, data=body, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = json.loads(resp.read())
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
            raise EngineApiError(f"engine rpc failed: {e}") from None
        if "error" in payload and payload["error"]:
            raise EngineApiError(f"engine error: {payload['error']}")
        return payload.get("result")

    # ------------------------------------------------------------- methods

    def exchange_capabilities(self, capabilities: list[str]) -> object:
        return self.rpc_call("engine_exchangeCapabilities", [capabilities])

    def new_payload(self, payload_json: dict) -> object:
        return self.rpc_call("engine_newPayloadV2", [payload_json])

    def forkchoice_updated(self, forkchoice_state: dict, payload_attributes=None):
        return self.rpc_call(
            "engine_forkchoiceUpdatedV2", [forkchoice_state, payload_attributes]
        )

    # -------------------------------------- state-transition engine adapter

    def verify_and_notify(self, payload) -> bool:
        """``execution_engine`` hook for process_execution_payload."""
        try:
            result = self.new_payload(execution_payload_to_json(payload))
        except EngineApiError:
            return False
        status = (result or {}).get("status") if isinstance(result, dict) else None
        return status in ("VALID", "SYNCING", "ACCEPTED")


class OptimisticEngine:
    """Accept-everything engine (the reference runs with the EL disabled)."""

    def verify_and_notify(self, payload) -> bool:
        return True


def execution_payload_to_json(payload) -> dict:
    return {
        "parentHash": "0x" + bytes(payload.parent_hash).hex(),
        "feeRecipient": "0x" + bytes(payload.fee_recipient).hex(),
        "stateRoot": "0x" + bytes(payload.state_root).hex(),
        "receiptsRoot": "0x" + bytes(payload.receipts_root).hex(),
        "logsBloom": "0x" + bytes(payload.logs_bloom).hex(),
        "prevRandao": "0x" + bytes(payload.prev_randao).hex(),
        "blockNumber": hex(payload.block_number),
        "gasLimit": hex(payload.gas_limit),
        "gasUsed": hex(payload.gas_used),
        "timestamp": hex(payload.timestamp),
        "extraData": "0x" + bytes(payload.extra_data).hex(),
        "baseFeePerGas": hex(payload.base_fee_per_gas),
        "blockHash": "0x" + bytes(payload.block_hash).hex(),
        "transactions": ["0x" + bytes(tx).hex() for tx in payload.transactions],
        "withdrawals": [
            {
                "index": hex(w.index),
                "validatorIndex": hex(w.validator_index),
                "address": "0x" + bytes(w.address).hex(),
                "amount": hex(w.amount),
            }
            for w in payload.withdrawals
        ],
    }
