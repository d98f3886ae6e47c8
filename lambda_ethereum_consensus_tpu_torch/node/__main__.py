"""CLI entry: ``python -m lambda_ethereum_consensus_tpu_torch.node``.

Flags extend the reference's single ``--checkpoint-sync`` option
(ref: application.ex:12-14) with network/preset/db/api selection.

The port's copy of the JAX package's ``node/__main__.py``.  Two flags
differ: ``--wire`` defaults to ``bespoke`` (the port's only wire so far;
``libp2p`` makes the node's start raise), and ``--device`` picks the
node's device (default: the card, and the node raises where there is
none; ``cpu`` runs the plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import asyncio
import logging

from ..config import load_config_file, set_chain_spec
from .node import BeaconNode, NodeConfig


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="lambda-ethereum-consensus-tpu")
    p.add_argument("--network", default="mainnet", help="mainnet | minimal | path to config YAML")
    p.add_argument("--checkpoint-sync", default=None, metavar="URL",
                   help="trusted beacon API to fetch the finalized state from")
    p.add_argument("--db", default="beacon.wal", help="path to the chain database")
    p.add_argument("--listen", default="127.0.0.1:0", help="p2p listen address")
    p.add_argument("--bootnodes", default="", help="comma-separated host:port seed peers")
    p.add_argument("--api-port", type=int, default=4000, help="Beacon API port (ref default)")
    p.add_argument("--no-sync", action="store_true", help="disable range sync")
    p.add_argument("--wire", default="bespoke", choices=["libp2p", "bespoke"],
                   help="p2p wire mode (default bespoke: the framed-protobuf "
                        "transport; libp2p is not ported yet and raises)")
    p.add_argument("--attnets", default="0,1",
                   help="comma-separated attestation subnet ids to subscribe "
                        "(beacon_attestation_{i} topics)")
    p.add_argument("--device", default=None,
                   help="cuda (the default: the card) | cpu (plain PyTorch versions)")
    p.add_argument("--log-level", default="info")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(),
                        format="%(asctime)s [%(name)s] %(message)s")
    if args.network in ("mainnet", "minimal"):
        set_chain_spec(args.network)
    else:
        set_chain_spec(load_config_file(args.network))
    config = NodeConfig(
        db_path=args.db,
        listen_addr=args.listen,
        bootnodes=[b for b in args.bootnodes.split(",") if b],
        api_port=args.api_port,
        checkpoint_sync_url=args.checkpoint_sync,
        enable_range_sync=not args.no_sync,
        wire=None if args.wire == "bespoke" else args.wire,
        attnet_subnets=tuple(
            int(s) for s in args.attnets.split(",") if s.strip()
        ),
    )
    node = BeaconNode(config, device=args.device)

    async def run():
        await node.start()
        try:
            await asyncio.Event().wait()  # run forever
        finally:
            await node.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
