"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any mismatch or exception ends the run with a nonzero exit):

1. the card's name and power limit, and the kernels built from ``csrc/``
   (one ``nvcc`` per source, all started together) beside the native host
   library (``g++`` of ``native/bls381/bls381.cpp`` into ``_build/``, then
   its self-check against the pure-Python path);
2. every kernel against its plain PyTorch version on the card, bit for bit,
   at the main paths' shapes (SHA-256 nodes, and the three field kernels at
   1, 7, 33, 1024, 4072, 20360 and 1,048,576 lanes and on both sides of
   ``mul_mod``'s group threshold, with the edge values 0, 1 and p-1 and a
   broadcast (32, 1) operand), plus a hashlib sample; kernels and plain
   versions timed with CUDA events;
3. the state-root leg: 65,536 seeded pubkeys derived on the card by
   ``batch_g1_mul``, then ``BeaconState.hash_tree_root`` of a mainnet-preset
   state with 1,000,000 seeded validators (validator i holding the i mod
   16,384-th key) through
   ``install_device_backend()``, cold and warm, each equal to the hashlib
   root, with the SHA-256 launch count read around each root, one warm root
   more with the telemetry registry off and one with it on (for phase 3f),
   and the node count of every launch of a further root recorded;
3b. the state transition at that state (``build_state`` seeds the work of
   an epoch boundary: participation, inactivity scores, slashings, an
   activation queue, exits): real keys for the sync committee and for 8
   committees (derived on the card); ``process_slots`` from two slots before
   the boundary to two after it, with every root through the incremental
   engine and the device backend and the boundary on the resident plane,
   then the same walk on the host path (hashlib, host epoch), every slot's
   root equal; a block for the next slot minted by ``duties`` with a live
   sync aggregate and the 8 committees' aggregate attestations, imported
   with ``validate_result=True`` and its signature set on the device chain
   (the set gate at 0; SHA-256 and field launches counted, then profiled),
   a copy with one attestation signature swapped rejected, and the block
   imported again on its default route (field launches as the constants
   pick);
   then the engine's full-field rebuild at 2^8 to 2^20 chunks through
   hashlib and through the device backend;
3c. the node's slot through the port's fork choice at that registry:
   native ``g1_decompress_batch`` of the 65,536 distinct keys timed (== the
   card's points); a store anchored at the epoch-start state
   (``process_slots`` across the boundary, ``get_forkchoice_store``); the
   registry planes built cold (decompression, packing, upload timed apart);
   a mainnet-shaped block (the 64 committees of each of the two slots
   before it, 90-100 % participation, ~59,000 members, a live sync
   aggregate) imported with ``on_block`` through the committee-cache
   branch (profiled, SHA-256 and field launches counted), its post-state
   rooted again through hashlib, a copy with one signature swapped
   rejected; ``on_attestation_batch`` of one aggregate per committee from
   the block's slot to the epoch's end (1,856, one at 50 % over ``mmax``),
   cold, warm and profiled on the cached body with its sparse entries on
   the device chain (the set gate at 0), every verdict None, the latest
   messages exactly the participants' votes and ``get_head`` the block; a
   second drain of 128 fresh aggregates blaming exactly its forged one
   (``reject=True``) on the cached body, its default route; 64 aggregates
   against the host oracle (native ``rlc_verify``); the aggregates over
   ``mmax`` counted through the block's and the cold drain's host-sum
   routes, the drain's checked again alone on the device chain and on their
   default route;
3d. the stateless witness plane at phase 3b's walk-end state: a
   ``WitnessService`` whose own engine roots the state cold on the device
   backend (== phase 3b's root), 2,048 seeded requests (1,024 x 1, 768 x 4
   and 256 x 16 indices over balances, validators, inactivity scores and
   both participation columns) proved, a repeat answered from its proof
   cache; ``verify_batch`` of the 2,048 on the card cold, warm and profiled
   (one plane, SHA-256 launches == its rounds, every verdict True and ==
   the host plane, a 64-proof sample == ``verify_host``, host seconds
   split into planning, assembly and plane), of 4,096 (two planes), of the
   six adversaries each in a batch of 64 (== ``verify_host``), of a
   4-proof request (the oracle route, no launch), and 32 threads x 8
   requests through the ``VerifyCoalescer`` with one proof corrupted (==
   the oracle, flushes by trigger); the vector commitment: ``generators(256)`` timed, a
   width-256 commitment and its opening at 16 indices on the card (== the
   host Jacobian sums), and a fold of 64 openings made on the host,
   verified on the card as one MSM of at most 384 lanes, True and, with
   one value tampered, False;
3e. the validator duty engine on phase 3c's store: a ``DutyScheduler`` on
   the card operating validators 0-16,383 and the proposers of the two slots
   after the head (validator v holding phase 3b's real key or the v mod
   16,384-th seeded one), against a ``SlotClock`` from the state's genesis
   time; ``duties_for_epoch`` timed; each slot's ``on_tick`` at its start
   (propose), 1/3 (attest) and 2/3 (aggregate), each produced block imported
   with ``on_block`` and the head, the second carrying the first slot's
   published aggregates; seconds per phase split into hash, ladder or
   native, pool, proposal (``process_slots``, build, root) and import; each
   phase's completion offset and deadline misses read from the port's
   registry (printed, not failed); field and SHA-256 launches per phase (none
   of the field kernels for a flush under ``DUTY_SIGN_MIN``, the SHA-256
   kernel for each proposal); then the first slot's flushes signed again on
   the ladder (``DUTY_SIGN_MIN`` at 0, all three field kernels), byte for
   byte the walk's, 64 of all the walk's signatures ``api.sign``;
3f. the node's observability on the same store: a ``ConsensusForensics``
   plane attached, a forced cold ``get_head`` landing exactly one audit (a
   memo hit none), a depth-0 reorg record from phase 3c's head to phase
   3e's, a finality sample with the three participation flags; the first
   1,024 aggregates of phase 3c's drain re-submitted with one item trace
   each on the cached body (every field kernel launched): one
   ``attestation_batch_verify`` span of 1,024 members (128 listed) in the
   flight recorder, every member's ``verify`` event carrying its batch id
   and an ``apply``, the forensics weight event carrying the same id, the
   registry's admission->apply histogram 1,024 higher and its error count
   unchanged, the Chrome export written to ``chiprun_out/trace_node.json``;
   16 of them with one item's aggregation bits raising ``TypeError``: that
   item's contained ignore verdict, the rest None, the error count 1
   higher; then the warm drain of 1,024 with the registry, recorder and
   plane on (traces minted) and off, and phase 3's warm state root timed
   there in each polarity, printed beside the card's name and power limit;
3g. the node's ingest path below the wire, after phase 8 on the same store:
   an ``IngestScheduler`` with the node's lane table and three sources
   after the node's bodies (blocks, blob sidecars, aggregates), a
   ``DataAvailability`` gate, and a ``PendingBlocks`` scan on the card
   writing to a ``BlockStore`` and a ``StateStore`` over a native
   ``KvStore`` in a temporary directory; two port sidecars on loopback
   (noise on) under phase 3c's fork digest, the receiver's
   ``TopicSubscription``s for ``beacon_block`` and
   ``beacon_aggregate_and_proof`` in the scheduler's block and aggregate
   lanes, the sender serving req/resp from the store; the block of the next
   slot on the head (signed by ``produce_block``) published over the wire,
   its expectation of phase 8's six commitments, the block parked by a
   scan, the six sidecars and three
   adversaries (a swapped proof REJECT after the fold fails, an
   unadvertised commitment REJECT by the pre-check, a duplicate IGNORE)
   in one blob flush folded on the card, the sixth honest sidecar
   ``"complete"``, a second scan applying the block with ``on_block`` and
   storing the block and its 1,000,000-validator post-state; ``barrier``,
   close, reopen and ``get_latest_verified_state`` returning the block's
   root and a state whose root on the SHA-256 kernel equals the block's
   ``state_root`` and the store's; the stored block back by range and by root
   over req/resp (``BlockDownloader``), byte for byte; 1,024 of phase 3c's
   aggregates directly, then published over the wire as
   ``SignedAggregateAndProof``s and flushed by the aggregate lane as they
   arrive: every verdict sent to the sidecar equal to the direct drain's,
   none lost, each flush's field launches equal to a direct drain of its
   members; each step's seconds and launches, the sidecars' start, publish
   -> last verdict and the requests' round trips, the WAL bytes, flushes
   by cause, batch sizes and peak memory printed beside the card's name and
   power limit, with the ``protobuf`` and ``cryptography`` versions and
   whether ``yaml`` imports (``config.load_config_file`` then checked on a
   devnet overlay); then the libp2p leg on the same store and scheduler: a
   receiver and 8 sender ports on the libp2p wire (gossipsub's D), the
   receiver's ``beacon_aggregate_and_proof`` subscription in the aggregate
   lane, the muxer a port host negotiates with the receiver's sidecar
   (yamux), the stored block by range and by root from a sender, byte for
   byte, and the 64 aggregates of phase 3c's drain after its first 1,024,
   directly and then 8 from each sender, all published at once: every
   verdict the host sends the direct drain's, the verdicts the sidecar
   applied (read by an observer in its mesh, which gets only what the
   sidecar accepts) counted where they diverge, at least one flush on the
   device route, the first such flush and every host-route flush launching
   what a direct drain of its members launches; the start, connect and
   round-trip seconds, the flushes, each message's arrival -> verdict
   (p50, max, past the sidecar's 5 s validation timeout), each flush's
   verdict loop beside this process's event-loop stalls outside the drain
   bodies (the main thread's stack sampled in them), garbage collections
   and CPU seconds, and the leg's seconds (``ingest/libp2p`` in ``phase
   seconds``);
3h. the Beacon API on phase 3g's store (its head the block's
   1,000,000-validator post-state, its finalized checkpoint phase 3c's
   anchor, phase 3f's forensics plane attached): a ``BeaconApiServer`` on
   the card at 127.0.0.1:0, its loop in a thread of its own, asked by
   client threads over real sockets: health, identity, the block root by
   ``head``, root and slot (== ``get_head``), block v2 (``body_root`` ==
   the body's hashlib root); the head's state root (== its block's
   ``state_root``) and a repeat answered by the response cache with no
   launch; a witness proof for ``head`` in JSON (the witness engine roots
   the state cold on the card) and in SSZ, its root the block's
   ``state_root`` and ``verify_host`` True, both repeated as hits with no
   launch; phase 3d's verify mix (32 threads x 8 POSTs of 1-4 proofs
   anchored at ``head``, one proof corrupted, every verdict ==
   ``verify_host``, flushes by trigger) and one POST of 256 proofs (one
   plane); ``harness.run_mixed_traffic`` for 5 s (no non-200 answer, no
   invalid verdict); ``/metrics`` parsed (one TYPE line a family,
   ``api_request_seconds`` for every route hit), ``/debug/slo`` printed row
   by row (never failed on a budget), the forensics and trace routes
   parsed, ``/debug/compile`` and ``/debug/profile`` answering with their
   bodies, ``POST /debug/profile/capture`` without ``seconds`` 400;
   checkpoint sync of the finalized state
   (``fetch_finalized_state``: encode, transfer, decode timed apart and
   the bytes counted), rooted on the SHA-256 kernel == the finalized
   block's ``state_root``; each step's seconds and launches and the peak
   device memory printed beside the card's name and power limit;
3i. one ``BeaconNode`` booted on the card at phase 3g's store's finalized
   checkpoint (phase 3c's epoch-start state, slot f): a copy of the
   1,000,000-validator state re-based so the wall clock's slot is f+2,
   given an empty-body header at slot f and rooted on the SHA-256 kernel,
   the node's own default anchor block for it; the block of slot f+1
   signed by ``produce_block`` and 1,024 aggregates on it (the 64
   committees of slot f+1 x 16, their target the anchor) minted on the
   card; the node, its
   device left at its default, booted (anchor root, store write, store
   build, sidecar and API timed apart); a bare port ``Port`` with the node
   as its bootnode publishing the block (the node's block lane, a scan
   parks it behind phase 8's six commitments, registered on its DA gate),
   the six sidecars (its blob lane, one fold on the card; a scan applies
   the block with ``on_block`` on the card and ``_on_applied`` stores it
   with its post-state) and the aggregates (its aggregate lane, every
   verdict ACCEPT after a direct drain on the node's store built the epoch
   context, each flush's field launches == a direct drain of its members);
   ``GET /eth/v1/beacon/blocks/head/root`` from the node's API
   == the block's root, ``/debug/lanes`` and ``/debug/slot`` read;
   ``stop()`` raising nothing and putting the previous hash backend back;
   each step's seconds and launches printed beside the card's name and
   power limit; on the same node, the compile and profile plumbing: each
   kernel body's per-element operation constant (``ops/profile.py``) equal
   to its SASS count, the warmer started at the phase's drain shapes and
   joined after the boot (stats and ``warmup_phase_seconds``), the
   aggregate lane's first flush beside the next, a 2 s ``POST
   /debug/profile/capture`` during the aggregate lane read for device busy
   ms and idle share, and ``/debug/profile`` and ``/debug/compile`` after
   it: the four kernels' launches equal to the wrappers' counters, the
   device planes plus ``unattributed`` equal to the allocator's total,
   ``registry_planes`` non-zero;
4. the signature leg: the attestation drain of ``scripts/bench_chain.py``
   (2 x 127 messages x 16 aggregates = 4,064 aggregates) over a
   524,288-validator registry and its epoch committee cache, through
   ``batch_verify_each_cached``, cold and warm, every verdict equal to the
   construction, with the field kernels' launch counts read around each
   drain; the drain's first 1,024 with one aggregate signed by the wrong
   key, whose bisection must blame exactly that entry; two committees' device sums
   against the host sums of their members; and a small sub-drain against
   the host ``pairing_check`` oracle;
5. duty signing: 1,024 seeded keys signing 64 messages (16 signers each,
   one ``SIGN_CHUNK``) through ``sign_batch`` on the full 256-bit ladder
   (``DUTY_SIGN_MIN`` at 0), cold and warm, then hash, ladder and affine
   timed apart; every signature equal to the host route; then the flush on
   its default route, whose launches must be what ``DUTY_SIGN_MIN`` picks;
6. signature sets: ``verify_points`` over those 1,024 entries, ``batch_verify``
   over their bytes, bisection blame of one swapped signature through
   ``batch_verify_each_points``, a ``None`` point, one entry (a block's
   proposer signature) cold, warm and on the host, all on the device chain
   (the set gate at 0), and the 1,024 entries on the host tail (native
   ``rlc_verify``); then each of those calls once more on its default
   route, whose launches must be what ``DEVICE_CHAIN_MIN`` picks;
6b. the size routes, each route forced through its constant and timed warm
   (one run each), every route's verdicts equal, each row printed beside the
   card's name and power limit: a set through ``verify_points`` on the
   device chain and on the host tail at 32,768 down to 1 entries (tiled
   from phase 6's entries); ``on_attestation_batch`` of the first 4 to
   1,024 of phase 3c's drain, re-submitted to its store, through the cached
   and the host body (every verdict None, the latest messages unchanged),
   and the cached body cold at 64; ``_verify_deferred_attestations`` over
   the first 32 and 64 aggregates of phase 3c's block through its three
   routes; (d) the pairing tail: ``check_tail`` over 1 to 256 checks of two
   Miller outputs each (to 1,024 while the composed tail has won nowhere),
   every eighth check false, through the hybrid tail (native final
   exponentiation on the host) and the composed one (on the card), then
   phase 4's drain, phase 6's 1,024-entry set on the device chain and
   phase 3b's block import (its set on the device chain) each once on its
   default route and once on the composed tail, verdicts equal, the composed
   tail launching exactly ``bls_pairing.FINAL_EXP_LAUNCHES`` more field
   kernels; (e) the sign flush: ``sign_batch`` of 512 down to 1
   signatures (16 signers a message; 8 and 1 signers one message) on the
   card's ladder and on the host route (the native multiply per
   signature), every signature equal.  A route that loses along its sweep
   (the card on the set and the sign flush, the host on the drain and the
   block, the hybrid tail) stops once another route has been at least as
   fast at two sizes in a row, and the sweep ends with it (the sign
   flush's host route runs on to 1).  The crossovers are printed beside the
   constants;
7. batch scalar multiplication: the mainnet KZG dev setup (4,096 host scalar
   multiplications, timed), ``batch_g1_mul`` on its 4,096 points with 255-bit
   scalars, ``batch_g2_mul`` on 1,024 points with 64-bit scalars (``k = 0``
   lanes included, 32-lane samples against the host), and
   ``pairing_products_are_one`` on 4 checks x 8 pairs against the host
   ``pairing_check``, on its default tail and on the composed one;
8. blob KZG at mainnet width: six seeded blobs committed and proved on the
   card, each commitment equal to ``[sum_i blob_i L_i(tau)] G1`` and one to
   the per-term host MSM, the 6-blob fold ``True``, and with one proof swapped
   the fold ``False`` and ``verify_blob_proof`` blaming exactly that blob;
9. the field kernels at the lane counts the drain, a sign flush, a KZG
   MSM, the block import, the fork-choice drain, the mainnet block
   import, the vector-commitment fold, the ingest path of phase 3g and the
   node of phase 3i launch them with (launch-weighted median and 90th
   percentile): each
   against its plain version there, bit for bit, with a full and a
   broadcast (32, 1) right operand, then timed beside an empty kernel
   launched with the same grid (what a bare launch costs);
   ``mul_mod``'s two bodies, each held against the plain version and timed,
   from 4,072 lanes to 2^20, which sets ``MUL_GROUP_THRESHOLD``;
   ``sub_mod`` at 1, 2 and 4 threads per element in 64- and 128-thread
   blocks, each held and timed from 2,048 lanes to 2^20, which sets
   ``SUB_GROUP`` and its block size; and the SHA-256 kernel at the median
   and 90th-percentile node counts of a root's launches, of the witness
   plane's, of the ingest path's and of the node's, held against its plain
   version and
   timed beside a bare launch
   and its bound;
10. one JSON line of per-kernel numbers, then the device line last.

Every path of phases 3-8 is driven with the kernels' launch counts set to 0
just before it and read just after; a path that launched a kernel of its
own no time fails the run (the block imports of phases 3b and 3c need both
the SHA-256 kernel and the three field kernels; phase 3d's planes the
SHA-256 kernel, its vector commitment the three field kernels; phase 3e's
proposals the SHA-256 kernel, its re-signed flushes the three field
kernels; phase 3f's traced and malformed drains the three field kernels;
phase 3g's blob and aggregate flushes and its libp2p leg's aggregates the
three field kernels, its scan
and resume the SHA-256 kernel; phase 3h's state root, cold witness proof,
verify planes, mixed traffic and checkpoint sync's root the SHA-256
kernel, and its repeated GETs none; phase 3i's boot and block the SHA-256
kernel, its blob and aggregate lanes the three field kernels).  A call on
its default route through a size gate must launch every field kernel at or
above the gate's threshold and none below it.  Needs one card, ``nvcc``,
``cuobjdump`` and ``g++``; exits nonzero without a card.  Longer records
land in ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# the card's figures PERF.md's bounds divide by, written once in the port
from lambda_ethereum_consensus_tpu_torch.ops.profile import (
    DISPATCH_LANES_PER_SM,
    FMA_LANES_PER_SM,
    HBM_BYTES_PER_S,
    INT32_LANES_PER_SM,
    SMS,
)

ROOT = Path(__file__).resolve().parent
SEED = 20261016
N_VALIDATORS = 1_000_000
CHECK_SIZES = (1, 7, 255, 1000, 1 << 20)
TIMED_SIZES = (1 << 20, 8_000_000)
FQ_SIZES = (1, 7, 33, 1024, 4072, 20360, 1 << 20)  # the last is timed
# lane counts at which mul_mod's two bodies are timed against each other (both
# sides of MUL_GROUP_THRESHOLD, and 2^20)
MUL_SWEEP = (4072, 8192, 9216, 10240, 16384, 1 << 20)
# lane counts and (threads per element, threads per block) of sub_mod's sweep:
# the drain's p50 and p90, and 2^20
SUB_SWEEP = (4072, 16288, 1 << 20)
# profiled launches per window of phase 9's timings at the paths' shapes
TIMING_REPS = 100
SUB_BODIES = tuple((g, t) for g in (1, 2, 4) for t in (64, 128))
FQ_KERNELS = ("mul_mod", "add_mod", "sub_mod")
# the drain of scripts/bench_chain.py:60-67 (BASELINE.json "128 Attestations
# x 2048-validator committees"): 2 x 127 messages x 16 aggregates
N_COMMITTEES, COMMITTEE = 256, 2048
INSTANCES, GROUPS, AGGS = 2, 127, 16
# the tampered drain: the drain's first TAMPER_DRAIN aggregates, one signed by
# the wrong key
TAMPER_DRAIN = 1024
# the Pallas kernel bodies the field kernels replace
_REPLACES = {"mul_mod": "127", "add_mod": "108", "sub_mod": "116"}
# duty signing: one sign_batch dispatch, an operator's slot of
# MAX_COMMITTEES_PER_SLOT = 64 messages with 16 signers each
SIGNERS, DUTY_MESSAGES = 1024, 64
# batch scalar multiplication: a mainnet-width KZG MSM, and the G2 side of
# the RLC scaling (_scale_entries) at the signer count
G1_LANES, G2_LANES, MUL_SAMPLE = 4096, 1024, 32
PAIR_CHECKS, PAIRS_PER_CHECK = 4, 8
# blob KZG: FIELD_ELEMENTS_PER_BLOB and MAX_BLOBS_PER_BLOCK (mainnet, Deneb)
BLOB_WIDTH, N_BLOBS = 4096, 6
# the state transition's block: full-committee aggregates of the previous
# slot, 8 of the 64 committees (3,892 members at this 1,000,000-validator
# state, under operations.BLOCK_BATCH_MIN_MEMBERS, 4,096)
ATT_COMMITTEES = 8
# the node's slot (phase 3c): every validator keyed with one of REGISTRY_KEYS
# seeded keys (validator i holds key i mod REGISTRY_KEYS); native batch
# decompression timed on DISTINCT_KEYS distinct keys; a mainnet-shaped block
# (the committees of the BLOCK_SLOTS slots before it), then a gossip drain of
# DRAIN_COPIES aggregates per committee from the block's slot to the epoch's
# end, a second drain of SECOND_DRAIN fresh aggregates with one forged, and
# ORACLE_SAMPLE aggregates against the host oracle
REGISTRY_KEYS, DISTINCT_KEYS = 16_384, 65_536
BLOCK_SLOTS, DRAIN_COPIES, SECOND_DRAIN, ORACLE_SAMPLE = 2, 1, 128, 64
# the witness plane (phase 3d): (requests, indices each), every request over
# one of WITNESS_FIELDS — 2,048 proofs, one plane of 2,048 x 1,024 padded
# slots (2^21, the footprint guard); WITNESS_SAMPLE of them against the
# per-proof oracle; a coalescer of COALESCE_THREADS threads x
# COALESCE_REQUESTS requests of 1-4 proofs; a width-256 vector commitment
# opened at VC_OPENED indices and a fold of VC_FOLD openings of VC_FOLD_WIDTH
# indices each (one MSM of at most 2 x 16 + 256 = 288 lanes; its inputs,
# made on the host, take about a quarter of a second an opening)
WITNESS_SHAPES = ((1024, 1), (768, 4), (256, 16))
WITNESS_FIELDS = ("balances", "validators", "inactivity_scores",
                  "previous_epoch_participation", "current_epoch_participation")
WITNESS_SAMPLE, COALESCE_THREADS, COALESCE_REQUESTS = 64, 32, 8
VC_OPENED, VC_FOLD, VC_FOLD_WIDTH = 16, 16, 4
# the size routes (after phase 6): each route timed warm, the median of
# ROUTE_REPS runs, on sets of ROUTE_SET_SIZES entries tiled from phase 6's
# duty entries (swept from the largest down), on the first ROUTE_DRAIN_SIZES
# of phase 3c's drain (re-submitted; the cached body also cold at
# ROUTE_COLD_DRAIN) and on the first ROUTE_BLOCK_SIZES aggregates of phase
# 3c's block; a route that loses along its sweep (the card on the set, the
# host on the drain and the block) stops once another route has been at
# least as fast at ROUTE_STOP sizes in a row, and the sweep ends with it;
# the drain's and the block's sweeps span just the sizes that bracket their
# constants, to hold the smoke's time
ROUTE_SET_SIZES = (32768, 16384, 8192, 4096, 2048, 1024, 128, 16, 1)
ROUTE_DRAIN_SIZES = (4, 8, 16, 64, 128, 256, 512, 1024)
ROUTE_BLOCK_SIZES = (16, 32, 64)
ROUTE_REPS, ROUTE_COLD_DRAIN, ROUTE_STOP = 1, 64, 2
# the tail's three paths (part d) run once on each tail
TAIL_PATH_REPS = 1
# the pairing tail alone (size routes, part d): TAIL_SIZES checks of two
# Miller outputs each, every TAIL_FALSE-th check false, through both tails up
# to TAIL_SWEEP_END checks, and on to the last size while the composed tail
# has won nowhere
TAIL_SIZES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
TAIL_SWEEP_END, TAIL_FALSE = 256, 8
# a blaming drain (size routes, part d): the first BLAME_DRAIN aggregates of
# phase 4's drain with every BLAME_EVERY-th signature negated; its last
# bisection level checks each of the BLAME_DRAIN aggregates alone
BLAME_DRAIN, BLAME_EVERY = 128, 2
# the sign flush (size routes, part e): SIGN_SWEEP signatures, from the
# largest down, SIGN_PER_MESSAGE signers a message (fewer: one message), on
# the card's ladder and on the host route; the card stops once the host has
# been at least as fast at ROUTE_STOP sizes in a row
SIGN_SWEEP, SIGN_PER_MESSAGE = (2048, 1024, 512, 128, 32, 8, 1), 16
# the duty engine (phase 3e): a scheduler operating validators 0 ..
# DUTY_KEYS - 1 and the proposers of the DUTY_SLOTS slots after the head,
# the first RESIGN_SLOTS slots' flushes re-signed on the ladder (one slot of
# two, to hold the smoke's time) and RESIGN_SAMPLE signatures against
# api.sign
DUTY_KEYS, DUTY_SLOTS, RESIGN_SLOTS, RESIGN_SAMPLE = 16_384, 2, 1, 64
# the node's observability (phase 3f): the first OBS_DRAIN aggregates of phase
# 3c's drain re-submitted with an item trace each, OBS_CONTAIN of them with
# one malformed
OBS_DRAIN, OBS_CONTAIN = 1024, 16
# the node's ingest path (phase 3g): NodeConfig's lane deadlines (block, blob,
# attestation lanes, ms) and admission budget; INGEST_AGGREGATES of phase
# 3c's drain through the aggregate lane, published over the loopback sidecar
# pair WIRE_BURST at a time (concurrent publish commands, as a peer relays a
# backlog)
INGEST_BLOCK_MS, INGEST_BLOB_MS, INGEST_ATT_MS, INGEST_MAX_ITEMS = 25, 50, 150, 24576
INGEST_AGGREGATES = 1024
WIRE_BURST = 64
# phase 3g's libp2p leg: LIBP2P_PEERS sender ports (gossipsub's D) dialled
# into one receiver, each publishing LIBP2P_AGGREGATES / LIBP2P_PEERS of the
# LIBP2P_AGGREGATES aggregates of phase 3c's drain after its first
# INGEST_AGGREGATES, all at once
LIBP2P_PEERS, LIBP2P_AGGREGATES = 8, 64
# how long the leg's observer waits, after the last verdict, for the messages
# the receiver's sidecar accepted and forwards
OBSERVER_WAIT_S = 3.0
# the Beacon API (phase 3h): run_mixed_traffic's window, seconds (1 GET
# thread, 8 POST threads of 16 proofs: the harness's MIXED_* constants)
API_TRAFFIC_S = 5.0
# the node on the card (phase 3i): NODE_AGG_COPIES aggregates per committee of
# the new block's slot, each at 90-100 % participation; Deneb scheduled at
# mainnet's epoch (the presets leave it unscheduled)
NODE_AGG_COPIES = 16
MAINNET_DENEB_EPOCH = 269_568
# the node's profiler window during its aggregate lane, seconds
NODE_CAPTURE_S = 2.0
# the incremental engine's full-field rebuild, timed at 2^8 .. 2^20 chunks
# (on an H100 the device backend is faster from about 2^10 chunks up)
CROSSOVER_LOG2 = tuple(range(8, 21, 2))

# SASS opcodes that run only on the INT32 ALU pipe
_ALU_OPCODES = {
    "IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL", "SHR",
    "PRMT", "LEA", "ISETP", "SEL", "IMNMX", "BMSK", "IABS", "POPC", "FLO", "BREV",
}
# integer multiplies, which issue on the FMA pipe (64 lanes per SM per clock
# for 32-bit IMAD on compute capability 9.0)
_FMA_OPCODES = {"IMAD", "IMUL"}


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def _event_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@functools.cache
def _sass(lib: Path) -> str:
    """``cuobjdump -sass`` of one library, read once."""
    from lambda_ethereum_consensus_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc_path()).parent / "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout


def _sass_opcodes(lib: Path, kernel: str) -> Counter:
    """Opcode histogram of ``kernel``'s SASS (NOPs left out).  The kernel is
    straight-line code, so the static count is what one in-range thread
    executes."""
    sections = re.split(r"^\s*Function : ", _sass(lib), flags=re.M)
    body = next(s for s in sections[1:] if kernel in s.splitlines()[0])
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", body)
    return Counter(op for op in ops if op != "NOP")


def _fq_symbol(name: str, group: int) -> str:
    """Fragment of the SASS symbol of the body ``fq_<name>`` runs with
    ``group`` threads per element (sub's kernel is a template on it)."""
    if name == "sub_mod":
        return f"fq_sub_mod_kernelILi{group}E"
    if name == "mul_mod" and group > 1:
        return "fq_mul_mod_group_kernel"
    return f"fq_{name}_kernel"


def _op_ms(opcodes: Counter, n: int, clock_mhz: float) -> float:
    """Least time for ``n`` threads of straight-line code by instruction
    issue: the ALU-pipe instructions over 64 lanes per SM, the integer
    multiplies over 64 (the FMA pipe), all of them over 128."""
    alu = sum(c for op, c in opcodes.items() if op in _ALU_OPCODES)
    fma = sum(c for op, c in opcodes.items() if op in _FMA_OPCODES)
    lane_clocks = max(alu / INT32_LANES_PER_SM, fma / FMA_LANES_PER_SM,
                      sum(opcodes.values()) / DISPATCH_LANES_PER_SM)
    return lane_clocks * n / (SMS * clock_mhz * 1e6) * 1e3


def build_state(spec, n: int, seed: int, keys: list[bytes]):
    """A mainnet-preset BeaconState with ``n`` seeded validators, two slots
    before an epoch boundary at which every pass has work: ~95 % of the
    registry with previous-epoch flags, nonzero inactivity scores on a
    fifth, slashed validators inside the slashings window (half of them
    penalty targets at this boundary), an activation queue, new
    eligibility marks, exits at the next epoch and balances on both sides
    of the hysteresis thresholds.  Validator i's pubkey is the compressed
    key ``keys[i % len(keys)]``."""
    from lambda_ethereum_consensus_tpu_torch import ssz
    from lambda_ethereum_consensus_tpu_torch.config import constants
    from lambda_ethereum_consensus_tpu_torch.types import (
        BeaconBlockHeader, BeaconState, Checkpoint, Eth1Data, ExecutionPayloadHeader, Fork,
        HistoricalSummary, SyncCommittee, Validator,
    )

    rng = np.random.default_rng(seed)

    def rows(count: int, width: int) -> list[bytes]:
        raw = rng.integers(0, 256, (count, width), dtype=np.uint8).tobytes()
        return [raw[i * width:(i + 1) * width] for i in range(count)]

    far = np.uint64(constants.FAR_FUTURE_EPOCH)
    slot = 9_000_000 + spec.SLOTS_PER_EPOCH - 2
    epoch = slot // spec.SLOTS_PER_EPOCH
    inc = spec.EFFECTIVE_BALANCE_INCREMENT

    def epochs(values) -> np.ndarray:
        return np.asarray(values, dtype=np.uint64)

    pubkeys = [keys[i % len(keys)] for i in range(n)]
    creds = rows(n, 32)
    incr = np.where(rng.random(n) < 0.9, 32, rng.integers(17, 32, n))
    eligibility = epochs(rng.integers(0, 250_000, n))
    activation = eligibility + epochs(rng.integers(1, 5, n))
    exit_epoch = np.where(rng.random(n) < 0.01, eligibility + epochs(300_000), far)
    withdrawable = np.where(exit_epoch == far, far, exit_epoch + epochs(256))
    roll = rng.random(n)
    # exits at the next epoch: active now, not in the next epoch's committees
    leaving = roll < 0.0005
    exit_epoch = np.where(leaving, epochs(epoch + 1), exit_epoch)
    withdrawable = np.where(leaving, epochs(epoch + 257), withdrawable)
    # the activation queue (eligible at the finalized epoch) and fresh
    # deposits awaiting their eligibility mark
    queued = (roll >= 0.0005) & (roll < 0.0025)
    marked = (roll >= 0.0025) & (roll < 0.0026)
    eligibility = np.where(queued, epochs(epoch - 10), np.where(marked, far, eligibility))
    activation = np.where(queued | marked, far, activation)
    incr = np.where(marked, 32, incr)
    # slashed and exited, inside the slashings window; half are this
    # boundary's penalty targets
    slashed = (roll >= 0.0026) & (roll < 0.0036)
    exit_epoch = np.where(slashed, epochs(epoch - 100), exit_epoch)
    late = epochs((rng.random(n) < 0.5) * rng.integers(1, 100, n))
    withdrawable = np.where(
        slashed, epochs(epoch + spec.EPOCHS_PER_SLASHINGS_VECTOR // 2) + late, withdrawable)
    eligibility, activation, exit_epoch, withdrawable = (
        a.tolist() for a in (eligibility, activation, exit_epoch, withdrawable))
    effective = (incr * inc).tolist()
    validators = [
        Validator(
            pubkey=pubkeys[i],
            withdrawal_credentials=creds[i],
            effective_balance=effective[i],
            slashed=bool(slashed[i]),
            activation_eligibility_epoch=eligibility[i],
            activation_epoch=activation[i],
            exit_epoch=exit_epoch[i],
            withdrawable_epoch=withdrawable[i],
        )
        for i in range(n)
    ]
    # 1 % half an increment below their effective balance (hysteresis down)
    balances = incr * inc + np.where(rng.random(n) < 0.01, -inc // 2, rng.integers(0, 10**8, n))
    previous = np.where(rng.random(n) < 0.95, 7, rng.integers(0, 8, n))
    current = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 8, n))
    scores = np.where(rng.random(n) < 0.2, rng.integers(1, 64, n), 0)
    sync = SyncCommittee(
        pubkeys=[pubkeys[i] for i in rng.integers(0, n, spec.SYNC_COMMITTEE_SIZE)],
        aggregate_pubkey=rows(1, 48)[0],
    )
    return BeaconState(
        genesis_time=1606824023,
        genesis_validators_root=rows(1, 32)[0],
        slot=slot,
        fork=Fork(previous_version=spec.BELLATRIX_FORK_VERSION,
                  current_version=spec.CAPELLA_FORK_VERSION, epoch=spec.CAPELLA_FORK_EPOCH),
        latest_block_header=BeaconBlockHeader(slot=slot, proposer_index=17,
                                              parent_root=rows(1, 32)[0], body_root=rows(1, 32)[0]),
        block_roots=rows(spec.SLOTS_PER_HISTORICAL_ROOT, 32),
        state_roots=rows(spec.SLOTS_PER_HISTORICAL_ROOT, 32),
        historical_roots=rows(758, 32),
        eth1_data=Eth1Data(deposit_root=rows(1, 32)[0], deposit_count=n, block_hash=rows(1, 32)[0]),
        eth1_data_votes=[Eth1Data(deposit_root=r, deposit_count=n, block_hash=r)
                         for r in rows(100, 32)],
        eth1_deposit_index=n,
        validators=validators,
        balances=balances.tolist(),
        randao_mixes=rows(spec.EPOCHS_PER_HISTORICAL_VECTOR, 32),
        slashings=rng.integers(0, 10**10, spec.EPOCHS_PER_SLASHINGS_VECTOR).tolist(),
        previous_epoch_participation=previous.tolist(),
        current_epoch_participation=current.tolist(),
        justification_bits=ssz.BitvectorValue.from_bools([1, 1, 1, 0]),
        previous_justified_checkpoint=Checkpoint(epoch=epoch - 2, root=rows(1, 32)[0]),
        current_justified_checkpoint=Checkpoint(epoch=epoch - 1, root=rows(1, 32)[0]),
        finalized_checkpoint=Checkpoint(epoch=epoch - 2, root=rows(1, 32)[0]),
        inactivity_scores=scores.tolist(),
        current_sync_committee=sync,
        next_sync_committee=sync,
        latest_execution_payload_header=ExecutionPayloadHeader(
            parent_hash=rows(1, 32)[0], fee_recipient=rows(1, 20)[0], state_root=rows(1, 32)[0],
            receipts_root=rows(1, 32)[0], logs_bloom=rows(1, spec.BYTES_PER_LOGS_BLOOM)[0],
            prev_randao=rows(1, 32)[0], block_number=18_000_000, gas_limit=30_000_000,
            gas_used=12_345_678, timestamp=1_700_000_000, extra_data=b"chip-smoke",
            base_fee_per_gas=7 * 10**9, block_hash=rows(1, 32)[0],
            transactions_root=rows(1, 32)[0], withdrawals_root=rows(1, 32)[0],
        ),
        next_withdrawal_index=42_000_000,
        next_withdrawal_validator_index=123_456 % n,
        historical_summaries=[HistoricalSummary(block_summary_root=r, state_summary_root=r)
                              for r in rows(200, 32)],
    )


class _TimedBackend:
    """Wall time spent inside a backend's calls (copies, launches and the
    synchronising copy back), to split a root into host and device work."""

    def __init__(self, inner):
        self.inner = inner
        self.tree_threshold = getattr(inner, "tree_threshold", 1 << 62)
        self.seconds = 0.0

    def hash_level(self, blocks):
        t = time.perf_counter()
        try:
            return self.inner.hash_level(blocks)
        finally:
            self.seconds += time.perf_counter() - t

    def merkle_subtree_root(self, chunks):
        t = time.perf_counter()
        try:
            return self.inner.merkle_subtree_root(chunks)
        finally:
            self.seconds += time.perf_counter() - t


def _fq_operands(rng, n: int, dev, edges: list[int]):
    """(32, n) canonical limb planes: random values below 0x1A0 * 2^372 (< p)
    with ``edges`` written into the first columns."""
    import torch

    from lambda_ethereum_consensus_tpu_torch.ops import bigint as BI

    x = rng.integers(0, 1 << BI.LIMB_BITS, (BI.NLIMBS, n), dtype=np.int32)
    x[-1] %= 0x1A0
    for i, v in enumerate(edges[:n]):
        x[:, i] = BI.to_limbs(v)
    return torch.from_numpy(x).to(dev)


def check_fq_kernels(dev, rng) -> tuple[int, dict]:
    """Each field kernel against its plain version on the card, bit for bit,
    at FQ_SIZES lanes and at ``MUL_GROUP_THRESHOLD`` - 1, + 0 and + 1 (so
    both of mul_mod's bodies), with edge values and a broadcast (32, 1)
    operand; then kernel and plain version timed at 1 M lanes.  Returns (max
    abs error, {name: timings})."""
    import torch

    from lambda_ethereum_consensus_tpu_torch.crypto.bls.fields import P
    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP

    max_err = 0
    edges_a = [0, 1, P - 1, P - 1, 1, 0, P - 1]
    edges_b = [P - 1, 1, P - 1, 0, P - 1, 0, 1]
    t = BP.MUL_GROUP_THRESHOLD
    if not FQ_SIZES[-1] >= t:
        raise AssertionError(f"the timed size {FQ_SIZES[-1]} must run mul_mod's one-thread body")
    for n in sorted({*FQ_SIZES, t - 1, t, t + 1}):
        a = _fq_operands(rng, n, dev, edges_a if n > 1 else [P - 1])
        b = _fq_operands(rng, n, dev, edges_b if n > 1 else [P - 1])
        const = _fq_operands(rng, 1, dev, [])
        for name in FQ_KERNELS:
            for rhs, tag in ((b, "full"), (const, "(32, 1)")):
                got = getattr(BP, name)(a, rhs)
                plain = BP._PLAIN[name](a, rhs)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max().item())
                max_err = max(max_err, err)
                if err or not torch.equal(got, plain):
                    raise AssertionError(f"{name} kernel != plain version at N={n}, {tag} operand")
        print(f"field kernels == plain versions at N={n} (edge values, broadcast (32, 1) operand; "
              f"mul_mod {BP._geometry('mul_mod', n)[0]} thread(s) per element)")
        del a, b
    timings = {}
    n = FQ_SIZES[-1]
    a = _fq_operands(rng, n, dev, edges_a)
    b = _fq_operands(rng, n, dev, edges_b)
    for name in FQ_KERNELS:
        kernel = getattr(BP, name)
        plain = BP._PLAIN[name]
        timings[name] = dict(
            kernel_ms=_event_ms(lambda: kernel(a, b), reps=20),
            plain_ms=_event_ms(lambda: plain(a, b), reps=3, warmup=1),
            byte_ms=3 * 128 * n / HBM_BYTES_PER_S * 1e3,
        )
    del a, b
    torch.cuda.empty_cache()
    return max_err, timings


def build_registry(rng):
    """The bench's registry: 64 known secret keys cycled over
    N_COMMITTEES x COMMITTEE validators, committees a seeded permutation."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.ops import bls_batch as BB

    n_vals = N_COMMITTEES * COMMITTEE
    base_sks = np.arange(3, 67, dtype=np.int64)
    base_pts = [C.g1.multiply_raw(C.G1_GENERATOR, int(k)) for k in base_sks]
    bx, by = BB._g1_planes(base_pts)
    cyc = np.arange(n_vals) % len(base_sks)
    rx, ry = np.ascontiguousarray(bx[:, cyc]), np.ascontiguousarray(by[:, cyc])
    committees = rng.permutation(n_vals).reshape(N_COMMITTEES, COMMITTEE)
    return base_pts, base_sks[cyc], rx, ry, committees


def build_drain(rng, sks, committees, mmax: int):
    """The bench's drain: INSTANCES x GROUPS messages, AGGS aggregates each,
    participation drawn from [90 %, 100 %]; each aggregate signature is
    H(m) * (sum of its participants' keys).  Returns (entries, aggregate
    secret keys, message points, hashing seconds)."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.hash_to_curve import (
        DST_POP, hash_to_g2_many,
    )

    n_msgs = INSTANCES * GROUPS
    a_total = n_msgs * AGGS
    comm_sk = sks[committees].sum(axis=1)
    comm_ids = np.repeat(np.arange(n_msgs) % N_COMMITTEES, AGGS)
    miss_counts = rng.integers(0, COMMITTEE // 10 + 1, size=a_total)
    assert miss_counts.max() <= mmax
    missing, agg_sk = [], []
    for j in range(a_total):
        miss = rng.choice(committees[comm_ids[j]], size=int(miss_counts[j]), replace=False)
        missing.append([int(v) for v in miss])
        agg_sk.append(int(comm_sk[comm_ids[j]] - sks[miss].sum()))
    msgs = [b"chip-smoke drain msg %d" % g for g in range(n_msgs)]
    t0 = time.perf_counter()
    h_points = hash_to_g2_many(msgs, DST_POP)
    hash_s = time.perf_counter() - t0
    entries = [
        (int(comm_ids[j]), missing[j], msgs[j // AGGS],
         C.g2.multiply_raw(h_points[j // AGGS], agg_sk[j]))
        for j in range(a_total)
    ]
    return entries, agg_sk, h_points, hash_s


def _zero_fq_launches():
    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP

    for name in BP.kernel_launches:
        BP.kernel_launches[name] = 0


def _device_busy_ms(prof) -> float | None:
    """Sum of device time of the CUDA events in a profile, or None when the
    profiler recorded none."""
    import torch

    total = 0.0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        total += us
    return total / 1e3 if total else None


def bls_phase(dev, rng, record: dict) -> dict:
    """Phase 4: the attestation drain on the card; returns the field
    kernels' launches per drain."""
    import torch

    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.batch import batch_verify_each_cached
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.pairing import pairing_check
    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP
    from lambda_ethereum_consensus_tpu_torch.ops import bls_batch as BB

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base_pts, sks, rx, ry, committees = build_registry(rng)
    registry_s = time.perf_counter() - t0
    rx_d, ry_d = torch.from_numpy(rx).to(dev), torch.from_numpy(ry).to(dev)
    print(f"registry: {rx.shape[1]} validators as (32, N) int32 planes, "
          f"{2 * rx_d.numel() * 4 / 1e6:.1f} MB on the card, packed in {registry_s:.1f} s")
    cache_s = []
    for _ in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = BB.DeviceCommitteeCache((rx_d, ry_d), committees, device=dev, chunk=256)
        torch.cuda.synchronize()
        cache_s.append(time.perf_counter() - t0)
    print(f"committee cache ({N_COMMITTEES} x {COMMITTEE}, chunk 256) built in "
          f"{cache_s[0]:.3f} s cold, {cache_s[1]:.3f} s warm; mmax {cache.mmax}")

    # two committees' device sums against the host sums of their members
    for c in (0, 1):
        want = None
        for v in committees[c]:
            want = C.g1.affine_add(want, base_pts[int(v) % len(base_pts)])
        got = (BP.from_planes(cache.sum_x[:, c].cpu().numpy())[0],
               BP.from_planes(cache.sum_y[:, c].cpu().numpy())[0])
        if got != want:
            raise AssertionError(f"committee {c}: device sum != host sum of its members")
    print(f"committee sums of committees 0 and 1 == host sums of their {COMMITTEE} members")

    t0 = time.perf_counter()
    entries, agg_sk, h_points, hash_s = build_drain(rng, sks, committees, cache.mmax)
    print(f"drain built: {len(entries)} aggregates over {len(h_points)} messages in "
          f"{time.perf_counter() - t0:.1f} s (hash_to_g2 {hash_s:.1f} s on the host)")

    # the messages were hashed on the host above; the drains reuse those
    # points, so cold and warm time the same work
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.hash_to_curve import DST_POP

    message_points = {(entries[g * AGGS][2], DST_POP): h for g, h in enumerate(h_points)}
    seconds, launches = [], []
    for _ in ("cold", "warm"):
        _zero_fq_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flags = batch_verify_each_cached(cache, entries, message_points=message_points)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(dict(BP.kernel_launches))
        if not all(flags):
            raise AssertionError(f"valid drain: {flags.count(False)} aggregates rejected")
    _require_all(launches[0], "drain")
    if launches[0] != launches[1]:
        raise AssertionError(f"drain launch counts differ between runs: {launches}")
    rate = len(entries) / seconds[1]
    print(f"drain of {len(entries)} aggregates: cold {seconds[0]:.3f} s, warm {seconds[1]:.3f} s; "
          f"{rate:.1f} aggregate verifications/s; every verdict True")
    print(f"field kernel launches per drain: {launches[1]}")

    prof_s, busy_ms = _profiled(
        lambda: batch_verify_each_cached(cache, entries, message_points=message_points),
        attempts=2)
    print(_idle_line("drain", prof_s, busy_ms))

    # one aggregate signed by the wrong key in the first TAMPER_DRAIN: the
    # bisection must blame it alone
    n = TAMPER_DRAIN
    bad = n // 3
    comm_id, miss, msg, _ = entries[bad]
    tampered = list(entries[:n])
    tampered[bad] = (comm_id, miss, msg, C.g2.multiply_raw(h_points[bad // AGGS], agg_sk[bad] + 1))
    t0 = time.perf_counter()
    flags = batch_verify_each_cached(cache, tampered, message_points=message_points)
    tamper_s = time.perf_counter() - t0
    if flags != [i != bad for i in range(n)]:
        raise AssertionError(f"tampered drain blamed {[i for i, f in enumerate(flags) if not f]}")
    print(f"tampered drain of {n}: bisection blamed exactly entry {bad} in {tamper_s:.3f} s")

    # a small sub-drain against the host pairing_check oracle
    pick = sorted({0, 1, AGGS + 1, bad, 2 * n // 3, n - 1})
    sub = [tampered[i] for i in pick]
    port = batch_verify_each_cached(cache, sub, message_points=message_points)
    neg_g1 = C.g1.affine_neg(C.G1_GENERATOR)
    host = [
        pairing_check([(C.g1.multiply_raw(C.G1_GENERATOR, agg_sk[i]), h_points[i // AGGS]),
                       (neg_g1, tampered[i][3])])
        for i in pick
    ]
    if port != host or host != [i != bad for i in pick]:
        raise AssertionError(f"sub-drain: port {port}, host pairing_check {host}")
    print(f"sub-drain of {len(pick)} aggregates == host pairing_check oracle: {host}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"peak device memory in the BLS phase {peak:.0f} MiB")
    record["bls"] = dict(
        validators=int(rx.shape[1]), aggregates=len(entries), messages=len(h_points),
        cache_build_s=cache_s, drain_s=seconds, aggregates_per_s=rate,
        launches_per_drain=launches[1], profiled_drain_s=prof_s,
        device_busy_ms=busy_ms, tampered_drain_s=tamper_s, peak_mib=peak,
        hash_to_g2_s=hash_s,
    )
    # the first BLAME_DRAIN aggregates with every BLAME_EVERY-th signature
    # negated: a drain whose bisection reaches DEVICE_TAIL_MIN checks, for
    # the tail part of the size routes
    blame_want = [i % BLAME_EVERY != BLAME_EVERY - 1 for i in range(BLAME_DRAIN)]
    forged = [(c, m, msg, sig if ok else C.g2.affine_neg(sig))
              for ok, (c, m, msg, sig) in zip(blame_want, entries)]

    def drain(batch):
        return lambda: batch_verify_each_cached(cache, batch, message_points=message_points)

    return launches[1], drain(entries), drain(forged), blame_want


def _sync() -> None:
    import torch

    torch.cuda.synchronize()


def _launches() -> dict:
    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP

    return dict(BP.kernel_launches)


def _require_all(launches: dict, path: str) -> None:
    """Fail the run unless every field kernel launched on ``path``."""
    missed = [name for name in FQ_KERNELS if not launches.get(name)]
    if missed:
        raise AssertionError(f"{path} launched no {missed}: launches {launches}")


def _counted(fn, path: str):
    """Run ``fn`` once with the launch counts zeroed just before and read
    just after; returns (result, seconds, launches)."""
    _zero_fq_launches()
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    seconds = time.perf_counter() - t0
    launches = _launches()
    _require_all(launches, path)
    return out, seconds, launches


@contextlib.contextmanager
def _constant(module, name: str, value):
    """Set the module constant ``module.name`` to ``value`` inside, and
    restore it after (a route forced by its threshold)."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _drain_gate(value: int):
    """The drain's threshold (``fork_choice/handlers.DRAIN_DEVICE_MIN``) at
    ``value``: at 0 every drain takes the cached body."""
    from lambda_ethereum_consensus_tpu_torch.fork_choice import handlers as FH

    return _constant(FH, "DRAIN_DEVICE_MIN", value)


def _on_device_chain(fn):
    """``fn()`` with the set gate at 0."""
    with _device_chain():
        return fn()


def _device_chain(value: int = 0):
    """The set gate (``crypto/bls/batch.DEVICE_CHAIN_MIN``) at ``value``:
    at 0 every set takes the chained device route."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import batch as B

    return _constant(B, "DEVICE_CHAIN_MIN", value)


def _duty_sign(value: int = 0):
    """The sign flush's threshold (``ops/bls_sign.DUTY_SIGN_MIN``) at
    ``value``: at 0 every flush takes the card's ladder."""
    from lambda_ethereum_consensus_tpu_torch.ops import bls_sign as S

    return _constant(S, "DUTY_SIGN_MIN", value)


def _device_tail(value: int = 0):
    """The pairing tail's threshold (``ops/bls_pairing.DEVICE_TAIL_MIN``) at
    ``value``: at 0 every chained call takes the composed tail, above its
    number of checks the hybrid one."""
    from lambda_ethereum_consensus_tpu_torch.ops import bls_pairing as BPair

    return _constant(BPair, "DEVICE_TAIL_MIN", value)


def _tail_launch_gap(more: dict, fewer: dict, path: str, calls: int) -> int:
    """Fail unless the run of ``path`` that launched ``more`` launched
    exactly ``calls`` composed final exponentiations' field calls more than
    the run that launched ``fewer`` (the two differ in the tail of ``calls``
    chained calls); returns that gap."""
    from lambda_ethereum_consensus_tpu_torch.ops import bls_pairing as BPair

    gap = {k: more[k] - fewer[k] for k in FQ_KERNELS}
    want = {k: calls * BPair.FINAL_EXP_LAUNCHES[k] for k in FQ_KERNELS}
    if gap != want:
        raise AssertionError(f"{path}: one route launched {gap} more field kernels than the "
                             f"other, not {want}")
    return sum(gap.values())


def _default_route(fn, on_device: bool, path: str):
    """Run ``fn`` once on its default route with the launch counts zeroed
    just before, and check that it launched what its size gate picks: every
    field kernel at or above the threshold, none below.  Returns (result,
    seconds, launches)."""
    if on_device:
        return _counted(fn, path)
    _zero_fq_launches()
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    seconds = time.perf_counter() - t0
    launches = _launches()
    if _total(launches):
        raise AssertionError(f"{path} stayed under its threshold and still launched {launches}")
    return out, seconds, launches


def _reset_peak() -> None:
    import torch

    torch.cuda.reset_peak_memory_stats()


def _peak_mib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**20


def _profiled(fn, attempts: int = 1) -> tuple[float, float]:
    """Wall seconds and device-busy ms of one run of ``fn`` under
    ``torch.profiler``, tracing the device only (host events of ~10^5 tensor
    ops take the profiler about a minute to post-process).  For an ``fn``
    that can run again unchanged, ``attempts`` > 1 takes a profile that
    holds no device event again, up to that many runs in all (CUPTI has
    once returned none for a run that launched kernels); a retry is
    printed."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            _sync()
            wall = time.perf_counter() - t0
        busy = _device_busy_ms(prof)
        if busy is not None:
            return wall, busy
        if attempt < attempts:
            print(f"the profiler recorded no device time (run {attempt}); profiling again")
    raise AssertionError(f"the profiler recorded no device time in {attempts} runs")


def _total(launches: dict) -> int:
    return sum(launches[k] for k in FQ_KERNELS)


def _idle_line(name: str, wall: float, busy_ms: float) -> str:
    return (f"profiled {name}: {wall:.3f} s, device busy {busy_ms:.1f} ms, "
            f"idle share {1 - busy_ms / 1e3 / wall:.4f}")


def _with_engine(state):
    """A copy of ``state`` carrying a fresh root engine, which records the
    seconds of each root in ``.seconds``, and no resident plane."""
    from lambda_ethereum_consensus_tpu_torch.ssz.incremental import IncrementalStateRoot
    from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut
    from lambda_ethereum_consensus_tpu_torch.types import BeaconState

    engine = IncrementalStateRoot(BeaconState)
    engine.seconds = []
    real = engine.root

    def root(st, spec=None):
        t = time.perf_counter()
        try:
            return real(st, spec)
        finally:
            engine.seconds.append(time.perf_counter() - t)

    engine.root = root
    ws = BeaconStateMut(state)
    ws._root_engine = engine
    ws._resident_plane = None
    return ws.freeze()


def _primed(state, spec):
    """``_with_engine(state)`` after its engine has rooted it once: a node's
    view of a parent state it has already rooted, so a block imported on it
    roots only what the slot and the block change."""
    out = _with_engine(state)
    out._root_engine.root(out, spec)
    out._root_engine.seconds.clear()
    return out


def _forked(parent):
    """A state equal to ``_primed`` output ``parent`` with a copy of its
    engine: a block imported on it leaves ``parent`` primed, so one rooting
    of the parent serves every import on it."""
    from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut

    ws = BeaconStateMut(parent)
    ws._root_engine = parent._root_engine.copy()
    return ws.freeze()


@contextlib.contextmanager
def _timed_epochs():
    """Seconds of each ``process_epoch`` the slot walk runs."""
    from lambda_ethereum_consensus_tpu_torch.state_transition import core

    seconds: list[float] = []
    real = core.process_epoch

    def timed(state, spec=None):
        t = time.perf_counter()
        try:
            return real(state, spec)
        finally:
            seconds.append(time.perf_counter() - t)

    core.process_epoch = timed
    try:
        yield seconds
    finally:
        core.process_epoch = real


def _walk(start, slot: int, spec, backend, resident: bool, dev) -> dict:
    """``process_slots`` from ``start`` to ``slot`` with ``backend`` installed
    and the resident plane on or off; the seconds of every root, of every
    epoch boundary, inside the backend's calls, and the SHA-256 launches."""
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops
    from lambda_ethereum_consensus_tpu_torch.ssz import set_hash_backend
    from lambda_ethereum_consensus_tpu_torch.state_transition import process_slots

    saved = os.environ.get("GRAFT_RESIDENT_EPOCH")
    os.environ["GRAFT_RESIDENT_EPOCH"] = "auto" if resident else "0"
    timed = _TimedBackend(backend)
    prev = set_hash_backend(timed)
    state = _with_engine(start)
    sops.sha256_kernel_launches = 0
    _sync()
    try:
        with _timed_epochs() as epoch_s:
            t0 = time.perf_counter()
            end = process_slots(state, slot, spec, dev)
            _sync()
            wall = time.perf_counter() - t0
        root_s = list(end._root_engine.seconds)
        launches = sops.sha256_kernel_launches
        final_root = end._root_engine.root(end, spec)
    finally:
        set_hash_backend(prev)
        if saved is None:
            os.environ.pop("GRAFT_RESIDENT_EPOCH")
        else:
            os.environ["GRAFT_RESIDENT_EPOCH"] = saved
    return dict(end=end, wall_s=wall, root_s=root_s, epoch_s=epoch_s, backend_s=timed.seconds,
                sha256_launches=launches, final_root=final_root)


def _aggregate_attestation(state, data, committee, sks: dict, spec):
    """The full committee's aggregate attestation, its signature minted as
    H(m) * (sum of the members' keys): the bytes ``duties.make_attestation``
    gives, without signing member by member on the host."""
    from lambda_ethereum_consensus_tpu_torch.config import constants
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.hash_to_curve import DST_POP, hash_to_g2
    from lambda_ethereum_consensus_tpu_torch.state_transition import accessors, misc
    from lambda_ethereum_consensus_tpu_torch.types import Attestation

    domain = accessors.get_domain(state, constants.DOMAIN_BEACON_ATTESTER, data.target.epoch, spec)
    root = misc.compute_signing_root(data, domain)
    k = sum(sks[v] for v in committee) % C.R
    return Attestation(aggregation_bits=[True] * len(committee), data=data,
                       signature=C.g2_to_bytes(C.g2.multiply_raw(hash_to_g2(root, DST_POP), k)))


def registry_keys(dev, rng) -> tuple[list[int], list, list[bytes], float]:
    """DISTINCT_KEYS seeded secret keys, their pubkey points derived on the
    card by ``batch_g1_mul``, and the compressed pubkeys; the registry uses
    the first REGISTRY_KEYS.  Returns (keys, points, compressed, seconds)."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.ops.bls_g1 import batch_g1_mul

    sks = [int.from_bytes(rng.bytes(32), "big") % (C.R - 1) + 1 for _ in range(DISTINCT_KEYS)]
    t0 = time.perf_counter()
    points = batch_g1_mul([C.G1_GENERATOR] * DISTINCT_KEYS, sks, device=dev)
    seconds = time.perf_counter() - t0
    return sks, points, [C.g1_to_bytes(p) for p in points], seconds


def _real_keys(dev, rng, indices: list) -> tuple[dict, dict]:
    """Seeded secret keys for ``indices`` and their pubkey points, derived
    on the card by ``batch_g1_mul``."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.ops.bls_g1 import batch_g1_mul

    sks = {i: int.from_bytes(rng.bytes(32), "big") % (C.R - 1) + 1 for i in indices}
    points = batch_g1_mul([C.G1_GENERATOR] * len(indices), [sks[i] for i in indices], device=dev)
    return sks, dict(zip(indices, points))


def transition_phase(dev, rng, record: dict, state, spec):
    """Phase 3b: the state transition on the card, at the phase-3 state.

    Real keys go to the current sync committee and the members of the
    ATT_COMMITTEES committees whose attestations the block carries; the
    slot walk crosses one epoch boundary on the resident plane with every
    root through the incremental engine and the device backend, and again
    on the host path (hashlib, host epoch) in the same process, every
    slot's root equal; then a block for the next slot, with a live sync
    aggregate and those attestations, is minted by ``duties`` on a lineage
    of its own, imported with ``validate_result=True`` (counted, then
    profiled) on the walk's end state under an engine that has rooted only
    that state, its post-state rooted again through hashlib, and a copy with
    one attestation signature swapped is rejected.  Returns the import as a
    path for phase 9, the keyed start state and its keys for phase 3c, and
    the card walk's end state and root for phase 3d."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops
    from lambda_ethereum_consensus_tpu_torch.ssz import HashlibBackend, set_hash_backend
    from lambda_ethereum_consensus_tpu_torch.ssz import incremental as inc
    from lambda_ethereum_consensus_tpu_torch.state_transition import (
        StateTransitionError, accessors, process_slots, state_transition,
    )
    from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut
    from lambda_ethereum_consensus_tpu_torch.types import SyncCommittee
    from lambda_ethereum_consensus_tpu_torch.validator import duties

    _reset_peak()
    t_phase = time.perf_counter()
    start_slot = int(state.slot)
    walk_to = start_slot + 4  # the boundary sits between start_slot + 1 and + 2
    block_slot = walk_to + 1
    att_epoch = walk_to // spec.SLOTS_PER_EPOCH

    # ---- real keys: the sync committee and the attesting committees
    ws = BeaconStateMut(state)
    committees = [accessors.get_beacon_committee(ws, walk_to, i, spec)
                  for i in range(ATT_COMMITTEES)]
    sync_members = [int(i) for i in rng.choice(ws.active_indices(att_epoch),
                                               spec.SYNC_COMMITTEE_SIZE, replace=False)]
    keyed = sorted(set(sync_members).union(*committees))
    t0 = time.perf_counter()
    sks, points = _real_keys(dev, rng, keyed)
    pubkeys = {i: C.g1_to_bytes(points[i]) for i in keyed}
    keys_s = time.perf_counter() - t0
    start_sks = dict(sks)
    for i in keyed:
        ws.validators[i] = ws.validators[i].copy(pubkey=pubkeys[i])
    ws.touch_registry()
    agg = None
    for i in sync_members:
        agg = C.g1.affine_add(agg, points[i])
    ws.current_sync_committee = SyncCommittee(
        pubkeys=[pubkeys[i] for i in sync_members], aggregate_pubkey=C.g1_to_bytes(agg))
    ws.next_sync_committee = ws.current_sync_committee
    start = ws.freeze()
    members = sum(len(c) for c in committees)
    print(f"real keys for {len(keyed)} validators ({spec.SYNC_COMMITTEE_SIZE} sync members, "
          f"{ATT_COMMITTEES} committees of {members // ATT_COMMITTEES} = {members} attesters) "
          f"derived on the card in {keys_s:.2f} s")

    # ---- the slot walk across the boundary: card, then host
    walks = {
        "card": _walk(start, walk_to, spec, sops.DeviceHashBackend(dev), True, dev),
        "host": _walk(start, walk_to, spec, HashlibBackend(), False, dev),
    }
    card, host = walks["card"]["end"], walks["host"]["end"]
    plane = card._resident_plane
    if plane is None or plane.stats["sweeps"] != 1 or plane.stats["fallbacks"]:
        raise AssertionError(f"the boundary missed the resident plane: {plane and plane.stats}")
    if getattr(host, "_resident_plane", None) is not None:
        raise AssertionError("the host walk attached a resident plane")
    if not walks["card"]["sha256_launches"]:
        raise AssertionError("the card walk launched no SHA-256 kernel")
    for s in range(start_slot, walk_to):
        i = s % spec.SLOTS_PER_HISTORICAL_ROOT
        if bytes(card.state_roots[i]) != bytes(host.state_roots[i]) or \
                bytes(card.block_roots[i]) != bytes(host.block_roots[i]):
            raise AssertionError(f"slot {s}: the card's root differs from the host path's")
    if walks["card"]["final_root"] != walks["host"]["final_root"]:
        raise AssertionError("the walks end on different state roots")
    ws = BeaconStateMut(card)
    if [accessors.get_beacon_committee(ws, walk_to, i, spec)
            for i in range(ATT_COMMITTEES)] != committees:
        raise AssertionError("the attesting committees moved across the boundary")
    for name, w in walks.items():
        print(f"{name} walk {start_slot} -> {walk_to}: {w['wall_s']:.3f} s; per-slot roots "
              + ", ".join(f"{x:.3f}" for x in w["root_s"])
              + f" s; epoch boundary {w['epoch_s'][0]:.3f} s; {w['backend_s']:.3f} s inside "
              f"backend calls, {w['wall_s'] - w['backend_s']:.3f} s host; "
              f"{w['sha256_launches']} SHA-256 launches")
    print(f"every slot's root, {start_slot} to {walk_to - 1}, and the final root "
          f"{walks['card']['final_root'].hex()} equal on the card and on the host path")
    print(f"resident plane: {plane.device_bytes / 2**20:.1f} MiB on the card, stats {plane.stats}")

    # ---- the block for the next slot: mint, import, profile, tamper
    device_backend = sops.install_device_backend(dev)
    proposer = duties.proposer_index_at_slot(ws, block_slot, spec)
    if proposer not in sks:
        sk = int.from_bytes(rng.bytes(32), "big") % (C.R - 1) + 1
        sks[proposer] = sk
        ws.update_validator(proposer, pubkey=C.g1_to_bytes(C.g1.multiply_raw(C.G1_GENERATOR, sk)))
        card = ws.freeze()
    proposer_sk = sks[proposer].to_bytes(32, "big")
    sync_keys = {pubkeys[i]: sks[i].to_bytes(32, "big") for i in sync_members}
    pre = process_slots(_with_engine(card), block_slot, spec, dev)
    pre_ws = BeaconStateMut(pre)
    head = accessors.get_block_root_at_slot(pre_ws, walk_to, spec)
    atts = [
        _aggregate_attestation(
            pre_ws, duties.attestation_data_from_state(pre_ws, walk_to, i, head, spec),
            committees[i], sks, spec)
        for i in range(ATT_COMMITTEES)
    ]
    t0 = time.perf_counter()
    signed, post = duties.build_signed_block(pre, block_slot, {proposer: proposer_sk},
                                             attestations=atts, spec=spec,
                                             sync_secret_keys=sync_keys, device=dev)
    mint_s = time.perf_counter() - t0

    def import_block(block, parent):
        return state_transition(parent, block, validate_result=True, spec=spec, device=dev)

    # the import's signature set on the device chain (the set gate at 0), as
    # phase 9's "block import" path runs it; the default route further down.
    # The parent is rooted once; each import runs on a fork of it
    primed = _primed(card, spec)
    parent = _forked(primed)
    _zero_fq_launches()
    sops.sha256_kernel_launches = 0
    _sync()
    t0 = time.perf_counter()
    with _device_chain():
        imported = import_block(signed, parent)
    _sync()
    import_s = time.perf_counter() - t0
    fq = _launches()
    sha = sops.sha256_kernel_launches
    _require_all(fq, "block import")
    if not sha:
        raise AssertionError("the block import launched no SHA-256 kernel")
    t0 = time.perf_counter()
    hashlib_root = imported.hash_tree_root(spec, backend=HashlibBackend())
    hashlib_s = time.perf_counter() - t0
    if hashlib_root != bytes(signed.message.state_root):
        raise AssertionError(f"the imported state's hashlib root {hashlib_root.hex()} != the "
                             f"block's state root {bytes(signed.message.state_root).hex()}")
    if bytes(imported.latest_block_header.body_root) != \
            signed.message.body.hash_tree_root(spec, backend=HashlibBackend()):
        raise AssertionError("the imported header does not carry the block's body")
    parent = _forked(primed)
    with _device_chain():
        wall, busy = _profiled(lambda: import_block(signed, parent))

    body = signed.message.body
    swapped = list(body.attestations)
    swapped[0] = swapped[0].copy(signature=bytes(swapped[1].signature))
    bad = duties.sign_block(pre_ws, signed.message.copy(body=body.copy(attestations=swapped)),
                            proposer_sk, spec)
    parent = _forked(primed)
    t0 = time.perf_counter()
    try:
        import_block(bad, parent)
    except StateTransitionError as e:
        if "invalid attestation signature" not in str(e):
            raise
        reject_s = time.perf_counter() - t0
    else:
        raise AssertionError("a block with a swapped attestation signature was imported")
    route = _block_route(members, len(atts))
    parent = _forked(primed)
    _, default_s, default_fq = _default_route(
        lambda: import_block(signed, parent), route != HOST_TAIL,
        "block import (default route)")
    peak = _peak_mib()
    print(f"block {block_slot}: {len(atts)} attestations ({members} members) and a "
          f"{spec.SYNC_COMMITTEE_SIZE}-member sync aggregate, minted in {mint_s:.3f} s")
    print(f"block import with validate_result=True, its signatures on the device chain: "
          f"{import_s:.3f} s; {sha} SHA-256 launches, {_total(fq)} field launches {fq}")
    print(f"block import on the default route ({ROUTE_LABEL[route]}): {default_s:.3f} s, "
          f"{_total(default_fq)} field launches")
    print(f"imported state's root == the block's state root through hashlib "
          f"({hashlib_s:.3f} s on the host)")
    print(_idle_line("block import", wall, busy) + f"; peak device memory {peak:.0f} MiB")
    print(f"swapped attestation signature rejected in {reject_s:.3f} s")

    # ---- the incremental engine's full-field rebuild: hashlib against the
    # device backend, one size at a time
    crossover = []
    for k in CROSSOVER_LOG2:
        chunks = rng.integers(0, 256, (1 << k, 32), dtype=np.uint8)
        row = {"chunks": 1 << k}
        for name, backend in (("hashlib", HashlibBackend()), ("device", device_backend)):
            _sync()
            t0 = time.perf_counter()
            levels = inc._build_levels(chunks.copy(), backend)
            _sync()
            row[f"{name}_s"] = time.perf_counter() - t0
            row[f"{name}_root"] = levels[-1][0].tobytes()
        if row.pop("hashlib_root") != row.pop("device_root"):
            raise AssertionError(f"rebuild roots differ at {1 << k} chunks")
        crossover.append(row)
    print("full-field rebuild, hashlib vs device backend: " + "; ".join(
        f"2^{k} chunks {r['hashlib_s'] * 1e3:.2f} vs {r['device_s'] * 1e3:.2f} ms"
        for k, r in zip(CROSSOVER_LOG2, crossover)))
    set_hash_backend(HashlibBackend())

    record["state_transition"] = dict(
        validators=len(state.validators), slots=[start_slot, walk_to], block_slot=block_slot,
        keyed_validators=len(keyed), attesters=members, keys_s=keys_s,
        walks={name: {k: v for k, v in w.items() if k not in ("end", "final_root")}
               for name, w in walks.items()},
        plane_stats=dict(plane.stats), plane_device_bytes=plane.device_bytes,
        mint_s=mint_s, import_s=import_s, import_sha256_launches=sha, import_fq_launches=fq,
        default_route=route, default_import_s=default_s, default_import_fq_launches=default_fq,
        import_hashlib_root_s=hashlib_s,
        profiled_import_s=wall, import_device_busy_ms=busy, reject_s=reject_s, peak_mib=peak,
        rebuild_crossover=crossover, seconds=time.perf_counter() - t_phase,
    )

    def on_device_backend(fn):
        prev = set_hash_backend(device_backend)
        try:
            return fn()
        finally:
            set_hash_backend(prev)

    def prime():
        return _forked(primed)

    def import_primed(parent):
        return on_device_backend(lambda: _on_device_chain(lambda: import_block(signed, parent)))

    def import_path():
        return import_primed(prime())

    return dict(import_path=import_path, prime=prime, import_primed=import_primed,
                start=start, start_sks=start_sks, sync_keys=sync_keys,
                walk_end=walks["card"]["end"],
                walk_root=walks["card"]["final_root"])


def _epoch_committees(ws, epoch: int, spec) -> tuple[int, dict]:
    """Every committee of ``epoch`` by the spec's ``compute_committee``
    over the active set, ``{(slot, index): [validators]}``, and the
    committees per slot."""
    from lambda_ethereum_consensus_tpu_torch.config import constants
    from lambda_ethereum_consensus_tpu_torch.state_transition import accessors, misc

    active = ws.active_indices(epoch)
    per_slot = accessors.get_committee_count_per_slot(ws, epoch, spec)
    seed = accessors.get_seed(ws, epoch, constants.DOMAIN_BEACON_ATTESTER, spec)
    count = per_slot * spec.SLOTS_PER_EPOCH
    first = epoch * spec.SLOTS_PER_EPOCH
    return per_slot, {
        (first + c // per_slot, c % per_slot): misc.compute_committee(active, seed, c, count, spec)
        for c in range(count)
    }


def _signed_aggregates(dev, state, items, sk_of, spec, forged=()) -> tuple[list, list]:
    """Aggregate attestations for ``items`` = [(data, committee, bits)], each
    signed as H(m) * (sum of its participants' keys), the multiplications on
    the card by ``batch_g2_mul``; an item whose position is in ``forged`` is
    signed with its key plus one.  Returns (attestations, aggregate keys)."""
    from lambda_ethereum_consensus_tpu_torch.config import constants
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2_many
    from lambda_ethereum_consensus_tpu_torch.ops.bls_g2 import batch_g2_mul
    from lambda_ethereum_consensus_tpu_torch.state_transition import accessors, misc
    from lambda_ethereum_consensus_tpu_torch.types import Attestation

    domain = accessors.get_domain(state, constants.DOMAIN_BEACON_ATTESTER,
                                  items[0][0].target.epoch, spec)
    roots = [misc.compute_signing_root(data, domain) for data, _, _ in items]
    distinct = list(dict.fromkeys(roots))
    hashed = dict(zip(distinct, hash_to_g2_many(distinct)))
    keys = [
        (sum(sk_of(v) for v, bit in zip(committee, bits) if bit) + (j in forged)) % C.R
        for j, (_, committee, bits) in enumerate(items)
    ]
    sigs = batch_g2_mul([hashed[r] for r in roots], keys, device=dev)
    atts = [Attestation(aggregation_bits=[bool(b) for b in bits], data=data,
                        signature=C.g2_to_bytes(sig))
            for (data, _, bits), sig in zip(items, sigs)]
    return atts, keys


def _participation(rng, k: int, low: float = 0.9, high: float = 1.0) -> np.ndarray:
    """A committee's aggregation bits at a participation drawn from
    [low, high], at least one bit set."""
    bits = rng.random(k) < rng.uniform(low, high)
    bits[rng.integers(0, k)] = True
    return bits


@contextlib.contextmanager
def _block_sets(seen: list):
    """Record the signature set of every block imported inside: a working
    copy of the state and the deferred attestations that
    ``operations._verify_deferred_attestations`` received."""
    from lambda_ethereum_consensus_tpu_torch.state_transition import operations
    from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut

    real = operations._verify_deferred_attestations

    def capture(state, deferred, spec, device=None):
        seen.append((BeaconStateMut(state.freeze()), list(deferred)))
        return real(state, deferred, spec, device)

    operations._verify_deferred_attestations = capture
    try:
        yield
    finally:
        operations._verify_deferred_attestations = real


@contextlib.contextmanager
def _entry_counts(module, attr: str, seen: list, keep: bool = False):
    """Record the entry count of every call of ``module.attr`` inside (the
    entries themselves with ``keep``)."""
    real = getattr(module, attr)

    def counted(entries, *args, **kwargs):
        seen.append(list(entries) if keep else len(entries))
        return real(entries, *args, **kwargs)

    setattr(module, attr, counted)
    try:
        yield
    finally:
        setattr(module, attr, real)


# the routes of a block's signature set, and what each is
HOST_TAIL, DEVICE_CHAIN, COMMITTEE_CACHE = "host_tail", "device_chain", "cached"
ROUTE_LABEL = {HOST_TAIL: "host sums, host tail", DEVICE_CHAIN: "host sums, device chain",
               COMMITTEE_CACHE: "committee cache"}


def _block_route(members: int, aggregates: int) -> str:
    """The route ``_verify_deferred_attestations`` takes at the current
    constants for a block of ``aggregates`` attestations and ``members``
    attesting members."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import batch as B
    from lambda_ethereum_consensus_tpu_torch.state_transition import operations

    if members >= operations.BLOCK_BATCH_MIN_MEMBERS:
        return COMMITTEE_CACHE
    return DEVICE_CHAIN if aggregates >= B.DEVICE_CHAIN_MIN else HOST_TAIL


def _block_forced(route: str, members: int, aggregates: int):
    """Both constants set so that ``_verify_deferred_attestations`` takes
    ``route`` for such a block."""
    from lambda_ethereum_consensus_tpu_torch.state_transition import operations

    stack = contextlib.ExitStack()
    stack.enter_context(_constant(operations, "BLOCK_BATCH_MIN_MEMBERS",
                                  0 if route == COMMITTEE_CACHE else members + 1))
    stack.enter_context(_device_chain(aggregates + 1 if route == HOST_TAIL else 0))
    return stack


def node_phase(dev, rng, record: dict, spec, start, start_sks: dict, sync_keys: dict,
               keys: list[int], points: list, compressed: list[bytes]) -> tuple[dict, dict]:
    """Phase 3c: a node's slot at 1,000,000 validators through the port's
    fork choice on the card.

    The store is anchored at the epoch-start state of phase 3b's keyed
    registry (``process_slots`` across the boundary on the card).  The
    registry planes are built cold and timed apart (native decompression of
    the distinct keys, packing, upload), and native decompression is timed
    again on DISTINCT_KEYS distinct keys.  A mainnet-shaped block (the
    committees of the two slots before it, 90-100 % participation, a live
    sync aggregate) is minted and imported with ``on_block`` (counted and
    profiled, through the committee-cache branch), its post-state rooted
    again through hashlib, and a copy with one signature swapped rejected.
    Then ``on_attestation_batch`` drains DRAIN_COPIES aggregates per committee from
    the block's slot to the epoch's end (one at about 50 %, over ``mmax``),
    cold, warm and profiled, every verdict None, the latest messages exactly
    the participants' votes for the block and ``get_head`` the block; a
    second drain of fresh aggregates blames exactly its forged one; and a
    sample is held against the host oracle.  Returns phase 9's paths, and
    the store, the drain and the block's signature set for the size-routes
    phase."""
    import torch

    from lambda_ethereum_consensus_tpu_torch import fork_choice as FC
    from lambda_ethereum_consensus_tpu_torch.config import constants
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import batch as B
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import native
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.batch import _verify_points_host
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.hash_to_curve import DST_POP
    from lambda_ethereum_consensus_tpu_torch.fork_choice import attestation as FA
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops
    from lambda_ethereum_consensus_tpu_torch.ops.bls_batch import _indexed_device
    from lambda_ethereum_consensus_tpu_torch.ssz import HashlibBackend, set_hash_backend
    from lambda_ethereum_consensus_tpu_torch.state_transition import (
        StateTransitionError, accessors, misc, operations, process_slots, state_transition,
    )
    from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut
    from lambda_ethereum_consensus_tpu_torch.types import BeaconBlock, BeaconBlockBody
    from lambda_ethereum_consensus_tpu_torch.validator import duties

    _reset_peak()
    t_phase = time.perf_counter()
    out: dict = {}
    device_backend = sops.install_device_backend(dev)

    def sk_of(v: int) -> int:
        return start_sks.get(v) or keys[v % REGISTRY_KEYS]

    # ---- native decompression and packing of DISTINCT_KEYS distinct keys
    from lambda_ethereum_consensus_tpu_torch.ops.bls_batch import _g1_planes

    native.library()  # built and checked in phase 1
    t0 = time.perf_counter()
    decoded = native.g1_decompress_batch(compressed)
    decompress_s = time.perf_counter() - t0
    if decoded != points:
        raise AssertionError("native decompression != the points batch_g1_mul derived")
    t0 = time.perf_counter()
    _g1_planes(decoded)
    pack_us = (time.perf_counter() - t0) / DISTINCT_KEYS * 1e6
    us_per_key = decompress_s / DISTINCT_KEYS * 1e6
    print(f"native g1_decompress_batch of {DISTINCT_KEYS} distinct keys (subgroup checks on): "
          f"{decompress_s:.3f} s, {us_per_key:.1f} us per key; every point == batch_g1_mul's; "
          f"packing {pack_us:.2f} us per key")

    # ---- the store, anchored at the epoch start
    epoch = int(start.slot) // spec.SLOTS_PER_EPOCH + 1
    first = epoch * spec.SLOTS_PER_EPOCH
    t0 = time.perf_counter()
    anchor = process_slots(_with_engine(start), first, spec, dev)
    anchor_state_root = anchor._root_engine.root(anchor, spec)
    header = anchor.latest_block_header
    anchor_root = header.hash_tree_root(spec)
    anchor_block = BeaconBlock(slot=header.slot, proposer_index=header.proposer_index,
                               parent_root=bytes(header.parent_root),
                               state_root=anchor_state_root, body=BeaconBlockBody())
    anchor_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = FC.get_forkchoice_store(anchor, anchor_block, spec, anchor_root=anchor_root)
    store_s = time.perf_counter() - t0
    print(f"anchor: epoch {epoch} start (slot {first}) reached in {anchor_s:.3f} s; "
          f"get_forkchoice_store {store_s:.3f} s (its full state root on the device backend)")

    # ---- the registry planes, cold and apart from the rest
    n = len(anchor.validators)
    timed = {"decompress_s": 0.0}
    real_points = FA._registry_points

    def timed_points(pubkeys):
        t = time.perf_counter()
        try:
            return real_points(pubkeys)
        finally:
            timed["decompress_s"] += time.perf_counter() - t

    FA._registry_points = timed_points
    try:
        t0 = time.perf_counter()
        rx, ry = FA.registry_planes(anchor, spec)
        host_s = time.perf_counter() - t0
    finally:
        FA._registry_points = real_points
    distinct = len({bytes(v.pubkey) for v in anchor.validators})
    _sync()
    t0 = time.perf_counter()
    plane_store = FA.device_plane_store(anchor, spec, dev)
    _sync()
    upload_s = time.perf_counter() - t0
    pack_s = host_s - timed["decompress_s"]
    # a registry of n distinct keys: each decompressed and packed once, plus
    # this run's walk over the validators and its upload
    cold_1m_s = (us_per_key + pack_us) * n / 1e6 + pack_s + upload_s
    out["registry"] = dict(validators=n, distinct_keys=distinct, build_s=host_s + upload_s,
                           decompress_s=timed["decompress_s"], pack_s=pack_s,
                           upload_s=upload_s, device_bytes=plane_store.resident_bytes,
                           distinct_decompress_s=decompress_s, us_per_key=us_per_key,
                           pack_us_per_key=pack_us, implied_distinct_s=cold_1m_s)
    print(f"registry planes cold: {n} validators ({distinct} distinct keys) in "
          f"{host_s + upload_s:.3f} s: decompression {timed['decompress_s']:.3f} s, packing "
          f"{pack_s:.3f} s, upload {upload_s:.3f} s; {plane_store.resident_bytes / 2**20:.0f} MiB "
          f"on the card; at {n} distinct keys the cold build would take about "
          f"{cold_1m_s:.0f} s")

    # ---- the block: the committees of the BLOCK_SLOTS slots before it
    block_slot = first + BLOCK_SLOTS
    pre = process_slots(_with_engine(anchor), block_slot, spec, dev)
    pre_ws = BeaconStateMut(pre)
    per_slot, table = _epoch_committees(pre_ws, epoch, spec)
    heads = {accessors.get_block_root_at_slot(pre_ws, s, spec) for s in range(first, block_slot)}
    if heads != {anchor_root}:
        raise AssertionError("the slots before the block do not point at the anchor")
    items = [
        (duties.attestation_data_from_state(pre_ws, s, i, anchor_root, spec), table[(s, i)],
         _participation(rng, len(table[(s, i)])))
        for s in range(first, block_slot) for i in range(per_slot)
    ]
    t0 = time.perf_counter()
    atts, _ = _signed_aggregates(dev, pre_ws, items, sk_of, spec)
    proposer = duties.proposer_index_at_slot(pre_ws, block_slot, spec)
    signed, post = duties.build_signed_block(
        pre, block_slot, {proposer: sk_of(proposer).to_bytes(32, "big")}, attestations=atts,
        spec=spec, sync_secret_keys=sync_keys, device=dev)
    mint_s = time.perf_counter() - t0
    members = sum(int(bits.sum()) for _, _, bits in items)
    mmax = FA.get_state_attestation_context(pre, epoch, spec, dev).device_cache().mmax
    if members < operations.BLOCK_BATCH_MIN_MEMBERS:
        raise AssertionError(f"{members} members stay under the committee-cache branch")
    # aggregates missing more members than the cache corrects take the host sum
    block_over = sum(int((~bits).sum()) > mmax for _, _, bits in items)
    print(f"block {block_slot}: {len(atts)} aggregates ({per_slot} committees x {BLOCK_SLOTS} "
          f"slots, {members} attesting members, mmax {mmax}, {block_over} over it) and a live "
          f"sync aggregate, minted in {mint_s:.3f} s")

    # ---- import: a node's first of the epoch (no state context yet)
    FC.on_tick(store, store.genesis_time + block_slot * spec.SECONDS_PER_SLOT, spec)
    FA._STATE_CTX.clear()
    routes = []
    real_cached = operations._verify_deferred_cached

    def counted_cached(*args):
        routes.append(len(args[1]))
        return real_cached(*args)

    imported_root, block_set, host_sums = [], [], []
    operations._verify_deferred_cached = counted_cached
    try:
        with _block_sets(block_set), _entry_counts(B, "verify_points", host_sums):
            _zero_fq_launches()
            sops.sha256_kernel_launches = 0
            wall, busy = _profiled(lambda: imported_root.append(
                FC.on_block(store, signed, spec=spec, device=dev)))
            fq, sha = _launches(), sops.sha256_kernel_launches
    finally:
        operations._verify_deferred_cached = real_cached
    block_root = imported_root[0]
    _require_all(fq, "mainnet block import")
    if not sha:
        raise AssertionError("the mainnet block import launched no SHA-256 kernel")
    if routes != [len(atts)]:
        raise AssertionError(f"the block missed the committee-cache branch: {routes}")
    if host_sums != ([block_over] if block_over else []):
        raise AssertionError(f"{block_over} aggregates over mmax, host-summed: {host_sums}")
    if block_root != signed.message.hash_tree_root(spec):
        raise AssertionError("on_block returned another root than the block's")
    imported = store.block_states[block_root]
    t0 = time.perf_counter()
    hashlib_root = imported.hash_tree_root(spec, backend=HashlibBackend())
    hashlib_s = time.perf_counter() - t0
    if hashlib_root != bytes(signed.message.state_root):
        raise AssertionError(f"the imported state's hashlib root {hashlib_root.hex()} != the "
                             f"block's state root {bytes(signed.message.state_root).hex()}")
    print(f"on_block (validate_result=True, a cold state context, profiled): {wall:.3f} s; "
          f"{sha} SHA-256 launches, {_total(fq)} field launches {fq}")
    print(_idle_line("on_block", wall, busy))
    print(f"imported state's root == the block's state root through hashlib "
          f"({hashlib_s:.3f} s on the host)")

    body = signed.message.body
    swapped = list(body.attestations)
    swapped[0] = swapped[0].copy(signature=bytes(swapped[1].signature))
    bad = duties.sign_block(pre_ws, signed.message.copy(body=body.copy(attestations=swapped)),
                            sk_of(proposer).to_bytes(32, "big"), spec)
    t0 = time.perf_counter()
    try:
        FC.on_block(store, bad, spec=spec, device=dev)
    except StateTransitionError as e:
        if "invalid attestation signature" not in str(e):
            raise
        reject_s = time.perf_counter() - t0
    else:
        raise AssertionError("a block with a swapped attestation signature was imported")
    print(f"swapped aggregate signature rejected in {reject_s:.3f} s")
    out["block"] = dict(slot=block_slot, aggregates=len(atts), members=members, mmax=mmax,
                        over_mmax=block_over,
                        mint_s=mint_s, import_s=wall, device_busy_ms=busy,
                        idle_share=1 - busy / 1e3 / wall, fq_launches=fq,
                        sha256_launches=sha, hashlib_root_s=hashlib_s, reject_s=reject_s)

    # ---- the drain: DRAIN_COPIES aggregates per committee, block slot to epoch end
    FC.on_tick(store, store.genesis_time + (first + spec.SLOTS_PER_EPOCH) * spec.SECONDS_PER_SLOT,
               spec)
    post_ws = BeaconStateMut(imported)
    slots = range(block_slot, first + spec.SLOTS_PER_EPOCH)
    items = [
        (duties.attestation_data_from_state(post_ws, s, i, block_root, spec), table[(s, i)],
         _participation(rng, len(table[(s, i)])))
        for s in slots for i in range(per_slot) for _ in range(DRAIN_COPIES)
    ]
    sparse = len(items) // 2
    items[sparse] = (*items[sparse][:2], _participation(rng, len(items[sparse][1]), 0.5, 0.5))
    fresh = [(data, committee, _participation(rng, len(committee)))
             for data, committee, _ in items[:SECOND_DRAIN]]
    forged = SECOND_DRAIN // 3
    t0 = time.perf_counter()
    signed_all, agg_keys = _signed_aggregates(dev, post_ws, items + fresh, sk_of, spec,
                                              forged={len(items) + forged})
    drain_mint_s = time.perf_counter() - t0
    drain, second = signed_all[:len(items)], signed_all[len(items):]
    missing = int((~items[sparse][2]).sum())
    if missing <= mmax:
        raise AssertionError(f"the sparse aggregate misses {missing} members, within mmax {mmax}")
    drain_over = [i for i, (_, _, bits) in enumerate(items) if int((~bits).sum()) > mmax]
    print(f"drain: {len(drain)} aggregates ({len(slots)} slots x {per_slot} committees x "
          f"{DRAIN_COPIES}; aggregate {sparse} missing {missing} members, over mmax {mmax}; "
          f"{len(drain_over)} over it in all) "
          f"and {len(second)} fresh ones, minted in {drain_mint_s:.3f} s")

    def expect_accepted(verdicts, tag: str) -> None:
        if any(v is not None for v in verdicts):
            bad_at = [(i, str(v)) for i, v in enumerate(verdicts) if v is not None][:4]
            raise AssertionError(f"{tag} drain rejected valid aggregates: {bad_at}")

    # cold: the store's context and committee cache are built; warm: reused
    # (the warm run is also the profiled one).  Both, and phase 9's drain
    # path, run the sparse entries on the device chain too (the set gate at
    # 0); their default route follows.
    sparse_calls = []
    with _entry_counts(B, "batch_verify_each_points", sparse_calls, keep=True), \
            _device_chain():
        verdicts, cold_s, cold_launches = _counted(
            lambda: FC.on_attestation_batch(store, drain, spec=spec, device=dev),
            "fork-choice drain (cold)")
    expect_accepted(verdicts, "cold")
    if sparse not in drain_over or [len(e) for e in sparse_calls] != [len(drain_over)]:
        raise AssertionError(f"{len(drain_over)} aggregates over mmax, the sparse route "
                             f"took {[len(e) for e in sparse_calls]}")
    sparse_entries = sparse_calls[0]
    with _device_chain():
        flags, sparse_chain_s, _ = _counted(
            lambda: B.batch_verify_each_points(sparse_entries, device=dev),
            "sparse host-aggregate entries (device chain)")
    sparse_default = len(sparse_entries) >= B.device_chain_threshold()
    default_flags, sparse_default_s, sparse_default_launches = _default_route(
        lambda: B.batch_verify_each_points(sparse_entries, device=dev), sparse_default,
        "sparse host-aggregate entries (default route)")
    if not all(flags) or default_flags != flags:
        raise AssertionError(f"the sparse entries: device chain {flags}, default {default_flags}")
    ctxs = list(store.attestation_contexts.values())
    if len(ctxs) != 1 or ctxs[0]._device_cache is None or \
            ctxs[0].device != _indexed_device(dev):
        raise AssertionError("the drain did not run on one committee cache on the card")
    warm = []
    _zero_fq_launches()
    with _device_chain():
        prof_s, prof_busy = _profiled(
            lambda: warm.append(FC.on_attestation_batch(store, drain, spec=spec, device=dev)))
    warm_launches = _launches()
    _require_all(warm_launches, "fork-choice drain (warm)")
    expect_accepted(warm[0], "warm")
    runs = [(cold_s, cold_launches), (prof_s, warm_launches)]
    voters = set()
    for _, committee, bits in items:
        voters.update(v for v, bit in zip(committee, bits) if bit)
    messages = store.latest_messages
    if set(messages) != voters or any(
            (m.epoch, m.root) != (epoch, block_root) for m in messages.values()):
        raise AssertionError("latest messages != the drain's participants voting for the block")
    t0 = time.perf_counter()
    head = FC.get_head(store, spec)
    head_s = time.perf_counter() - t0
    if head != block_root or store.head_cache.head() != block_root:
        raise AssertionError(f"get_head {head.hex()} is not the block {block_root.hex()}")
    print(f"sparse host-aggregate route: {len(sparse_entries)} entries (aggregate {sparse} "
          f"among them) through batch_verify_each_points in the cold drain; again alone, "
          f"every flag True: device chain {sparse_chain_s:.3f} s, default route "
          f"({'device chain' if sparse_default else 'host tail'}) {sparse_default_s:.3f} s, "
          f"{_total(sparse_default_launches)} field launches")
    print(f"on_attestation_batch of {len(drain)} aggregates: cold {runs[0][0]:.3f} s, warm "
          f"(profiled) {runs[1][0]:.3f} s; every verdict None; {_total(runs[1][1])} field "
          f"launches {runs[1][1]} (cold {_total(runs[0][1])})")
    print(_idle_line("warm drain", prof_s, prof_busy))
    print(f"latest messages == the {len(voters)} participants' votes for the block; get_head "
          f"== the block in {head_s:.3f} s")

    def expect_forged(verdicts) -> None:
        blamed = [i for i, v in enumerate(verdicts) if v is not None]
        if blamed != [forged] or not verdicts[forged].reject:
            raise AssertionError(f"the second drain blamed {blamed}")

    # on its default route, the cached body: every field kernel must launch
    verdicts, second_s, second_launches = _default_route(
        lambda: FC.on_attestation_batch(store, second, spec=spec, device=dev),
        len(second) >= FC.attestation_batch_target(), "fork-choice drain (forged)")
    expect_forged(verdicts)
    print(f"second drain of {len(second)} fresh aggregates on its default route (the cached "
          f"body from {FC.attestation_batch_target()}): exactly aggregate {forged} rejected "
          f"(reject=True) in {second_s:.3f} s, {_total(second_launches)} field launches")

    # ---- a sample against the host oracle (native rlc_verify)
    pick = np.linspace(0, len(drain) - 1, ORACLE_SAMPLE).astype(int).tolist()
    domain = accessors.get_domain(post_ws, constants.DOMAIN_BEACON_ATTESTER, epoch, spec)
    entries = [(native.g1_mul(C.G1_GENERATOR, agg_keys[i]),
                misc.compute_signing_root(items[i][0], domain),
                C.g2_from_bytes(bytes(drain[i].signature))) for i in pick]
    t0 = time.perf_counter()
    host_ok = _verify_points_host(entries, DST_POP, {})
    oracle_s = time.perf_counter() - t0
    entries[1] = (entries[1][0], entries[1][1], entries[0][2])
    if host_ok is not True or _verify_points_host(entries, DST_POP, {}) is not False:
        raise AssertionError("the host oracle disagrees with the drain's sample")
    print(f"{ORACLE_SAMPLE}-aggregate sample: host oracle (native rlc_verify) True like the "
          f"drain in {oracle_s:.3f} s, and False with one signature swapped")

    peak = _peak_mib()
    print(f"peak device memory in the node phase {peak:.0f} MiB")
    set_hash_backend(HashlibBackend())
    out["drain"] = dict(aggregates=len(drain), messages=len(slots) * per_slot,
                        sparse_missing=missing, over_mmax=len(drain_over),
                        mint_s=drain_mint_s,
                        cold_s=runs[0][0], warm_s=runs[1][0], cold_launches=runs[0][1],
                        warm_launches=runs[1][1], device_busy_ms=prof_busy,
                        idle_share=1 - prof_busy / 1e3 / prof_s, voters=len(voters),
                        get_head_s=head_s, second_aggregates=len(second), second_s=second_s,
                        second_launches=second_launches, sparse_chain_s=sparse_chain_s, sparse_default_s=sparse_default_s,
                        sparse_default_launches=sparse_default_launches, oracle_s=oracle_s)
    out.update(anchor_s=anchor_s, store_s=store_s, peak_mib=peak,
               seconds=time.perf_counter() - t_phase)
    record["node"] = out

    def drain_path():
        with _device_chain():
            return FC.on_attestation_batch(store, drain, spec=spec, device=dev)

    def import_path():
        prev = set_hash_backend(device_backend)
        try:
            return state_transition(_primed(anchor, spec), signed, validate_result=True,
                                    spec=spec, device=dev)
        finally:
            set_hash_backend(prev)

    paths = {"fork-choice drain": drain_path, "mainnet block import": import_path}
    return paths, dict(store=store, drain=drain, block_set=block_set[0])

_DUTY_PHASES = ("propose", "attest", "aggregate")  # at 0, 1/3 and 2/3 of a slot


def _timing(timers: Counter, key: str, fn):
    """``fn`` with the seconds of each call added to ``timers[key]``."""
    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            timers[key] += time.perf_counter() - t

    return timed


def duty_phase(dev, record: dict, card: str, spec, store, start_sks: dict,
               keys: list[int]) -> None:
    """Phase 3e: the validator duty engine at 1,000,000 validators on phase
    3c's store.

    A ``DutyScheduler`` on the card operates validators 0 .. DUTY_KEYS - 1
    and the proposers of the DUTY_SLOTS slots after the store's head
    (validator v holding ``start_sks.get(v)`` or ``keys[v % REGISTRY_KEYS]``)
    against a ``SlotClock`` from the state's genesis time;
    ``duties_for_epoch`` is timed.  Each slot's ``on_tick`` runs at its
    start (propose), 1/3 (attest) and 2/3 (aggregate); each produced block
    is imported with ``on_block`` and must become the head, and the second
    must carry the first slot's published aggregates.  Seconds per phase
    are split into hash, ladder or native, pool, proposal (``process_slots``,
    build, root) and import; each phase's completion offset and deadline
    misses are read from the port's registry (a miss is printed, not
    failed); field and SHA-256 launches are counted per phase (no field
    launch for a flush below ``DUTY_SIGN_MIN``, the SHA-256 kernel for each
    proposal).  The flushes of the first RESIGN_SLOTS slots are then signed
    again on the ladder (``DUTY_SIGN_MIN`` at 0, all three field kernels) and
    must equal the walk's signatures byte for byte; RESIGN_SAMPLE of every
    flush's signatures equal ``api.sign``."""
    from lambda_ethereum_consensus_tpu_torch import fork_choice as FC
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import api
    from lambda_ethereum_consensus_tpu_torch.ops import bls_sign as S
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops
    from lambda_ethereum_consensus_tpu_torch.ssz import HashlibBackend, set_hash_backend
    from lambda_ethereum_consensus_tpu_torch.state_transition import core
    from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut
    from lambda_ethereum_consensus_tpu_torch.telemetry import get_metrics
    from lambda_ethereum_consensus_tpu_torch.tracing import SlotClock
    from lambda_ethereum_consensus_tpu_torch.validator import (
        DutyScheduler, is_aggregator_hash, proposer_index_at_slot,
    )
    from lambda_ethereum_consensus_tpu_torch.validator import scheduler as SCH

    t_phase = time.perf_counter()
    sops.install_device_backend(dev)
    metrics = get_metrics()
    head = FC.get_head(store, spec)
    state = store.block_states[head]
    slots = [int(state.slot) + 1 + i for i in range(DUTY_SLOTS)]
    epoch = slots[0] // spec.SLOTS_PER_EPOCH

    def key(v: int) -> bytes:
        return (start_sks.get(v) or keys[v % REGISTRY_KEYS]).to_bytes(32, "big")

    view = BeaconStateMut(state)  # vectorized registry columns
    proposers = {s: proposer_index_at_slot(view, s, spec) for s in slots}
    keymap = {v: key(v) for v in range(DUTY_KEYS)}
    keymap.update({v: key(v) for v in proposers.values()})
    clock = SlotClock(int(state.genesis_time), int(spec.SECONDS_PER_SLOT), 3)
    sched = DutyScheduler(keymap, spec, clock=clock, device=dev)
    flushes: list = []  # (slot, phase, keys, messages, signatures)
    current = {}
    default_sign = sched._sign

    def recorded(secret_keys, messages):
        sigs = default_sign(secret_keys, messages)
        flushes.append((current["slot"], current["phase"], list(secret_keys), list(messages),
                        sigs))
        return sigs

    sched._sign = recorded
    t0 = time.perf_counter()
    duties = sched.duties_for_epoch(state, epoch)
    duties_s = time.perf_counter() - t0
    per_slot = {s: len(duties.attesters_by_slot.get(s, [])) for s in slots}
    out: dict = {"keys": len(keymap), "epoch": epoch, "duties_s": duties_s,
                 "attester_duties": duties.attester_count,
                 "committees_per_slot": duties.committees_per_slot, "slots": {}}
    print(f"duties_for_epoch({epoch}) for {len(keymap)} keys ({DUTY_KEYS} validators and the "
          f"proposers {sorted(proposers.values())} of slots {slots}): {duties_s:.3f} s; "
          f"{duties.attester_count} attester duties over {duties.committees_per_slot} "
          f"committees a slot, {per_slot} in the ticked slots [{card}]")

    timers: Counter = Counter()
    pool = sched.pool
    for name in ("add_vote", "aggregate_for", "block_attestations", "prune"):
        setattr(pool, name, _timing(timers, "pool", getattr(pool, name)))
    patches = [(S, "hash_to_g2_many", "hash"), (S, "_sign_points_host", "native"),
               (S, "_sign_points_device", "ladder"), (SCH, "process_slots", "process_slots"),
               (SCH, "build_signed_block", "build"), (core, "state_root", "root")]
    aggregates: dict = {}
    blocks: dict = {}
    with contextlib.ExitStack() as stack:
        for module, name, part in patches:
            stack.enter_context(_constant(module, name,
                                          _timing(timers, part, getattr(module, name))))
        for slot in slots:
            row: dict = {}
            for k, phase in enumerate(_DUTY_PHASES):
                now = clock.slot_start(slot) + k * spec.SECONDS_PER_SLOT / 3
                current.update(slot=slot, phase=phase)
                miss0 = metrics.get("duty_deadline_miss_total", type=phase)
                hist0 = metrics.get_histogram("duty_completion_offset_seconds", type=phase)
                seen0, n0 = timers.copy(), len(flushes)
                _zero_fq_launches()
                sops.sha256_kernel_launches = 0
                _sync()
                t0 = time.perf_counter()
                produced = sched.on_tick(store, now)
                _sync()
                wall = time.perf_counter() - t0
                fq, sha = _launches(), sops.sha256_kernel_launches
                hist = metrics.get_histogram("duty_completion_offset_seconds", type=phase)
                if hist is None or hist[3] != (hist0[3] if hist0 else 0) + 1:
                    raise AssertionError(f"slot {slot} {phase}: no completion offset recorded")
                parts = {p: timers[p] - seen0[p] for p in
                         ("hash", "ladder", "native", "pool", "process_slots", "build", "root")}
                sizes = [len(f[2]) for f in flushes[n0:]]
                info = dict(seconds=wall, parts=parts, flushes=sizes, fq_launches=fq,
                            sha256_launches=sha,
                            offset_s=hist[2] - (hist0[2] if hist0 else 0.0),
                            misses=metrics.get("duty_deadline_miss_total", type=phase) - miss0)
                if any(n >= S.DUTY_SIGN_MIN for n in sizes):
                    _require_all(fq, f"slot {slot} {phase} (a flush on the ladder)")
                elif phase != "propose" and _total(fq):
                    raise AssertionError(f"slot {slot} {phase}: flushes {sizes} under "
                                         f"DUTY_SIGN_MIN launched {fq}")
                if phase == "propose":
                    if "block" not in produced:
                        raise AssertionError(f"slot {slot}: the managed proposer made no block")
                    if not sha:
                        raise AssertionError(f"slot {slot}: the proposal launched no SHA-256 "
                                             f"kernel")
                    signed, _post = produced["block"]
                    _zero_fq_launches()
                    sops.sha256_kernel_launches = 0
                    _sync()
                    t0 = time.perf_counter()
                    root = FC.on_block(store, signed, spec=spec, device=dev)
                    _sync()
                    info["import_s"] = time.perf_counter() - t0
                    info["import_fq_launches"] = _launches()
                    info["import_sha256_launches"] = sops.sha256_kernel_launches
                    new_head = FC.get_head(store, spec)
                    if root != signed.message.hash_tree_root(spec) or new_head != root or \
                            store.head_cache.head() != root:
                        raise AssertionError(f"slot {slot}: the imported block is not the head")
                    info["attestations"] = len(signed.message.body.attestations)
                    blocks[slot] = signed
                elif phase == "attest":
                    info["votes"] = len(produced.get("attestations", []))
                    if info["votes"] != per_slot[slot]:
                        raise AssertionError(f"slot {slot}: {info['votes']} votes for "
                                             f"{per_slot[slot]} duties")
                else:
                    aggregates[slot] = produced.get("aggregates", [])
                    slot_duties = duties.attesters_by_slot.get(slot, [])
                    proofs = flushes[n0][4] if len(flushes) > n0 else []
                    info["winners"] = sum(is_aggregator_hash(p, d.committee_size)
                                          for d, p in zip(slot_duties, proofs))
                    info["aggregates"] = len(aggregates[slot])
                row[phase] = info
                p = info["parts"]
                print(f"slot {slot} {phase} tick: {wall:.3f} s (hash {p['hash']:.3f}, ladder "
                      f"{p['ladder']:.3f}, native {p['native']:.3f}, pool {p['pool']:.3f}, "
                      f"process_slots {p['process_slots']:.3f}, build "
                      f"{p['build'] - p['root']:.3f}, root {p['root']:.3f})"
                      + (f", import {info['import_s']:.3f} s" if "import_s" in info else "")
                      + f"; flushes {sizes}; "
                      + ", ".join(f"{name} {info[name]}" for name in
                                  ("attestations", "votes", "winners", "aggregates")
                                  if name in info)
                      + f"; completion offset {info['offset_s']:.3f} s, deadline misses "
                      f"{info['misses']:.0f}; {_total(fq)} field launches {fq}, {sha} SHA-256"
                      + (f"; import {_total(info['import_fq_launches'])} field, "
                         f"{info['import_sha256_launches']} SHA-256" if "import_s" in info
                         else "")
                      + f" [{card}]")
            out["slots"][slot] = row
    if not aggregates[slots[0]]:
        raise AssertionError(f"slot {slots[0]} published no aggregate")
    included = {att.encode(spec) for att in blocks[slots[1]].message.body.attestations}
    published = [sap.message.aggregate.encode(spec) for sap in aggregates[slots[0]]]
    if not all(a in included for a in published):
        raise AssertionError(f"slot {slots[1]}'s block misses slot {slots[0]}'s aggregates")
    print(f"slot {slots[1]}'s block carries all {len(published)} aggregates slot {slots[0]} "
          f"published ({len(included)} attestations); the head is slot {slots[-1]}'s block")

    # ---- the first slots' flushes again on the ladder, byte for byte
    resigned = [f for f in flushes if f[0] in slots[:RESIGN_SLOTS]]
    with _duty_sign(0):
        again, resign_s, resign_launches = _counted(
            lambda: [S.sign_batch(k, m, device=dev) for _, _, k, m, _ in resigned],
            "the duty flushes re-signed on the ladder")
    for (slot, phase, _, _, sigs), sigs_again in zip(resigned, again):
        if sigs_again != sigs:
            raise AssertionError(f"slot {slot} {phase}: the ladder's signatures != the walk's")
    every = [(k, m, sig) for _, _, ks, ms, sigs in flushes for k, m, sig in zip(ks, ms, sigs)]
    pick = np.linspace(0, len(every) - 1, RESIGN_SAMPLE).astype(int).tolist()
    if [api.sign(every[i][0], every[i][1]) for i in pick] != [every[i][2] for i in pick]:
        raise AssertionError("the walk's signatures != api.sign on a sample")
    print(f"{len(resigned)} of {len(flushes)} flushes (slots {slots[:RESIGN_SLOTS]}; "
          f"{[len(f[2]) for f in resigned]} signatures) signed again on the ladder "
          f"(DUTY_SIGN_MIN at 0): {resign_s:.3f} s, {_total(resign_launches)} field launches "
          f"{resign_launches}; every signature == the walk's, {RESIGN_SAMPLE} of all "
          f"{len(every)} == api.sign [{card}]")
    set_hash_backend(HashlibBackend())
    out.update(flushes=[(s, ph, len(k)) for s, ph, k, _, _ in flushes],
               resigned=len(resigned), resign_s=resign_s,
               resign_launches=resign_launches, duty_sign_min=S.DUTY_SIGN_MIN,
               seconds=time.perf_counter() - t_phase)
    record["duties"] = out


class _Unreadable:
    """An aggregation bit that raises ``TypeError`` when read: the malformed
    item of phase 3f's containment check (tests/test_torch_drain_containment.py
    builds the same)."""

    def __bool__(self):
        raise TypeError("unreadable aggregation bit")


def observability_phase(dev, record: dict, card: str, spec, store, drain: list,
                        head_3c: bytes, root_polarity: dict) -> None:
    """Phase 3f: the node's observability at 1,000,000 validators, on phase
    3c's store as phase 3e left it (two blocks past phase 3c's head).

    (a) A ``ConsensusForensics`` plane is attached and a cold ``get_head``
    forced (``store.bump()``): exactly one audit lands, its head the head,
    and a memo hit adds none; ``observe_transition(store, head_3c, head)``
    mints a depth-0 record whose common ancestor is phase 3c's head;
    ``observe_epoch`` returns the three participation flags; the
    ``forkchoice_view`` size is printed.  (b) The first OBS_DRAIN aggregates
    of phase 3c's drain are re-submitted with one ``new_trace`` each, on the
    cached body on the card (every field kernel launched, every verdict
    None): the recorder must hold one ``attestation_batch_verify`` span
    (``n`` and ``n_members`` OBS_DRAIN, 128 listed members, ``path``
    ``"cached"``), a ``verify`` event carrying its batch id and an ``apply``
    on every member; the forensics weight event carries the same batch id;
    the registry's ``attestation_admit_apply_seconds`` rose by OBS_DRAIN,
    the span's histogram by 1, ``gossip_batch_error_count`` by nothing.  The
    recorder's Chrome export lands in ``chiprun_out/trace_node.json``.  (c)
    OBS_CONTAIN of those aggregates, one with aggregation bits that raise
    ``TypeError`` when read: that item gets the contained ignore verdict,
    the rest None, ``gossip_batch_error_count{stage="item"}`` rises by 1.
    (d) The OBS_DRAIN drain warm, the median of ROUTE_REPS runs, with the
    registry, recorder and forensics plane on and traces minted, then with
    all three off and no traces; printed (not failed) beside the card's name
    and power limit with ``root_polarity``, phase 3's warm state root timed
    there in each polarity."""
    from lambda_ethereum_consensus_tpu_torch import fork_choice as FC
    from lambda_ethereum_consensus_tpu_torch import tracing
    from lambda_ethereum_consensus_tpu_torch.telemetry import get_metrics

    t_phase = time.perf_counter()
    out: dict = {}
    metrics = get_metrics()
    recorder = tracing.get_recorder()
    for plane in (metrics, recorder):
        if not plane.enabled:
            raise AssertionError("the registry and the recorder must be on (TELEMETRY_OFF set?)")

    # ---- (a) the audit of a forced cold walk, and the reorg record
    store.forensics = forensics = FC.ConsensusForensics()
    if not forensics.enabled:
        raise AssertionError("the forensics plane is off (FORENSICS_OFF set?)")
    store.bump()
    t0 = time.perf_counter()
    head = FC.get_head(store, spec)
    cold_s = time.perf_counter() - t0
    audits = forensics.stats()["rings"]["head_audit"]["appended_total"]
    audit = forensics.last_audit()
    t0 = time.perf_counter()
    again = FC.get_head(store, spec)
    memo_s = time.perf_counter() - t0
    if audits != 1 or audit["head"] != "0x" + head.hex() or again != head or \
            forensics.stats()["rings"]["head_audit"]["appended_total"] != 1:
        raise AssertionError(f"cold walk: {audits} audits, audit head {audit and audit['head']}, "
                             f"head {head.hex()}, memo hit {again.hex()}")
    reorg = forensics.observe_transition(store, head_3c, head)
    if reorg is None or reorg.depth != 0 or reorg.orphaned or \
            reorg.common_ancestor != "0x" + head_3c.hex():
        raise AssertionError(f"reorg record {reorg and reorg.to_dict()}")
    t0 = time.perf_counter()
    finality = forensics.observe_epoch(store, spec)
    epoch_s = time.perf_counter() - t0
    if finality is None or set(finality["participation"]) != {"source", "target", "head"}:
        raise AssertionError(f"finality sample {finality}")
    view = forensics.forkchoice_view(store, spec)
    view_bytes = len(json.dumps(view))
    print(f"forensics: cold get_head {cold_s:.3f} s, one audit ({len(audit['branch_points'])} "
          f"branch points, {len(audit['filtered_out'])} filtered out), a memo hit "
          f"{memo_s * 1e6:.1f} us and no audit; reorg record depth {reorg.depth}, common "
          f"ancestor phase 3c's head (slot {reorg.ancestor_slot}) -> slot {reorg.slot}; "
          f"observe_epoch {epoch_s:.3f} s: finality lag {finality['finality_lag_epochs']} "
          f"epochs, participation {finality['participation']}, "
          f"{len(finality['subnet_missing_votes'])} subnets; forkchoice_view "
          f"{len(view['nodes'])} nodes, {view_bytes} bytes of JSON")

    # ---- (b) the trace fan-in of one cached drain on the card
    sub = drain[:OBS_DRAIN]

    def hist_count(name: str, **labels) -> int:
        got = metrics.get_histogram(name, **labels)
        return 0 if got is None else got[3]

    def errors() -> float:
        return sum(metrics.get("gossip_batch_error_count", stage=stage)
                   for stage in ("item", "context"))

    span_labels = dict(n_devices=1, path="cached")
    before = (hist_count("attestation_admit_apply_seconds"),
              hist_count("attestation_batch_verify_seconds", **span_labels), errors())
    recorder.clear()
    traces = [tracing.new_trace("gossip_aggregate") for _ in sub]
    verdicts, fan_s, fan_launches = _counted(
        lambda: FC.on_attestation_batch(store, sub, spec=spec, traces=traces, device=dev),
        "traced fork-choice drain")
    for t in traces:
        t.end("done")
    if any(v is not None for v in verdicts):
        raise AssertionError("the traced drain rejected valid aggregates")
    snap = recorder.snapshot()
    spans = [ev for ev in snap if ev["kind"] == "span"]
    if len(spans) != 1 or spans[0]["name"] != "attestation_batch_verify":
        raise AssertionError(f"{len(spans)} batch spans in the recorder")
    args = spans[0]["args"]
    batch = spans[0]["trace_id"]
    if (args["n"], args["n_members"], len(args["members"]), args["path"]) != \
            (OBS_DRAIN, OBS_DRAIN, min(128, OBS_DRAIN), "cached"):
        raise AssertionError(f"the batch span's args {dict(args, members=len(args['members']))}")
    members = {t.trace_id for t in traces}
    verified = {ev["trace_id"] for ev in snap
                if ev["name"] == "verify" and ev["args"] == {"batch": batch, "path": "cached"}}
    applied = {ev["trace_id"] for ev in snap if ev["name"] == "apply"}
    if verified != members or applied != members:
        raise AssertionError(f"{len(verified)} members carry the batch id, {len(applied)} "
                             f"applied, of {len(members)}")
    weight = forensics._weight_events.list()[-1]
    if (weight["batch"], weight["path"], weight["n"]) != (batch, "cached", OBS_DRAIN):
        raise AssertionError(f"the forensics weight event {weight}")
    after = (hist_count("attestation_admit_apply_seconds"),
             hist_count("attestation_batch_verify_seconds", **span_labels), errors())
    if (after[0] - before[0], after[1] - before[1], after[2] - before[2]) != (OBS_DRAIN, 1, 0):
        raise AssertionError(f"registry before {before}, after {after}")
    chrome = recorder.chrome()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "trace_node.json").write_text(json.dumps(chrome))
    print(f"traced drain of {OBS_DRAIN} aggregates (cached body): {fan_s:.3f} s, "
          f"{_total(fan_launches)} field launches {fan_launches}; one batch span (batch "
          f"{batch}, {args['n_members']} members, {len(args['members'])} listed, "
          f"{spans[0]['dur_us']} us), every member's verify event carries it and applied; "
          f"the forensics weight event carries it; admit->apply +{OBS_DRAIN}, span +1, errors "
          f"+0; chiprun_out/trace_node.json: {len(chrome['traceEvents'])} events "
          f"({recorder.stats()['events']} ring entries)")

    # ---- (c) one malformed item contained on the card
    small = list(sub[:OBS_CONTAIN])
    bad = small[OBS_CONTAIN // 2]
    small[OBS_CONTAIN // 2] = bad.copy(
        aggregation_bits=[_Unreadable()] * len(bad.aggregation_bits))
    item_before = metrics.get("gossip_batch_error_count", stage="item")
    verdicts, contain_s, contain_launches = _counted(
        lambda: FC.on_attestation_batch(store, small, spec=spec, device=dev),
        "fork-choice drain with a malformed item")
    contained = verdicts[OBS_CONTAIN // 2]
    want = "attestation drain internal error: TypeError: unreadable aggregation bit"
    others = [v for i, v in enumerate(verdicts) if i != OBS_CONTAIN // 2]
    counted = metrics.get("gossip_batch_error_count", stage="item") - item_before
    if contained is None or str(contained) != want or contained.reject or \
            any(v is not None for v in others) or counted != 1:
        raise AssertionError(f"containment: {contained!r}, others {others}, counted {counted}")
    print(f"drain of {OBS_CONTAIN} with one malformed item (cached body): {contain_s:.3f} s; "
          f"that item ignored ({want!r}), the other {len(others)} None, "
          f"gossip_batch_error_count{{stage=item}} +1")

    # ---- (d) what the plane costs: the warm drain and the root, on and off
    def traced():
        ts = [tracing.new_trace("gossip_aggregate") for _ in sub]
        got = FC.on_attestation_batch(store, sub, spec=spec, traces=ts, device=dev)
        for t in ts:
            t.end("done")
        return _drain_verdicts(got)

    on_s, got_on = _median_run(traced)
    for plane in (metrics, recorder, forensics):
        plane.set_enabled(False)
    try:
        off_s, got_off = _median_run(lambda: _drain_verdicts(
            FC.on_attestation_batch(store, sub, spec=spec, device=dev)))
    finally:
        for plane in (metrics, recorder, forensics):
            plane.set_enabled(True)
    if got_on != got_off or any(v is not None for v in got_on):
        raise AssertionError("the drain's verdicts differ between the polarities")
    print(f"observability cost, drain of {OBS_DRAIN} aggregates warm (median of {ROUTE_REPS}): "
          f"on (registry, recorder, forensics, traces) {on_s:.4f} s, off {off_s:.4f} s "
          f"({(on_s - off_s) * 1e3:+.1f} ms) [{card}]")
    print(f"observability cost, phase 3's warm state root (one each, timed in phase 3): "
          f"ssz_hash_tree_root span on {root_polarity['on_s']:.4f} s, off "
          f"{root_polarity['off_s']:.4f} s ({(root_polarity['on_s'] - root_polarity['off_s']) * 1e3:+.1f} ms) "
          f"[{card}]")
    out.update(cold_get_head_s=cold_s, memo_get_head_s=memo_s, branch_points=len(audit["branch_points"]),
               filtered_out=len(audit["filtered_out"]), reorg=reorg.to_dict(), observe_epoch_s=epoch_s,
               finality=finality, view_nodes=len(view["nodes"]), view_bytes=view_bytes,
               traced_drain_s=fan_s, traced_launches=fan_launches, batch_span_us=spans[0]["dur_us"],
               trace_events=len(chrome["traceEvents"]), contain_s=contain_s,
               drain_on_s=on_s, drain_off_s=off_s, root_on_s=root_polarity["on_s"],
               root_off_s=root_polarity["off_s"], seconds=time.perf_counter() - t_phase)
    record["observability"] = out


# ---- the node's ingest path below the wire (phase 3g)

# verdict names of the gossip validator (ACCEPT re-propagates, REJECT
# penalizes the sender, IGNORE drops quietly)
ACCEPT, REJECT, IGNORE = "ACCEPT", "REJECT", "IGNORE"


class _LaneSource:
    """The node's handler around one of phase 3g's bodies: ``process(items)``
    makes it a lane source fed by direct submits (the blob lane), and
    ``handle(batch)`` a ``TopicSubscription``'s handler, which takes the
    decoded ``GossipMessage``s of one lane flush, runs ``body`` over
    ``extract(message)`` of each and returns the verdict codes the
    subscription sends back to the sidecar.  Each flush's size and verdicts
    are recorded; a wire flush also records its members, their message ids
    and its field launches (the counters read around ``body``, which runs
    to its end without yielding the event loop).  The three bodies below
    are phase 3g's copies of ``node/node.py``'s, so that phase holds the
    path below the node item by item (adversaries submitted straight into
    a lane); phase 3i drives the node's own."""

    def __init__(self, body, extract=None):
        self.body = body
        self.extract = extract
        self.flushes: list = []

    async def process(self, items):
        self.flushes.append(dict(size=len(items), verdicts=self.body(items)))

    async def handle(self, batch):
        from lambda_ethereum_consensus_tpu_torch.network import port as P

        codes = {ACCEPT: P.VERDICT_ACCEPT, REJECT: P.VERDICT_REJECT, IGNORE: P.VERDICT_IGNORE}
        items = [self.extract(m) for m in batch]
        _sync()
        before = _launches()
        t0 = time.perf_counter()
        _IN_BODY[0] = True
        try:
            verdicts = self.body(items)
            _sync()
        finally:
            _IN_BODY[0] = False
        t1 = time.perf_counter()
        after = _launches()
        self.flushes.append(dict(size=len(items), verdicts=verdicts, members=items,
                                 msg_ids=[m.msg_id for m in batch], body=(t0, t1),
                                 fq_launches={k: after[k] - before[k] for k in after}))
        return [codes[v] for v in verdicts]


def _block_body(store, pending, spec):
    """``node.py:726-764`` ``_on_block_batch``: the one-epoch window, then
    ``pending.add_block``."""
    def body(blocks):
        verdicts = []
        head_slot = store.current_slot(spec)
        for block in blocks:
            if abs(block.message.slot - head_slot) <= spec.SLOTS_PER_EPOCH:
                pending.add_block(block)
                verdicts.append(ACCEPT)
            else:
                verdicts.append(IGNORE)
        return verdicts

    return body


def _blob_body(da, setup, spec, dev, linkages: list, folds: list):
    """``node.py:890-958`` ``_blob_sidecar_drain`` over ``(subnet, sidecar)``
    items: structural REJECTs, the linkage pre-check, one
    ``verify_blob_batch`` per flush on the card and per-item blame only when
    the fold fails, then ``da.on_sidecar`` mapped to verdicts (each linkage
    appended to ``linkages`` by position, each fold's size to ``folds``)."""
    from lambda_ethereum_consensus_tpu_torch.da import kzg as K
    from lambda_ethereum_consensus_tpu_torch.telemetry import inc

    max_blobs = int(spec.get("MAX_BLOBS_PER_BLOCK", 6))
    subnet_count = int(spec.get("BLOB_SIDECAR_SUBNET_COUNT", 6))

    def body(tagged):
        verdicts = [None] * len(tagged)
        items = []  # (pos, root, sidecar)
        for pos, (subnet, sc) in enumerate(tagged):
            index = int(sc.index)
            if index >= max_blobs or index % subnet_count != subnet:
                verdicts[pos] = REJECT
                continue
            root = sc.signed_block_header.message.hash_tree_root(spec)
            expected = da.expected_commitment(root, index)
            if expected is not None and expected != bytes(sc.kzg_commitment):
                inc("da_sidecars_total", 1, result="mismatch")
                verdicts[pos] = REJECT
                continue
            items.append((pos, root, sc))
        if items:
            blobs = [bytes(sc.blob) for _, _, sc in items]
            comms = [bytes(sc.kzg_commitment) for _, _, sc in items]
            proofs = [bytes(sc.kzg_proof) for _, _, sc in items]
            folds.append(len(items))
            if K.verify_blob_batch(blobs, comms, proofs, setup, device=dev):
                ok = [True] * len(items)
            else:
                ok = [K.verify_blob_proof(b, c, p, setup) for b, c, p in zip(blobs, comms, proofs)]
            for (pos, root, sc), valid in zip(items, ok):
                if not valid:
                    verdicts[pos] = REJECT
                    continue
                linkage = da.on_sidecar(root, int(sc.index), bytes(sc.kzg_commitment))
                linkages.append((pos, linkage))
                if linkage == "mismatch":
                    verdicts[pos] = REJECT
                elif linkage == "duplicate":
                    verdicts[pos] = IGNORE
                else:
                    verdicts[pos] = ACCEPT
        return [IGNORE if v is None else v for v in verdicts]

    return body


def _aggregate_body(store, spec, dev, results: list):
    """``node.py:766-796`` (``_attestation_drain``): one
    ``on_attestation_batch`` per flush, errors mapped to REJECT or IGNORE
    (the drain's results appended to ``results``)."""
    from lambda_ethereum_consensus_tpu_torch import fork_choice as FC

    def body(aggregates):
        got = FC.on_attestation_batch(store, list(aggregates), is_from_block=False, spec=spec,
                                      device=dev)
        results.extend(got)
        return [ACCEPT if e is None else (REJECT if getattr(e, "reject", False) else IGNORE)
                for e in got]

    return body


def _ingest_scheduler():
    """The node's lane table (``node.py:654-705``) with ``NodeConfig``'s
    deadlines and budget."""
    from lambda_ethereum_consensus_tpu_torch.fork_choice import attestation_batch_target
    from lambda_ethereum_consensus_tpu_torch.pipeline import IngestScheduler, LaneConfig

    att_deadline = INGEST_ATT_MS / 1000.0
    att_target = min(attestation_batch_target(), 8192)
    sched = IngestScheduler(max_items=INGEST_MAX_ITEMS)
    sched.add_lane(LaneConfig(name="block", priority=0, weight=64, max_batch=64, max_queue=1024,
                              deadline_s=INGEST_BLOCK_MS / 1000.0, coalesce_target=1,
                              shed_newest=True))
    sched.add_lane(LaneConfig(name="blob", priority=1, weight=64, max_batch=64, max_queue=1024,
                              deadline_s=INGEST_BLOB_MS / 1000.0, coalesce_target=N_BLOBS,
                              shed_newest=True))
    for name, priority in (("aggregate", 2), ("subnet", 3)):
        sched.add_lane(LaneConfig(name=name, priority=priority, weight=4096, max_batch=8192,
                                  max_queue=16384, deadline_s=att_deadline,
                                  coalesce_target=att_target))
    sched.add_lane(LaneConfig(name="other", priority=4, weight=64, max_batch=64, max_queue=1024,
                              deadline_s=0.2, coalesce_target=16))
    return sched


async def _wire_pair(digest: bytes, ports: list, wire: str | None = None,
                     senders: int = 1) -> tuple:
    """A receiver and ``senders`` sender ports on loopback under ``digest``
    on ``wire`` (None: the bespoke sidecar), each sender dialling the
    receiver (each ``Port`` appended to ``ports`` as it starts, for the
    caller to close; the senders start together): (senders, receiver,
    seconds)."""
    from lambda_ethereum_consensus_tpu_torch.network import Port

    seconds = {}
    t0 = time.perf_counter()
    receiver = await Port.start(fork_digest=digest, wire=wire)
    ports.append(receiver)
    seconds["receiver_start_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    started = await asyncio.gather(*(Port.start(fork_digest=digest, wire=wire)
                                     for _ in range(senders)), return_exceptions=True)
    ports.extend(p for p in started if not isinstance(p, BaseException))
    for p in started:
        if isinstance(p, BaseException):
            raise p
    seconds["sender_start_s"] = time.perf_counter() - t0
    connected = []
    for sender in started:
        fut = asyncio.get_running_loop().create_future()
        sender.on_new_peer = functools.partial(
            lambda f, pid, addr: f.done() or f.set_result(pid), fut)
        connected.append(fut)
    t0 = time.perf_counter()
    await asyncio.gather(*(s.add_peer(f"127.0.0.1:{receiver.listen_port}") for s in started))
    if any(pid != receiver.node_id for pid in
           await asyncio.wait_for(asyncio.gather(*connected), 30)):
        raise AssertionError("a sender connected to another node")
    seconds["connect_s"] = time.perf_counter() - t0
    return list(started), receiver, seconds


async def _announced(sender, receiver, topics: list, limit_s: float = 30.0) -> None:
    """Wait until the sender's sidecar has heard the receiver subscribe to
    every one of ``topics`` (a publish routes to announced subscribers)."""
    peer = receiver.node_id.hex()
    t_end = time.perf_counter() + limit_s
    while True:
        stats = await sender.get_gossip_stats()
        if set(topics) <= set(stats["peers"].get(peer, {}).get("topics", ())):
            return
        if time.perf_counter() > t_end:
            raise AssertionError(f"the receiver's subscriptions never reached the sender: {stats}")
        await asyncio.sleep(0.01)


def _check_flushes(flushes: list, store, spec, dev) -> None:
    """Each wire flush's field launches equal a direct drain of its members,
    every member valid (its ``direct_launches`` recorded)."""
    from lambda_ethereum_consensus_tpu_torch import fork_choice as FC

    for f in flushes:
        _zero_fq_launches()
        _sync()
        again = FC.on_attestation_batch(store, f["members"], spec=spec, device=dev)
        _sync()
        f["direct_launches"] = _launches()
        if f["fq_launches"] != f["direct_launches"] or \
                _drain_verdicts(again) != [None] * f["size"]:
            raise AssertionError(f"a flush of {f['size']}: launches {f['fq_launches']} != "
                                 f"a direct drain's {f['direct_launches']}")


def _wire_codes(direct: list) -> list:
    """The verdict code the host sends the sidecar for each direct-drain
    result."""
    from lambda_ethereum_consensus_tpu_torch.network.port import (
        VERDICT_ACCEPT, VERDICT_IGNORE, VERDICT_REJECT,
    )

    return [VERDICT_ACCEPT if e is None else
            (VERDICT_REJECT if getattr(e, "reject", False) else VERDICT_IGNORE) for e in direct]


def _check_arrivals(ids: list, direct: list, verdicts: dict, src: _LaneSource, results: list,
                    what: str) -> None:
    """Every message of ``ids`` arrived once through ``src``'s flushes and
    got one verdict, the direct drain's code for its aggregate, and the
    lane's drain results equal the direct drain's."""
    index = {msg_id: i for i, msg_id in enumerate(ids)}
    codes = _wire_codes(direct)
    arrived = [msg_id for f in src.flushes for msg_id in f["msg_ids"]]
    if len(index) != len(ids) or sorted(arrived, key=lambda m: index.get(m, -1)) != ids or \
            verdicts != {m: [codes[index[m]]] for m in ids} or \
            _drain_verdicts(results) != _drain_verdicts([direct[index[m]] for m in arrived]):
        raise AssertionError(f"{what}: {len(arrived)} of {len(ids)} arrived, "
                             f"{len(verdicts)} verdicts, not the direct drain's")


async def _negotiated_muxer(port) -> str:
    """The muxer a port ``Libp2pHost`` in this process negotiates when it
    dials ``port``'s libp2p sidecar (the sidecars run the same host)."""
    from lambda_ethereum_consensus_tpu_torch.network.libp2p import Libp2pHost

    probe = Libp2pHost()
    try:
        peer = await probe.dial("127.0.0.1", port.listen_port)
        return type(probe.connections[peer].muxer).__name__
    finally:
        await probe.close()


def _arrivals(port, topic: str) -> dict:
    """Records when each message of ``topic`` reaches ``port``'s handler:
    ``{msg_id: perf_counter}``."""
    got: dict = {}
    inner = port.gossip_handlers[topic]

    async def handler(*args):
        got.setdefault(args[1], time.perf_counter())
        value = inner(*args)
        if asyncio.iscoroutine(value):
            await value

    port.gossip_handlers[topic] = handler
    return got


async def _observer(receiver, topic: str, limit_s: float = 30.0) -> tuple:
    """A port ``Libp2pHost`` and ``Gossipsub`` in this process, dialled into
    ``receiver``'s libp2p sidecar and subscribed to ``topic``, recording
    when each message reaches it (``{msg_id: perf_counter}``) and accepting
    it: (host, router, record), once the receiver's sidecar holds it in its
    ``topic`` mesh.  The sidecar forwards a message to its mesh only when
    its own validator returned ACCEPT, and returns IGNORE for a verdict
    that came after ``VALIDATION_TIMEOUT_S``, so the record holds what the
    sidecar applied, not what the host sent."""
    from lambda_ethereum_consensus_tpu_torch.network.libp2p import Libp2pHost
    from lambda_ethereum_consensus_tpu_torch.network.libp2p.gossipsub import ACCEPT, Gossipsub

    got: dict = {}

    async def validator(_topic, _data, msg_id, _peer):
        got.setdefault(msg_id, time.perf_counter())
        return ACCEPT

    host = Libp2pHost()
    router = Gossipsub(host, validator=validator)
    try:
        router.start()
        await host.dial("127.0.0.1", receiver.listen_port)
        await router.subscribe(topic)
        me, t_end = host.peer_id.bytes.hex(), time.perf_counter() + limit_s
        while me not in (await receiver.get_gossip_stats())["mesh"].get(topic, ()):
            if time.perf_counter() > t_end:
                raise AssertionError(f"the observer never joined the receiver's {topic} mesh")
            await asyncio.sleep(0.02)
    except BaseException:
        await router.stop()
        await host.close()
        raise
    return host, router, got


def _cpu_seconds(pid: int | str = "self") -> dict:
    """User + system CPU seconds of each thread of process ``pid``, by
    thread id, from ``/proc`` (empty where it cannot be read)."""
    out = {}
    tick = os.sysconf("SC_CLK_TCK")
    try:
        for tid in os.listdir(f"/proc/{pid}/task"):
            with open(f"/proc/{pid}/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            out[int(tid)] = (int(fields[11]) + int(fields[12])) / tick
    except OSError:
        pass
    return out


# set while a _LaneSource runs its drain body (which holds the event loop by
# design), so that _stalls samples only the other stalls
_IN_BODY = [False]


@contextlib.asynccontextmanager
async def _stalls(pids: dict, step_s: float = 0.005, floor_s: float = 0.02,
                  dump_s: float = 0.3, sample_s: float = 0.02):
    """While the block runs: this event loop's stalls (a ``step_s`` sleep
    that returned ``floor_s`` or more late: ``(start perf_counter,
    seconds)``); the main thread's stack, sampled every ``sample_s`` by a
    thread of its own while the loop has not ticked for ``dump_s`` outside
    a drain body (``samples``: ``(perf_counter, frames innermost first)``,
    each stack once), and that thread's waits past 0.1 s (``gil_waits``:
    it needs the GIL, so a long wait is the GIL held in C code); this
    process's garbage collections (``(start, seconds, generation)``); and
    the CPU seconds of this process's threads (by name) and of the
    processes in ``pids`` (name -> pid)."""
    import gc
    import traceback

    rec: dict = dict(stalls=[], gc=[], threads={}, processes={}, samples=[], gil_waits=[])
    started: list = []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            t0 = started.pop()
            rec["gc"].append((t0, time.perf_counter() - t0, info["generation"]))

    tick = [time.perf_counter()]
    done = threading.Event()
    main = threading.main_thread().ident

    def sampler():
        seen = set()
        t_last = time.perf_counter()
        while not done.wait(sample_s):
            now = time.perf_counter()
            if now - t_last > 0.1 + sample_s:
                rec["gil_waits"].append((t_last, now - t_last))
            t_last = now
            if now - tick[0] < dump_s or _IN_BODY[0]:
                continue
            frame = sys._current_frames().get(main)
            if frame is None:
                continue
            stack = tuple(f"{Path(fs.filename).name}:{fs.lineno} {fs.name}"
                          for fs in reversed(traceback.extract_stack(frame)))
            if stack not in seen and len(seen) < 8:
                seen.add(stack)
                rec["samples"].append((now, list(stack)))

    async def watch():
        while True:
            t0 = tick[0] = time.perf_counter()
            await asyncio.sleep(step_s)
            late = time.perf_counter() - t0 - step_s
            if late >= floor_s:
                rec["stalls"].append((t0 + step_s, late))

    cpu0 = _cpu_seconds()
    proc0 = {name: sum(_cpu_seconds(pid).values()) for name, pid in pids.items()}
    gc.callbacks.append(on_gc)
    task = asyncio.ensure_future(watch())
    thread = threading.Thread(target=sampler, name="stall-sampler", daemon=True)
    thread.start()
    try:
        yield rec
    finally:
        task.cancel()
        done.set()
        thread.join()
        gc.callbacks.remove(on_gc)
        names = {t.native_id: t.name for t in threading.enumerate()}
        for tid, sec in _cpu_seconds().items():
            used = sec - cpu0.get(tid, 0.0)
            if used >= 0.01:
                name = names.get(tid, f"thread {tid}")
                rec["threads"][name] = rec["threads"].get(name, 0.0) + used
        rec["processes"] = {name: sum(_cpu_seconds(pid).values()) - proc0[name]
                            for name, pid in pids.items()}


async def _libp2p_leg(sched, src: _LaneSource, store, spec, chain, digest: bytes, topic: str,
                      aggregates: list, stored: bytes, slot: int, root: bytes, begin, end,
                      shapes) -> dict:
    """Phase 3g's libp2p leg on the phase's store and ingest scheduler: a
    receiver ``Port`` on the libp2p wire, its ``topic`` subscription in the
    aggregate lane feeding ``src``, and LIBP2P_PEERS sender ports dialled in
    and announced; the muxer negotiated with the receiver's sidecar; an
    :func:`_observer` in the receiver's mesh; the stored block by range and
    by root from a sender's ``ReqRespServer`` over ``chain``, byte for
    byte; then ``aggregates`` as ``SignedAggregateAndProof``s, each sender
    publishing its share, all at once, until every message has a verdict
    and the lane is empty, and the observer has every message the sidecar
    accepted (a bounded wait).  During the burst, :func:`_stalls` records
    this event loop's stalls, garbage collections and CPU seconds beside
    the receiver sidecar's, and the spy each verdict's completion."""
    from lambda_ethereum_consensus_tpu_torch.compression import compress as snappy_compress
    from lambda_ethereum_consensus_tpu_torch.network.gossip import TopicSubscription
    from lambda_ethereum_consensus_tpu_torch.network.libp2p.gossipsub import eth2_msg_id
    from lambda_ethereum_consensus_tpu_torch.network.peerbook import Peerbook
    from lambda_ethereum_consensus_tpu_torch.network.port import VERDICT_ACCEPT, VERDICT_IGNORE
    from lambda_ethereum_consensus_tpu_torch.network.reqresp import (
        BlockDownloader, ReqRespServer,
    )
    from lambda_ethereum_consensus_tpu_torch.types.validator import (
        AggregateAndProof, SignedAggregateAndProof,
    )

    leg: dict = {}
    ports: list = []
    observer = None
    t_leg = time.perf_counter()
    try:
        t0 = time.perf_counter()
        senders, receiver, leg["pair"] = await _wire_pair(digest, ports, wire="libp2p",
                                                          senders=LIBP2P_PEERS)
        leg["muxer"] = await _negotiated_muxer(receiver)
        if leg["muxer"] != "Yamux":
            raise AssertionError(f"the libp2p sidecar negotiated {leg['muxer']}, not yamux")
        spy = _spy_verdicts(receiver)
        sub = TopicSubscription(receiver, topic, src.handle, ssz_type=SignedAggregateAndProof,
                                spec=spec, scheduler=sched, lane="aggregate")
        await sub.start()
        arrivals = _arrivals(receiver, topic)
        await ReqRespServer(senders[0], chain, spec).register()
        await asyncio.gather(*(_announced(s, receiver, [topic]) for s in senders))
        observer = await _observer(receiver, topic)
        leg["setup_s"] = time.perf_counter() - t0
        # the stored block over req/resp on the libp2p pair
        peers = Peerbook()
        peers.add_peer(senders[0].node_id)
        downloader = BlockDownloader(receiver, peers, spec)
        for name, request in (("range", lambda: downloader.request_blocks_by_range(slot, 1)),
                              ("root", lambda: downloader.request_blocks_by_root([root]))):
            t0 = time.perf_counter()
            answer = await request()
            leg[f"by_{name}_s"] = time.perf_counter() - t0
            if [b.encode(spec) for b in answer] != [stored]:
                raise AssertionError(f"libp2p blocks by {name}: {len(answer)} blocks, not the "
                                     f"stored block")
        # the aggregates, each sender its share, all published at once
        payloads = [snappy_compress(SignedAggregateAndProof(message=AggregateAndProof(
            aggregator_index=i, aggregate=agg)).encode(spec)) for i, agg in enumerate(aggregates)]
        leg["ids"] = [eth2_msg_id(topic, p) for p in payloads]
        share = len(payloads) // len(senders)
        spy.clear()
        t0 = begin()
        async with _stalls({"receiver sidecar": receiver._proc.pid}) as probe:
            t_pub = time.perf_counter()
            with shapes():
                await asyncio.gather(*(senders[i // share].publish(topic, p)
                                       for i, p in enumerate(payloads)))
                leg["publish_s"] = time.perf_counter() - t_pub
                await _verdicts_in(spy, len(payloads), sched, "the libp2p aggregates")
            leg["last_verdict_s"] = max(ts for got in spy.values() for _, ts in got) - t_pub
        end("libp2p aggregates", t0)
        # what the sidecar applied: every message it accepted reaches the
        # observer; a verdict past VALIDATION_TIMEOUT_S never does
        accepted = sum(got[0][0] == VERDICT_ACCEPT for got in spy.values())
        t_end = time.perf_counter() + OBSERVER_WAIT_S
        while len(observer[2]) < accepted and time.perf_counter() < t_end:
            await asyncio.sleep(0.02)
        leg["applied"] = {m: VERDICT_ACCEPT if m in observer[2] else VERDICT_IGNORE
                          for m in leg["ids"]}
        leg["verdicts"] = {k: [v for v, _ in got] for k, got in spy.items()}
        leg["waits"] = sorted(spy[m][0][1] - arrivals[m] for m in leg["ids"])
        # per flush: its verdict loop (first to last verdict done), and where
        # the host stalled
        loops = [(min(spy[m][0][1] for m in f["msg_ids"]), max(spy[m][0][1] for m in f["msg_ids"]))
                 for f in src.flushes]
        leg["verdict_loops"] = [(a - t_pub, b - a) for a, b in loops]
        bodies = [f["body"] for f in src.flushes]
        leg["probe"] = dict(
            stalls=[(t - t_pub, d) for t, d in probe["stalls"]
                    if not any(a - 0.01 <= t and t + d <= b + 0.05 for a, b in bodies)],
            # the main thread's stacks in stalls of 0.3 s or more outside a
            # drain body, innermost frames first
            samples=[(t - t_pub, frames[:14]) for t, frames in probe["samples"]],
            gil_waits=[(t - t_pub, d) for t, d in probe["gil_waits"]],
            gc=dict(collections=len(probe["gc"]), seconds=sum(d for _, d, _ in probe["gc"]),
                    max_s=max((d for _, d, _ in probe["gc"]), default=0.0)),
            threads=dict(sorted(probe["threads"].items(), key=lambda kv: -kv[1])[:6]),
            processes=probe["processes"])
        # per flush: which senders its members came from, and how far apart
        # they arrived
        sender_of = {m: i // share for i, m in enumerate(leg["ids"])}
        leg["flush_senders"] = [sorted(sender_of[m] for m in f["msg_ids"]) for f in src.flushes]
        leg["arrival_spread_s"] = [max(arrivals[m] for m in f["msg_ids"])
                                   - min(arrivals[m] for m in f["msg_ids"]) for f in src.flushes]
        leg["stats"] = await receiver.get_gossip_stats()
        await sub.stop()
    finally:
        t0 = time.perf_counter()
        if observer is not None:
            await observer[1].stop()
            await observer[0].close()
        for port in ports:
            await port.close()
        leg["close_s"] = time.perf_counter() - t0
    leg["seconds"] = time.perf_counter() - t_leg
    return leg


def _spy_verdicts(port) -> dict:
    """Records every verdict ``port`` sends to its sidecar, once the sidecar
    took it: ``{msg_id: [(verdict, perf_counter)]}``."""
    got: dict = {}
    real = port.validate_message

    async def validate_message(msg_id, verdict):
        await real(msg_id, verdict)
        got.setdefault(msg_id, []).append((verdict, time.perf_counter()))

    port.validate_message = validate_message
    return got


async def _verdicts_in(spy: dict, n: int, sched, what: str, limit_s: float = 300.0) -> None:
    """Wait until ``spy`` holds ``n`` message ids and the scheduler holds
    nothing queued or in flight; raise what ended the drain loop, if it
    ended."""
    t_end = time.perf_counter() + limit_s
    while len(spy) < n or sched.depth or sched._inflight:
        if sched._task is None or sched._task.done():
            await sched.stop()  # raises what ended the drain loop
            raise AssertionError("the ingest drain loop ended")
        if time.perf_counter() > t_end:
            raise AssertionError(f"{what}: {len(spy)} of {n} verdicts after {limit_s} s")
        await asyncio.sleep(0.001)


async def _flushed(sched, source: _LaneSource, flushes: int) -> None:
    """Wait until ``source`` has taken ``flushes`` flushes and the
    scheduler holds nothing queued or in flight."""
    while len(source.flushes) < flushes or sched.depth or sched._inflight:
        if sched._task is None or sched._task.done():
            await sched.stop()  # raises what ended the drain loop
            raise AssertionError("the ingest drain loop ended")
        await asyncio.sleep(0.001)


@contextlib.contextmanager
def _path_shapes(fq_hist: Counter, sha_hist: Counter):
    """Adds the lane count of each field launch (by kernel) to ``fq_hist``
    and the node count of each SHA-256 launch to ``sha_hist`` while
    active."""
    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops

    with _recording(BP, "_launch", _fq_lanes) as fq, \
            _recording(sops, "sha256_nodes", lambda blocks: int(blocks.shape[0])) as sha:
        yield
    fq_hist.update(fq)
    sha_hist.update(sha)


def _sidecar_maker(spec, signed, blobs):
    """``sidecar(index, commitment, proof)`` -> ``(subnet, BlobSidecar)`` of
    blob ``index`` under ``signed``'s header."""
    from lambda_ethereum_consensus_tpu_torch.types import (
        BeaconBlockHeader, SignedBeaconBlockHeader,
    )
    from lambda_ethereum_consensus_tpu_torch.types.deneb import BlobSidecar

    block = signed.message
    header = SignedBeaconBlockHeader(
        message=BeaconBlockHeader(slot=block.slot, proposer_index=block.proposer_index,
                                  parent_root=block.parent_root, state_root=block.state_root,
                                  body_root=block.body.hash_tree_root(spec)),
        signature=signed.signature)
    subnets = int(spec.get("BLOB_SIDECAR_SUBNET_COUNT", 6))

    def sidecar(index, commitment, proof):
        return (index % subnets, BlobSidecar(index=index, blob=blobs[index],
                                              kzg_commitment=commitment, kzg_proof=proof,
                                              signed_block_header=header))

    return sidecar


def _blob_sidecars(spec, signed, blobs, commitments, proofs) -> tuple[list, list]:
    """The block's six sidecars, each on its subnet, and the three
    adversaries, interleaved: ``[(subnet, sidecar)]`` and what each must
    get, ``[(verdict, linkage or None)]``."""
    sidecar = _sidecar_maker(spec, signed, blobs)
    honest = [sidecar(i, commitments[i], proofs[i]) for i in range(len(blobs))]
    swapped = sidecar(0, commitments[0], proofs[1])  # REJECT once the fold fails
    mismatch = sidecar(2, commitments[3], proofs[3])  # REJECT by the pre-check
    items = [honest[0], honest[1], swapped, honest[2], mismatch, honest[3], honest[4],
             honest[4], honest[5]]
    want = [(ACCEPT, "accept"), (ACCEPT, "accept"), (REJECT, None), (ACCEPT, "accept"),
            (REJECT, None), (ACCEPT, "accept"), (ACCEPT, "accept"), (IGNORE, "duplicate"),
            (ACCEPT, "complete")]
    return items, want


def _wire_versions() -> str:
    """The versions of the sidecar's two imports on this machine."""
    import cryptography
    import google.protobuf

    return f"protobuf {google.protobuf.__version__}, cryptography {cryptography.__version__}"


def _yaml_check(spec_fn) -> str:
    """``config.load_config_file`` on this machine: the overlay of
    ``tests/test_torch_ssz.py``'s parity test loaded through the port where
    ``yaml`` imports, else ``"yaml absent"``."""
    import tempfile

    from lambda_ethereum_consensus_tpu_torch.config import load_config_file

    try:
        import yaml  # noqa: F401
    except ImportError:
        return "yaml absent"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "devnet.yaml")
        with open(path, "w") as f:
            f.write("PRESET_BASE: minimal\nCONFIG_NAME: devnet\nSECONDS_PER_SLOT: 3\n"
                    "GENESIS_FORK_VERSION: 0x10000038\n")
        got = load_config_file(path)
    want = dict(spec_fn())
    want.update(PRESET_BASE="minimal", CONFIG_NAME="devnet", SECONDS_PER_SLOT=3,
                GENESIS_FORK_VERSION=bytes.fromhex("10000038"))
    if got.name != "devnet" or dict(got) != want:
        raise AssertionError(f"load_config_file: {got.name}, "
                             f"{ {k: v for k, v in dict(got).items() if want.get(k) != v} }")
    return f"yaml {yaml.__version__}: the devnet overlay loaded, == minimal + overlay"


def ingest_phase(dev, record: dict, card: str, spec, store, drain: list, start_sks: dict,
                 keys: list[int], setup, blobs: list, commitments: list,
                 proofs: list) -> tuple[Counter, Counter]:
    """Phase 3g: the node's ingest path below the wire at 1,000,000
    validators, on phase 3c's store as the phases after it left it.

    An ``IngestScheduler`` with the node's lane table, three handlers after
    the node's bodies (:class:`_LaneSource`), a ``DataAvailability`` gate, a
    ``PendingBlocks`` scan on the card whose ``on_applied`` writes the block
    and its post-state to a ``BlockStore`` and a ``StateStore`` over a native
    ``KvStore`` in a temporary directory (deleted after), and the wire: two
    port sidecars on loopback under the head state's fork digest, the
    receiver's ``TopicSubscription``s for ``beacon_block`` and
    ``beacon_aggregate_and_proof`` feeding the block and aggregate lanes, the
    sender's ``ReqRespServer`` answering from the store through the node's
    ``LiveChainView``.
    In order: the block of the next slot on the head, signed by
    ``DutyScheduler.produce_block`` as phase 3e's proposals are; ``da.expect``
    of phase 8's six commitments and their versioned hashes; the block
    published over the wire, through the block lane, and a scan, which must
    park it; the six sidecars and three
    adversaries (a swapped proof, a commitment the block did not advertise,
    a duplicate) submitted straight into the blob lane in one flush (over
    the wire the sidecar's seen cache would drop the duplicate before the
    gate), each verdict held, the sixth honest one ``"complete"``; a second
    scan, which applies the block with ``on_block`` on the card and stores
    it; the block back from the sender by range and by root, equal to the
    stored bytes; the first INGEST_AGGREGATES of phase 3c's drain, directly
    through ``on_attestation_batch``, then published over the wire and
    flushed by the aggregate lane as they arrive (per message: one verdict,
    the direct drain's; per flush: the field launches of a direct drain of
    its members); then ``barrier()``, close, reopen (the WAL replayed) and
    ``get_latest_verified_state``, which must return the block's root and a
    state whose root on the SHA-256 kernel equals the block's
    ``state_root`` and the store's.  Between the aggregates and the barrier
    runs the libp2p leg (:func:`_libp2p_leg`) on the same store and
    scheduler, held as the bespoke step is.  Every step's seconds and launches are
    printed beside the card's name and power limit, with the wire's times,
    the WAL bytes, the flushes by cause, the batch sizes and the peak device
    memory.  Returns
    the path's field launches by (kernel, lanes) and its SHA-256 launches by
    nodes (the lanes, the scans and the resume; not the direct drain), for
    phase 9."""
    import tempfile

    from lambda_ethereum_consensus_tpu_torch import fork_choice as FC
    from lambda_ethereum_consensus_tpu_torch.config import minimal_spec
    from lambda_ethereum_consensus_tpu_torch.da import DataAvailability
    from lambda_ethereum_consensus_tpu_torch.compression import compress as snappy_compress
    from lambda_ethereum_consensus_tpu_torch.da import kzg as K
    from lambda_ethereum_consensus_tpu_torch.network.gossip import (
        TopicSubscription, publish_ssz, topic_name,
    )
    from lambda_ethereum_consensus_tpu_torch.network.peerbook import Peerbook
    from lambda_ethereum_consensus_tpu_torch.network.port import VERDICT_ACCEPT
    from lambda_ethereum_consensus_tpu_torch.network.reqresp import BlockDownloader, ReqRespServer
    from lambda_ethereum_consensus_tpu_torch.network.sidecar import _msg_id
    from lambda_ethereum_consensus_tpu_torch.node import PendingBlocks
    from lambda_ethereum_consensus_tpu_torch.node import pending_blocks as PB
    from lambda_ethereum_consensus_tpu_torch.node.chain import LiveChainView
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops
    from lambda_ethereum_consensus_tpu_torch.state_transition import misc
    from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut
    from lambda_ethereum_consensus_tpu_torch.store import BlockStore, KvStore, StateStore
    from lambda_ethereum_consensus_tpu_torch.store import block_store
    from lambda_ethereum_consensus_tpu_torch.telemetry import get_metrics
    from lambda_ethereum_consensus_tpu_torch.types import BeaconState, SignedBeaconBlock
    from lambda_ethereum_consensus_tpu_torch.types.validator import (
        AggregateAndProof, SignedAggregateAndProof,
    )
    from lambda_ethereum_consensus_tpu_torch.validator import DutyScheduler, proposer_index_at_slot

    t_phase = time.perf_counter()
    _reset_peak()
    sops.install_device_backend(dev)
    metrics = get_metrics()
    out: dict = {}
    steps: dict = {}
    fq_hist, sha_hist = Counter(), Counter()

    def begin():
        _zero_fq_launches()
        sops.sha256_kernel_launches = 0
        _sync()
        return time.perf_counter()

    def end(name: str, t0: float, **extra) -> dict:
        _sync()
        steps[name] = dict(seconds=time.perf_counter() - t0, fq_launches=_launches(),
                           sha256_launches=sops.sha256_kernel_launches, **extra)
        return steps[name]

    # ---- the block of the next slot on the head, signed as phase 3e's are
    head = FC.get_head(store, spec)
    state = store.block_states[head]
    slot = int(state.slot) + 1
    proposer = proposer_index_at_slot(BeaconStateMut(state), slot, spec)
    secret = (start_sks.get(proposer) or keys[proposer % REGISTRY_KEYS]).to_bytes(32, "big")
    if store.current_slot(spec) < slot:
        FC.on_tick(store, store.genesis_time + slot * spec.SECONDS_PER_SLOT, spec)
    t0 = begin()
    signed, _post = DutyScheduler({proposer: secret}, spec, device=dev).produce_block(state, slot)
    end("produce_block", t0)
    root = signed.message.hash_tree_root(spec)
    items, want = _blob_sidecars(spec, signed, blobs, commitments, proofs)
    if any(sc.signed_block_header.message.hash_tree_root(spec) != root for _, sc in items):
        raise AssertionError("a sidecar's header does not root to the block")

    da = DataAvailability(spec)
    linkages: list = []
    results: list = []
    applied: list = []
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ingest_", dir=str(ROOT / "chiprun_out"))
    wal = os.path.join(tmp, "beacon.wal")
    kv = KvStore(wal)
    if not kv.native:
        raise AssertionError("the store did not open the native engine")
    blocks_db, states_db = BlockStore(kv), StateStore(kv)
    put_s = [0.0]
    real_put = kv.put

    def timed_put(key, value):
        t = time.perf_counter()
        real_put(key, value)
        put_s[0] += time.perf_counter() - t

    kv.put = timed_put

    def on_applied(block_root, block):
        applied.append(block_root)
        t = time.perf_counter()
        blocks_db.store_block(block, spec)
        states_db.store_state(block_root, store.block_states[block_root], spec)
        steps["store"] = dict(seconds=time.perf_counter() - t, put_s=put_s[0])

    pending = PendingBlocks(store, spec, on_applied=on_applied, da_gate=da, device=dev)
    sched = _ingest_scheduler()
    block_src = _LaneSource(_block_body(store, pending, spec))
    folds: list = []
    blob_src = _LaneSource(_blob_body(da, setup, spec, dev, linkages, folds))
    agg_src = _LaneSource(_aggregate_body(store, spec, dev, results))
    on_block_s = []
    real_on_block = PB.on_block

    def timed_on_block(*args, **kwargs):
        t = time.perf_counter()
        try:
            return real_on_block(*args, **kwargs)
        finally:
            on_block_s.append(time.perf_counter() - t)

    flushes0 = {(lane, cause): metrics.get("ingest_flush_count", lane=lane, cause=cause)
                for lane in ("block", "blob", "aggregate") for cause in ("full", "deadline")}
    da0 = {r: metrics.get("da_sidecars_total", result=r)
           for r in ("accept", "duplicate", "mismatch")}
    sub = drain[:INGEST_AGGREGATES]
    digest = misc.compute_fork_digest(bytes(state.fork.current_version),
                                      bytes(state.genesis_validators_root))
    block_topic = topic_name(digest, "beacon_block")
    agg_topic = topic_name(digest, "beacon_aggregate_and_proof")
    block_src.extract = lambda m: m.value
    agg_src.extract = lambda m: m.value.message.aggregate
    wire: dict = {}
    leg_aggs = drain[INGEST_AGGREGATES:INGEST_AGGREGATES + LIBP2P_AGGREGATES]
    if len(leg_aggs) != LIBP2P_AGGREGATES:
        raise AssertionError(f"phase 3c's drain holds {len(drain)} aggregates")
    leg_results: list = []
    leg_src = _LaneSource(_aggregate_body(store, spec, dev, leg_results),
                          extract=lambda m: m.value.message.aggregate)
    leg: dict = {}

    async def run():
        sched.start()
        ports: list = []
        try:
            # ---- the wire: two port sidecars on loopback, the receiver's
            # subscriptions in the scheduler's block and aggregate lanes
            t0 = time.perf_counter()
            (sender,), receiver, wire["pair"] = await _wire_pair(digest, ports)
            spy = _spy_verdicts(receiver)
            subs = [TopicSubscription(receiver, block_topic, block_src.handle,
                                      ssz_type=SignedBeaconBlock, spec=spec, scheduler=sched,
                                      lane="block"),
                    TopicSubscription(receiver, agg_topic, agg_src.handle,
                                      ssz_type=SignedAggregateAndProof, spec=spec,
                                      scheduler=sched, lane="aggregate")]
            for s in subs:
                await s.start()
            await ReqRespServer(sender, LiveChainView(store, blocks_db, spec), spec).register()
            await _announced(sender, receiver, [block_topic, agg_topic])
            wire["setup_s"] = time.perf_counter() - t0
            # the expectation, then the block over the wire and a scan
            if da.expect(root, commitments, [K.versioned_hash(c) for c in commitments]):
                raise AssertionError("the block is available before any sidecar")
            t0 = begin()
            with _path_shapes(fq_hist, sha_hist):
                await publish_ssz(sender, block_topic, signed, spec)
                await _verdicts_in(spy, 1, sched, "the block")
            end("block wire", t0)
            block_id = _msg_id(block_topic, snappy_compress(signed.encode(spec)))
            if [v for v, _ in spy.get(block_id, ())] != [VERDICT_ACCEPT] or \
                    [f["verdicts"] for f in block_src.flushes] != [[ACCEPT]]:
                raise AssertionError(f"the block's verdicts {spy}, flushes {block_src.flushes}")
            t0 = begin()
            with _path_shapes(fq_hist, sha_hist):
                parked = await pending.process_once()
            end("scan 1", t0)
            if parked or da.is_available(root) or not pending.is_pending(root):
                raise AssertionError(f"scan 1 applied {parked}; available "
                                     f"{da.is_available(root)}")
            # the sidecars and the adversaries, one flush, submitted directly:
            # the sidecar's seen cache would drop the duplicate before the DA
            # gate and change the flush's verdicts
            t0 = begin()
            with _path_shapes(fq_hist, sha_hist):
                for subnet, sc in items:
                    sched.submit("blob", (subnet, sc), blob_src)
                await _flushed(sched, blob_src, 1)
            end("blob lane", t0)
            # the second scan applies the block on the card and stores it
            t0 = begin()
            with _constant(PB, "on_block", timed_on_block), _path_shapes(fq_hist, sha_hist):
                done = await pending.process_once()
            end("scan 2", t0, on_block_s=on_block_s[0] if on_block_s else None)
            if done != 1 or applied != [root]:
                raise AssertionError(f"scan 2 applied {done}: {[r.hex() for r in applied]}")
            # the stored block back over req/resp, by range and by root
            peers = Peerbook()
            peers.add_peer(sender.node_id)
            downloader = BlockDownloader(receiver, peers, spec)
            stored = kv.get(block_store._BLOCK + root)
            for name, request in (("range", lambda: downloader.request_blocks_by_range(slot, 1)),
                                  ("root", lambda: downloader.request_blocks_by_root([root]))):
                t0 = time.perf_counter()
                answer = await request()
                wire[f"by_{name}_s"] = time.perf_counter() - t0
                if [b.encode(spec) for b in answer] != [stored] or stored != signed.encode(spec):
                    raise AssertionError(f"blocks by {name}: {len(answer)} blocks, not the "
                                         f"stored block")
            wire["block_bytes"] = len(stored)
            # the aggregates: directly, then over the wire through their lane
            verdicts, direct_s, direct_launches = _counted(
                lambda: FC.on_attestation_batch(store, sub, spec=spec, device=dev),
                "direct drain (phase 3g)")
            steps["direct drain"] = dict(seconds=direct_s, fq_launches=direct_launches)
            t0 = time.perf_counter()
            payloads = [snappy_compress(SignedAggregateAndProof(message=AggregateAndProof(
                aggregator_index=i, aggregate=agg)).encode(spec)) for i, agg in enumerate(sub)]
            wire["ids"] = [_msg_id(agg_topic, p) for p in payloads]
            wire["encode_s"] = time.perf_counter() - t0
            wire["payload_bytes"] = sum(map(len, payloads))
            spy.clear()
            t0 = begin()
            with _path_shapes(fq_hist, sha_hist):
                t_pub = time.perf_counter()
                for i in range(0, len(payloads), WIRE_BURST):
                    await asyncio.gather(*(sender.publish(agg_topic, p)
                                           for p in payloads[i:i + WIRE_BURST]))
                wire["publish_s"] = time.perf_counter() - t_pub
                await _verdicts_in(spy, len(payloads), sched, "the aggregates")
                wire["last_verdict_s"] = max(ts for got in spy.values() for _, ts in got) - t_pub
            end("aggregate wire", t0)
            wire["verdicts"] = {k: [v for v, _ in got] for k, got in spy.items()}
            wire["gossip_stats"] = await sender.get_gossip_stats()
            t0 = time.perf_counter()
            for s in subs:
                await s.stop()
            wire["unsubscribe_s"] = time.perf_counter() - t0
            # ---- the libp2p leg, on the same store and ingest scheduler
            leg["direct"], leg["direct_s"], leg["direct_launches"] = _counted(
                lambda: FC.on_attestation_batch(store, leg_aggs, spec=spec, device=dev),
                "direct drain (phase 3g, libp2p leg)")
            leg.update(await _libp2p_leg(
                sched, leg_src, store, spec, LiveChainView(store, blocks_db, spec), digest,
                agg_topic, leg_aggs, stored, slot, root, begin, end,
                lambda: _path_shapes(fq_hist, sha_hist)))
            return verdicts
        finally:
            t0 = time.perf_counter()
            for port in ports:
                await port.close()
            wire["close_s"] = time.perf_counter() - t0
            await sched.stop()

    try:
        direct = asyncio.run(run())
        blob_verdicts = blob_src.flushes[0]["verdicts"]
        got = [(v, dict(linkages).get(pos)) for pos, v in enumerate(blob_verdicts)]
        if got != want:
            raise AssertionError(f"blob verdicts {got} != {want}")
        if not da.is_available(root) or da.pending_count():
            raise AssertionError("the gate did not open")
        da_delta = {r: metrics.get("da_sidecars_total", result=r) - da0[r] for r in da0}
        if da_delta != {"accept": 6, "duplicate": 1, "mismatch": 1}:
            raise AssertionError(f"da_sidecars_total moved by {da_delta}")
        if store.block_states.get(root) is None or FC.get_head(store, spec) != root:
            raise AssertionError("the applied block is not the head")
        if any(v is not None for v in direct):
            raise AssertionError("the direct drain rejected valid aggregates")
        # per item: one verdict per message, the direct drain's
        t0 = time.perf_counter()
        _check_arrivals(wire["ids"], direct, wire["verdicts"], agg_src, results, "aggregate wire")
        # per flush: the launches of a direct drain of the same members
        _check_flushes(agg_src.flushes, store, spec, dev)
        wire["flush_check_s"] = time.perf_counter() - t0
        # the step's own seconds: what the wire added to the phase
        wire["seconds"] = sum(wire[k] for k in (
            "setup_s", "by_range_s", "by_root_s", "encode_s", "flush_check_s", "unsubscribe_s",
            "close_s")) + steps["block wire"]["seconds"] + steps["aggregate wire"]["seconds"]
        # the libp2p leg: per message the host's verdict the direct drain's
        # (the sidecar's, read by the observer, counted), a device-route
        # flush, and the launches of a direct drain of its members for the
        # first device-route flush and every host-route one
        t0 = time.perf_counter()
        if any(v is not None for v in leg["direct"]):
            raise AssertionError("the libp2p leg's direct drain rejected valid aggregates")
        _check_arrivals(leg["ids"], leg["direct"], leg["verdicts"], leg_src, leg_results,
                        "libp2p aggregates")
        codes = _wire_codes(leg["direct"])
        leg["diverging"] = sum(leg["applied"][m] != codes[i] for i, m in enumerate(leg["ids"]))
        leg["device_flushes"] = [i for i, f in enumerate(leg_src.flushes)
                                 if all(f["fq_launches"].get(k) for k in FQ_KERNELS)]
        if not leg["device_flushes"]:
            raise AssertionError(f"no libp2p flush took the device route: sizes "
                                 f"{[f['size'] for f in leg_src.flushes]}")
        leg["checked_flushes"] = [i for i in range(len(leg_src.flushes))
                                  if i == leg["device_flushes"][0] or i not in leg["device_flushes"]]
        _check_flushes([leg_src.flushes[i] for i in leg["checked_flushes"]], store, spec, dev)
        leg["flush_check_s"] = time.perf_counter() - t0
        leg["seconds"] += leg["direct_s"] + leg["flush_check_s"]
        PHASE_S["ingest/libp2p"] = leg["seconds"]

        # ---- durability: barrier, close, reopen, the verified resume
        t0 = begin()
        kv.barrier()
        end("barrier", t0)
        kv.close()
        wal_bytes = os.path.getsize(wal)
        t0 = begin()
        reopened = KvStore(wal)
        end("reopen", t0, records=reopened.recovery["records"])
        if reopened.recovery["truncated"] or reopened.recovery["records"] != 4:
            raise AssertionError(f"reopen recovery {reopened.recovery}")
        blocks_again, states_again = BlockStore(reopened), StateStore(reopened)
        decode_s = [0.0]
        real_get_state = states_again.get_state

        def timed_get_state(*args, **kwargs):
            t = time.perf_counter()
            try:
                return real_get_state(*args, **kwargs)
            finally:
                decode_s[0] += time.perf_counter() - t

        states_again.get_state = timed_get_state
        resumed_roots = []
        real_root = BeaconState.hash_tree_root

        def spied_root(self, spec=None, backend=None):
            got_root = real_root(self, spec, backend)
            resumed_roots.append(got_root)
            return got_root

        t0 = begin()
        with _constant(BeaconState, "hash_tree_root", spied_root), \
                _path_shapes(fq_hist, sha_hist):
            resumed = states_again.get_latest_verified_state(blocks_again, spec)
        end("resume", t0, decode_s=decode_s[0])
        reopened.close()
        t0 = begin()
        store_root = store.block_states[root].hash_tree_root(spec)
        end("store root", t0)
        if resumed is None or resumed[0] != root or \
                resumed_roots != [bytes(signed.message.state_root)] or \
                store_root != resumed_roots[0]:
            raise AssertionError(f"resume {resumed and resumed[0].hex()}: state roots "
                                 f"{[r.hex() for r in resumed_roots]}, store {store_root.hex()}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- the launch guard, and what the phase prints
    steps["store"]["encode_s"] = steps["store"]["seconds"] - steps["store"]["put_s"]
    for name in ("blob lane", "aggregate wire", "libp2p aggregates"):
        _require_all(steps[name]["fq_launches"], f"the {name} (phase 3g)")
    for name in ("scan 2", "resume"):
        if not steps[name]["sha256_launches"]:
            raise AssertionError(f"the {name} (phase 3g) launched no SHA-256 kernel")
    flushes = {f"{lane} {cause}": int(metrics.get("ingest_flush_count", lane=lane, cause=cause)
                                      - flushes0[(lane, cause)]) for lane, cause in flushes0}
    sizes = {"block": [f["size"] for f in block_src.flushes],
             "blob": [f["size"] for f in blob_src.flushes],
             "blob fold": folds,
             "aggregate": [f["size"] for f in agg_src.flushes]}
    yaml_note = _yaml_check(minimal_spec)
    versions = _wire_versions()
    peak = _peak_mib()
    seconds = time.perf_counter() - t_phase
    pair = wire["pair"]
    print(f"wire: two port sidecars on loopback, noise on ({versions}): receiver started in "
          f"{pair['receiver_start_s']:.3f} s, sender in {pair['sender_start_s']:.3f} s, connected "
          f"in {pair['connect_s']:.3f} s; subscribed, served and announced "
          f"{wire['setup_s']:.3f} s in all [{card}]")
    print(f"ingest: block of slot {slot} (proposer {proposer}) produced in "
          f"{steps['produce_block']['seconds']:.3f} s; published over the wire, publish -> "
          f"verdict {steps['block wire']['seconds']:.3f} s "
          f"({steps['block wire']['sha256_launches']} SHA-256); scan 1 "
          f"{steps['scan 1']['seconds']:.4f} s, parked (available False, 0 applied) [{card}]")
    print(f"ingest: blob lane, one flush of {len(items)} sidecars submitted directly (over the "
          f"wire the sidecar's seen cache would drop the duplicate before the DA gate; 8 past "
          f"the pre-check, folded on the card, then blamed on the host): "
          f"{steps['blob lane']['seconds']:.3f} s, "
          f"{_total(steps['blob lane']['fq_launches'])} field launches "
          f"{steps['blob lane']['fq_launches']}; verdicts {blob_verdicts}; the sixth honest "
          f"sidecar 'complete', the swapped proof and the unadvertised commitment REJECT, the "
          f"duplicate IGNORE [{card}]")
    print(f"ingest: scan 2 {steps['scan 2']['seconds']:.3f} s: on_block "
          f"{steps['scan 2']['on_block_s']:.3f} s on the card "
          f"({steps['scan 2']['sha256_launches']} SHA-256, "
          f"{_total(steps['scan 2']['fq_launches'])} field launches); store "
          f"{steps['store']['seconds']:.3f} s (encode {steps['store']['encode_s']:.3f} s, put "
          f"{steps['store']['put_s']:.3f} s); WAL {wal_bytes} bytes; barrier "
          f"{steps['barrier']['seconds']:.4f} s; reopen (WAL replay) "
          f"{steps['reopen']['seconds']:.3f} s, {steps['reopen']['records']} records [{card}]")
    print(f"ingest: get_latest_verified_state {steps['resume']['seconds']:.3f} s (get and decode "
          f"{steps['resume']['decode_s']:.3f} s, root {steps['resume']['seconds'] - steps['resume']['decode_s']:.3f} s, "
          f"{steps['resume']['sha256_launches']} SHA-256): block root {root.hex()[:16]}, state "
          f"root {resumed_roots[0].hex()[:16]} == the block's state_root == the store's "
          f"({steps['store root']['seconds']:.3f} s) [{card}]")
    print(f"wire: the stored block ({wire['block_bytes']} bytes) back from the sender's "
          f"ReqRespServer: blocks by range round trip {wire['by_range_s']:.4f} s, by root "
          f"{wire['by_root_s']:.4f} s, both == the stored block [{card}]")
    per_flush = [_total(f["fq_launches"]) for f in agg_src.flushes]
    wire_total = _total(steps["aggregate wire"]["fq_launches"])
    direct_total = _total(steps["direct drain"]["fq_launches"])
    print(f"wire: {len(sub)} aggregates directly {steps['direct drain']['seconds']:.3f} s "
          f"({direct_total} field launches); over the wire in bursts of {WIRE_BURST} "
          f"({wire['payload_bytes']} snappy bytes, encoded in {wire['encode_s']:.3f} s): publish "
          f"{wire['publish_s']:.3f} s, publish -> last verdict {wire['last_verdict_s']:.3f} s, "
          f"{len(agg_src.flushes)} flushes of {sizes['aggregate']}; field launches per flush "
          f"{per_flush} (each == a direct drain of its members, {wire['flush_check_s']:.3f} s), "
          f"{wire_total} in all ({wire_total / len(sub):.1f} per aggregate against "
          f"{direct_total / len(sub):.1f} in one drain); every verdict == the direct drain's, "
          f"none lost or shed [{card}]")
    print(f"wire: step {wire['seconds']:.3f} s (sidecars, subscriptions, the block, the "
          f"requests, the aggregates' encode, wire and per-flush check, unsubscribe "
          f"{wire['unsubscribe_s']:.3f} s, close {wire['close_s']:.3f} s) [{card}]")
    from lambda_ethereum_consensus_tpu_torch.network.sidecar_libp2p import VALIDATION_TIMEOUT_S

    pair, waits = leg["pair"], leg.pop("waits")
    leg_flushes = [f["size"] for f in leg_src.flushes]
    leg_launches = [_total(f["fq_launches"]) for f in leg_src.flushes]
    leg_total = _total(steps["libp2p aggregates"]["fq_launches"])
    leg.update(wait_p50_s=waits[len(waits) // 2], wait_max_s=waits[-1],
               waits_past_timeout=sum(w > VALIDATION_TIMEOUT_S for w in waits),
               flush_sizes=leg_flushes, flush_launches=[f["fq_launches"] for f in leg_src.flushes])
    applied = Counter("ACCEPT" if v == VERDICT_ACCEPT else "IGNORE" for v in leg["applied"].values())
    same = ("every verdict == the direct drain's" if not leg["diverging"] else
            f"{leg['diverging']} of {len(waits)} verdicts the sidecar applied diverge from "
            f"the direct drain's")
    print(f"libp2p: a receiver and {LIBP2P_PEERS} sender ports on loopback, noise on "
          f"({versions}): receiver started in {pair['receiver_start_s']:.3f} s, the senders "
          f"together in {pair['sender_start_s']:.3f} s, all connected in "
          f"{pair['connect_s']:.3f} s; negotiated muxer {leg['muxer']} (a port host dialling "
          f"the receiver's sidecar); subscribed, served and announced {leg['setup_s']:.3f} s "
          f"in all [{card}]")
    print(f"libp2p: the stored block ({len(signed.encode(spec))} bytes) back from a sender's "
          f"ReqRespServer over libp2p: blocks by range round trip {leg['by_range_s']:.4f} s, "
          f"by root {leg['by_root_s']:.4f} s, both == the stored block [{card}]")
    print(f"libp2p: {LIBP2P_AGGREGATES} aggregates (phase 3c's drain after its first "
          f"{INGEST_AGGREGATES}) directly {leg['direct_s']:.3f} s "
          f"({_total(leg['direct_launches'])} field launches); over libp2p, "
          f"{LIBP2P_AGGREGATES // LIBP2P_PEERS} from each sender, all published at once: "
          f"publish {leg['publish_s']:.3f} s, publish -> last verdict "
          f"{leg['last_verdict_s']:.3f} s; {len(leg_flushes)} flushes of {leg_flushes}, field "
          f"launches per flush {leg_launches} ({len(leg['device_flushes'])} on the device "
          f"route, each launching {list(FQ_KERNELS)}; flushes {leg['checked_flushes']}, the "
          f"first on the device route and every one on the host route, each == a direct "
          f"drain of its members, {leg['flush_check_s']:.3f} s), {leg_total} in all "
          f"{steps['libp2p aggregates']['fq_launches']}; arrival -> verdict p50 "
          f"{leg['wait_p50_s']:.3f} s, max {leg['wait_max_s']:.3f} s, "
          f"{leg['waits_past_timeout']} of {len(waits)} past VALIDATION_TIMEOUT_S = "
          f"{VALIDATION_TIMEOUT_S} s; every verdict the host sent == the direct drain's; "
          f"the sidecar applied {dict(applied)} (an observer in its mesh gets what it "
          f"accepts): {same} [{card}]")
    print(f"libp2p: each flush's senders {leg['flush_senders']}, its arrivals spread over "
          f"{[round(x, 3) for x in leg['arrival_spread_s']]} s (the lane's deadline "
          f"{INGEST_ATT_MS} ms) [{card}]")
    pr = leg["probe"]
    print(f"libp2p: each flush's verdict loop, first to last verdict done (start after the "
          f"publish, seconds) {[(round(t, 3), round(d, 3)) for t, d in leg['verdict_loops']]}; "
          f"this event loop's stalls of 20 ms or more outside the drain bodies (start, "
          f"seconds) "
          f"{[(round(t, 3), round(d, 3)) for t, d in pr['stalls']]}; "
          f"over the burst {pr['gc']['collections']} garbage collections "
          f"({pr['gc']['seconds']:.3f} s, the longest {pr['gc']['max_s']:.3f} s), CPU seconds "
          f"by thread "
          f"{ {k: round(v, 3) for k, v in pr['threads'].items()} }, and of "
          f"{ {k: round(v, 3) for k, v in pr['processes'].items()} } [{card}]")
    print(f"libp2p: the stall sampler's waits for the GIL past 0.1 s (start, seconds) "
          f"{[(round(t, 3), round(d, 3)) for t, d in pr['gil_waits']]} [{card}]")
    for t, frames in pr["samples"]:
        print(f"libp2p: the main thread {t:.3f} s after the publish, in a stall of 0.3 s or more "
              f"outside a drain body, innermost first: {' | '.join(frames)} [{card}]")
    print(f"libp2p: leg {leg['seconds']:.3f} s (the sidecars, subscription, announce, the "
          f"requests, the direct drain, the aggregates' wire and per-flush check, close "
          f"{leg['close_s']:.3f} s) [{card}]")
    print(f"ingest: flushes by cause {flushes}; batch sizes {sizes}; {yaml_note}; peak device "
          f"memory {peak:.0f} MiB; phase {seconds:.1f} s [{card}]")
    wire.update(versions=versions, flush_launches=[f["fq_launches"] for f in agg_src.flushes],
                stats=wire.pop("gossip_stats"))
    for key in ("ids", "verdicts"):
        wire.pop(key)
    for key in ("ids", "verdicts", "direct", "applied"):
        leg.pop(key)
    out.update(slot=slot, proposer=proposer, steps=steps, wal_bytes=wal_bytes, flushes=flushes,
               batch_sizes=sizes, blob_verdicts=blob_verdicts, yaml=yaml_note, peak_mib=peak,
               wire=wire, libp2p=leg, seconds=seconds)
    record["ingest"] = out
    return fq_hist, sha_hist


# ---- the Beacon API on the card (phase 3h)


def _http(port: int, method: str, path: str, body: bytes | None = None,
          ctype: str = "") -> tuple:
    """One request over a fresh loopback connection from the calling
    thread: (status code, Content-Type, body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body, headers={"Content-Type": ctype} if ctype else {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _http_json(port: int, method: str, path: str, body: bytes | None = None) -> dict:
    status, ctype, payload = _http(port, method, path, body,
                                   "application/json" if body is not None else "")
    if status != 200 or ctype != "application/json":
        raise AssertionError(f"{method} {path}: {status} {ctype} {payload[:200]!r}")
    return json.loads(payload)


_PROM_SAMPLE = re.compile(r'^[A-Za-z_:][A-Za-z0-9_:]*(\{([A-Za-z_][A-Za-z0-9_]*="(\\.|[^"\\])*",?)*\})? '
                          r'\S+$')


def _parse_prometheus(text: str) -> dict:
    """Families by name from Prometheus text (0.0.4): each sample line
    parsed, each ``# TYPE`` line once."""
    families: dict = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split()
            if name in families:
                raise AssertionError(f"/metrics: a second TYPE line for {name}")
            families[name] = typ
        elif line and not line.startswith("#"):
            if not _PROM_SAMPLE.match(line):
                raise AssertionError(f"/metrics: unparsable line {line!r}")
            float(line.rsplit(" ", 1)[1])
    return families


def api_phase(dev, record: dict, card: str, spec, store) -> int:
    """Phase 3h: the Beacon API on the card, on phase 3g's store (its head
    the 1,000,000-validator post-state of phase 3g's block, its finalized
    checkpoint phase 3c's anchor state, phase 3f's forensics plane
    attached).

    A ``BeaconApiServer`` on 127.0.0.1:0 with ``device`` the card, its
    event loop in a thread of its own (``harness.serving_thread``); every
    request from client threads over real sockets, but the mixed traffic,
    which the harness drives through the server's worker-thread dispatch.
    In order: (1) health, identity, the block root by ``head``, by root and
    by slot (== ``get_head``), block v2 (``body_root`` == the body's
    hashlib root); (2) the head's state root (== its block's
    ``state_root``) and a repeat, a response-cache hit; (3) a witness proof
    for ``head`` in JSON, which roots the state cold on the witness
    engine, and in SSZ (one proof, its root the block's ``state_root``,
    ``verify_host`` True), each repeated as a hit; (4) phase 3d's request
    mix, COALESCE_THREADS clients x COALESCE_REQUESTS POSTs of 1-4 proofs
    anchored at ``head``, one proof corrupted (every verdict ==
    ``verify_host``); (5) one POST of ``coalesce.MAX_FLUSH`` proofs, one
    plane; (6) ``run_mixed_traffic`` for API_TRAFFIC_S; (7) ``/metrics``
    parsed (one TYPE line a family, ``api_request_seconds`` for every
    route hit), ``/debug/slo`` printed row by row, the forensics and trace
    routes parsed, ``/debug/compile`` and ``/debug/profile`` 200 with their
    keys and a capture without ``seconds`` 400; (8) checkpoint sync of the
    finalized state (``fetch_finalized_state``), rooted on the SHA-256
    kernel == the finalized block's ``state_root``.  Every step's seconds
    and launches are printed beside the card's name and power limit; a
    step that must launch the SHA-256 kernel and did not fails the run, a
    repeat that launched anything too.  Returns the phase's SHA-256
    launches."""
    from lambda_ethereum_consensus_tpu_torch import fork_choice as FC
    from lambda_ethereum_consensus_tpu_torch.api import BeaconApiServer, checkpoint_sync, harness
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops
    from lambda_ethereum_consensus_tpu_torch.ssz import HashlibBackend
    from lambda_ethereum_consensus_tpu_torch.telemetry import get_metrics
    from lambda_ethereum_consensus_tpu_torch.types import BeaconState
    from lambda_ethereum_consensus_tpu_torch.witness import coalesce
    from lambda_ethereum_consensus_tpu_torch.witness.multiproof import WitnessProof, verify_host

    t_phase = time.perf_counter()
    _reset_peak()
    metrics = get_metrics()
    steps: dict = {}
    out: dict = {"steps": steps}

    def begin():
        _zero_fq_launches()
        sops.sha256_kernel_launches = 0
        _sync()
        return time.perf_counter()

    def end(name: str, t0: float, need_sha: bool | None, **extra) -> dict:
        """``need_sha``: True, the step must launch the SHA-256 kernel;
        False, it must launch nothing; None, either."""
        _sync()
        steps[name] = dict(seconds=time.perf_counter() - t0, fq_launches=_launches(),
                           sha256_launches=sops.sha256_kernel_launches, **extra)
        launched = steps[name]["sha256_launches"] + _total(steps[name]["fq_launches"])
        if need_sha and not steps[name]["sha256_launches"]:
            raise AssertionError(f"{name} (phase 3h) launched no SHA-256 kernel")
        if need_sha is False and launched:
            raise AssertionError(f"{name} (phase 3h) launched {launched} kernels")
        return steps[name]

    def hits(kind: str) -> float:
        return metrics.get("serve_cache_hit_total", cache="response", kind=kind)

    head = FC.get_head(store, spec)
    head_block = store.blocks[head]
    state_root = bytes(head_block.state_root)
    fin = bytes(store.finalized_checkpoint.root)
    api = BeaconApiServer(store=store, spec=spec, device=dev)
    fin_state = store.block_states[fin]
    with harness.serving_thread(api) as base:
        port = api.port
        # ---- (1) the basic routes
        t0 = begin()
        if _http(port, "GET", "/eth/v1/node/health") != (200, "application/json", b"{}"):
            raise AssertionError("health")
        if _http_json(port, "GET", "/eth/v1/node/identity")["data"]["peer_id"] != "":
            raise AssertionError("identity")
        for block_id in ("head", "0x" + head.hex(), str(int(head_block.slot))):
            got = _http_json(port, "GET", f"/eth/v1/beacon/blocks/{block_id}/root")
            if got != {"data": {"root": "0x" + head.hex()}}:
                raise AssertionError(f"block root by {block_id}: {got}")
        v2 = _http_json(port, "GET", "/eth/v2/beacon/blocks/head")["data"]["message"]
        body_root = head_block.body.hash_tree_root(spec, backend=HashlibBackend())
        if v2["body_root"] != "0x" + body_root.hex() or \
                v2["state_root"] != "0x" + state_root.hex() or v2["slot"] != str(head_block.slot):
            raise AssertionError(f"block v2 {v2}")
        end("basic routes", t0, None)
        # ---- (2) the head's state root, then a repeat from the response cache
        path = "/eth/v1/beacon/states/head/root"
        t0 = begin()
        got = _http_json(port, "GET", path)
        end("state root", t0, True)
        if got != {"data": {"root": "0x" + state_root.hex()}}:
            raise AssertionError(f"state root {got} != the block's {state_root.hex()}")
        before = hits("state_root")
        t0 = begin()
        if _http_json(port, "GET", path) != got or hits("state_root") != before + 1:
            raise AssertionError("the repeated state root missed the response cache")
        end("state root again", t0, False)
        # ---- (3) a witness proof for head, cold on the witness engine, then SSZ
        n = len(store.block_states[head].validators)
        query = f"indices=balances:{17 % n},validators:{42 % n},inactivity_scores:{n - 1}"
        t0 = begin()
        proof_json = _http_json(port, "GET", f"/eth/v0/witness/head?{query}")["data"]
        end("witness proof", t0, True)
        t0 = begin()
        status, ctype, ssz = _http(port, "GET", f"/eth/v0/witness/head?{query}&format=ssz")
        end("witness proof ssz", t0, False)
        proof = WitnessProof.from_json(proof_json)
        if status != 200 or ctype != "application/octet-stream" or \
                WitnessProof.decode(ssz) != proof or proof.state_root != state_root or \
                not verify_host(proof, state_root):
            raise AssertionError(f"witness proof: {status} {ctype}, root "
                                 f"{proof.state_root.hex()} != {state_root.hex()} or rejected")
        before = hits("witness")
        t0 = begin()
        if _http_json(port, "GET", f"/eth/v0/witness/head?{query}")["data"] != proof_json or \
                _http(port, "GET", f"/eth/v0/witness/head?{query}&format=ssz")[2] != ssz or \
                hits("witness") != before + 2:
            raise AssertionError("the repeated witness proofs missed the response cache")
        end("witness proof again", t0, False)
        out["proof_bytes"] = {"json": len(json.dumps(proof_json)), "ssz": len(ssz)}
        # ---- a pool of single-index proofs for the verify steps, proved on
        # the server from the retained engine
        rng = np.random.default_rng(SEED + 17)
        t0 = begin()
        pool = []
        for k in range(coalesce.MAX_FLUSH):
            field = WITNESS_FIELDS[k % len(WITNESS_FIELDS)]
            pool.append(_http_json(port, "GET", f"/eth/v0/witness/head?indices="
                                                f"{field}:{int(rng.integers(n))}")["data"])
        end("proof pool", t0, False)
        # ---- (4) phase 3d's concurrent mix, one proof corrupted
        bad_at = (int(rng.integers(COALESCE_THREADS)), int(rng.integers(COALESCE_REQUESTS)))
        batches = {}
        for t in range(COALESCE_THREADS):
            for r in range(COALESCE_REQUESTS):
                batch = [pool[int(i)] for i in rng.choice(len(pool), int(rng.integers(1, 5)),
                                                          replace=False)]
                if (t, r) == bad_at:
                    batch[-1] = dict(batch[-1], siblings=["0x" + "5a" * 32] +
                                     batch[-1]["siblings"][1:])
                batches[(t, r)] = batch
        results, errors = {}, []

        def client(t):
            try:
                for r in range(COALESCE_REQUESTS):
                    body = json.dumps({"state_id": "head", "proofs": batches[(t, r)]}).encode()
                    results[(t, r)] = _http_json(port, "POST", "/eth/v0/witness/verify",
                                                 body)["data"]
            except Exception as e:  # noqa: BLE001 - reported and failed below
                errors.append(e)

        flushes0 = {trig: metrics.get("serve_coalesce_flush_total", trigger=trig)
                    for trig in ("target", "deadline")}
        threads = [threading.Thread(target=client, args=(t,)) for t in range(COALESCE_THREADS)]
        t0 = begin()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        end("verify, concurrent", t0, True)
        if errors:
            raise errors[0]
        for key, batch in batches.items():
            want = [verify_host(WitnessProof.from_json(p), state_root) for p in batch]
            got = results[key]
            if got["results"] != want or want.count(False) != (key == bad_at) or \
                    not got["anchored"] or got["batch"] != len(batch):
                raise AssertionError(f"verify request {key}: {got} != verify_host {want}")
        flushes = {trig: int(metrics.get("serve_coalesce_flush_total", trigger=trig)
                             - flushes0[trig]) for trig in flushes0}
        out.update(verify_flushes=flushes, verify_proofs=sum(len(b) for b in batches.values()))
        # ---- (5) one full plane: MAX_FLUSH proofs in one POST
        body = json.dumps({"state_id": "head", "proofs": pool}).encode()
        if len(body) >= BeaconApiServer._MAX_BODY:
            raise AssertionError(f"a {len(pool)}-proof body of {len(body)} bytes is over "
                                 f"_MAX_BODY")
        t0 = begin()
        got = _http_json(port, "POST", "/eth/v0/witness/verify", body)["data"]
        end("verify, one plane", t0, True, body_bytes=len(body))
        if got["results"] != [True] * len(pool) or not got["valid"]:
            raise AssertionError(f"{got['results'].count(False)} of {len(pool)} rejected")
        # ---- (6) mixed traffic through the harness
        t0 = begin()
        traffic = harness.run_mixed_traffic(api, head, API_TRAFFIC_S)
        end("mixed traffic", t0, True)
        if traffic["non_200_count"] or traffic["invalid_verdicts"]:
            raise AssertionError(f"mixed traffic: {traffic['non_200_count']} non-200 answers "
                                 f"{traffic['non_200']}, {traffic['invalid_verdicts']} invalid")
        out["traffic"] = {k: v for k, v in traffic.items() if k != "non_200"}
        # ---- (7) /metrics and the debug routes
        t0 = begin()
        status, ctype, text = _http(port, "GET", "/metrics")
        if status != 200 or ctype != "text/plain; version=0.0.4":
            raise AssertionError(f"/metrics: {status} {ctype}")
        families = _parse_prometheus(text.decode())
        routes = ("/eth/v1/node/health", "/eth/v1/node/identity",
                  "/eth/v1/beacon/blocks/{id}/root", "/eth/v2/beacon/blocks/{id}",
                  "/eth/v1/beacon/states/{id}/root", "/eth/v0/witness/{id}",
                  "/eth/v0/witness/verify")
        missing = [r for r in routes
                   if f'api_request_seconds_count{{route="{r}"}}' not in text.decode()]
        if families.get("api_request_seconds") != "histogram" or missing:
            raise AssertionError(f"/metrics: api_request_seconds missing for {missing}")
        slo_report = _http_json(port, "GET", "/debug/slo")["data"]
        for route in ("/debug/forkchoice", "/debug/reorgs", "/debug/finality", "/debug/trace"):
            _http_json(port, "GET", route)
        compiled = _http_json(port, "GET", "/debug/compile")["data"]
        profiled = _http_json(port, "GET", "/debug/profile")["data"]
        if set(compiled) != {"stats", "warmed_buckets", "executables"} or \
                not compiled["executables"] or set(profiled) != {
                    "backend", "peaks", "entries", "planes", "live_device_bytes",
                    "plane_watermark_bytes", "capture"} or profiled["backend"] != "gpu":
            raise AssertionError(f"/debug/compile {sorted(compiled)}, /debug/profile "
                                 f"{sorted(profiled)}")
        status = _http(port, "POST", "/debug/profile/capture", b"{}", "application/json")[0]
        if status != 400:
            raise AssertionError(f"POST /debug/profile/capture without seconds answered {status}")
        end("metrics and debug routes", t0, None, families=len(families),
            metrics_bytes=len(text))
        # ---- (8) checkpoint sync of the finalized state, rooted on the card
        timing: dict = {}
        real_encode = BeaconState.encode

        def timed_encode(self, spec=None):
            t = time.perf_counter()
            raw = real_encode(self, spec)
            timing.update(encode_s=time.perf_counter() - t, encoded_at=time.perf_counter(),
                          bytes=len(raw))
            return raw

        class TimedDecode:
            """checkpoint_sync's ``BeaconState``, its decode timed."""

            @staticmethod
            def decode(data, spec=None):
                t = time.perf_counter()
                timing["decode_from"] = t
                state = BeaconState.decode(data, spec)
                timing["decode_s"] = time.perf_counter() - t
                return state

        t0 = begin()
        with _constant(BeaconState, "encode", timed_encode), \
                _constant(checkpoint_sync, "BeaconState", TimedDecode):
            synced = checkpoint_sync.fetch_finalized_state(base, spec=spec, timeout=600)
        fetch_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        synced_root = synced.hash_tree_root(spec, backend=sops.DeviceHashBackend(dev))
        _sync()
        root_s = time.perf_counter() - t1
        end("checkpoint sync", t0, True, fetch_s=fetch_s, root_s=root_s,
            encode_s=timing["encode_s"], decode_s=timing["decode_s"],
            transfer_s=timing["decode_from"] - timing["encoded_at"], bytes=timing["bytes"])
        want = bytes(store.blocks[fin].state_root)
        if synced_root != want or len(synced.validators) != len(fin_state.validators):
            raise AssertionError(f"checkpoint sync: root {synced_root.hex()} != the finalized "
                                 f"block's {want.hex()}")
        del synced
    peak = _peak_mib()
    seconds = time.perf_counter() - t_phase
    sha_total = sum(s["sha256_launches"] for s in steps.values())
    out.update(peak_mib=peak, seconds=seconds, sha256_launches=sha_total,
               slo=[{k: r.get(k) for k in ("slo", "count", "observed", "budget", "ok", "status",
                                           "burn_rates", "breaching")}
                    for r in slo_report["slos"]])

    def line(name: str) -> str:
        s = steps[name]
        return f"{name} {s['seconds']:.3f} s ({s['sha256_launches']} SHA-256)"

    print(f"api: BeaconApiServer on the card at 127.0.0.1:{port}, {len(fin_state.validators)} "
          f"validators; {line('basic routes')}; {line('state root')} == the head block's "
          f"state_root, {line('state root again')} a response-cache hit [{card}]")
    print(f"api: {line('witness proof')} (the witness engine's cold root; "
          f"{out['proof_bytes']['json']} JSON bytes), {line('witness proof ssz')} "
          f"({out['proof_bytes']['ssz']} bytes, == the JSON proof, root == state_root, "
          f"verify_host True), {line('witness proof again')} both hits; "
          f"{line('proof pool')} ({len(pool)} proofs) [{card}]")
    print(f"api: {line('verify, concurrent')}: {COALESCE_THREADS} threads x "
          f"{COALESCE_REQUESTS} POSTs ({out['verify_proofs']} proofs), flushes by trigger "
          f"{flushes}, every verdict == verify_host, only the corrupted proof False; "
          f"{line('verify, one plane')} ({len(pool)} proofs, "
          f"{steps['verify, one plane']['body_bytes']} body bytes), all True [{card}]")
    print(f"api: {line('mixed traffic')}: {traffic['requests']} requests in "
          f"{traffic['duration_s']:.3f} s ({traffic['req_per_sec']:.1f} a second; "
          f"{traffic['get_requests']} GET, {traffic['post_requests']} POST of "
          f"{traffic['proofs_per_post']}), cache hit ratio {traffic['cache_hit_ratio']}, mean "
          f"coalesced batch {traffic['coalesce_mean_batch']}, 0 non-200, 0 invalid [{card}]")
    print(f"api: {line('metrics and debug routes')}: /metrics {len(text)} bytes, "
          f"{len(families)} families, one TYPE line each, api_request_seconds for every route "
          f"hit; /debug/forkchoice, reorgs, finality and trace parsed; /debug/compile and "
          f"/debug/profile 200, a capture without seconds 400 [{card}]")
    for r in out["slo"]:
        observed = "no data" if r["observed"] is None else f"{r['observed']:.6f} s"
        print(f"  /debug/slo {r['slo']}: observed p{r['slo'].rsplit('_p', 1)[-1]} {observed} "
              f"over {r['count']} against {r['budget']} s, ok {r['ok']}, burn "
              f"{r['burn_rates']}")
    c = steps["checkpoint sync"]
    print(f"api: checkpoint sync of the finalized state ({c['bytes']} bytes): encode "
          f"{c['encode_s']:.3f} s, transfer {c['transfer_s']:.3f} s, decode {c['decode_s']:.3f} "
          f"s, root {c['root_s']:.3f} s on the card ({c['sha256_launches']} SHA-256) == the "
          f"finalized block's state_root; {c['seconds']:.3f} s in all [{card}]")
    print(f"api: {sha_total} SHA-256 launches in the phase; peak device memory {peak:.0f} MiB; "
          f"phase {seconds:.1f} s [{card}]")
    record["api"] = out
    return sha_total


# ---- one beacon node booted on the card (phase 3i)


@contextlib.contextmanager
def _seconds_in(targets: list, into: Counter):
    """Adds the seconds of each call of ``owner.attr`` (sync or async) to
    ``into[key]`` for each ``(owner, attr, key)`` of ``targets`` while
    active."""
    import inspect

    saved = []
    for owner, attr, key in targets:
        real = getattr(owner, attr)
        own = attr in vars(owner)  # else inherited: deleted again after

        def wrap(real=real, key=key):
            if inspect.iscoroutinefunction(real):
                async def timed(*args, **kwargs):
                    t = time.perf_counter()
                    try:
                        return await real(*args, **kwargs)
                    finally:
                        into[key] += time.perf_counter() - t
            else:
                def timed(*args, **kwargs):
                    t = time.perf_counter()
                    try:
                        return real(*args, **kwargs)
                    finally:
                        into[key] += time.perf_counter() - t
            return timed

        setattr(owner, attr, wrap())
        saved.append((owner, attr, real, own))
    try:
        yield into
    finally:
        for owner, attr, real, own in reversed(saved):
            if own:
                setattr(owner, attr, real)
            else:
                delattr(owner, attr)


def _flush_recorder(node, attr: str, members, flushes: list) -> None:
    """Replaces the node's drain body ``attr`` on the instance with one that
    records each flush: its size, seconds, field and SHA-256 launches (the
    counters read around the body, which runs to its end without yielding
    the event loop) and ``members(*args)``."""
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops

    real = getattr(node, attr)

    def recorded(*args):
        _sync()
        before, sha0, t = _launches(), sops.sha256_kernel_launches, time.perf_counter()
        verdicts = real(*args)
        _sync()
        after = _launches()
        flushes.append(dict(size=len(args[0]), seconds=time.perf_counter() - t,
                            t_end=time.perf_counter(), fq_launches={k: after[k] - before.get(k, 0) for k in after},
                            sha256_launches=sops.sha256_kernel_launches - sha0,
                            members=members(*args), verdicts=list(verdicts)))
        return verdicts

    setattr(node, attr, recorded)


def _sum_launches(flushes: list) -> dict:
    total = Counter()
    for f in flushes:
        total.update(f["fq_launches"])
    return {name: total.get(name, 0) for name in FQ_KERNELS}


def _op_constants() -> dict:
    """Each kernel body's SASS instructions per element, counted on the
    card's build (``cuobjdump -sass``, times the body's threads per
    element), by ``"kernel/threads"``; raises unless each equals its
    ``ops/profile.OPS_PER_ELEMENT`` constant."""
    from lambda_ethereum_consensus_tpu_torch.ops import _build, profile

    libs = _build.build_all()
    counted = {}
    for name, bodies in profile.OPS_PER_ELEMENT.items():
        for group, constant in bodies.items():
            if name == "sha256":
                ops = _sass_opcodes(libs["sha256"], "sha256_nodes_kernel")
            else:
                ops = _sass_opcodes(libs["fq"], _fq_symbol(name, group))
            counted[f"{name}/{group}"] = sum(ops.values()) * group
            if counted[f"{name}/{group}"] != constant:
                raise AssertionError(f"{name} with {group} threads an element: "
                                     f"{counted[f'{name}/{group}']} SASS instructions, "
                                     f"OPS_PER_ELEMENT says {constant}")
    return counted


def _cost_launches(rows: list) -> Counter:
    """Launches by kernel of ``/debug/compile``'s executables (or
    ``ops/profile.cost_table()``'s rows)."""
    out = Counter()
    for row in rows:
        out[row["entry"]] += row["launches"]
    return out


def _trace_busy(path: Path) -> dict:
    """Device busy time of a ``torch.profiler`` Chrome trace: the union of
    its kernel, memcpy and memset intervals, over the span of every
    complete event it holds (the capture window); the field and SHA-256
    kernels' events by name."""
    doc = json.loads(path.read_text())
    spans, device, kernels = [], [], Counter()
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        start = float(ev["ts"])
        span = (start, start + float(ev["dur"]))
        spans.append(span)
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(span)
            name = ev.get("name", "")
            for kernel in ("fq_mul_mod", "fq_add_mod", "fq_sub_mod", "sha256_nodes"):
                if kernel in name:
                    kernels[kernel] += 1
    if not device:
        raise AssertionError(f"the capture {path} holds no device event")
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(device):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    return dict(events=len(spans), device_events=len(device), kernels=dict(kernels),
                window_ms=window / 1e3, busy_ms=busy / 1e3, idle_share=1.0 - busy / window)


def node_boot_phase(dev, rng, record: dict, card: str, spec, store, start_sks: dict,
                    keys: list[int], blobs: list, commitments: list,
                    proofs: list) -> tuple[Counter, Counter, dict]:
    """Phase 3i: one ``BeaconNode`` booted on the card at 1,000,000
    validators, anchored at phase 3g's store's finalized checkpoint (phase
    3c's epoch-start state, slot f).

    A node anchored at a block past its epoch's first slot never sees that
    epoch's boundary block, so it would IGNORE every vote of the epoch (the
    target is unknown); a real node anchors at a finalized checkpoint.  And
    a block across an epoch boundary costs a fresh 10^6 state a ~42 s epoch
    transition.  So, setup: a copy of the epoch-start state whose
    ``genesis_time`` is re-based to ``now - (f+2) * SECONDS_PER_SLOT - 2``
    (the wall clock's slot is then f+2, so a block at f+1 and votes on it
    are acceptable) and whose ``latest_block_header`` is an empty-body
    header at slot f, rooted on the SHA-256 kernel; the anchor is the
    node's own default anchor for such a state (``node.py``'s
    ``_select_anchor``: slot f, empty body, ``state_root`` that root),
    which the votes of the epoch then target; the block of slot f+1 signed
    by ``DutyScheduler.produce_block``; NODE_AGG_COPIES aggregates per
    committee of slot f+1 on that block, signed on the card by
    ``_signed_aggregates``.  The node's spec schedules Deneb at mainnet's
    epoch, so it joins the blob topics.  Then, in one event loop:
    ``BeaconNode(NodeConfig(...), spec)`` with its device left at its
    default, the card, and ``start()`` (the device backend, the anchor
    stored, the store built, the sidecar, the ingest scheduler and the API);
    a bare port ``Port`` as the sender with the node as its bootnode; the
    DA expectation of phase 8's six commitments registered on the node's
    gate (the node registers none from a block body, in either package);
    the block published over the wire through the node's block lane, a
    scan that must park it; the six sidecars published, folded on the card
    by the node's blob lane, the block applied on the card by a scan and
    stored with its post-state by ``_on_applied``; the aggregates drained
    directly on the node's store (which builds the target's epoch context
    cold), then published as ``SignedAggregateAndProof``s through the
    node's aggregate lane, every verdict ACCEPT; ``GET
    /eth/v1/beacon/blocks/head/root`` from the node's API == the block's
    root, ``/debug/lanes`` and ``/debug/slot`` read; ``stop()``, which must
    raise nothing and put the previous hash backend back.  After it, each
    aggregate flush's field launches are held equal to a direct drain of
    its members.  Every step's seconds and launches are printed beside the
    card's name and power limit.

    The compile and profile plumbing on the same node: each kernel body's
    per-element operation constant (``ops/profile.OPS_PER_ELEMENT``) held
    equal to its SASS count; ``NodeConfig.warm_drain_shapes`` set to the
    phase's drain (the epoch's committees, the committee size, the 1,024
    aggregates, the slot's 64 messages), the warmer joined after the boot
    (its stats and each ``warmup_phase_seconds`` printed beside the boot's
    split); the aggregate lane's first flush beside the one after it; a
    ``POST /debug/profile/capture`` of ``NODE_CAPTURE_S`` during the
    aggregate lane, its trace read for device busy ms and idle share; then
    ``GET /debug/profile`` and ``GET /debug/compile``: the four kernels'
    launches in ``entries`` and ``executables`` equal to the wrappers'
    counters over the phase (every count a step zeroes folded in first),
    the device planes plus ``unattributed`` equal to the allocator total
    the route read, which lies between ``torch.cuda.memory_allocated()``
    read before and after it, and ``registry_planes`` non-zero.  Returns the phase's field launches by
    (kernel, lanes) and its SHA-256 launches by nodes (for phase 9; the
    direct drain left out) and its launches by kernel."""
    import tempfile

    import torch

    from lambda_ethereum_consensus_tpu_torch import fork_choice as FC
    from lambda_ethereum_consensus_tpu_torch.compression import compress as snappy_compress
    from lambda_ethereum_consensus_tpu_torch.da import kzg as K
    from lambda_ethereum_consensus_tpu_torch.network import Port
    from lambda_ethereum_consensus_tpu_torch.network.gossip import publish_ssz, topic_name
    from lambda_ethereum_consensus_tpu_torch.network.port import VERDICT_ACCEPT
    from lambda_ethereum_consensus_tpu_torch.network.sidecar import _msg_id
    from lambda_ethereum_consensus_tpu_torch.node import BeaconNode, NodeConfig
    from lambda_ethereum_consensus_tpu_torch.node import node as node_mod
    from lambda_ethereum_consensus_tpu_torch.node import pending_blocks as PB
    from lambda_ethereum_consensus_tpu_torch.node.warmup import DrainShapes
    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP
    from lambda_ethereum_consensus_tpu_torch.ops import profile
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops
    from lambda_ethereum_consensus_tpu_torch.ssz import get_hash_backend
    from lambda_ethereum_consensus_tpu_torch.state_transition import misc
    from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut
    from lambda_ethereum_consensus_tpu_torch.telemetry import get_metrics
    from lambda_ethereum_consensus_tpu_torch.types import (
        BeaconBlock, BeaconBlockBody, BeaconBlockHeader, BeaconState,
    )
    from lambda_ethereum_consensus_tpu_torch.types.validator import (
        AggregateAndProof, SignedAggregateAndProof,
    )
    from lambda_ethereum_consensus_tpu_torch.validator import (
        DutyScheduler, duties, proposer_index_at_slot,
    )

    t_phase = time.perf_counter()
    _reset_peak()
    out: dict = {}
    steps: dict = {}
    fq_hist, sha_hist = Counter(), Counter()
    # the blob topic rows join the mesh once Deneb is active: the node's spec
    # schedules it at mainnet's Deneb epoch (the repo's presets leave it
    # unscheduled), as the JAX package's DA scenario schedules it at 0
    spec = spec.replace(DENEB_FORK_EPOCH=MAINNET_DENEB_EPOCH)
    sops.install_device_backend(dev)
    op_constants = _op_constants()
    # the cost table's launches over the phase, held against the wrappers'
    # counters: each step zeroes the counters, so begin() folds them into
    # ``tally`` first
    _zero_fq_launches()
    sops.sha256_kernel_launches = 0
    base = _cost_launches(profile.cost_table())
    tally = Counter()

    def counters() -> Counter:
        return Counter(_launches(), sha256=sops.sha256_kernel_launches)

    def begin():
        tally.update(counters())
        _zero_fq_launches()
        sops.sha256_kernel_launches = 0
        _sync()
        return time.perf_counter()

    def end(name: str, t0: float, **extra) -> dict:
        _sync()
        steps[name] = dict(seconds=time.perf_counter() - t0, fq_launches=_launches(),
                           sha256_launches=sops.sha256_kernel_launches, **extra)
        return steps[name]

    def sk_of(v: int) -> int:
        return start_sks.get(v) or keys[v % REGISTRY_KEYS]

    # ---- setup: the epoch-start state re-based, given an empty-body header
    # at its own slot, rooted; its anchor block, the block and the
    # aggregates on it
    fin = bytes(store.finalized_checkpoint.root)
    start_state = store.block_states[fin]
    first = int(start_state.slot)
    if first % int(spec.SLOTS_PER_EPOCH):
        raise AssertionError(f"the finalized state's slot {first} is not an epoch's first")
    slot = first + 1
    sps = int(spec.SECONDS_PER_SLOT)
    genesis_time = int(time.time()) - (slot + 1) * sps - 2
    t0 = begin()
    anchor_state = start_state.copy(
        genesis_time=genesis_time,
        latest_block_header=BeaconBlockHeader(
            slot=first, proposer_index=0, parent_root=b"\x00" * 32, state_root=b"\x00" * 32,
            body_root=BeaconBlockBody().hash_tree_root(spec)))
    anchor_state_root = anchor_state.hash_tree_root(spec)
    end("setup root", t0)
    if not steps["setup root"]["sha256_launches"]:
        raise AssertionError("the re-based state's root (phase 3i) launched no SHA-256 kernel")
    # the node's own default anchor for such a state (node.py's _select_anchor)
    anchor_block = BeaconBlock(slot=first, proposer_index=0, parent_root=b"\x00" * 32,
                               state_root=anchor_state_root, body=BeaconBlockBody())
    anchor_root = anchor_block.hash_tree_root(spec)
    proposer = proposer_index_at_slot(BeaconStateMut(anchor_state), slot, spec)
    t0 = begin()
    signed, post = DutyScheduler({proposer: sk_of(proposer).to_bytes(32, "big")}, spec,
                                 device=dev).produce_block(anchor_state, slot)
    end("produce_block", t0)
    root = signed.message.hash_tree_root(spec)
    if bytes(signed.message.parent_root) != anchor_root:
        raise AssertionError("the block's parent_root is not the re-based anchor's root")
    t0 = time.perf_counter()
    post_ws = BeaconStateMut(post)
    epoch = misc.compute_epoch_at_slot(slot, spec)
    if duties.attestation_data_from_state(post_ws, slot, 0, root, spec).target.root != anchor_root:
        raise AssertionError("the votes' target is not the node's anchor")
    if spec.fork_at_epoch(epoch) != "deneb":
        raise AssertionError(f"epoch {epoch} is before Deneb: the node would join no blob topic")
    per_slot, table = _epoch_committees(post_ws, epoch, spec)
    items = [(duties.attestation_data_from_state(post_ws, slot, i, root, spec), table[(slot, i)],
              _participation(rng, len(table[(slot, i)])))
             for i in range(per_slot) for _ in range(NODE_AGG_COPIES)]
    atts, _ = _signed_aggregates(dev, post_ws, items, sk_of, spec)
    aggregates = [SignedAggregateAndProof(message=AggregateAndProof(aggregator_index=i,
                                                                    aggregate=att))
                  for i, att in enumerate(atts)]
    out["mint_s"] = time.perf_counter() - t0
    sidecar = _sidecar_maker(spec, signed, blobs)
    sidecars = [sidecar(i, commitments[i], proofs[i]) for i in range(len(blobs))]
    del post_ws, post

    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="node_", dir=str(ROOT / "chiprun_out"))
    # the warmer at the phase's drain: the epoch's committees, the committee
    # size (the warmer pads it to a power of two), the aggregates and the
    # slot's messages
    shapes = DrainShapes(n_validators=len(anchor_state.validators), n_committees=len(table),
                         committee=max(len(m) for m in table.values()),
                         entries=len(aggregates), groups=per_slot)
    config = NodeConfig(db_path=os.path.join(tmp, "beacon.wal"), genesis_state=anchor_state,
                        anchor_block=anchor_block, wire=None, enable_range_sync=False,
                        warm_drain_shapes=shapes)
    node = BeaconNode(config, spec)
    if node.device.type != "cuda":
        raise AssertionError(f"the node's default device is {node.device}, not the card")
    blob_flushes: list = []
    agg_flushes: list = []
    _flush_recorder(node, "_blob_sidecar_drain", lambda tagged: list(tagged), blob_flushes)
    _flush_recorder(node, "_attestation_drain",
                    lambda batch, extract, kind: [extract(m) for m in batch], agg_flushes)
    boot_split = Counter()
    block_calls: list = []
    real_on_block = PB.on_block

    def counted_on_block(*args, **kwargs):
        _sync()
        before, sha0, t = _launches(), sops.sha256_kernel_launches, time.perf_counter()
        try:
            return real_on_block(*args, **kwargs)
        finally:
            _sync()
            after = _launches()
            block_calls.append(dict(seconds=time.perf_counter() - t,
                                    fq_launches={k: after[k] - before.get(k, 0) for k in after},
                                    sha256_launches=sops.sha256_kernel_launches - sha0))

    applied: list = []
    api: dict = {}
    wire: dict = {}
    observatory: dict = {}
    direct_hist = Counter()
    previous_backend = get_hash_backend()

    async def run():
        loop = asyncio.get_running_loop()
        sender = None
        # ---- boot
        t0 = begin()
        with _seconds_in([(BeaconState, "hash_tree_root", "anchor root"),
                          (node_mod, "get_forkchoice_store", "store build"),
                          (node_mod.StateStore, "store_state", "store write"),
                          (node_mod.BlockStore, "store_block", "store write"),
                          (BeaconNode, "_start_network", "sidecar"),
                          (node_mod.BeaconApiServer, "start", "API")], boot_split):
            await node.start()
        end("boot", t0, split=dict(boot_split))
        try:
            # ---- the warmer, started with the backend, joined here
            t0 = time.perf_counter()
            await loop.run_in_executor(None, node._warmer.join, 300)
            steps["warmer wait"] = dict(seconds=time.perf_counter() - t0)
            stats = dict(node.warmer_stats)
            if node._warmer.is_alive() or set(stats) != {
                    "overlap_s", "transition_s", "witness_s", "duties_s", "kzg_s"}:
                raise AssertionError(f"the warmer: alive {node._warmer.is_alive()}, stats {stats}")
            observatory["warmer_stats"] = stats
            observatory["warmup_phase_seconds"] = {
                dict(labels)["phase"]: h_sum for labels, _b, _c, h_sum, _n
                in get_metrics().histogram_series("warmup_phase_seconds")}
            real_applied = node.pending.on_applied

            def timed_applied(block_root, block):
                t = time.perf_counter()
                real_applied(block_root, block)
                applied.append(dict(root=block_root, seconds=time.perf_counter() - t,
                                    t_end=time.perf_counter()))

            node.pending.on_applied = timed_applied
            spy = _spy_verdicts(node.port)
            digest = node.chain.fork_digest()
            block_topic = topic_name(digest, "beacon_block")
            agg_topic = topic_name(digest, "beacon_aggregate_and_proof")
            blob_topics = {subnet: topic_name(digest, f"blob_sidecar_{subnet}")
                           for subnet, _ in sidecars}
            # ---- the sender: a bare port with the node as its bootnode
            t0 = time.perf_counter()
            sender = await Port.start(fork_digest=digest,
                                      bootnodes=[f"127.0.0.1:{node.port.listen_port}"])
            connected = loop.create_future()
            sender.on_new_peer = lambda pid, addr: connected.done() or connected.set_result(pid)
            if await asyncio.wait_for(connected, 30) != node.port.node_id:
                raise AssertionError("the sender connected to another node")
            await _announced(sender, node.port,
                             [block_topic, agg_topic, *blob_topics.values()])
            wire["sender_s"] = time.perf_counter() - t0
            # ---- the block over the wire, parked by a scan
            if node.da.expect(root, commitments, [K.versioned_hash(c) for c in commitments]):
                raise AssertionError("the block is available before any sidecar")
            t0 = begin()
            await publish_ssz(sender, block_topic, signed, spec)
            await _verdicts_in(spy, 1, node.ingest, "the block")
            parked = await node.pending.process_once()
            end("block lane", t0)
            block_id = _msg_id(block_topic, snappy_compress(signed.encode(spec)))
            if [v for v, _ in spy.get(block_id, ())] != [VERDICT_ACCEPT]:
                raise AssertionError(f"the block's verdicts {spy}")
            if parked or root in node.store.blocks or not node.pending.is_pending(root) or \
                    node.da.is_available(root):
                raise AssertionError(f"the scan applied {parked}; available "
                                     f"{node.da.is_available(root)}")
            # ---- the six sidecars, folded by the blob lane; the scan applies
            # all six in flight at once, as a peer relays a block's sidecars:
            # the blob lane's 50 ms deadline then folds them together
            # (the pending loop's scan may apply the block before the last
            # verdict lands: it holds the event loop while it runs)
            t0 = begin()
            await asyncio.gather(*(publish_ssz(sender, blob_topics[subnet], sc, spec)
                                   for subnet, sc in sidecars))
            await _verdicts_in(spy, 1 + len(sidecars), node.ingest, "the sidecars")
            end("blob lane", t0)
            if not node.da.is_available(root):
                raise AssertionError("the node's DA gate did not open")
            await node.pending.process_once()
            for _ in range(6000):
                if root in node.store.blocks:
                    break
                await asyncio.sleep(0.001)
            wire["folded_s"] = blob_flushes[-1]["t_end"] - t0
            if root not in node.store.blocks or [a["root"] for a in applied] != [root] or \
                    len(block_calls) != 1:
                raise AssertionError(f"the block was not applied once: {len(block_calls)} "
                                     f"on_block calls, applied {[a['root'].hex() for a in applied]}")
            # ---- the aggregates: directly on the node's store (which builds
            # the target's epoch context cold), then through the aggregate lane
            t0 = begin()
            with _recording(BP, "_launch", _fq_lanes) as hist:
                direct = FC.on_attestation_batch(node.store, atts, spec=spec, device=dev)
            end("direct drain", t0)
            direct_hist.update(hist)
            if any(v is not None for v in direct):
                raise AssertionError("the direct drain rejected valid aggregates")
            payloads = [snappy_compress(a.encode(spec)) for a in aggregates]
            ids = [_msg_id(agg_topic, p) for p in payloads]
            spy.clear()
            capture = loop.run_in_executor(
                None, _http_json, node.api.port, "POST", "/debug/profile/capture",
                json.dumps({"seconds": NODE_CAPTURE_S, "dir": tmp}).encode())
            t0 = begin()
            t_pub = time.perf_counter()
            for i in range(0, len(payloads), WIRE_BURST):
                await asyncio.gather(*(sender.publish(agg_topic, p)
                                       for p in payloads[i:i + WIRE_BURST]))
            wire["publish_s"] = time.perf_counter() - t_pub
            await _verdicts_in(spy, len(payloads), node.ingest, "the aggregates")
            wire["last_verdict_s"] = max(ts for got in spy.values() for _, ts in got) - t_pub
            end("aggregate lane", t0)
            observatory["capture"] = (await capture)["data"]
            observatory["trace"] = _trace_busy(Path(observatory["capture"]["dir"]) / "trace.json")
            shutil.rmtree(observatory["capture"]["dir"])
            if {k: [v for v, _ in got] for k, got in spy.items()} != \
                    {m: [VERDICT_ACCEPT] for m in ids}:
                raise AssertionError(f"aggregate verdicts: {len(spy)} of {len(ids)}, not all "
                                     f"ACCEPT")
            # ---- the node's own API
            t0 = time.perf_counter()
            port = node.api.port
            for path in ("/eth/v1/beacon/blocks/head/root", "/debug/lanes", "/debug/slot"):
                api[path] = await loop.run_in_executor(None, _http_json, port, "GET", path)
            api["seconds"] = time.perf_counter() - t0
            # ---- the observatory: launches, planes, the build table
            t0 = time.perf_counter()
            before = torch.cuda.memory_allocated()
            prof = (await loop.run_in_executor(None, _http_json, port, "GET",
                                               "/debug/profile"))["data"]
            after = torch.cuda.memory_allocated()
            compiled = (await loop.run_in_executor(None, _http_json, port, "GET",
                                                   "/debug/compile"))["data"]
            counted = tally + counters()
            observatory["routes_s"] = time.perf_counter() - t0
            from_executables = _cost_launches(compiled["executables"])
            from_entries = Counter({e["entry"]: e["calls"] for e in prof["entries"]})
            launches_seen = {k: dict(counters=counted[k],
                                     executables=from_executables[k] - base[k],
                                     entries=from_entries[k] - base[k])
                             for k in ("sha256", *FQ_KERNELS)}
            if any(not v["counters"] or len(set(v.values())) != 1
                   for v in launches_seen.values()):
                raise AssertionError(f"cost table against the counters: {launches_seen}")
            planes = prof["planes"]
            device_planes = sum(planes[n] for n in profile.device_planes())
            live = prof["live_device_bytes"]
            if live is None or not min(before, after) <= live <= max(before, after) or \
                    device_planes + planes["unattributed"] != live or \
                    not planes["registry_planes"]:
                raise AssertionError(f"planes {planes} against the allocator's {live} "
                                     f"({before}, {after} read around the route)")
            observatory.update(launches=launches_seen, planes=planes, live_device_bytes=live,
                               watermark=prof["plane_watermark_bytes"], peaks=prof["peaks"],
                               entries=[{k: e[k] for k in ("rank", "entry", "calls",
                                                           "roofline_ratio", "span_family")}
                                        for e in prof["entries"]],
                               executables=len(compiled["executables"]),
                               builds=compiled["stats"]["builds"])
            if api["/eth/v1/beacon/blocks/head/root"]["data"]["root"] != "0x" + root.hex():
                raise AssertionError(f"the API's head {api['/eth/v1/beacon/blocks/head/root']} "
                                     f"!= the block's root {root.hex()}")
        finally:
            if sender is not None:
                await sender.close()
            t0 = time.perf_counter()
            await node.stop()
            steps["stop"] = dict(seconds=time.perf_counter() - t0)

    try:
        with _constant(PB, "on_block", counted_on_block), _path_shapes(fq_hist, sha_hist):
            asyncio.run(run())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the node's path: less the direct drain, which only warmed the context
    fq_hist.subtract(direct_hist)
    fq_hist = +fq_hist
    if get_hash_backend() is not previous_backend:
        raise AssertionError("stop() did not put the previous hash backend back")

    # ---- per flush: the launches of a direct drain of the same members
    t0 = time.perf_counter()
    for f in agg_flushes:
        _zero_fq_launches()
        _sync()
        again = FC.on_attestation_batch(node.store, f["members"], spec=spec, device=dev)
        _sync()
        f["direct_launches"] = _launches()
        if f["fq_launches"] != f["direct_launches"] or \
                _drain_verdicts(again) != [None] * f["size"]:
            raise AssertionError(f"a flush of {f['size']}: launches {f['fq_launches']} != a "
                                 f"direct drain's {f['direct_launches']}")
    out["flush_check_s"] = time.perf_counter() - t0
    if sum(f["size"] for f in agg_flushes) != len(aggregates) or \
            any(v != VERDICT_ACCEPT for f in agg_flushes for v in f["verdicts"]):
        raise AssertionError("the aggregate lane's flushes do not hold every aggregate, accepted")

    # ---- the launch guard, and what the phase prints
    block = dict(block_calls[0], store_s=applied[0]["seconds"],
                 available_to_stored_s=applied[0]["t_end"] - blob_flushes[-1]["t_end"])
    blob_launches, agg_launches = _sum_launches(blob_flushes), _sum_launches(agg_flushes)
    if not steps["boot"]["sha256_launches"]:
        raise AssertionError("the boot (phase 3i) launched no SHA-256 kernel")
    if not block["sha256_launches"]:
        raise AssertionError("the block's on_block (phase 3i) launched no SHA-256 kernel")
    _require_all(blob_launches, "the blob lane (phase 3i)")
    _require_all(agg_launches, "the aggregate lane (phase 3i)")
    launches = {name: sum(n for (k, _), n in fq_hist.items() if k == name)
                for name in FQ_KERNELS}
    launches["sha256"] = sum(sha_hist.values())
    peak = _peak_mib()
    seconds = time.perf_counter() - t_phase
    split = steps["boot"]["split"]
    # the anchor's root runs inside the store build
    other = steps["boot"]["seconds"] - sum(v for k, v in split.items() if k != "anchor root")
    lanes = api["/debug/lanes"]["data"]
    slot_view = api["/debug/slot"]["data"]
    print(f"node: the finalized state of slot {first} ({len(anchor_state.validators)} "
          f"validators), given an empty-body header at its slot, re-based to genesis_time "
          f"{genesis_time} (the wall clock's slot {slot + 1}) and rooted "
          f"in {steps['setup root']['seconds']:.3f} s ({steps['setup root']['sha256_launches']} "
          f"SHA-256); the block of slot {slot} (proposer {proposer}) produced in "
          f"{steps['produce_block']['seconds']:.3f} s; {len(aggregates)} aggregates "
          f"({per_slot} committees x {NODE_AGG_COPIES}) minted on the card in "
          f"{out['mint_s']:.3f} s [{card}]")
    print(f"node: BeaconNode on {node.device} booted in {steps['boot']['seconds']:.3f} s: "
          f"anchor root {split.get('anchor root', 0.0):.3f} s, store build "
          f"{split.get('store build', 0.0) - split.get('anchor root', 0.0):.3f} s, store write "
          f"{split.get('store write', 0.0):.3f} s, sidecar {split.get('sidecar', 0.0):.3f} s, "
          f"API {split.get('API', 0.0):.3f} s, the rest {other:.3f} s; "
          f"{steps['boot']['sha256_launches']} SHA-256 launches [{card}]")
    print(f"node: a bare port sender connected and announced in {wire['sender_s']:.3f} s; the "
          f"block over the wire, its verdict and a scan (parked: available False) "
          f"{steps['block lane']['seconds']:.3f} s [{card}]")
    print(f"node: the six sidecars over the wire, publish -> folded {wire['folded_s']:.3f} s: "
          f"blob lane flushes {[f['size'] for f in blob_flushes]} "
          f"({sum(f['seconds'] for f in blob_flushes):.3f} s in the drain), "
          f"{_total(blob_launches)} field launches {blob_launches}; DA complete -> the block "
          f"applied and stored by a scan {block['available_to_stored_s']:.3f} s: on_block "
          f"{block['seconds']:.3f} s on the card ({block['sha256_launches']} SHA-256, "
          f"{_total(block['fq_launches'])} field launches), _on_applied {block['store_s']:.3f} s "
          f"(block and post-state stored); the scan holds the event loop, so publish -> the "
          f"sidecars' last verdict {steps['blob lane']['seconds']:.3f} s [{card}]")
    print(f"node: {len(aggregates)} aggregates directly on the node's store (the epoch context "
          f"cold) {steps['direct drain']['seconds']:.3f} s, "
          f"{_total(steps['direct drain']['fq_launches'])} field launches; over the wire in "
          f"bursts of {WIRE_BURST}: publish "
          f"{wire['publish_s']:.3f} s, publish -> last verdict {wire['last_verdict_s']:.3f} s, "
          f"every verdict ACCEPT; {len(agg_flushes)} flushes of "
          f"{[f['size'] for f in agg_flushes]}, field launches per flush "
          f"{[_total(f['fq_launches']) for f in agg_flushes]} (each == a direct drain of its "
          f"members, {out['flush_check_s']:.3f} s), {_total(agg_launches)} in all "
          f"{agg_launches} [{card}]")
    print(f"node: GET /eth/v1/beacon/blocks/head/root == the block's root {root.hex()[:16]}; "
          f"/debug/lanes depth {lanes['depth']}, lanes "
          f"{[(lane['name'], lane['depth']) for lane in lanes['lanes']]}; /debug/slot "
          f"{slot_view}; {api['seconds']:.3f} s; stop() {steps['stop']['seconds']:.3f} s, raised "
          f"nothing, the previous hash backend back [{card}]")
    first, later = agg_flushes[0], agg_flushes[1:2]
    flush_line = "; ".join(f"{f['size']} aggregates in {f['seconds']:.3f} s, "
                           f"{_total(f['fq_launches'])} field launches" for f in [first, *later])
    trace = observatory["trace"]
    print(f"node: op constants == SASS instructions per element {op_constants} [{card}]")
    print(f"node: warmer at {shapes.n_committees} committees x {shapes.committee} (padded to "
          f"{1 << (shapes.committee - 1).bit_length()}), {shapes.entries} entries, {shapes.groups} messages: "
          f"stats {observatory['warmer_stats']}; warmup_phase_seconds "
          f"{ {k: round(v, 3) for k, v in observatory['warmup_phase_seconds'].items()} }; "
          f"joined {steps['warmer wait']['seconds']:.3f} s after the boot's "
          f"{steps['boot']['seconds']:.3f} s (split "
          f"{ {k: round(v, 3) for k, v in split.items()} }) [{card}]")
    print(f"node: the aggregate lane's first flush and the one after it: {flush_line} [{card}]")
    print(f"node: POST /debug/profile/capture of {NODE_CAPTURE_S:g} s during the aggregate "
          f"lane: {observatory['capture']['bytes']} bytes in "
          f"{observatory['capture']['seconds']:.3f} s; {trace['events']} events, "
          f"{trace['device_events']} on the device {trace['kernels']}; device busy "
          f"{trace['busy_ms']:.3f} ms of a {trace['window_ms']:.3f} ms window, idle share "
          f"{trace['idle_share']:.4f} [{card}]")
    print(f"node: /debug/profile and /debug/compile in {observatory['routes_s']:.3f} s: "
          f"launches (counters, executables, entries) {observatory['launches']}; device planes "
          f"+ unattributed == the allocator's {observatory['live_device_bytes']:.0f} bytes: "
          f"{ {k: int(v) for k, v in observatory['planes'].items()} }, watermark "
          f"{observatory['watermark']:.0f}; {observatory['executables']} executables; kernels "
          f"by headroom {[(e['entry'], e['roofline_ratio']) for e in observatory['entries']]}; "
          f"builds {[(b['name'], b['source']) for b in observatory['builds']]} [{card}]")
    print(f"node: the phase's launches {launches}; peak device memory {peak:.0f} MiB; phase "
          f"{seconds:.1f} s [{card}]")
    for f in blob_flushes + agg_flushes:
        f.pop("members")
    out.update(slot=slot, proposer=proposer, genesis_time=genesis_time, steps=steps,
               block=block, blob_flushes=blob_flushes, aggregate_flushes=agg_flushes,
               wire=wire, api={k: v for k, v in api.items() if k != "/debug/lanes"},
               lanes=lanes, launches=launches, peak_mib=peak, seconds=seconds,
               op_constants=op_constants, observatory=observatory)
    record["node_boot"] = out
    return fq_hist, sha_hist, launches


class _MetricCounts:
    """A metrics sink for the witness modules: counts each ``inc`` by name
    and labels, each ``observe`` as ``<name>_count`` and each span as
    ``<name>_seconds_count``."""

    def __init__(self):
        self.counts = Counter()
        self._lock = threading.Lock()

    def inc(self, name, value=1, **labels):
        with self._lock:
            self.counts[(name, tuple(sorted(labels.items())))] += value

    def observe(self, name, value, **labels):
        self.inc(name + "_count")

    def set_gauge(self, name, value, **labels):
        pass

    @contextlib.contextmanager
    def span(self, name, slow=None, **labels):
        yield
        self.observe(name + "_seconds", 0.0, **labels)

    def get(self, name, **labels) -> int:
        return self.counts[(name, tuple(sorted(labels.items())))]


def _witness_requests(rng, n: int) -> list:
    """WITNESS_SHAPES' requests in a seeded order, each over one witness
    field at seeded indices below ``n``."""
    out = []
    for count, width in WITNESS_SHAPES:
        for k in rng.integers(0, len(WITNESS_FIELDS), count):
            out.append([(WITNESS_FIELDS[int(k)], int(i)) for i in rng.integers(0, n, width)])
    return [out[i] for i in rng.permutation(len(out))]


def _corrupted(proof):
    from lambda_ethereum_consensus_tpu_torch.witness.multiproof import WitnessProof

    return WitnessProof(proof.state_root, proof.indices, proof.leaves,
                        (b"\x5a" * 32,) + tuple(proof.siblings[1:]))


def _witness_adversaries(proof) -> list:
    """The six rejection cases of ``tests/unit/test_witness.py``:
    (name, proof, expected root or None for the proof's own)."""
    from lambda_ethereum_consensus_tpu_torch.witness.multiproof import WitnessProof

    g, chunk = proof.leaves[0]
    root, idx, leaves, sibs = proof.state_root, proof.indices, proof.leaves, proof.siblings
    return [
        ("corrupted sibling", _corrupted(proof), None),
        ("truncated proof", WitnessProof(root, idx, leaves, sibs[:-1]), None),
        ("padded proof", WitnessProof(root, idx, leaves, sibs + (b"\x00" * 32,)), None),
        ("duplicated gindex", WitnessProof(root, idx, ((g, chunk), (g, chunk)) + leaves[1:],
                                           sibs), None),
        ("empty index set", WitnessProof(root, (), (), sibs), None),
        ("wrong root", proof, b"\x13" * 32),
    ]


def witness_phase(dev, rng, record: dict, state, root: bytes, spec) -> tuple[dict, Counter]:
    """Phase 3d: the stateless witness plane at phase 3b's walk-end state,
    whose root phase 3b held equal to the host walk's.

    A ``WitnessService`` with its own engine on the device backend roots
    the state cold (== ``root``), proves the seeded requests and answers a
    repeat from its proof cache; ``verify_batch`` checks the 2,048 proofs
    on the card cold, warm and profiled (one plane, one SHA-256 launch per
    round; == the host plane and a sample == the per-proof oracle; host
    seconds split into planning, assembly and plane), then 4,096 (two
    planes), the six adversaries each in a batch of 64, a 4-proof request
    on the oracle route (no launch), and the coalescer under concurrent
    requests; then
    the vector commitment: generators, a width-256 commitment and an
    opening on the card (== the host Jacobian sums), and a fold of
    VC_FOLD openings made on the host, True and, tampered, False on the
    card.  Returns phase 9's "VC fold" path and the node counts of every
    SHA-256 launch of the plane."""
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops
    from lambda_ethereum_consensus_tpu_torch.witness import coalesce
    from lambda_ethereum_consensus_tpu_torch.witness import multiproof as mp
    from lambda_ethereum_consensus_tpu_torch.witness import vector_commitment as VC
    from lambda_ethereum_consensus_tpu_torch.witness import verify as V
    from lambda_ethereum_consensus_tpu_torch.witness.service import WitnessService

    _reset_peak()
    t_phase = time.perf_counter()
    n = len(state.validators)
    out: dict = {}

    # ---- the service's own engine roots the state cold on the device backend
    svc_metrics = _MetricCounts()
    svc = WitnessService(backend=sops.DeviceHashBackend(dev), metrics=svc_metrics)
    planner, _lock = svc.planner(root)
    sops.sha256_kernel_launches = 0
    _sync()
    t0 = time.perf_counter()
    cold_root = planner.root(state, spec)
    _sync()
    out["cold_root_s"] = time.perf_counter() - t0
    out["cold_root_sha256_launches"] = sops.sha256_kernel_launches
    if cold_root != root:
        raise AssertionError(f"the service's engine root {cold_root.hex()} != phase 3b's "
                             f"{root.hex()}")
    if not out["cold_root_sha256_launches"]:
        raise AssertionError("the service's cold root launched no SHA-256 kernel")
    out["retained_mib"] = planner.engine.retained_bytes() / 2**20
    print(f"witness service: cold engine root {out['cold_root_s']:.3f} s on the device backend, "
          f"{out['cold_root_sha256_launches']} SHA-256 launches, == phase 3b's root; "
          f"{out['retained_mib']:.1f} MiB of retained rows")

    # ---- the seeded requests proved, one answered again from the proof cache
    requests = _witness_requests(rng, n)
    t0 = time.perf_counter()
    proofs = [svc.prove(root, state, req, spec) for req in requests]
    out["prove_s"] = time.perf_counter() - t0
    hits = svc_metrics.get("serve_cache_hit_total", cache="witness_proof", kind="proof")
    t0 = time.perf_counter()
    again = svc.prove(root, state, requests[-1], spec)
    out["cached_prove_s"] = time.perf_counter() - t0
    if again is not proofs[-1] or svc_metrics.get("serve_cache_hit_total", cache="witness_proof",
                                                  kind="proof") != hits + 1:
        raise AssertionError("the repeated request missed the proof cache")
    t0 = time.perf_counter()
    plans = [mp.plan_for(p) for p in proofs]  # what verify_batch pays: 2,048 distinct leaf sets
    out["plan_s"] = time.perf_counter() - t0
    shapes = {}
    for req, plan in zip(requests, plans):
        row = shapes.setdefault(len(req), dict(proofs=0, max_slots=0, max_rounds=0))
        row["proofs"] += 1
        row["max_slots"] = max(row["max_slots"], plan.n_slots)
        row["max_rounds"] = max(row["max_rounds"], len(plan.rounds))
    out["shapes"] = shapes
    rounds = max(len(p.rounds) for p in plans)
    planes, oracle = V.split_planes(list(range(len(proofs))), plans)
    if [len(p) for p in planes] != [len(proofs)] or oracle:
        raise AssertionError(f"{len(proofs)} proofs made planes {[len(p) for p in planes]}, "
                             f"{len(oracle)} to the oracle")
    print(f"{len(proofs)} proofs in {out['prove_s']:.3f} s ({len(proofs) / out['prove_s']:.0f} "
          f"a second); the repeat from the proof cache in {out['cached_prove_s'] * 1e6:.1f} us; "
          f"by width {shapes}; one plane of {len(proofs)} x "
          f"{V._pow2(max(p.n_slots for p in plans))} slots, {rounds} rounds")

    with _recording(V, "sha256_nodes", lambda blocks: int(blocks.shape[0])) as plane_nodes:
        # ---- the 2,048 on the card: cold, warm, the host split, a profile
        for tag in ("cold", "warm"):
            sops.sha256_kernel_launches = 0
            _sync()
            t0 = time.perf_counter()
            got = V.verify_batch(proofs, root, device=dev)
            _sync()
            out[f"verify_{tag}_s"] = time.perf_counter() - t0
            if got != [True] * len(proofs):
                raise AssertionError(f"{got.count(False)} of the {len(proofs)} valid proofs "
                                     f"rejected ({tag})")
            if sops.sha256_kernel_launches != rounds:
                raise AssertionError(f"{sops.sha256_kernel_launches} SHA-256 launches for a "
                                     f"plane of {rounds} rounds")
        out["verify_sha256_launches"] = rounds
        _sync()
        t0 = time.perf_counter()
        packed = V._assemble(proofs, [root] * len(proofs), plans)
        t1 = time.perf_counter()
        plane = V._verify_plane(packed, dev)
        t2 = time.perf_counter()
        host_plane = V._verify_plane_host(packed)
        t3 = time.perf_counter()
        out.update(assembly_s=t1 - t0, plane_s=t2 - t1, host_plane_s=t3 - t2,
                   plane_bytes=int(packed["nodes"].nbytes))
        if plane.tolist() != host_plane.tolist() or not host_plane.all():
            raise AssertionError("the plane on the card != the host plane")
        sample = [int(i) for i in rng.choice(len(proofs), WITNESS_SAMPLE, replace=False)]
        if not all(mp.verify_host(proofs[i], root) for i in sample):
            raise AssertionError("the per-proof oracle rejected a sampled proof")
        wall, busy = _profiled(lambda: V.verify_batch(proofs, root, device=dev), attempts=2)
        out.update(profiled_s=wall, device_busy_ms=busy, idle_share=1 - busy / 1e3 / wall)
        print(f"verify_batch of {len(proofs)} on the card: cold {out['verify_cold_s']:.3f} s, "
              f"warm {out['verify_warm_s']:.3f} s, {rounds} SHA-256 launches (== the plane's "
              f"rounds); every verdict True, == _verify_plane_host "
              f"({out['host_plane_s']:.3f} s on the host), a {WITNESS_SAMPLE}-proof sample == "
              f"verify_host")
        print(f"host split: planning {out['plan_s']:.3f} s, assembly {out['assembly_s']:.3f} s, "
              f"plane {out['plane_s']:.3f} s "
              f"({out['plane_bytes'] / 2**20:.0f} MiB of nodes up, launches, verdicts back); "
              + _idle_line("verify_batch", wall, busy))

        # ---- 4,096 proofs: two planes
        more = [svc.prove(root, state, req, spec) for req in _witness_requests(rng, n)]
        both = proofs + more
        both_plans = plans + [mp.plan_for(p) for p in more]
        planes, oracle = V.split_planes(list(range(len(both))), both_plans)
        if len(planes) != 2 or oracle:
            raise AssertionError(f"{len(both)} proofs made {len(planes)} planes")
        want_launches = sum(max(len(both_plans[i].rounds) for i in p) for p in planes)
        seen = []
        real_plane = V._verify_plane
        V._verify_plane = lambda packed, device: seen.append(packed["n"]) or real_plane(packed,
                                                                                      device)
        try:
            sops.sha256_kernel_launches = 0
            _sync()
            t0 = time.perf_counter()
            got = V.verify_batch(both, root, device=dev)
            _sync()
            out["verify_4096_s"] = time.perf_counter() - t0
        finally:
            V._verify_plane = real_plane
        if got != [True] * len(both) or seen != [len(p) for p in planes] or \
                sops.sha256_kernel_launches != want_launches:
            raise AssertionError(f"{len(both)} proofs: {got.count(False)} rejected, planes "
                                 f"{seen}, {sops.sha256_kernel_launches} launches for "
                                 f"{want_launches} rounds")
        if not all(mp.verify_host(more[i], root) for i in sample):
            raise AssertionError("the per-proof oracle rejected a sampled proof")
        out["verify_4096_launches"] = want_launches
        print(f"verify_batch of {len(both)}: {out['verify_4096_s']:.3f} s in planes of {seen}, "
              f"{want_launches} SHA-256 launches, every verdict True")

        # ---- the six adversaries, each in a batch of 64 among valid proofs
        base = next(p for p, req in zip(proofs, requests) if len(req) == 4)
        valid = proofs[:63]
        out["adversaries"] = {}
        for name, bad, override in _witness_adversaries(base):
            batch = valid[:31] + [bad] + valid[31:]
            roots = [root] * 31 + [override or root] + [root] * 32
            sops.sha256_kernel_launches = 0
            got = V.verify_batch(batch, roots, device=dev)
            want = [mp.verify_host(p, r) for p, r in zip(batch, roots)]
            if got != want or got[31] or got.count(False) != 1 or not sops.sha256_kernel_launches:
                raise AssertionError(f"{name}: verdicts differ from verify_host or the plane did "
                                     f"not run ({sops.sha256_kernel_launches} launches)")
            out["adversaries"][name] = sops.sha256_kernel_launches
        print(f"the six adversaries, each in a batch of 64: every verdict == verify_host, only the "
              f"adversary False; SHA-256 launches {out['adversaries']}")

        # ---- a 4-proof request takes the oracle route
        sops.sha256_kernel_launches = 0
        if V.verify_batch(proofs[:4], root, device=dev) != [True] * 4 or \
                sops.sha256_kernel_launches:
            raise AssertionError("a 4-proof request did not take the oracle route")
        print(f"a 4-proof request (under DEVICE_MIN = {V.DEVICE_MIN}): the oracle route, 0 SHA-256 "
              f"launches")

        # ---- the coalescer under concurrent requests, one proof corrupted
        co_metrics = _MetricCounts()
        co = coalesce.VerifyCoalescer(metrics=co_metrics)
        bad_at = (int(rng.integers(COALESCE_THREADS)), int(rng.integers(COALESCE_REQUESTS)))
        batches = {}
        for t in range(COALESCE_THREADS):
            for r in range(COALESCE_REQUESTS):
                picks = rng.choice(len(proofs), int(rng.integers(1, 5)), replace=False)
                batch = [proofs[int(i)] for i in picks]
                if (t, r) == bad_at:
                    batch[-1] = _corrupted(batch[-1])
                batches[(t, r)] = batch
        results, errors = {}, []

        def client(t):
            try:
                for r in range(COALESCE_REQUESTS):
                    batch = batches[(t, r)]
                    results[(t, r)] = co.verify(batch, [root] * len(batch), device=dev)
            except Exception as e:  # noqa: BLE001 - reported and failed below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(COALESCE_THREADS)]
        sops.sha256_kernel_launches = 0
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        out["coalesce_s"] = time.perf_counter() - t0
        if errors:
            raise errors[0]
        for key, batch in batches.items():
            want = [mp.verify_host(p, root) for p in batch]
            if results[key] != want or want.count(False) != (key == bad_at):
                raise AssertionError(f"coalesced request {key}: {results[key]} != oracle {want}")
        flushes = {trig: co_metrics.get("serve_coalesce_flush_total", trigger=trig)
                   for trig in ("target", "deadline")}
        out.update(coalesce_flushes=flushes, coalesce_sha256_launches=sops.sha256_kernel_launches,
                   coalesce_proofs=sum(len(b) for b in batches.values()))
        if not sops.sha256_kernel_launches:
            raise AssertionError("the coalescer's flushes launched no SHA-256 kernel")
        print(f"coalescer: {COALESCE_THREADS} threads x {COALESCE_REQUESTS} requests "
              f"({out['coalesce_proofs']} proofs) in {out['coalesce_s']:.3f} s; flushes by "
              f"trigger {flushes}; {sops.sha256_kernel_launches} SHA-256 launches; every "
              f"request == the oracle, only the corrupted proof False")
    out["plane_nodes"] = dict(sorted(plane_nodes.items()))

    # ---- the vector commitment
    t0 = time.perf_counter()
    VC.generators(VC.WIDTH)
    out["generators_s"] = time.perf_counter() - t0
    values = [int.from_bytes(rng.bytes(31), "big") for _ in range(VC.WIDTH)]
    commitment, out["vc_commit_s"], out["vc_commit_launches"] = _counted(
        lambda: VC.commit(values, device=dev), "VC commit")
    if commitment != VC.commit(values, host=True):
        raise AssertionError("the card's commitment != the host Jacobian sum")
    opened = sorted(int(i) for i in rng.choice(VC.WIDTH, VC_OPENED, replace=False))
    opening, out["vc_open_s"], out["vc_open_launches"] = _counted(
        lambda: VC.open_indices(values, opened, device=dev), "VC open")
    host_opening = VC.open_indices(values, opened, host=True)
    if (opening.indices, opening.values, opening.rest) != \
            (host_opening.indices, host_opening.values, host_opening.rest):
        raise AssertionError("the card's opening != the host Jacobian sums")
    t0 = time.perf_counter()
    vecs = [[int.from_bytes(rng.bytes(31), "big") for _ in range(VC.WIDTH)]
            for _ in range(VC_FOLD)]
    commitments = [VC.commit(v, host=True) for v in vecs]
    openings = [VC.open_indices(v, [int(i) for i in rng.choice(VC.WIDTH, VC_FOLD_WIDTH,
                                                                replace=False)], host=True)
                for v in vecs]
    out["vc_fold_host_s"] = time.perf_counter() - t0
    with _recording(VC, "batch_g1_mul", lambda points, *rest: len(points)) as msm_lanes:
        ok, out["vc_fold_s"], out["vc_fold_launches"] = _counted(
            lambda: VC.verify_openings(commitments, openings, device=dev), "VC fold")
    bad, j = list(openings), VC_FOLD // 2
    bad[j] = VC.VcOpening(bad[j].indices, (bad[j].values[0] + 1,) + bad[j].values[1:],
                          bad[j].rest)
    tampered, out["vc_tampered_s"], _ = _counted(
        lambda: VC.verify_openings(commitments, bad, device=dev), "VC fold, tampered")
    lanes = sorted(msm_lanes.elements())
    if ok is not True or tampered is not False or len(lanes) != 1 or lanes[0] > 2 * VC_FOLD + VC.WIDTH:
        raise AssertionError(f"VC fold {ok}, tampered {tampered}, MSM lanes {lanes}")
    if VC.verify_openings(commitments, openings, host=True) is not True:
        raise AssertionError("the host fold rejected the openings")
    out["vc_fold_lanes"] = lanes[0]
    print(f"vector commitment: generators({VC.WIDTH}) {out['generators_s']:.3f} s; width-{VC.WIDTH} "
          f"commitment on the card {out['vc_commit_s']:.3f} s ({_total(out['vc_commit_launches'])} "
          f"field launches), opening at {VC_OPENED} indices {out['vc_open_s']:.3f} s, both == the "
          f"host Jacobian sums; {VC_FOLD} openings made on the host in "
          f"{out['vc_fold_host_s']:.3f} s, their fold one MSM of {lanes[0]} lanes on the card: "
          f"True in {out['vc_fold_s']:.3f} s ({_total(out['vc_fold_launches'])} field launches "
          f"{out['vc_fold_launches']}), tampered False in {out['vc_tampered_s']:.3f} s")

    out.update(peak_mib=_peak_mib(), seconds=time.perf_counter() - t_phase)
    print(f"peak device memory in the witness phase {out['peak_mib']:.0f} MiB")
    record["witness"] = out
    return ({"VC fold": lambda: VC.verify_openings(commitments, openings, device=dev)},
            plane_nodes)


def sign_phase(dev, rng, record: dict) -> dict:
    """Phase 5: a duty flush of SIGNERS signatures over DUTY_MESSAGES
    messages through ``sign_batch`` on the ladder (``DUTY_SIGN_MIN`` at 0),
    cold and warm; then hash, ladder and affine apart; every signature
    equal to the host route; then the flush once on its default route,
    whose launches must be what ``DUTY_SIGN_MIN`` picks."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import api
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.fields import R
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2_many
    from lambda_ethereum_consensus_tpu_torch.ops import bls_g2 as G2
    from lambda_ethereum_consensus_tpu_torch.ops import bls_sign as S

    _reset_peak()
    per_msg = SIGNERS // DUTY_MESSAGES
    scalars = [int.from_bytes(rng.bytes(32), "big") % (R - 1) + 1 for _ in range(SIGNERS)]
    sks = [k.to_bytes(32, "big") for k in scalars]
    messages = [b"chip-smoke duty msg %d" % (i // per_msg) for i in range(SIGNERS)]
    flushes = []
    for tag in ("cold", "warm"):
        with _duty_sign(0):
            sigs, sec, launches = _counted(lambda: S.sign_batch(sks, messages, device=dev),
                                           f"sign_batch ({tag})")
        flushes.append((sigs, sec, launches))
    if flushes[0][0] != flushes[1][0] or flushes[0][2] != flushes[1][2]:
        raise AssertionError("cold and warm sign flushes differ")
    sigs, launches = flushes[1][0], flushes[1][2]

    distinct = list(dict.fromkeys(messages))
    t0 = time.perf_counter()
    hashed = hash_to_g2_many(distinct)
    hash_s = time.perf_counter() - t0
    points = [hashed[i // per_msg] for i in range(SIGNERS)]
    jac, ladder_s, ladder_launches = _counted(lambda: G2.g2_ladder(points, scalars, 256, dev),
                                              "sign ladder")
    t0 = time.perf_counter()
    sig_points = G2.g2_affine(jac)
    affine_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    comb = S._sign_points_host(points, scalars)
    comb_s = time.perf_counter() - t0
    if sig_points != comb or [C.g2_to_bytes(p) for p in comb] != sigs:
        raise AssertionError("device signatures != the host route")
    default_card = SIGNERS >= S.DUTY_SIGN_MIN
    default_sigs, default_s, default_launches = _default_route(
        lambda: S.sign_batch(sks, messages, device=dev), default_card,
        "sign_batch (default route)")
    if default_sigs != sigs:
        raise AssertionError("the default route's signatures != the ladder's")
    sample = [0, 1, SIGNERS // 2, SIGNERS - 1]
    if [api.sign(sks[i], messages[i]) for i in sample] != [sigs[i] for i in sample]:
        raise AssertionError("device signatures != api.sign on a sample")
    wall, busy = _profiled(lambda: G2.g2_affine(G2.g2_ladder(points, scalars, 256, dev)),
                           attempts=2)
    peak = _peak_mib()
    print(f"sign flush of {SIGNERS} signatures ({DUTY_MESSAGES} messages x {per_msg} signers, "
          f"256-bit ladder, {-(-SIGNERS // S.SIGN_CHUNK)} dispatch): cold {flushes[0][1]:.3f} s, "
          f"warm {flushes[1][1]:.3f} s; {launches} field launches per flush "
          f"({_total(launches)} in all)")
    print(f"sign flush parts: hash {hash_s:.3f} s ({len(distinct)} messages on the host), "
          f"ladder {ladder_s:.3f} s ({_total(ladder_launches)} launches), affine {affine_s:.3f} s")
    print(f"{SIGNERS} signatures == the host route ({comb_s:.1f} s, native multiply per "
          f"signature) and api.sign on {len(sample)}")
    print(f"sign flush on its default route ({'ladder' if default_card else 'host route'}, "
          f"DUTY_SIGN_MIN {S.DUTY_SIGN_MIN}): {default_s:.3f} s, {_total(default_launches)} "
          f"field launches; signatures == the ladder's")
    print(_idle_line("sign ladder + affine", wall, busy) + f"; peak device memory {peak:.0f} MiB")
    record["sign"] = dict(
        signers=SIGNERS, messages=DUTY_MESSAGES, flush_s=[f[1] for f in flushes],
        launches_per_flush=launches, hash_s=hash_s, ladder_s=ladder_s, affine_s=affine_s,
        ladder_launches=ladder_launches, host_route_s=comb_s, profiled_s=wall,
        default_route="ladder" if default_card else "host", default_s=default_s,
        default_launches=default_launches,
        device_busy_ms=busy, peak_mib=peak,
    )
    return dict(scalars=scalars, messages=messages, points=points, sig_points=sig_points,
                sigs=sigs, hashed=dict(zip(distinct, hashed)))


def sets_phase(dev, rng, record: dict, duty: dict) -> dict:
    """Phase 6: the duty flush's (pk, message, signature) entries as
    signature sets, each on the device chain (the set gate at 0) and again
    on its default route, whose launches must be what the gate picks.
    Returns the entries and their message points for the size-routes
    phase."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import batch as B
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.hash_to_curve import DST_POP

    _reset_peak()
    msgs, sig_points = duty["messages"], duty["sig_points"]
    t0 = time.perf_counter()
    pks = [C.g1.multiply(C.G1_GENERATOR, k) for k in duty["scalars"]]
    duty["pks"] = pks
    pk_s = time.perf_counter() - t0
    memo = {(m, DST_POP): h for m, h in duty["hashed"].items()}
    entries = [(pk, m, sig) for pk, m, sig in zip(pks, msgs, sig_points)]
    items = [(C.g1_to_bytes(pk), m, sig) for pk, m, sig in zip(pks, msgs, duty["sigs"])]
    bad = SIGNERS // 3
    other = bad ^ 1  # a co-signer of the same message
    swapped = list(entries)
    swapped[bad] = (pks[bad], msgs[bad], sig_points[other])
    single = entries[:1]
    want_flags = [i != bad for i in range(len(swapped))]

    with _device_chain():
        ok, set_s, set_launches = _counted(
            lambda: B.verify_points(entries, message_points=memo, device=dev), "verify_points")
        if ok is not True:
            raise AssertionError(f"verify_points over {len(entries)} valid entries: {ok}")
        ok, bytes_s, _ = _counted(lambda: B.batch_verify(items, device=dev), "batch_verify")
        if ok is not True:
            raise AssertionError(f"batch_verify over {len(items)} valid byte triples: {ok}")
        flags, blame_s, blame_launches = _counted(
            lambda: B.batch_verify_each_points(swapped, message_points=memo, device=dev),
            "batch_verify_each_points")
        if flags != want_flags:
            raise AssertionError(f"bisection blamed {[i for i, f in enumerate(flags) if not f]}")
        with_none = list(entries)
        with_none[7] = (None, msgs[7], sig_points[7])
        if B.verify_points(with_none, message_points=memo, device=dev) is not False:
            raise AssertionError("a None point did not fail the set")
        _, cold_s, single_launches = _counted(
            lambda: B.verify_points(single, device=dev), "verify_points (one entry, cold)")
        ok, warm_s, warm_launches = _counted(
            lambda: B.verify_points(single, message_points=memo, device=dev),
            "verify_points (one entry, warm)")
        wall, busy = _profiled(lambda: B.verify_points(entries, message_points=memo, device=dev),
                               attempts=2)
    t0 = time.perf_counter()
    host_ok = B.verify_points(single, message_points=memo, host=True)
    host_s = time.perf_counter() - t0
    if not (ok is True and host_ok is True):
        raise AssertionError(f"one valid entry: device {ok}, host {host_ok}")
    # the whole set on the host tail (native rlc_verify): the size gate's
    # other side
    t0 = time.perf_counter()
    host_set_ok = B.verify_points(entries, message_points=memo, host=True)
    host_set_s = time.perf_counter() - t0
    if host_set_ok is not True:
        raise AssertionError(f"the host tail over {len(entries)} valid entries: {host_set_ok}")

    # the default routes: the gate decides by size alone
    gate = B.device_chain_threshold()
    default = {}
    for name, fn, n, want in (
        ("verify_points", lambda: B.verify_points(entries, message_points=memo, device=dev),
         len(entries), True),
        ("batch_verify", lambda: B.batch_verify(items, device=dev), len(items), True),
        ("batch_verify_each_points",
         lambda: B.batch_verify_each_points(swapped, message_points=memo, device=dev),
         len(swapped), want_flags),
        ("verify_points (one entry)",
         lambda: B.verify_points(single, message_points=memo, device=dev), 1, True),
    ):
        got, sec, launches = _default_route(fn, n >= gate, f"{name} (default route)")
        if got != want:
            raise AssertionError(f"{name} on its default route disagrees with the device chain")
        default[name] = dict(entries=n, device=n >= gate, s=sec, launches=launches)
    peak = _peak_mib()
    print(f"verify_points over {len(entries)} entries ({DUTY_MESSAGES} messages) True in "
          f"{set_s:.3f} s, {_total(set_launches)} field launches {set_launches}; "
          f"host pubkeys {pk_s:.1f} s")
    print(f"batch_verify over {len(items)} byte triples True in {bytes_s:.3f} s "
          f"(decompression and subgroup checks on the host included)")
    print(f"swapped signature: batch_verify_each_points blamed exactly entry {bad} in "
          f"{blame_s:.3f} s, {_total(blame_launches)} field launches")
    print("a None point: verify_points False")
    print(f"one entry (a proposer signature): cold {cold_s:.3f} s (hash_to_g2 included), warm "
          f"{warm_s:.3f} s, {_total(warm_launches)} field launches; host check (native "
          f"rlc_verify) {host_s:.3f} s; the {len(entries)} entries on the host {host_set_s:.3f} s")
    print(f"default routes at DEVICE_CHAIN_MIN {gate}, each verdict == the device chain's: "
          + "; ".join(f"{name} ({r['entries']} entries, {'device chain' if r['device'] else 'host tail'}) "
                      f"{r['s']:.3f} s, {_total(r['launches'])} field launches"
                      for name, r in default.items()))
    print(_idle_line("verify_points", wall, busy) + f"; peak device memory {peak:.0f} MiB")
    record["sets"] = dict(
        entries=len(entries), verify_points_s=set_s, verify_points_launches=set_launches,
        batch_verify_bytes_s=bytes_s, blame_s=blame_s, blame_launches=blame_launches,
        single_cold_s=cold_s, single_warm_s=warm_s, single_launches=warm_launches,
        single_cold_launches=single_launches, single_host_s=host_s, host_set_s=host_set_s,
        host_pubkeys_s=pk_s, default_routes=default,
        profiled_s=wall, device_busy_ms=busy, peak_mib=peak,
    )
    return dict(entries=entries, memo=memo)


def _median_run(fn, reps: int = ROUTE_REPS, setup=None):
    """(median wall seconds of ``reps`` runs of ``fn``, its result); every
    run must return what the first did.  With ``setup``, each run times
    ``fn(setup())`` without the ``setup()``."""
    times, results = [], []
    for _ in range(reps):
        arg = () if setup is None else (setup(),)
        _sync()
        t0 = time.perf_counter()
        results.append(fn(*arg))
        _sync()
        times.append(time.perf_counter() - t0)
    if any(r != results[0] for r in results):
        raise AssertionError(f"one route gave different answers across runs: {results}")
    return sorted(times)[reps // 2], results[0]


def _crossover(rows: list, size: str, card: str, host: str):
    """The smallest swept size at which the card's median is at or below the
    host route's, else None."""
    won = [r[size] for r in rows if r[card] <= r[host]]
    return min(won) if won else None


def _bisection_widths(valid: list) -> list:
    """The checks in each level of a level-synchronous bisection over
    entries whose validity is ``valid``: a failed range of more than one
    entry splits in half."""
    widths, pending = [], [range(len(valid))] if valid else []
    while pending:
        widths.append(len(pending))
        pending = [half for r in pending if len(r) > 1 and not all(valid[i] for i in r)
                   for half in (r[:len(r) // 2], r[len(r) // 2:])]
    return widths


def _drain_verdicts(results) -> list:
    return [None if r is None else (str(r), r.reject) for r in results]


def _tail_route(fn, tail_min: int, setup=None, reps: int = ROUTE_REPS):
    """``fn`` run ``reps`` times with the tail's constant at ``tail_min``
    (each on a fresh ``setup()``, untimed, where given): (median seconds,
    result, field launches per run)."""
    with _device_tail(tail_min):
        _zero_fq_launches()
        seconds, result = _median_run(fn, reps, setup)
        launches = _launches()
    if any(launches[k] % reps for k in FQ_KERNELS):
        raise AssertionError(f"field launches {launches} differ between the {reps} runs")
    return seconds, result, {k: launches[k] // reps for k in FQ_KERNELS}


def _tail_planes(dev, n: int):
    """Miller outputs ``(32, 2, 3, 2, n, 2)`` of ``n`` checks of two pairs:
    ``(P_i, Q)`` with ``(-P_i, Q)``, and every TAIL_FALSE-th check ``(P_i,
    Q)`` twice, so it is false."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.ops import bls_pairing as BPair

    q = C.g2.multiply_raw(C.G2_GENERATOR, SEED)
    pairs = []
    for i in range(n):
        pt = C.g1.multiply_raw(C.G1_GENERATOR, SEED + i)
        pairs += [(pt, q), (pt if i % TAIL_FALSE == TAIL_FALSE - 1 else C.g1.affine_neg(pt), q)]
    return BPair._miller_planes(pairs, dev).reshape(32, 2, 3, 2, n, 2)


def tail_routes(dev, card: str, paths: dict, blame: tuple) -> dict:
    """Size routes, part (d): the pairing tail.  First the tail alone:
    ``check_tail`` over the Miller outputs of C checks (``_tail_planes``)
    through the hybrid and the composed tail (the constant above C, then at
    0), warm, the median of ROUTE_REPS runs, the verdicts of both equal to
    the construction.  The sweep runs up from one check; the hybrid tail,
    which loses along it, stops once the composed one has been at least as
    fast at ROUTE_STOP sizes in a row, and the sweep ends at TAIL_SWEEP_END
    once the composed tail has won anywhere (the outputs past it are built
    only if it goes on).  Then each of ``paths`` (one chained call each) on
    its default route and on the composed tail, TAIL_PATH_REPS runs each,
    verdicts equal, and the launch gap between them held to the composed final
    exponentiation's field calls.  A path is a callable, or ``(setup,
    fn)``: then each run times ``fn(setup())`` without the setup.  Last
    ``blame`` = (name, fn, verdicts, levels): a drain whose bisection has
    ``levels`` levels of at least DEVICE_TAIL_MIN checks, once on its
    default route and once on the hybrid tail throughout, its verdicts
    equal to ``verdicts`` on both, the launch gap ``levels`` composed final
    exponentiations."""
    import torch

    from lambda_ethereum_consensus_tpu_torch.ops import bls_pairing as BPair

    t_start = time.perf_counter()
    miller = _tail_planes(dev, TAIL_SWEEP_END)
    check_tail = BPair.get_pairing_ops(dev)["check_tail"]
    rows, losses = [], 0
    for n in TAIL_SIZES:
        if losses >= ROUTE_STOP or (n > TAIL_SWEEP_END and any(
                r["composed_s"] <= r["hybrid_s"] for r in rows)):
            break
        if n > miller.shape[4]:
            miller = _tail_planes(dev, TAIL_SIZES[-1])
        f, mask = miller[..., :n, :], torch.ones((n, 2), dtype=torch.bool, device=dev)
        want = [i % TAIL_FALSE != TAIL_FALSE - 1 for i in range(n)]
        row = {"checks": n}
        row["hybrid_s"], hybrid, row["hybrid_launches"] = _tail_route(
            lambda: check_tail(f, mask).cpu().tolist(), n + 1)
        row["composed_s"], composed, row["composed_launches"] = _tail_route(
            lambda: check_tail(f, mask).cpu().tolist(), 0)
        if not hybrid == composed == want:
            raise AssertionError(f"the tail at {n} checks: hybrid {hybrid}, composed {composed}")
        row["gap"] = _tail_launch_gap(row["composed_launches"], row["hybrid_launches"],
                                      f"the tail at {n} checks", 1)
        losses = losses + 1 if row["composed_s"] <= row["hybrid_s"] else 0
        rows.append(row)
        print(f"size route, tail of {n} checks (check_tail, 2 pairs each): hybrid "
              f"{row['hybrid_s']:.4f} s, composed {row['composed_s']:.4f} s ({row['gap']} more "
              f"field launches); verdicts equal, {want.count(False)} false [{card}]")
    out = dict(rows=rows, crossover=_crossover(rows, "checks", "composed_s", "hybrid_s"),
               constant=BPair.DEVICE_TAIL_MIN)
    del miller

    # the three paths, one chained call each, on both tails
    out["paths"] = {}
    hybrid = 1 < BPair.DEVICE_TAIL_MIN  # the default tail of one check
    for name, path in paths.items():
        setup, fn = path if isinstance(path, tuple) else (None, path)
        row = {}
        row["default_s"], default, row["default_launches"] = _tail_route(
            fn, BPair.DEVICE_TAIL_MIN, setup, TAIL_PATH_REPS)
        row["composed_s"], composed, row["composed_launches"] = _tail_route(
            fn, 0, setup, TAIL_PATH_REPS)
        if default != composed:
            raise AssertionError(f"{name}: the default route said {default}, the composed tail "
                                 f"{composed}")
        row["gap"] = _tail_launch_gap(row["composed_launches"], row["default_launches"], name,
                                      int(hybrid))
        out["paths"][name] = row
        print(f"tail of {name}: default route ({'hybrid' if hybrid else 'composed'}) "
              f"{row['default_s']:.4f} s, {_total(row['default_launches'])} field launches; "
              f"composed {row['composed_s']:.4f} s, {_total(row['composed_launches'])} (the gap "
              f"{row['gap']} == the composed final exponentiation's); verdicts equal [{card}]")
    out["sweep_and_paths_s"] = time.perf_counter() - t_start

    # a drain blaming enough forged aggregates that a bisection level
    # reaches the composed tail: its default route against the hybrid tail
    # throughout, one run each
    name, fn, want, levels = blame
    t0 = time.perf_counter()
    row = {"levels": levels}
    row["default_s"], default, row["default_launches"] = _tail_route(
        fn, BPair.DEVICE_TAIL_MIN, reps=1)
    row["hybrid_s"], hybrid_flags, row["hybrid_launches"] = _tail_route(
        fn, len(want) + 1, reps=1)
    if not default == hybrid_flags == want:
        raise AssertionError(f"{name}: the default route blamed "
                             f"{[i for i, ok in enumerate(default) if not ok]}, the hybrid tail "
                             f"{[i for i, ok in enumerate(hybrid_flags) if not ok]}")
    row["gap"] = _tail_launch_gap(row["default_launches"], row["hybrid_launches"], name, levels)
    row["seconds"] = time.perf_counter() - t0
    out["blame"] = {name: row}
    print(f"tail of {name}: default route ({levels} level(s) on the composed tail) "
          f"{row['default_s']:.4f} s, {_total(row['default_launches'])} field launches; hybrid "
          f"tail throughout {row['hybrid_s']:.4f} s, {_total(row['hybrid_launches'])} (the gap "
          f"{row['gap']} == {levels} composed final exponentiation(s)); one run each, "
          f"{want.count(False)} blamed on both [{card}]")
    return out


def sign_routes(dev, card: str, sign_scalars: list) -> dict:
    """Size routes, part (e): ``sign_batch`` of SIGN_SWEEP signatures (keys
    tiled from ``sign_scalars``, SIGN_PER_MESSAGE signers a message) from
    the largest down, each timed warm (median of ROUTE_REPS runs) on the
    host route (the native library's multiply per signature) and on the
    card's ladder, through ``DUTY_SIGN_MIN``; every signature equal.  The
    card stops once the host has been at least as fast at ROUTE_STOP sizes
    in a row; the host route runs on to the smallest size."""
    from lambda_ethereum_consensus_tpu_torch.ops import bls_sign as S

    t0 = time.perf_counter()
    sks = [k.to_bytes(32, "big") for k in
           (sign_scalars * -(-SIGN_SWEEP[0] // len(sign_scalars)))[:SIGN_SWEEP[0]]]
    rows, losses = [], 0
    for n in SIGN_SWEEP:
        per = min(SIGN_PER_MESSAGE, n)
        msgs = [b"chip-smoke sign sweep %d" % (i // per) for i in range(n)]
        row = {"signatures": n, "messages": n // per}
        _zero_fq_launches()
        with _duty_sign(n + 1):
            row["host_s"], host_sigs = _median_run(
                lambda: S.sign_batch(sks[:n], msgs, device=dev))
        if _total(_launches()):
            raise AssertionError(f"the host route of {n} signatures launched {_launches()}")
        if losses < ROUTE_STOP:
            _zero_fq_launches()
            with _duty_sign(0):
                row["card_s"], card_sigs = _median_run(
                    lambda: S.sign_batch(sks[:n], msgs, device=dev))
            _require_all(_launches(), f"the ladder's sign flush of {n}")
            if card_sigs != host_sigs:
                raise AssertionError(f"a sign flush of {n}: the routes' signatures differ")
            losses = losses + 1 if row["host_s"] <= row["card_s"] else 0
        rows.append(row)
        print(f"size route, sign flush of {n} signatures ({row['messages']} messages x {per} "
              f"signers, sign_batch): card "
              + (f"{row['card_s']:.4f} s" if "card_s" in row else "stopped")
              + f", host route {row['host_s']:.4f} s; signatures equal [{card}]")
    timed = [r for r in rows if "card_s" in r]
    return dict(rows=rows, crossover=_crossover(timed, "signatures", "card_s", "host_s"),
                constant=S.DUTY_SIGN_MIN, seconds=time.perf_counter() - t0)


def size_routes_phase(dev, record: dict, card: str, spec, sets: dict, node: dict,
                      tail_paths: dict, blame: tuple, sign_scalars: list) -> None:
    """The size routes: each route of the three size gates timed warm
    (median of ROUTE_REPS runs) on either side of where it crosses, every
    route's verdicts equal.  (a) a signature set through ``verify_points``
    on the device chain against the host tail (native ``rlc_verify``); (b)
    ``on_attestation_batch`` of the first k of phase 3c's drain,
    re-submitted to its store after the warm drain, through the cached body
    and the host body (every verdict None, the latest messages unchanged),
    and the cached body cold once; (c) ``_verify_deferred_attestations``
    over the first k aggregates of phase 3c's block through its three
    routes; (d) the pairing tail (``tail_routes``) alone, on ``tail_paths``
    and on the blaming drain ``blame`` = (name, fn, verdicts), its levels
    of at least DEVICE_TAIL_MIN checks counted from the verdicts; (e) the
    sign flush (``sign_batch``) of SIGN_SWEEP signatures by keys tiled from
    ``sign_scalars``, on the card's ladder and on the host route, every
    signature equal.  Each
    route is forced through the constants and restored; a
    route stops once another has been at least as fast at ROUTE_STOP sizes
    in a row, and a sweep ends when its host side has stopped.
    Every row is printed beside the card's name and power limit, the
    crossovers beside the constants."""
    from lambda_ethereum_consensus_tpu_torch import fork_choice as FC
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import batch as B
    from lambda_ethereum_consensus_tpu_torch.fork_choice import attestation as FA
    from lambda_ethereum_consensus_tpu_torch.ops import bls_pairing as BPair
    from lambda_ethereum_consensus_tpu_torch.ops import bls_sign as S
    from lambda_ethereum_consensus_tpu_torch.state_transition import operations

    t_phase = time.perf_counter()
    out: dict = {}

    # ---- (a) the set, from the largest down: the card loses at the small end
    entries, memo = sets["entries"], sets["memo"]
    with _device_chain():
        B.verify_points(entries[:1], message_points=memo, device=dev)
    rows, losses = [], 0
    for n in ROUTE_SET_SIZES:
        if losses >= ROUTE_STOP:
            break
        tiled = (entries * -(-n // len(entries)))[:n]
        row = {"entries": n}
        row["host_s"], host_ok = _median_run(
            lambda: B.verify_points(tiled, message_points=memo, host=True))
        with _device_chain():
            row["card_s"], card_ok = _median_run(
                lambda: B.verify_points(tiled, message_points=memo, device=dev))
        if (host_ok, card_ok) != (True, True):
            raise AssertionError(f"a set of {n} valid entries: host {host_ok}, card {card_ok}")
        losses = losses + 1 if row["card_s"] > row["host_s"] else 0
        rows.append(row)
        print(f"size route, set of {n} entries (verify_points): card {row['card_s']:.4f} s, "
              f"host tail {row['host_s']:.4f} s; every verdict True [{card}]")
    out["set"] = dict(rows=rows, crossover=_crossover(rows, "entries", "card_s", "host_s"),
                      constant=B.DEVICE_CHAIN_MIN)

    # ---- (b) the drain, re-submitted after phase 3c's warm drain
    store, drain = node["store"], node["drain"]
    before = dict(store.latest_messages)
    accepted = [None] * max(ROUTE_DRAIN_SIZES)
    with _drain_gate(0):
        FC.on_attestation_batch(store, drain[:ROUTE_DRAIN_SIZES[0]], spec=spec, device=dev)
    rows, losses = [], 0
    for k in ROUTE_DRAIN_SIZES:
        if losses >= ROUTE_STOP:
            break
        sub = drain[:k]
        row = {"aggregates": k}
        with _drain_gate(0):
            row["cached_s"], got = _median_run(lambda: _drain_verdicts(
                FC.on_attestation_batch(store, sub, spec=spec, device=dev)))
        with _drain_gate(k + 1):
            row["host_s"], host_got = _median_run(lambda: _drain_verdicts(
                FC.on_attestation_batch(store, sub, spec=spec, device=dev)))
        if got != accepted[:k] or host_got != accepted[:k]:
            raise AssertionError(f"the drain of {k}: verdicts not all None on both bodies")
        losses = losses + 1 if row["cached_s"] <= row["host_s"] else 0
        rows.append(row)
        print(f"size route, drain of {k} aggregates (on_attestation_batch): cached body "
              f"{row['cached_s']:.4f} s, host body {row['host_s']:.4f} s; every verdict None "
              f"[{card}]")
    store.attestation_contexts.clear()
    with _drain_gate(0):
        cold_s, got = _median_run(lambda: _drain_verdicts(FC.on_attestation_batch(
            store, drain[:ROUTE_COLD_DRAIN], spec=spec, device=dev)), reps=1)
    if got != accepted[:ROUTE_COLD_DRAIN]:
        raise AssertionError("the cold cached drain rejected valid aggregates")
    if store.latest_messages != before:
        raise AssertionError("re-submitted aggregates moved the latest messages")
    print(f"size route, drain of {ROUTE_COLD_DRAIN} aggregates, cached body cold (no epoch "
          f"context: committees and their sums built again): {cold_s:.4f} s; the latest "
          f"messages unchanged [{card}]")
    out["drain"] = dict(rows=rows, crossover=_crossover(rows, "aggregates", "cached_s", "host_s"),
                        cold_aggregates=ROUTE_COLD_DRAIN, cold_cached_s=cold_s,
                        constant=FC.attestation_batch_target())

    # ---- (c) the block's signature set: the committee cache against host
    # sums on the host tail and on the device chain
    state, deferred = node["block_set"]
    with _block_forced(COMMITTEE_CACHE, 0, 0):
        operations._verify_deferred_attestations(state, deferred[:1], spec, dev)
    rows, losses = [], {HOST_TAIL: 0, DEVICE_CHAIN: 0}
    for k in ROUTE_BLOCK_SIZES:
        if min(losses.values()) >= ROUTE_STOP:
            break
        sub = deferred[:k]
        members = sum(len(ind.attesting_indices) for _, ind, _, _ in sub)
        row = {"aggregates": k, "members": members}
        for route in (COMMITTEE_CACHE, HOST_TAIL, DEVICE_CHAIN):
            if losses.get(route, 0) >= ROUTE_STOP:
                continue
            with _block_forced(route, members, k):
                row[f"{route}_s"], ok = _median_run(
                    lambda: operations._verify_deferred_attestations(state, sub, spec, dev))
            if ok is not True:
                raise AssertionError(f"{k} aggregates: the {ROUTE_LABEL[route]} route said {ok}")
        # a host-sum route loses where another route ran at most as long
        for route in losses:
            if f"{route}_s" in row:
                others = [row[f"{r}_s"] for r in ROUTE_LABEL if r != route and f"{r}_s" in row]
                losses[route] = losses[route] + 1 if min(others) <= row[f"{route}_s"] else 0
        # the host-sum route the set gate picks for this many aggregates
        row["host_sums"] = DEVICE_CHAIN if k >= B.DEVICE_CHAIN_MIN else HOST_TAIL
        rows.append(row)
        print(f"size route, block set of {k} aggregates ({members} members): "
              + "; ".join(f"{ROUTE_LABEL[r]} " + (f"{row[f'{r}_s']:.4f} s" if f"{r}_s" in row
                                                   else "stopped") for r in ROUTE_LABEL)
              + f"; every verdict True [{card}]")
    won = [r["members"] for r in rows if f"{r['host_sums']}_s" not in r
           or r["cached_s"] <= r[f"{r['host_sums']}_s"]]
    out["block"] = dict(rows=rows, crossover_members=min(won) if won else None,
                        constant=operations.BLOCK_BATCH_MIN_MEMBERS)
    FA._STATE_CTX.clear()

    # ---- (d) the pairing tail, alone and on three paths
    t0 = time.perf_counter()
    name, fn, want = blame
    levels = sum(w >= BPair.DEVICE_TAIL_MIN for w in _bisection_widths(want))
    out["tail"] = tail_routes(dev, card, {
        **tail_paths,
        f"the set of {len(entries)} entries (verify_points, device chain)":
            lambda: _on_device_chain(lambda: B.verify_points(entries, message_points=memo,
                                                              device=dev)),
    }, (name, fn, want, levels))
    out["tail"]["seconds"] = time.perf_counter() - t0

    # ---- (e) the sign flush, from the largest down
    out["sign"] = sign_routes(dev, card, sign_scalars)

    out["seconds"] = time.perf_counter() - t_phase
    record["size_routes"] = out
    print(f"size-route crossovers (the card's median at or below the host's): set "
          f"{out['set']['crossover']} entries (DEVICE_CHAIN_MIN {B.DEVICE_CHAIN_MIN}), drain "
          f"{out['drain']['crossover']} aggregates (DRAIN_DEVICE_MIN, attestation_batch_target() "
          f"{FC.attestation_batch_target()}), block {out['block']['crossover_members']} members "
          f"against the host sums the set gate picks (BLOCK_BATCH_MIN_MEMBERS "
          f"{operations.BLOCK_BATCH_MIN_MEMBERS}), tail {out['tail']['crossover']} checks "
          f"(DEVICE_TAIL_MIN {BPair.DEVICE_TAIL_MIN}; the tail part "
          f"{out['tail']['seconds']:.1f} s: the sweep and three paths "
          f"{out['tail']['sweep_and_paths_s']:.1f} s, the blaming drain "
          f"{out['tail']['blame'][name]['seconds']:.1f} s), sign flush {out['sign']['crossover']} "
          f"signatures (DUTY_SIGN_MIN {S.DUTY_SIGN_MIN}; the sweep {out['sign']['seconds']:.1f} "
          f"s); phase {out['seconds']:.1f} s [{card}]")


def kzg_setup(record: dict):
    from lambda_ethereum_consensus_tpu_torch.da import kzg as K

    t0 = time.perf_counter()
    setup = K.dev_setup(BLOB_WIDTH)
    setup_s = time.perf_counter() - t0
    print(f"KZG dev setup of width {BLOB_WIDTH} ({BLOB_WIDTH} G1 scalar multiplications) "
          f"on the host in {setup_s:.1f} s")
    record["kzg_setup_s"] = setup_s
    return setup


def mul_phase(dev, rng, record: dict, duty: dict, setup) -> None:
    """Phase 7: batch_g1_mul / batch_g2_mul with k = 0 lanes against the
    host on samples, and pairing_products_are_one against pairing_check."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.pairing import pairing_check
    from lambda_ethereum_consensus_tpu_torch.ops import bls_g1 as G1
    from lambda_ethereum_consensus_tpu_torch.ops import bls_g2 as G2
    from lambda_ethereum_consensus_tpu_torch.ops import bls_pairing as BPair

    _reset_peak()
    runs = {}
    for name, group, mul, bases, nbits in (
        ("batch_g1_mul", C.g1, G1.batch_g1_mul, list(setup.g1_lagrange[:G1_LANES]), 255),
        ("batch_g2_mul", C.g2, G2.batch_g2_mul, duty["sig_points"][:G2_LANES], 64),
    ):
        n = len(bases)
        every = max(n // 8, 2)  # every this-many-th scalar is 0
        ks = [int.from_bytes(rng.bytes(32), "big") >> (256 - nbits) for _ in range(n)]
        for i in range(0, n, every):
            ks[i] = 0
        out, sec, launches = _counted(lambda: mul(bases, ks, 256 if nbits > 64 else 64, dev),
                                      name)
        pick = sorted({0, every, *rng.choice(n, MUL_SAMPLE - 2, replace=False).tolist()})
        want = [group.multiply_raw(bases[i], ks[i]) for i in pick]
        if [out[i] for i in pick] != want or [out[i] is None for i in range(n)] != [
            k == 0 for k in ks
        ]:
            raise AssertionError(f"{name} != host multiply_raw on the sample")
        runs[name] = dict(lanes=n, scalar_bits=nbits, seconds=sec, launches=launches)
        print(f"{name}: {n} lanes, {nbits}-bit scalars, {n // every} k = 0 lanes, {sec:.3f} s, "
              f"{_total(launches)} field launches {launches}; == host on {len(pick)} lanes")

    neg_g = C.g1.affine_neg(C.G1_GENERATOR)
    half = PAIRS_PER_CHECK // 2
    checks, expect = [], []
    for c in range(PAIR_CHECKS):
        signers = list(range(c * 16, c * 16 + half))
        sigs = [duty["sig_points"][i] for i in signers]
        if c % 2:  # a false check: one signature from another key
            sigs[0] = duty["sig_points"][signers[0] ^ 1]
        checks.append([pair for i, s in zip(signers, sigs)
                       for pair in ((duty["pks"][i], duty["points"][i]), (neg_g, s))])
        expect.append(c % 2 == 0)
    got, pair_s, pair_launches = _counted(lambda: BPair.pairing_products_are_one(checks, dev),
                                          "pairing_products_are_one")
    with _device_tail():
        composed, composed_s, composed_launches = _counted(
            lambda: BPair.pairing_products_are_one(checks, dev),
            "pairing_products_are_one (composed tail)")
    gap = _tail_launch_gap(composed_launches, pair_launches, "pairing_products_are_one",
                           int(PAIR_CHECKS < BPair.DEVICE_TAIL_MIN))
    t0 = time.perf_counter()
    host = [pairing_check(c) for c in checks]
    host_s = time.perf_counter() - t0
    if not got == composed == host == expect:
        raise AssertionError(f"pairing_products_are_one {got}, on the composed tail {composed}, "
                             f"host {host}, expected {expect}")
    peak = _peak_mib()
    tail = "hybrid" if PAIR_CHECKS < BPair.DEVICE_TAIL_MIN else "composed"
    print(f"pairing_products_are_one: {PAIR_CHECKS} checks x {PAIRS_PER_CHECK} pairs {got} == host "
          f"pairing_check ({host_s:.2f} s on the host) in {pair_s:.3f} s on its default tail "
          f"({tail}), {_total(pair_launches)} field launches; on the composed tail "
          f"{composed_s:.3f} s, {gap} field launches more; peak device memory {peak:.0f} MiB")
    record["mul"] = dict(runs, pairing_s=pair_s, pairing_launches=pair_launches,
                         pairing_composed_s=composed_s,
                         pairing_composed_launches=composed_launches,
                         pairing_host_s=host_s, peak_mib=peak)


def kzg_phase(dev, rng, record: dict, setup) -> tuple[list, list, list]:
    """Phase 8: six mainnet-width blobs committed, proved and folded on the
    card; returns the blobs, their commitments and their proofs (for phase
    3g; blob 0 for phase 9)."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
    from lambda_ethereum_consensus_tpu_torch.crypto.bls.fields import R
    from lambda_ethereum_consensus_tpu_torch.da import kzg as K

    _reset_peak()
    evals = [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(BLOB_WIDTH)]
             for _ in range(N_BLOBS)]
    blobs = [b"".join(v.to_bytes(32, "big") for v in e) for e in evals]
    lagrange = K._lagrange_at(K._dev_tau(BLOB_WIDTH), setup.domain)
    commitments, commit = [], []
    for b, e in zip(blobs, evals):
        c, sec, launches = _counted(lambda: K.blob_to_commitment(b, setup, device=dev),
                                    "blob_to_commitment")
        oracle = C.g1.multiply(C.G1_GENERATOR, sum(x * l for x, l in zip(e, lagrange)) % R)
        if c != C.g1_to_bytes(oracle):
            raise AssertionError(f"commitment {len(commitments)} != [sum blob_i L_i(tau)] G1")
        commitments.append(c)
        commit.append((sec, launches))
    t0 = time.perf_counter()
    per_term = K._msm(setup.g1_lagrange, evals[0], host=True)
    per_term_s = time.perf_counter() - t0
    if C.g1_to_bytes(per_term) != commitments[0]:
        raise AssertionError("commitment 0 != the per-term host MSM")
    proofs, prove = [], []
    for b, c in zip(blobs, commitments):
        pf, sec, launches = _counted(lambda: K.compute_blob_proof(b, c, setup, device=dev),
                                     "compute_blob_proof")
        proofs.append(pf)
        prove.append((sec, launches))
    ok, fold_s, fold_launches = _counted(
        lambda: K.verify_blob_batch(blobs, commitments, proofs, setup, device=dev),
        "verify_blob_batch")
    if ok is not True:
        raise AssertionError(f"verify_blob_batch over {N_BLOBS} valid blobs: {ok}")
    bad = N_BLOBS // 2
    swapped = list(proofs)
    swapped[bad] = proofs[(bad + 1) % N_BLOBS]
    folded = K.verify_blob_batch(blobs, commitments, swapped, setup, device=dev)
    t0 = time.perf_counter()
    per_blob = [K.verify_blob_proof(b, c, pf, setup)
                for b, c, pf in zip(blobs, commitments, swapped)]
    per_blob_s = time.perf_counter() - t0
    if folded is not False or per_blob != [i != bad for i in range(N_BLOBS)]:
        raise AssertionError(f"swapped proof: fold {folded}, per blob {per_blob}")
    wall, busy = _profiled(lambda: K.blob_to_commitment(blobs[0], setup, device=dev),
                           attempts=2)
    peak = _peak_mib()
    print(f"{N_BLOBS} commitments at width {BLOB_WIDTH} == [sum blob_i L_i(tau)] G1 (and blob 0 "
          f"== the per-term host MSM, {per_term_s:.1f} s on the host)")
    for tag, rows in (("commitment", commit), ("blob proof", prove)):
        print(f"{tag} dispatches: " + ", ".join(f"{s:.3f} s" for s, _ in rows)
              + f"; {_total(rows[-1][1])} field launches each {rows[-1][1]}")
    print(f"verify_blob_batch over {N_BLOBS} blobs True in {fold_s:.3f} s "
          f"({_total(fold_launches)} field launches); with proof {bad} swapped the fold is False "
          f"and verify_blob_proof blames exactly blob {bad} ({per_blob_s:.2f} s on the host)")
    print(_idle_line("commitment", wall, busy) + f"; peak device memory {peak:.0f} MiB")
    record["kzg"] = dict(
        width=BLOB_WIDTH, blobs=N_BLOBS, commit=commit, prove=prove, fold_s=fold_s,
        fold_launches=fold_launches, per_term_host_s=per_term_s, per_blob_host_s=per_blob_s,
        profiled_s=wall, device_busy_ms=busy, peak_mib=peak,
    )
    return blobs, commitments, proofs


@contextlib.contextmanager
def _recording(module, attr: str, key):
    """Counts each call of ``module.attr`` by ``key(*args)`` while active
    (the wrappers look each other up through their module, so every call of
    the path is seen); yields the Counter."""
    hist = Counter()
    real = getattr(module, attr)

    def recording(*args):
        hist[key(*args)] += 1
        return real(*args)

    setattr(module, attr, recording)
    try:
        yield hist
    finally:
        setattr(module, attr, real)


def _fq_lanes(name, a, b) -> tuple[str, int]:
    import torch

    return name, math.prod(torch.broadcast_shapes(a.shape, b.shape)[1:])


def _weighted_quantile(hist: Counter, q: float) -> int:
    """The lane count below which a share ``q`` of the launches fall."""
    total = sum(hist.values())
    acc = 0
    for lanes in sorted(hist):
        acc += hist[lanes]
        if acc >= q * total:
            return lanes
    raise AssertionError("empty launch histogram")


def _device_us(fn, reps: int, kernel: str, attempts: int = 6) -> tuple[float, int]:
    """Device time per launch of ``kernel`` (a symbol-name fragment) over
    ``reps`` calls of ``fn``, from the profiler's device trace, and the
    number of launches the trace kept (it can drop over half of them, and
    now and then all: such a window is profiled again, up to ``attempts``
    times; the launches are identical, so the mean over those kept stands
    for all)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            _sync()
        evts = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in evts)
        if count:
            break
    if not 0 < count <= reps:
        raise AssertionError(f"profiler saw {count} launches of {kernel}, expected {reps}")
    return sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
               for e in evts) / count, count


def path_shape_timings(dev, rng, paths: dict) -> tuple[int, dict]:
    """Phase 9: each field kernel at the launch-weighted median and
    90th-percentile lane counts of each path, held against its plain
    version there bit for bit (a full and a broadcast (32, 1) right
    operand); then its device time per launch (profiler), the wall time per
    wrapper call back to back (CUDA events; host-bound at these sizes), and
    its byte bound there (two 128-byte operands read and one written per
    lane).  A path is a callable, run once under recording, or the Counter
    of (kernel, lanes) recorded where the path ran (phase 3g's).  Returns
    (max abs error, {path: {kernel: row}})."""
    import torch

    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP

    max_err = 0
    out = {}
    for path, fn in paths.items():
        if isinstance(fn, Counter):
            hist = fn
        else:
            with _recording(BP, "_launch", _fq_lanes) as hist:
                fn()
                _sync()
        out[path] = {}
        for name in FQ_KERNELS:
            kernel = getattr(BP, name)
            lanes = Counter({m: c for (n, m), c in hist.items() if n == name})
            row = dict(launches=sum(lanes.values()))
            for tag, q in (("p50", 0.5), ("p90", 0.9)):
                m = _weighted_quantile(lanes, q)
                a = _fq_operands(rng, m, dev, [])
                b = _fq_operands(rng, m, dev, [])
                for rhs in (b, _fq_operands(rng, 1, dev, [])):
                    got, plain = kernel(a, rhs), BP._PLAIN[name](a, rhs)
                    err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max().item())
                    max_err = max(max_err, err)
                    if err or not torch.equal(got, plain):
                        raise AssertionError(f"{name} kernel != plain version at the {path} "
                                             f"{tag} shape (32, {m}), right operand "
                                             f"{tuple(rhs.shape)}")
                call_us = _event_ms(lambda: kernel(a, b), reps=TIMING_REPS, warmup=5) * 1e3
                device_us, traced = _device_us(lambda: kernel(a, b), TIMING_REPS,
                                               f"fq_{name}")
                geometry = BP._geometry(name, m)
                bare_us, _ = _device_us(lambda: BP._run("empty", a, b, (32, m), geometry),
                                        TIMING_REPS,
                                        "fq_empty")
                bound_us = 3 * 128 * m / HBM_BYTES_PER_S * 1e6
                row[tag] = dict(lanes=m, device_us=device_us, traced=traced, call_us=call_us,
                                byte_bound_us=bound_us, share=bound_us / device_us,
                                bare_launch_us=bare_us, group=geometry[0])
            out[path][name] = row
            print(f"{path:>10} {name}: {row['launches']} launches; "
                  + "; ".join(f"{tag} {r['lanes']} lanes: device {r['device_us']:.3f} us per "
                              f"launch, bare launch {r['bare_launch_us']:.3f} us, byte bound "
                              f"{r['byte_bound_us']:.3f} us ({100 * r['share']:.1f} %), "
                              f"wrapper call {r['call_us']:.1f} us"
                              for tag, r in ((t, row[t]) for t in ("p50", "p90"))))
    print("field kernels == plain versions at every path's p50 and p90 lane counts "
          "(full and broadcast (32, 1) right operands)")
    return max_err, out


def body_sweep(dev, rng, name: str, sizes: tuple, bodies: dict) -> tuple[int, dict]:
    """Phase 9: kernel ``name``'s bodies (``{label: (threads per element,
    threads per block)}``) at each of ``sizes`` lanes, each held against the
    plain version there bit for bit and timed (profiler device time per
    launch), beside the byte bound and a bare launch of each grid.  Where
    mul_mod's one-thread body overtakes its group body sets
    ``MUL_GROUP_THRESHOLD``; sub_mod's sweep picks ``SUB_GROUP`` and its
    block size.  Returns (max abs error, rows)."""
    import torch

    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP

    max_err = 0
    rows = {}
    for m in sizes:
        a, b = _fq_operands(rng, m, dev, []), _fq_operands(rng, m, dev, [])
        plain = BP._PLAIN[name](a, b)
        row = dict(byte_bound_us=3 * 128 * m / HBM_BYTES_PER_S * 1e6)
        for label, (group, threads) in bodies.items():
            geometry = (group, threads, -(-m * group // threads))
            got = BP._run(name, a, b, (32, m), geometry)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max().item())
            max_err = max(max_err, err)
            if err or not torch.equal(got, plain):
                raise AssertionError(f"{name} {label} body != plain version at N={m}")
            us, _ = _device_us(lambda: BP._run(name, a, b, (32, m), geometry), 100, f"fq_{name}")
            bare, _ = _device_us(lambda: BP._run("empty", a, b, (32, m), geometry), 100,
                                 "fq_empty")
            row[label] = dict(device_us=us, bare_launch_us=bare)
        wrapper = BP._geometry(name, m)[:2]
        row["wrapper_body"] = next((label for label, body in bodies.items() if body == wrapper),
                                   None)
        rows[m] = row
        print(f"{name} at {m} lanes: " + ", ".join(
            f"{label} {row[label]['device_us']:.3f} us (bare {row[label]['bare_launch_us']:.3f})"
            for label in bodies) + f"; byte bound {row['byte_bound_us']:.3f} us; the wrapper runs "
            f"the {row['wrapper_body']} body")
        del a, b, plain
    print(f"{name}'s bodies == plain version at {list(sizes)} lanes")
    return max_err, rows


def sha256_path_shapes(dev, hist: Counter, opcodes: Counter, clock_mhz: float,
                       label: str) -> dict:
    """Phase 9: the SHA-256 kernel at the launch-weighted median and 90th
    percentile of the node counts ``hist`` of a path's launches (one state
    root's, the witness plane's), held
    against its plain version there, timed (profiler device time per
    launch) beside a bare launch of the same grid (the field library's
    empty kernel on 256-thread blocks, the SHA-256 launcher's) and the
    bound: the larger of 96 bytes a node over the memory rate and phase 2's
    SASS count over the issue rate."""
    import torch

    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops

    row = dict(launches=sum(hist.values()), lanes=dict(sorted(hist.items())))
    zero = torch.zeros((32, 1), dtype=torch.int32, device=dev)
    for tag, q in (("p50", 0.5), ("p90", 0.9)):
        n = _weighted_quantile(hist, q)
        blocks = torch.randint(0, 256, (n, 64), dtype=torch.uint8, device=dev)
        if not torch.equal(sops.sha256_nodes(blocks), sops.hash_blocks_torch(blocks)):
            raise AssertionError(f"sha256 kernel != plain version at {label}'s {tag} "
                                 f"({n} nodes)")
        device_us, _ = _device_us(lambda: sops.sha256_nodes(blocks), TIMING_REPS,
                                  "sha256_nodes")
        geometry = (1, 256, -(-n // 256))
        bare_us, _ = _device_us(lambda: BP._run("empty", zero, zero, (32, n), geometry),
                                TIMING_REPS,
                                "fq_empty")
        byte_us = 96 * n / HBM_BYTES_PER_S * 1e6
        op_us = _op_ms(opcodes, n, clock_mhz) * 1e3
        row[tag] = dict(lanes=n, device_us=device_us, bare_launch_us=bare_us,
                        bound_us=max(byte_us, op_us),
                        bound_by="operations" if op_us >= byte_us else "bytes")
    print(f"sha256 at {label}'s shapes: {row['launches']} launches; " + "; ".join(
        f"{tag} {r['lanes']} nodes: device {r['device_us']:.3f} us per launch, bare launch "
        f"{r['bare_launch_us']:.3f} us, bound {r['bound_us']:.4f} us ({r['bound_by']})"
        for tag, r in ((t, row[t]) for t in ("p50", "p90"))) + " (== plain version at both)")
    return row


T_START = time.perf_counter()
PHASE_S: dict = {}  # seconds of each phase of main(), in order


def _done(name: str, t0: float) -> None:
    PHASE_S[name] = time.perf_counter() - t0
    print(f"{name} phase {PHASE_S[name]:.1f} s")


def _timed_native_load() -> float:
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import native

    t0 = time.perf_counter()
    native.library()
    return time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from lambda_ethereum_consensus_tpu_torch.config import mainnet_spec
    from lambda_ethereum_consensus_tpu_torch.ops import _build
    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops
    from lambda_ethereum_consensus_tpu_torch.ssz import HashlibBackend, set_hash_backend

    # ---- phase 1: the card and the build
    card = _smi("name,power.limit")
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    print(card)
    print(f"max SM clock {clock_mhz:.0f} MHz")
    t0 = time.perf_counter()
    # the native host library (g++, then its self-check) builds beside nvcc
    with ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(_timed_native_load)
        libs = _build.build_all()
        build_s = time.perf_counter() - t0
        native_s = host_build.result()
    print(f"kernels built in {build_s:.2f} s: {sorted(libs)}; native host library built, "
          f"loaded and self-checked in {native_s:.2f} s (g++ {' '.join(_build.HOST_FLAGS)})")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    # ---- phase 2: the kernel against its plain version, on the card
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    max_err = 0
    batches = [rng.integers(0, 256, (n, 64), dtype=np.uint8) for n in CHECK_SIZES]
    batches.append(np.zeros((4, 64), np.uint8))
    for host in batches:
        blocks = torch.from_numpy(host).to(dev)
        got = sops.sha256_nodes(blocks)
        plain = sops.hash_blocks_torch(blocks)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - plain.to(torch.int16)).abs().max().item())
        max_err = max(max_err, err)
        if err or not torch.equal(got, plain):
            raise AssertionError(f"kernel != plain version at N={len(host)} (max abs err {err})")
        print(f"kernel == plain version at N={len(host)}")
    big = batches[len(CHECK_SIZES) - 1]
    got_big = sops.sha256_nodes(torch.from_numpy(big).to(dev)).cpu().numpy()
    for i in rng.choice(len(big), 4096, replace=False):
        if got_big[i].tobytes() != hashlib.sha256(big[i].tobytes()).digest():
            raise AssertionError(f"kernel != hashlib at row {i}")
    print("kernel == hashlib on a 4096-row sample")

    opcodes = _sass_opcodes(libs["sha256"], "sha256_nodes_kernel")
    timings = {}
    for n in TIMED_SIZES:
        blocks = torch.from_numpy(rng.integers(0, 256, (n, 64), dtype=np.uint8)).to(dev)
        kernel_ms = _event_ms(lambda: sops.sha256_nodes(blocks), reps=20)
        plain_ms = _event_ms(lambda: sops.hash_blocks_torch(blocks), reps=3, warmup=1)
        byte_ms = 96 * n / HBM_BYTES_PER_S * 1e3
        op_ms = _op_ms(opcodes, n, clock_mhz)
        timings[n] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, byte_ms=byte_ms, op_ms=op_ms,
                          bound_ms=max(byte_ms, op_ms))
        print(f"N={n}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.2f} ms, "
              f"bound {max(byte_ms, op_ms):.4f} ms (bytes {byte_ms:.4f}, int ops {op_ms:.4f}); "
              f"{n / kernel_ms / 1e6:.3f} G hashes/s")
        del blocks
    alu = sum(c for op, c in opcodes.items() if op in _ALU_OPCODES)
    print(f"SASS per hash: {sum(opcodes.values())} instructions, {alu} on the ALU pipe; "
          f"{dict(opcodes.most_common())}")

    fq_err, fq_timings = check_fq_kernels(dev, rng)
    for name, t in fq_timings.items():
        group = BP._geometry(name, FQ_SIZES[-1])[0]
        ops = _sass_opcodes(libs["fq"], _fq_symbol(name, group))
        t["op_ms"] = _op_ms(ops, FQ_SIZES[-1] * group, clock_mhz)
        t["bound_ms"] = max(t["byte_ms"], t["op_ms"])
        alu = sum(c for op, c in ops.items() if op in _ALU_OPCODES)
        fma = sum(c for op, c in ops.items() if op in _FMA_OPCODES)
        print(f"{name} at N={FQ_SIZES[-1]}: kernel {t['kernel_ms']:.4f} ms, plain "
              f"{t['plain_ms']:.2f} ms, bound {t['bound_ms']:.4f} ms (bytes {t['byte_ms']:.4f}, "
              f"int ops {t['op_ms']:.4f}); SASS per thread ({group} per element): "
              f"{sum(ops.values())} instructions, "
              f"{alu} on the ALU pipe, {fma} integer multiplies; {dict(ops.most_common(8))}")
    group_ops = _sass_opcodes(libs["fq"], "fq_mul_mod_group_kernel")
    print(f"mul_mod group body: SASS per thread {sum(group_ops.values())} instructions, "
          f"{sum(c for op, c in group_ops.items() if op in _FMA_OPCODES)} integer multiplies, "
          f"{group_ops.get('SHFL', 0)} shuffles; {dict(group_ops.most_common(8))}")

    _done("build and kernel checks", T_START)

    # ---- phase 3: the slice — a 1M-validator mainnet state root on the card
    t_phase = time.perf_counter()
    spec = mainnet_spec()
    keys, key_points, compressed, keys_s = registry_keys(dev, rng)
    print(f"{DISTINCT_KEYS} seeded pubkeys derived on the card by batch_g1_mul in {keys_s:.3f} s")
    t0 = time.perf_counter()
    state = build_state(spec, N_VALIDATORS, SEED, compressed[:REGISTRY_KEYS])
    setup_s = time.perf_counter() - t0
    print(f"setup: {N_VALIDATORS} validators ({REGISTRY_KEYS} keys, validator i holding key "
          f"i mod {REGISTRY_KEYS}) built in {setup_s:.1f} s")
    backend = sops.install_device_backend()
    roots, seconds, launches = [], [], []
    for _ in ("cold", "warm"):
        sops.sha256_kernel_launches = 0
        t0 = time.perf_counter()
        roots.append(state.hash_tree_root(spec))
        seconds.append(time.perf_counter() - t0)
        launches.append(sops.sha256_kernel_launches)
    subtree_calls = backend.subtree_calls
    # one warm root in each polarity of the registry (the ssz_hash_tree_root
    # span), for phase 3f
    from lambda_ethereum_consensus_tpu_torch.telemetry import get_metrics

    root_polarity = {}
    for polarity in ("off", "on"):
        get_metrics().set_enabled(polarity == "on")
        t0 = time.perf_counter()
        roots.append(state.hash_tree_root(spec))
        root_polarity[polarity + "_s"] = time.perf_counter() - t0
    get_metrics().set_enabled(True)
    timed = _TimedBackend(backend)
    t0 = time.perf_counter()
    with _recording(sops, "sha256_nodes", lambda blocks: int(blocks.shape[0])) as sha_lanes:
        timed_root = state.hash_tree_root(spec, backend=timed)
    timed_s = time.perf_counter() - t0
    if sum(sha_lanes.values()) != launches[1]:
        raise AssertionError(f"recorded {sum(sha_lanes.values())} SHA-256 launches in a root, "
                             f"counted {launches[1]}")
    set_hash_backend(HashlibBackend())
    t0 = time.perf_counter()
    reference = state.hash_tree_root(spec)
    hashlib_s = time.perf_counter() - t0
    if not all(r == reference for r in roots) or timed_root != reference:
        raise AssertionError(f"device roots {[r.hex() for r in roots]} != hashlib {reference.hex()}")
    if not launches[0] or launches[0] != launches[1] or not subtree_calls:
        raise AssertionError(f"main path missed the kernel: launches {launches}, "
                             f"subtree reductions {subtree_calls}")
    print(f"state root {reference.hex()} == hashlib root ({hashlib_s:.2f} s on the host)")
    print(f"state root cold {seconds[0]:.3f} s, warm {seconds[1]:.3f} s; "
          f"{launches[1]} kernel launches per root; {subtree_calls // 2} subtree reductions per root")
    print(f"timed root {timed_s:.3f} s: {timed.seconds:.3f} s inside device backend calls, "
          f"{timed_s - timed.seconds:.3f} s host work")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    del backend, timed

    _done("state root", t_phase)

    # ---- phase 3b: the state transition on the card, at the same state
    record: dict = {"card": card, "build_s": build_s, "native_build_s": native_s,
                    "registry_keys_s": keys_s}
    t0 = time.perf_counter()
    transition = transition_phase(dev, rng, record, state, spec)
    _done("state-transition", t0)
    del state

    # ---- phase 3c: the node's slot through fork choice, at the same registry
    t0 = time.perf_counter()
    node_paths, node_routes = node_phase(dev, rng, record, spec, transition["start"],
                                         transition["start_sks"], transition["sync_keys"], keys,
                                         key_points, compressed)
    _done("node", t0)
    del transition["start"], key_points, compressed

    # ---- phase 3e: the validator duty engine on phase 3c's store
    from lambda_ethereum_consensus_tpu_torch import fork_choice as FC

    head_3c = FC.get_head(node_routes["store"], spec)
    t0 = time.perf_counter()
    duty_phase(dev, record, card, spec, node_routes["store"], transition["start_sks"], keys)
    _done("duty-engine", t0)

    # ---- phase 3f: the node's observability on the same store
    t0 = time.perf_counter()
    observability_phase(dev, record, card, spec, node_routes["store"], node_routes["drain"],
                        head_3c, root_polarity)
    _done("observability", t0)

    # ---- phase 3d: the witness plane, at phase 3b's walk-end state
    t0 = time.perf_counter()
    witness_paths, witness_nodes = witness_phase(dev, rng, record, transition.pop("walk_end"),
                                                 transition.pop("walk_root"), spec)
    _done("witness", t0)

    # ---- phase 4: the signature leg — the attestation drain on the card
    t0 = time.perf_counter()
    fq_launches, drain, blame_drain, blame_want = bls_phase(dev, rng, record)
    _done("BLS", t0)

    # ---- phases 5-8: duty signing, signature sets, scalar multiplication, KZG
    t0 = time.perf_counter()
    duty = sign_phase(dev, rng, record)
    _done("duty-signing", t0)
    t0 = time.perf_counter()
    sets = sets_phase(dev, rng, record, duty)
    _done("signature-set", t0)
    t0 = time.perf_counter()
    size_routes_phase(dev, record, card, spec, sets, node_routes, {
        f"the drain of {record['bls']['aggregates']} aggregates (batch_verify_each_cached)": drain,
        "the block import (its set on the device chain; on a fork of the rooted parent, made "
        "untimed)": (transition["prime"],
                     lambda parent: transition["import_primed"](parent) is not None),
    }, (f"the drain of {BLAME_DRAIN} aggregates, {blame_want.count(False)} forged "
        f"(batch_verify_each_cached)", blame_drain, blame_want), duty["scalars"])
    _done("size routes", t0)
    ingest_store, ingest_drain = node_routes["store"], node_routes["drain"]
    del sets, node_routes
    t0 = time.perf_counter()
    setup = kzg_setup(record)
    mul_phase(dev, rng, record, duty, setup)
    _done("scalar-multiplication", t0)
    t0 = time.perf_counter()
    blobs, commitments, proofs = kzg_phase(dev, rng, record, setup)
    _done("KZG", t0)

    # ---- phase 3g: the node's ingest path below the wire, on phase 3c's store
    t0 = time.perf_counter()
    ingest_lanes, ingest_nodes = ingest_phase(dev, record, card, spec, ingest_store, ingest_drain,
                                              transition["start_sks"], keys, setup, blobs,
                                              commitments, proofs)
    _done("ingest", t0)

    # ---- phase 3h: the Beacon API on the card, on phase 3g's store
    t0 = time.perf_counter()
    api_launches = api_phase(dev, record, card, spec, ingest_store)
    _done("API", t0)

    # ---- phase 3i: one beacon node booted on the card, on phase 3g's head
    t0 = time.perf_counter()
    node_lanes, node_nodes, node_launches = node_boot_phase(
        dev, rng, record, card, spec, ingest_store, transition["start_sks"], keys, blobs,
        commitments, proofs)
    _done("node-boot", t0)
    del ingest_store, ingest_drain
    blob = blobs[0]

    # ---- phase 9: the field kernels at the main paths' lane counts
    t_phase = time.perf_counter()
    from lambda_ethereum_consensus_tpu_torch.da import kzg as K
    from lambda_ethereum_consensus_tpu_torch.ops import bls_g2 as G2

    paths = {
        "drain": drain,
        "sign flush": lambda: G2.g2_ladder(duty["points"], duty["scalars"], 256, dev),
        "KZG MSM": lambda: K.blob_to_commitment(blob, setup, device=dev),
        "block import": transition["import_path"],
        **node_paths,
        **witness_paths,
        "ingest": ingest_lanes,
        "node": node_lanes,
    }
    path_err, record["path_shapes"] = path_shape_timings(dev, rng, paths)
    mul_err, record["mul_body_sweep"] = body_sweep(
        dev, rng, "mul_mod", MUL_SWEEP,
        {"group": (BP.MUL_GROUP, BP.BLOCK_THREADS["mul_mod"]),
         "one-thread": (1, BP.BLOCK_THREADS["mul_mod"])})
    print(f"MUL_GROUP_THRESHOLD {BP.MUL_GROUP_THRESHOLD}")
    sub_err, record["sub_body_sweep"] = body_sweep(
        dev, rng, "sub_mod", SUB_SWEEP, {f"g{g} t{t}": (g, t) for g, t in SUB_BODIES})
    print(f"SUB_GROUP {BP.SUB_GROUP}, {BP.BLOCK_THREADS['sub_mod']}-thread blocks")
    fq_err = max(fq_err, path_err, mul_err, sub_err)
    record["sha256_root_shapes"] = sha256_path_shapes(dev, sha_lanes, opcodes, clock_mhz,
                                                      "the state root")
    record["sha256_witness_shapes"] = sha256_path_shapes(dev, witness_nodes, opcodes, clock_mhz,
                                                         "the witness plane")
    record["sha256_ingest_shapes"] = sha256_path_shapes(dev, ingest_nodes, opcodes, clock_mhz,
                                                        "the ingest path")
    record["sha256_node_shapes"] = sha256_path_shapes(dev, node_nodes, opcodes, clock_mhz,
                                                      "the node")

    _done("path shapes and sweeps", t_phase)

    # ---- phase 10: per-kernel numbers, then the device line
    big_n = TIMED_SIZES[-1]
    t = timings[big_n]
    kernels = [{
        "name": "sha256",
        "route": "cuda",
        "source": "lambda_ethereum_consensus_tpu_torch/csrc/sha256.cu",
        "replaces": "lambda_ethereum_consensus_tpu/ops/sha256.py:191",
        "launches": launches[1],
        "api_launches": api_launches,
        "node_launches": node_launches["sha256"],
        "max_abs_err": max_err,
        "n": big_n,
        "ms": t["kernel_ms"],
        "kernel_ms": t["kernel_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "operations" if t["op_ms"] >= t["byte_ms"] else "bytes",
        "library_ms": None,
    }]
    for name in FQ_KERNELS:
        t = fq_timings[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "lambda_ethereum_consensus_tpu_torch/csrc/fq.cu",
            "replaces": "lambda_ethereum_consensus_tpu/ops/bigint_pallas.py:" + _REPLACES[name],
            "launches": fq_launches[name],
            "node_launches": node_launches[name],
            "max_abs_err": fq_err,
            "n": FQ_SIZES[-1],
            "ms": t["kernel_ms"],
            "kernel_ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "operations" if t["op_ms"] >= t["byte_ms"] else "bytes",
            "library_ms": None,
        })
    record["kernels"] = kernels
    record["phase_s"] = PHASE_S
    record["seconds"] = time.perf_counter() - T_START
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in PHASE_S.items()})}")
    print(f"chip smoke {record['seconds']:.1f} s on {card}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
