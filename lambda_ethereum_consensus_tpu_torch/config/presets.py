"""Chain presets: the per-network compile-time constants of the beacon chain spec.

The reference loads these from YAML preset files merged later-fork-wins and
overlays a runtime config file (ref: lib/utils/config.ex:7-26,
lib/chain_spec/configs/mainnet.ex:6-9).  Here the canonical presets ship as
plain Python data, organized per fork exactly like the upstream preset
directories (config/presets/{mainnet,minimal}/{phase0..capella}.yaml); external
YAML overlays remain supported via :func:`..config.load_config_file`.

Values are protocol constants of the public Ethereum consensus specification.
"""

# --- mainnet preset -----------------------------------------------------------

MAINNET_PHASE0 = {
    # Misc
    "MAX_COMMITTEES_PER_SLOT": 2**6,          # 64
    "TARGET_COMMITTEE_SIZE": 2**7,            # 128
    "MAX_VALIDATORS_PER_COMMITTEE": 2**11,    # 2048
    "SHUFFLE_ROUND_COUNT": 90,
    # Hysteresis
    "HYSTERESIS_QUOTIENT": 4,
    "HYSTERESIS_DOWNWARD_MULTIPLIER": 1,
    "HYSTERESIS_UPWARD_MULTIPLIER": 5,
    # Gwei values
    "MIN_DEPOSIT_AMOUNT": 10**9,
    "MAX_EFFECTIVE_BALANCE": 32 * 10**9,
    "EFFECTIVE_BALANCE_INCREMENT": 10**9,
    # Time parameters
    "MIN_ATTESTATION_INCLUSION_DELAY": 1,
    "SLOTS_PER_EPOCH": 2**5,                  # 32
    "MIN_SEED_LOOKAHEAD": 1,
    "MAX_SEED_LOOKAHEAD": 4,
    "EPOCHS_PER_ETH1_VOTING_PERIOD": 2**6,    # 64
    "SLOTS_PER_HISTORICAL_ROOT": 2**13,       # 8192
    "MIN_EPOCHS_TO_INACTIVITY_PENALTY": 4,
    # State list lengths
    "EPOCHS_PER_HISTORICAL_VECTOR": 2**16,
    "EPOCHS_PER_SLASHINGS_VECTOR": 2**13,
    "HISTORICAL_ROOTS_LIMIT": 2**24,
    "VALIDATOR_REGISTRY_LIMIT": 2**40,
    # Rewards and penalties
    "BASE_REWARD_FACTOR": 2**6,
    "WHISTLEBLOWER_REWARD_QUOTIENT": 2**9,
    "PROPOSER_REWARD_QUOTIENT": 2**3,
    "INACTIVITY_PENALTY_QUOTIENT": 2**26,
    "MIN_SLASHING_PENALTY_QUOTIENT": 2**7,
    "PROPORTIONAL_SLASHING_MULTIPLIER": 1,
    # Max operations per block
    "MAX_PROPOSER_SLASHINGS": 2**4,
    "MAX_ATTESTER_SLASHINGS": 2**1,
    "MAX_ATTESTATIONS": 2**7,
    "MAX_DEPOSITS": 2**4,
    "MAX_VOLUNTARY_EXITS": 2**4,
}

MAINNET_ALTAIR = {
    "INACTIVITY_PENALTY_QUOTIENT_ALTAIR": 3 * 2**24,
    "MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR": 2**6,
    "PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR": 2,
    "SYNC_COMMITTEE_SIZE": 2**9,              # 512
    "EPOCHS_PER_SYNC_COMMITTEE_PERIOD": 2**8, # 256
    "MIN_SYNC_COMMITTEE_PARTICIPANTS": 1,
    "UPDATE_TIMEOUT": 2**13,
}

MAINNET_BELLATRIX = {
    "INACTIVITY_PENALTY_QUOTIENT_BELLATRIX": 2**24,
    "MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX": 2**5,
    "PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX": 3,
    "MAX_BYTES_PER_TRANSACTION": 2**30,
    "MAX_TRANSACTIONS_PER_PAYLOAD": 2**20,
    "BYTES_PER_LOGS_BLOOM": 2**8,
    "MAX_EXTRA_DATA_BYTES": 2**5,
}

MAINNET_CAPELLA = {
    "MAX_BLS_TO_EXECUTION_CHANGES": 2**4,
    "MAX_WITHDRAWALS_PER_PAYLOAD": 2**4,
    "MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP": 2**14,
}

MAINNET_DENEB = {
    # Blob / KZG geometry (EIP-4844 polynomial commitments)
    "FIELD_ELEMENTS_PER_BLOB": 2**12,          # 4096
    "MAX_BLOB_COMMITMENTS_PER_BLOCK": 2**12,
    "MAX_BLOBS_PER_BLOCK": 6,
    "KZG_COMMITMENT_INCLUSION_PROOF_DEPTH": 17,
    # Networking
    "BLOB_SIDECAR_SUBNET_COUNT": 6,
    "MIN_EPOCHS_FOR_BLOB_SIDECARS_REQUESTS": 2**12,
}

# --- minimal preset -----------------------------------------------------------
# Expressed as deltas on mainnet: only the customized keys differ.

MINIMAL_PHASE0 = dict(MAINNET_PHASE0, **{
    "MAX_COMMITTEES_PER_SLOT": 4,
    "TARGET_COMMITTEE_SIZE": 4,
    "SHUFFLE_ROUND_COUNT": 10,
    "SLOTS_PER_EPOCH": 8,
    "EPOCHS_PER_ETH1_VOTING_PERIOD": 4,
    "SLOTS_PER_HISTORICAL_ROOT": 64,
    "EPOCHS_PER_HISTORICAL_VECTOR": 64,
    "EPOCHS_PER_SLASHINGS_VECTOR": 64,
    "INACTIVITY_PENALTY_QUOTIENT": 2**25,
    "MIN_SLASHING_PENALTY_QUOTIENT": 64,
    "PROPORTIONAL_SLASHING_MULTIPLIER": 2,
})

MINIMAL_ALTAIR = dict(MAINNET_ALTAIR, **{
    "SYNC_COMMITTEE_SIZE": 32,
    "EPOCHS_PER_SYNC_COMMITTEE_PERIOD": 8,
    "UPDATE_TIMEOUT": 64,
})

MINIMAL_BELLATRIX = dict(MAINNET_BELLATRIX)

MINIMAL_CAPELLA = dict(MAINNET_CAPELLA, **{
    "MAX_WITHDRAWALS_PER_PAYLOAD": 4,
    "MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP": 16,
})

MINIMAL_DENEB = dict(MAINNET_DENEB, **{
    # 4 field elements per blob keeps the minimal-preset trusted setup
    # and every CI-path MSM tiny (consensus-specs minimal/deneb.yaml)
    "FIELD_ELEMENTS_PER_BLOB": 4,
    "KZG_COMMITMENT_INCLUSION_PROOF_DEPTH": 9,
})

# Fork-ordered merge, later fork wins (ref: lib/utils/config.ex:19-26).
FORK_ORDER = ("phase0", "altair", "bellatrix", "capella", "deneb")

PRESETS = {
    "mainnet": {
        "phase0": MAINNET_PHASE0,
        "altair": MAINNET_ALTAIR,
        "bellatrix": MAINNET_BELLATRIX,
        "capella": MAINNET_CAPELLA,
        "deneb": MAINNET_DENEB,
    },
    "minimal": {
        "phase0": MINIMAL_PHASE0,
        "altair": MINIMAL_ALTAIR,
        "bellatrix": MINIMAL_BELLATRIX,
        "capella": MINIMAL_CAPELLA,
        "deneb": MINIMAL_DENEB,
    },
}


def merged_preset(name: str) -> dict:
    """Merge the per-fork preset tables for ``name``, later fork winning."""
    out: dict = {}
    for fork in FORK_ORDER:
        out.update(PRESETS[name][fork])
    return out


# --- runtime configs ----------------------------------------------------------
# The network-level config overlay (ref: config/configs/{mainnet,minimal}.yaml).

MAINNET_CONFIG = {
    "PRESET_BASE": "mainnet",
    "CONFIG_NAME": "mainnet",
    # Transition
    "TERMINAL_TOTAL_DIFFICULTY": 58750000000000000000000,
    "TERMINAL_BLOCK_HASH": b"\x00" * 32,
    "TERMINAL_BLOCK_HASH_ACTIVATION_EPOCH": 2**64 - 1,
    # Genesis
    "MIN_GENESIS_ACTIVE_VALIDATOR_COUNT": 2**14,
    "MIN_GENESIS_TIME": 1606824000,
    "GENESIS_FORK_VERSION": bytes.fromhex("00000000"),
    "GENESIS_DELAY": 604800,
    # Forking
    "ALTAIR_FORK_VERSION": bytes.fromhex("01000000"),
    "ALTAIR_FORK_EPOCH": 74240,
    "BELLATRIX_FORK_VERSION": bytes.fromhex("02000000"),
    "BELLATRIX_FORK_EPOCH": 144896,
    "CAPELLA_FORK_VERSION": bytes.fromhex("03000000"),
    "CAPELLA_FORK_EPOCH": 194048,
    "DENEB_FORK_VERSION": bytes.fromhex("04000000"),
    "DENEB_FORK_EPOCH": 2**64 - 1,
    # Time parameters
    "SECONDS_PER_SLOT": 12,
    "SECONDS_PER_ETH1_BLOCK": 14,
    "MIN_VALIDATOR_WITHDRAWABILITY_DELAY": 2**8,
    "SHARD_COMMITTEE_PERIOD": 2**8,
    "ETH1_FOLLOW_DISTANCE": 2**11,
    # Validator cycle
    "INACTIVITY_SCORE_BIAS": 4,
    "INACTIVITY_SCORE_RECOVERY_RATE": 16,
    "EJECTION_BALANCE": 16 * 10**9,
    "MIN_PER_EPOCH_CHURN_LIMIT": 4,
    "CHURN_LIMIT_QUOTIENT": 2**16,
    # Fork choice
    "PROPOSER_SCORE_BOOST": 40,
    # Deposit contract
    "DEPOSIT_CHAIN_ID": 1,
    "DEPOSIT_NETWORK_ID": 1,
    "DEPOSIT_CONTRACT_ADDRESS": bytes.fromhex("00000000219ab540356cbb839cbe05303d7705fa"),
}

MINIMAL_CONFIG = dict(MAINNET_CONFIG, **{
    "PRESET_BASE": "minimal",
    "CONFIG_NAME": "minimal",
    "TERMINAL_TOTAL_DIFFICULTY": 2**256 - 2**10,
    "MIN_GENESIS_ACTIVE_VALIDATOR_COUNT": 64,
    "MIN_GENESIS_TIME": 1578009600,
    "GENESIS_FORK_VERSION": bytes.fromhex("00000001"),
    "GENESIS_DELAY": 300,
    "ALTAIR_FORK_VERSION": bytes.fromhex("01000001"),
    "ALTAIR_FORK_EPOCH": 2**64 - 1,
    "BELLATRIX_FORK_VERSION": bytes.fromhex("02000001"),
    "BELLATRIX_FORK_EPOCH": 2**64 - 1,
    "CAPELLA_FORK_VERSION": bytes.fromhex("03000001"),
    "CAPELLA_FORK_EPOCH": 2**64 - 1,
    "DENEB_FORK_VERSION": bytes.fromhex("04000001"),
    "DENEB_FORK_EPOCH": 2**64 - 1,
    "SECONDS_PER_SLOT": 6,
    "SHARD_COMMITTEE_PERIOD": 64,
    "ETH1_FOLLOW_DISTANCE": 16,
    "CHURN_LIMIT_QUOTIENT": 32,
    "DEPOSIT_CHAIN_ID": 5,
    "DEPOSIT_NETWORK_ID": 5,
    "DEPOSIT_CONTRACT_ADDRESS": bytes.fromhex("1234567890123456789012345678901234567890"),
})

CONFIGS = {"mainnet": MAINNET_CONFIG, "minimal": MINIMAL_CONFIG}
