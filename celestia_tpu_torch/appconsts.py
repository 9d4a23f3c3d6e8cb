"""Protocol constants for the TPU-native Celestia-style DA framework.

Behavioral parity with the reference constants in
pkg/appconsts/global_consts.go:29-92,
initial_consts.go:8-31, versioned_consts.go:19-34, v1/app_consts.go,
v2/app_consts.go, consensus_consts.go:5-12.  These values define the share
layout, square bounds, gas model and consensus timing envelope; they cannot
change within a network's lifetime (except the versioned ones, dispatched on
app version).
"""

from __future__ import annotations

# --- Namespace layout (global_consts.go:17-27) ---
NAMESPACE_VERSION_SIZE = 1
NAMESPACE_ID_SIZE = 28
NAMESPACE_SIZE = NAMESPACE_VERSION_SIZE + NAMESPACE_ID_SIZE  # 29
NAMESPACE_VERSION_MAX = 255

# Raw bytes of the parity-share namespace (version 0xFF, id all-0xFF —
# global_consts.go:68-75).  da/namespace.py wraps these in its Namespace
# type; the bytes themselves live HERE because ops/nmt.py prefixes every
# Q1-Q3 leaf with them and ops/ sits below da/ in the package DAG
# (celint R8: ops may not import da).
PARITY_SHARE_NAMESPACE_RAW = b"\xff" * NAMESPACE_SIZE

# --- Share layout (global_consts.go:29-66) ---
SHARE_SIZE = 512
SHARE_INFO_BYTES = 1
SEQUENCE_LEN_BYTES = 4
SHARE_VERSION_ZERO = 0
DEFAULT_SHARE_VERSION = SHARE_VERSION_ZERO
MAX_SHARE_VERSION = 127
COMPACT_SHARE_RESERVED_BYTES = 4

FIRST_COMPACT_SHARE_CONTENT_SIZE = (
    SHARE_SIZE
    - NAMESPACE_SIZE
    - SHARE_INFO_BYTES
    - SEQUENCE_LEN_BYTES
    - COMPACT_SHARE_RESERVED_BYTES
)  # 474
CONTINUATION_COMPACT_SHARE_CONTENT_SIZE = (
    SHARE_SIZE - NAMESPACE_SIZE - SHARE_INFO_BYTES - COMPACT_SHARE_RESERVED_BYTES
)  # 478
FIRST_SPARSE_SHARE_CONTENT_SIZE = (
    SHARE_SIZE - NAMESPACE_SIZE - SHARE_INFO_BYTES - SEQUENCE_LEN_BYTES
)  # 478
CONTINUATION_SPARSE_SHARE_CONTENT_SIZE = (
    SHARE_SIZE - NAMESPACE_SIZE - SHARE_INFO_BYTES
)  # 482

MIN_SQUARE_SIZE = 1
MIN_SHARE_COUNT = MIN_SQUARE_SIZE * MIN_SQUARE_SIZE

SUPPORTED_SHARE_VERSIONS = (SHARE_VERSION_ZERO,)

BOND_DENOM = "utia"

# --- Hashes ---
HASH_LENGTH = 32  # SHA-256

# --- App versions (versioned_consts.go, v1/, v2/) ---
V1_VERSION = 1
V2_VERSION = 2
LATEST_VERSION = V2_VERSION


def subtree_root_threshold(_app_version: int = LATEST_VERSION) -> int:
    """Target upper bound on subtree roots per share commitment (ADR-013).

    versioned_consts.go:19-27 — constant 64 for all current versions.
    """
    return 64


def square_size_upper_bound(_app_version: int = LATEST_VERSION) -> int:
    """Hard cap on the effective square size (versioned_consts.go:26-34)."""
    return 128


DEFAULT_SUBTREE_ROOT_THRESHOLD = subtree_root_threshold()
DEFAULT_SQUARE_SIZE_UPPER_BOUND = square_size_upper_bound()

# --- Governance-modifiable initial params (initial_consts.go:8-31) ---
DEFAULT_GOV_MAX_SQUARE_SIZE = 64
DEFAULT_MAX_BYTES = (
    DEFAULT_GOV_MAX_SQUARE_SIZE
    * DEFAULT_GOV_MAX_SQUARE_SIZE
    * CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
)
DEFAULT_GAS_PER_BLOB_BYTE = 8
DEFAULT_MIN_GAS_PRICE = 0.002  # utia
DEFAULT_UNBONDING_TIME_SECONDS = 3 * 7 * 24 * 3600

# v2 global min gas price enforced by x/minfee (v2/app_consts.go:5-9).
# Stored and compared as an integer in utia-per-gas parts-per-million:
# consensus-critical fee math must never touch floats (same rationale as the
# mint module's integer fixed point).  2000 ppm == 0.002 utia/gas.
GLOBAL_MIN_GAS_PRICE_PPM = 2000

# --- Consensus timing (consensus_consts.go:5-12) ---
TIMEOUT_PROPOSE_SECONDS = 10
TIMEOUT_COMMIT_SECONDS = 11
GOAL_BLOCK_TIME_SECONDS = 15

# --- Blobstream (celestia-core consts.DataCommitmentBlocksLimit) ---
DATA_COMMITMENT_BLOCKS_LIMIT = 1000


def round_up_power_of_two(n: int) -> int:
    """Smallest power of two >= n (n >= 0; 0 -> 1)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def round_down_power_of_two(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"round_down_power_of_two requires n >= 1, got {n}")
    return 1 << (n.bit_length() - 1)


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0
