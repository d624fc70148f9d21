"""Rollup shape constants (reference ``src/config/mod.rs:1-47``) plus the
canonical small test configuration used by the reference's full-block test
(``rollup/circuits/mod.rs:1335-1351``)."""

from __future__ import annotations

from dataclasses import dataclass

LOG_MAX_N_BLOCKS = 32  # reference transaction/block_header.rs:20


@dataclass(frozen=True)
class RollupConstants:
    log_max_n_users: int
    log_max_n_txs: int
    log_max_n_contracts: int
    log_max_n_variables: int
    log_n_txs: int
    log_n_recipients: int
    log_n_contracts: int
    log_n_variables: int
    n_registrations: int
    n_diffs: int
    n_merges: int
    n_deposits: int
    n_scroll_flags: int
    n_polygon_flags: int
    n_blocks: int

    @classmethod
    def test_constants(cls) -> "RollupConstants":
        """The canonical values the reference's in-module tests use."""
        return cls(
            log_max_n_users=3,
            log_max_n_txs=3,
            log_max_n_contracts=3,
            log_max_n_variables=3,
            log_n_txs=2,
            log_n_recipients=3,
            log_n_contracts=3,
            log_n_variables=3,
            n_registrations=2,
            n_diffs=2,
            n_merges=2,
            n_deposits=2,
            n_scroll_flags=2,
            n_polygon_flags=2,
            n_blocks=2,
        )
