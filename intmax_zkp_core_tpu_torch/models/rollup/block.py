"""Serialized block format (reference ``src/rollup/block.rs``) — the shape
of ``test_cases/block1_info.json``."""

from __future__ import annotations

from dataclasses import dataclass, field

from ...utils.hash_out import HashOut
from ..transaction.block_header import BlockHeader
from .address_list import TransactionSenderWithValidity
from .gadgets.deposit_block import DepositInfo


@dataclass
class BlockInfo:
    header: BlockHeader
    transactions: list[HashOut] = field(default_factory=list)
    deposit_list: list[DepositInfo] = field(default_factory=list)
    scroll_flag_list: list[DepositInfo] = field(default_factory=list)
    polygon_flag_list: list[DepositInfo] = field(default_factory=list)
    address_list: list[TransactionSenderWithValidity] = field(default_factory=list)

    @classmethod
    def new(cls, log_num_txs_in_block: int) -> "BlockInfo":
        return cls(header=BlockHeader.new(log_num_txs_in_block))

    def to_json(self) -> dict:
        return {
            "header": self.header.to_json(),
            "transactions": [t.to_hex() for t in self.transactions],
            "deposit_list": [d.to_json() for d in self.deposit_list],
            "scroll_flag_list": [d.to_json() for d in self.scroll_flag_list],
            "polygon_flag_list": [d.to_json() for d in self.polygon_flag_list],
            "address_list": [a.to_json() for a in self.address_list],
        }

    @classmethod
    def from_json(cls, o: dict) -> "BlockInfo":
        return cls(
            header=BlockHeader.from_json(o["header"]),
            transactions=[HashOut.from_hex(t) for t in o["transactions"]],
            deposit_list=[DepositInfo.from_json(d) for d in o["deposit_list"]],
            scroll_flag_list=[DepositInfo.from_json(d) for d in o["scroll_flag_list"]],
            polygon_flag_list=[DepositInfo.from_json(d) for d in o["polygon_flag_list"]],
            address_list=[
                TransactionSenderWithValidity.from_json(a) for a in o["address_list"]
            ],
        )
