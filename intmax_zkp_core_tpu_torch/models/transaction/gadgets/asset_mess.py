"""Asset conservation via probabilistic multiset equality ("mess")
(reference ``src/transaction/gadgets/asset_mess/mod.rs``)."""

from __future__ import annotations

from dataclasses import dataclass

from ....engine.circuit import CircuitBuilder, HashOutTarget
from .utils import is_non_zero


@dataclass
class AssetTargets:
    contract_address: HashOutTarget
    token_id: HashOutTarget
    amount: int  # target

    @classmethod
    def add_virtual_to(cls, builder: CircuitBuilder) -> "AssetTargets":
        return cls(
            contract_address=builder.add_virtual_hash(),
            token_id=builder.add_virtual_hash(),
            amount=builder.add_virtual_target(),
        )


def calc_asset_id(
    builder: CircuitBuilder, contract_t: HashOutTarget, token_id_t: HashOutTarget
) -> HashOutTarget:
    """asset_id = Poseidon(contract || token_id padded with flags), forced
    non-zero (``asset_mess/mod.rs:59-86``)."""
    zero = builder.zero()
    one = builder.one()
    inputs = list(contract_t) + list(token_id_t) + [one, zero, zero, one]
    asset_id = builder.hash_n_to_hash_no_pad(inputs)
    is_non_zero(builder, asset_id)
    return asset_id


def assets_into_mess(builder: CircuitBuilder, assets_t: list[AssetTargets]):
    """mess = sum amount_i * asset_id_i over limbs 0..3, plus total amount
    (``asset_mess/mod.rs:32-56``)."""
    total_amount = builder.zero()
    mess = [builder.zero()] * 4
    for target in assets_t:
        total_amount = builder.add(target.amount, total_amount)
        asset_id = calc_asset_id(builder, target.contract_address, target.token_id)
        for i in range(3):
            mess[i] = builder.arithmetic(1, 1, list(asset_id)[i], target.amount, mess[i])
    return HashOutTarget(tuple(mess)), total_amount


def verify_equal_assets(
    builder: CircuitBuilder,
    input_assets_t: list[AssetTargets],
    output_assets_t: list[AssetTargets],
) -> None:
    """input mess == output mess and equal totals
    (``asset_mess/mod.rs:97-106``)."""
    in_mess, in_total = assets_into_mess(builder, input_assets_t)
    out_mess, out_total = assets_into_mess(builder, output_assets_t)
    builder.connect(in_total, out_total)
    for a, b in zip(in_mess, out_mess):
        builder.connect(a, b)
