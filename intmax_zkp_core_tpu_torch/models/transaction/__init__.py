"""User-transaction layer: asset model, user asset tree, block headers,
merge/purge circuits (reference ``src/transaction/``)."""
