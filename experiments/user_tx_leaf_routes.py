#!/usr/bin/env python3
"""Time the routes for the leaf hashing of one batched commitment on one
NVIDIA GPU.

    python3 experiments/user_tx_leaf_routes.py [--log-rows N] [--K K]

The batch prover hands the Merkle builder each proof's LDE transposed:
[K, 135, L] columns seen as [K, L, 135] leaves (default: the flagship's
user-tx batch, K = 3, 4,096 rows, L = 2^15).  Prints one JSON line with the
median ms of the fused route as the prover takes it (the transposed view
copied to [K L, 135], then one sponge launch), of the copy alone and the
sponge alone, of K sponge launches on the untransposed strided views (no
copy), and of the chained route (one permutation launch per absorb step),
beside the bound of ``chip_smoke.py``.  Every route's digests are held
against the fused route's (the script fails on a mismatch).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import bound_ms, nvidia_smi_line, rand_field, time_ms  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import cuda_build as cb  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import poseidon as ps  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc  # noqa: E402

WIDTH = 135  # the user-tx circuit's wires, the widest commitment


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-rows", type=int, default=12)
    ap.add_argument("--K", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("user_tx_leaf_routes: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    cb.build()
    cb.load()
    K, L = args.K, 1 << (args.log_rows + 3)
    rng = np.random.default_rng(20240917)
    view = rand_field(rng, (K, WIDTH, L), device).transpose(1, 2)  # [K, L, 135]
    copied = view.reshape(K * L, WIDTH)
    want = ps.hash_no_pad(view, fused_sponge=True)
    for name, got in (("per_tree_launches", torch.cat([pc.hash_no_pad_cuda(view[k])
                                                       for k in range(K)])),
                      ("chained", ps.hash_no_pad(view))):
        if not torch.equal(got.reshape(want.shape), want):
            raise RuntimeError(f"the {name} route's digests differ from the fused route's")
    flush = torch.empty(64 << 20, dtype=torch.int64, device=device)  # 512 MB
    rec = {
        "card": nvidia_smi_line(),
        "shape": [K, L, WIDTH],
        "fused_ms": time_ms(lambda: ps.hash_no_pad(view, fused_sponge=True), 10, flush),
        "copy_ms": time_ms(lambda: view.reshape(K * L, WIDTH), 10, flush),
        "hash_ms": time_ms(lambda: pc.hash_no_pad_cuda(copied), 10, flush),
        "per_tree_launches_ms": time_ms(
            lambda: [pc.hash_no_pad_cuda(view[k]) for k in range(K)], 10, flush),
        "chained_ms": time_ms(lambda: ps.hash_no_pad(view), 5, flush),
        **bound_ms(K * L, WIDTH, 4, (WIDTH + 7) // 8),
    }
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
