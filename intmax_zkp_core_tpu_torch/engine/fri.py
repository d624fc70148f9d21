"""FRI low-degree commitment: batched fold on the device, Merkle-capped
layers, query openings, and host-side verification.

Protocol (arity-2, natural-order coset domains):
* layer domain: x_i = shift * w^i, |domain| = N; pairing x_{i+N/2} = -x_i;
* fold: f'(x^2) = (f(x) + f(-x))/2 + beta * (f(x) - f(-x))/(2x);
* each layer committed as leaves [f(x_i), f(-x_i)] (4 u64 -> no-op leaf
  hash), reduced to a 2^cap_height Merkle cap;
* fold until degree <= final_poly_len, then ship coefficients;
* 16-bit grinding + per-round query indices from the Poseidon transcript.

Values are extension-field: tensors [..., 2] on device, (c0, c1) tuples on
host.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops import goldilocks as gl
from ..ops import merkle as mk
from ..ops import ntt as nt
from ..ops import poseidon as ps
from .algebra import ext_add, ext_mul, ext_sub
from .challenger import Challenger
from .config import FriConfig
from .spans import TRANSCRIPT, span

P = gl.P_INT


@lru_cache(maxsize=64)
def _inv_2x_table(log_n: int, shift: int, device: torch.device) -> torch.Tensor:
    """(2 * x_i)^-1 for i < N/2 on the domain shift * <w_N>, computed on
    the device: (2 x_i)^-1 = (2 shift)^-1 * (w^-1)^i."""
    n = 1 << log_n
    w_inv = pow(gl.primitive_root_of_unity(log_n), P - 2, P)
    lead = pow(2 * shift % P, P - 2, P)
    return gl.mul(gl.powers(w_inv, n // 2, device), gl.i64(lead))


@dataclass
class FriProof:
    caps: list  # per folded layer: list of 4-tuples (cap digests)
    final_poly: list  # list of (c0, c1) coefficients
    pow_witness: int
    # per query round: list over layers of (leaf_pair, merkle_path)
    query_rounds: list


def _fold_step(cur: torch.Tensor, inv2x: torch.Tensor, beta_arr: torch.Tensor) -> torch.Tensor:
    """One FRI fold of K proofs' layers: cur [K, m, 2] -> [K, m/2, 2] via
    f'(x^2) = (f(x)+f(-x))/2 + beta * (f(x)-f(-x))/(2x); beta_arr [K, 2]
    holds each proof's challenge."""
    half = cur.shape[1] // 2
    e_pos, e_neg = cur[:, :half], cur[:, half:]
    s = gl.ext_add(e_pos, e_neg)  # f(x) + f(-x)
    d = gl.ext_sub(e_pos, e_neg)
    half_sum = gl.mul(s, gl.i64(pow(2, P - 2, P)))
    slope = gl.mul(d, inv2x[:, None])  # (f(x)-f(-x)) / (2x)
    return gl.ext_add(half_sum, gl.ext_mul(slope, beta_arr[:, None, :].expand(slope.shape)))


def fold_layers(
    evals: torch.Tensor,
    shift: int,
    cfg: FriConfig,
    challengers: list,
    fused_sponge: bool = False,
):
    """Commit phase of K proofs in lockstep.  evals: [K, N, 2] ext values on
    coset shift*<w_N>; ``challengers`` holds each proof's transcript, which
    observes its own caps and samples its own betas.

    Returns (trees, final_polys), each a list over the K proofs.  A
    FRI leaf is 4 u64 wide, which ``hash_leaves`` passes through unhashed,
    so ``tree.levels[0]`` *is* the ``[f(x_i), f(-x_i)]`` pair table (see
    ``query_rounds``).  Per layer the K trees are built in one pass and the
    only host synchronization is the transfer of their caps, which the
    Fiat-Shamir observations need.
    """
    device = evals.device
    K = evals.shape[0]
    trees = [[] for _ in range(K)]
    cur = evals
    cur_shift = shift % P
    while cur.shape[1] > cfg.final_poly_len * cfg.blowup:
        m = cur.shape[1]
        half = m // 2
        # commit current layer as (f(x), f(-x)) pairs
        leaf = torch.cat([cur[:, :half], cur[:, half:]], dim=2)  # [K, half, 4]
        cap_h = min(cfg.cap_height, (half - 1).bit_length())
        layer_trees = mk.device_merkle_trees_batch(leaf, cap_h, fused_sponge=fused_sponge)
        betas = []
        with span(TRANSCRIPT):
            for proof_trees, tree, challenger in zip(trees, layer_trees, challengers):
                proof_trees.append(tree)
                challenger.observe_cap([tuple(int(x) for x in d) for d in tree.cap])
                betas.append(challenger.get_extension_challenge())
        inv2x = _inv_2x_table(m.bit_length() - 1, cur_shift, device)
        beta_arr = gl.from_u64(np.array(betas, dtype=np.uint64), device)
        cur = _fold_step(cur, inv2x, beta_arr)
        cur_shift = cur_shift * cur_shift % P

    # final polynomial coefficients from the remaining evals: both extension
    # components of all K proofs in one coset_ilde with the current shift
    flat = torch.cat([cur[:, :, 0], cur[:, :, 1]], dim=0)  # [2K, final_n]
    coeffs = mk.fetch_arrays(nt.coset_ilde(flat, cfg.rate_bits, cur_shift))[0]
    final_polys = []
    with span(TRANSCRIPT):
        for k, challenger in enumerate(challengers):
            final_poly = [(int(a), int(b)) for a, b in zip(coeffs[k], coeffs[K + k])]
            for c in final_poly:
                challenger.observe_ext(c)
            final_polys.append(final_poly)
    return trees, final_polys


def grind_pow(
    challenger: Challenger,
    pow_bits: int,
    device=None,
    fused_sponge: bool = False,
) -> int:
    """Find the LOWEST nonce (scanning upward from 0) so that
    H(challenge, nonce)[0] has pow_bits leading zeros; batched search on
    the device."""
    if pow_bits == 0:
        challenger.observe_element(0)
        return 0
    device = gl.resolve_device(device)
    c = challenger.get_challenge()
    # about four expected hits' worth of nonces per batch, at most 2^14: the
    # lowest nonce found does not depend on the batch
    batch = min(1 << 14, 1 << (pow_bits + 2))
    threshold = 1 << (64 - pow_bits)
    base = 0
    with span(TRANSCRIPT):
        while True:
            nonces = np.arange(base, base + batch, dtype=np.uint64)
            inputs = np.zeros((batch, 2), dtype=np.uint64)
            inputs[:, 0] = c
            inputs[:, 1] = nonces
            digests = gl.to_u64(
                ps.hash_no_pad(gl.from_u64(inputs, device), fused_sponge=fused_sponge)
            )
            ok = np.nonzero(digests[:, 0] < np.uint64(threshold))[0]
            if len(ok):
                nonce = int(nonces[ok[0]])
                challenger.observe_element(nonce)
                return nonce
            base += batch


def check_pow(challenger: Challenger, nonce: int, pow_bits: int) -> None:
    if pow_bits == 0:
        challenger.observe_element(0)
        return
    c = challenger.get_challenge()
    digest = ps.hash_no_pad_s([c, nonce])
    assert digest[0] < (1 << (64 - pow_bits)), "proof-of-work check failed"
    challenger.observe_element(nonce)


def query_rounds(
    trees, cfg: FriConfig, challenger: Challenger, lde_n: int
) -> tuple[list, list]:
    """Sample query indices and open all folded layers.

    Layer eval pairs are read straight off each tree's leaf level: FRI
    leaves are the 4-wide ``[f(x), f(-x)]`` pairs, which ``hash_leaves``
    stores unhashed (plonky2 hash_or_noop semantics).  Only the
    query-touched leaf rows and path digests are gathered on the device and
    fetched in ONE combined transfer instead of the full layer tables."""
    indices = [challenger.get_challenge() % lde_n for _ in range(cfg.num_query_rounds)]

    # per-layer query positions (qi = q % half, chained)
    qis = []  # list over layers of [nq] int arrays
    q = np.asarray(indices, dtype=np.int64)
    for tree in trees:
        half = tree.levels[0].shape[0]
        qi = q % half
        qis.append(qi)
        q = qi

    gathers = []  # flat list of device tensors; counts per layer
    counts = []
    for tree, qi in zip(trees, qis):
        opened = tree.open_gathers(qi)  # [leaf rows] + sibling paths
        gathers.extend(opened)
        counts.append(len(opened))
    fetched = mk.fetch_arrays(*gathers) if gathers else []
    rounds = []
    for k in range(cfg.num_query_rounds):
        per_layer = []
        off = 0
        for li, tree in enumerate(trees):
            chunk = fetched[off : off + counts[li]]
            off += counts[li]
            leaf = [int(x) for x in chunk[0][k]]
            path = [tuple(int(x) for x in lv[k]) for lv in chunk[1:]]
            per_layer.append((leaf, path))
        rounds.append(per_layer)
    return indices, rounds


def verify_fri(
    proof: FriProof,
    challenger: Challenger,
    cfg: FriConfig,
    lde_n: int,
    shift: int,
    eval_initial,
) -> None:
    """Host-side FRI verification.

    ``eval_initial(idx)`` must return the claimed value (ext tuple) of the
    composition polynomial at LDE index ``idx``, derived from the opened
    initial-tree leaves (checked by the caller).
    """
    # replay transcript: caps -> betas, final poly, pow, query indices
    betas = []
    for cap in proof.caps:
        challenger.observe_cap(cap)
        betas.append(challenger.get_extension_challenge())
    for c in proof.final_poly:
        challenger.observe_ext(c)
    check_pow(challenger, proof.pow_witness, cfg.proof_of_work_bits)

    n_layers = len(proof.caps)

    # domain bookkeeping per layer
    shifts = [shift % P]
    sizes = [lde_n]
    for _ in range(n_layers):
        shifts.append(shifts[-1] * shifts[-1] % P)
        sizes.append(sizes[-1] // 2)

    for per_layer in proof.query_rounds:
        idx = challenger.get_challenge() % lde_n
        value = eval_initial(idx)
        q = idx
        for layer in range(n_layers):
            m = sizes[layer]
            half = m // 2
            qi = q % half
            leaf, path = per_layer[layer]
            assert mk.verify_merkle_proof(
                leaf, qi, path, np.array(proof.caps[layer], dtype=np.uint64)
            ), f"FRI layer {layer} merkle check failed"
            e_pos = (leaf[0], leaf[1])
            e_neg = (leaf[2], leaf[3])
            opened = e_pos if q < half else e_neg
            assert opened == tuple(int(v) % P for v in value), (
                f"FRI layer {layer} value mismatch"
            )
            # fold
            w = gl.primitive_root_of_unity(m.bit_length() - 1)
            x = shifts[layer] * pow(w, qi, P) % P
            inv2x = pow(2 * x % P, P - 2, P)
            half_sum = ext_mul(ext_add(e_pos, e_neg), (pow(2, P - 2, P), 0))
            slope = ext_mul(ext_sub(e_pos, e_neg), (inv2x, 0))
            value = ext_add(half_sum, ext_mul(slope, betas[layer]))
            q = qi
        # final polynomial evaluation at x^2 of the last layer point
        m = sizes[n_layers]
        w = gl.primitive_root_of_unity(m.bit_length() - 1)
        x = shifts[n_layers] * pow(w, q % m, P) % P
        acc = (0, 0)
        for c in reversed(proof.final_poly):
            acc = ext_add(ext_mul(acc, (x, 0)), c)
        assert acc == tuple(int(v) % P for v in value), "FRI final poly mismatch"
