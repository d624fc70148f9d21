"""The least time the card needs for the work of a proof, counted from the
proof's shapes (never from launches), stage by stage.

The peaks are those of one NVIDIA H100 SXM at its full power limit: device
memory 3.35 TB/s (published), and 32-bit integer multiply-adds at 16.75e12
a second.  That integer rate is derived, not published: half the float32
FMA rate (67 TFLOP/s = 33.5e12 FMA/s over 128 FP32 lanes an SM; the SM has
64 INT32 lanes).  A stage's least time is the larger of its bytes over the
memory rate (each input read once, each output written once) and its
multiply-adds over the integer rate.  The counts are the cheapest
formulations known (a field multiply 4 multiply-adds, a squaring 3, a
multiply by a small constant 2, a Fermat inverse chain 232, one inverse of
a batch 12)."""

from __future__ import annotations

from port_bench.reference.poseidon import partial_round_tables

HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 16.75e12

MUL, SQR = 4, 3
CHAIN = 64 * SQR + 10 * MUL
INV_BATCHED = 3 * MUL
SBOXES = 8 * 12 + 22
MDS_LAYER_MADS = (12 * 12 + 1) * 2
# one permutation in the sparse form of its partial rounds: 118 S-boxes (x^7
# as two squarings and two multiplies), 8 dense MDS layers of small
# constants, one 11x11 layer of full constants, 22 sparse partial rounds
MADS_PER_PERMUTATION = (SBOXES * (2 * SQR + 2 * MUL) + 8 * MDS_LAYER_MADS + 11 * 11 * 4
                        + 22 * (22 * 4 + 2))
CHUNK = 7  # routed wires per partial product
POSEIDON_GATE_CONSTRAINTS = 123


def least_seconds(n_bytes: float, mads: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, mads / INT32_MAD_PER_S)


def poseidon_rows(rows: int, width_in: int, width_out: int, perms_per_row: int) -> tuple:
    """(bytes, multiply-adds) of hashing ``rows`` rows."""
    return rows * (width_in + width_out) * 8, rows * perms_per_row * MADS_PER_PERMUTATION


def merkle_tree(leaves: int, width: int, cap_height: int) -> tuple:
    """A tree over ``leaves`` leaves of ``width`` elements reduced to a cap
    of 2^cap_height: each leaf wider than a digest hashed (ceil(width / 8)
    permutations), then every node below the cap (one two-to-one each)."""
    n_bytes = mads = 0
    if width > 4:
        b, m = poseidon_rows(leaves, width, 4, -(-width // 8))
        n_bytes, mads = n_bytes + b, mads + m
    nodes = leaves - (1 << cap_height)
    if nodes > 0:
        b, m = poseidon_rows(nodes, 8, 4, 1)
        n_bytes, mads = n_bytes + b, mads + m
    return n_bytes, mads


def ntt(rows: int, n: int) -> tuple:
    """[rows, n] read and written once; (n / 2) log2 n twiddle multiplies a
    row."""
    return rows * n * 8 * 2, rows * (n // 2) * (n.bit_length() - 1) * MUL


def perm_columns(K: int, C: int, R: int, n: int) -> tuple:
    """The permutation argument's running products: wires, identity and
    sigma read once; Z and the partial products written once.  Per point and
    challenge two factor multiplies a wire, the chunk products, prefix and
    suffix products, the quotients and the running product, one inverse of
    a batch."""
    nch = -(-R // CHUNK)
    n_bytes = (K * R + 2 * R) * n * 8 + K * C * nch * n * 8 + K * C * 8
    common = (2 * R + 2 * (R - nch) + 2 * (nch - 1) + max(nch - 2, 0) + 2 * (nch - 1) + 1
              + (nch - 1))
    return n_bytes, K * C * n * ((common + 1) * MUL + INV_BATCHED)


def perm_quotient(K: int, C: int, R: int, L: int) -> tuple:
    nch = -(-R // CHUNK)
    n_bytes = (K * R + R + 2) * L * 8 + K * C * (nch + 1) * L * 8 + (4 * K * C + R) * 8
    muls = 2 * R + 2 * (R - nch) + 3 * nch + 2
    return n_bytes, K * C * L * muls * MUL


def zinv_mul(rows: int, L: int, distinct: int) -> tuple:
    """acc [rows, L] times 1 / Z_H, whose coset values take ``distinct``
    values."""
    return (2 * rows + 1) * L * 8, distinct * CHAIN + rows * L * MUL


def fri_initial(K: int, L: int) -> tuple:
    term = SQR + 2 * MUL + 4 * MUL + 2
    return K * L * 3 * 16 + L * 8 + K * 8 * 8, K * L * 2 * (term + INV_BATCHED)


def gate_quotient(K: int, C: int, L: int, width: int = 135) -> tuple:
    """The Poseidon gate's constraints at L points: 118 S-boxes, 7 dense MDS
    layers, the affine tables' products (a coefficient below 2^32 as 2
    multiply-adds, else 4), the swap and delta products, and the fold of 123
    constraints into C accumulators."""
    a_rows, b_rows = partial_round_tables()
    coef = [c for row in a_rows + b_rows for c in row[1:] if c]
    small = sum(1 for c in coef if c < (1 << 32))
    n_bytes = (K * width * L + L + 2 * K * C * L) * 8 + 4 * K * C * 8
    common = (7 * MDS_LAYER_MADS + SQR + 4 * MUL
              + (POSEIDON_GATE_CONSTRAINTS * C + C) * MUL)
    per_point = SBOXES * (2 * SQR + 2 * MUL) + small * 2 + (len(coef) - small) * MUL + common
    return n_bytes, K * L * per_point


def batch_calls(shape: dict, K: int, pow_nonces: list) -> list:
    """The counted work of one ``prove_batch`` of K proofs of a circuit of
    ``shape`` (n, num_wires, num_routed_wires, num_challenges, rate_bits,
    cap_height, final_poly_len, poseidon_gate), as (stage, function, args)
    of the functions above: per commitment (wires; Z and the partial
    products; the quotient's chunks) its iNTT or the quotient's, its LDE and
    K trees; K trees a FRI layer (its leaves are pairs, not hashed); the
    grinding of each proof (the lowest nonce that passes costs nonce + 1
    hashes); the permutation argument's and the quotient's kernels."""
    n, W, R, C = shape["n"], shape["num_wires"], shape["num_routed_wires"], shape["num_challenges"]
    blowup = 1 << shape["rate_bits"]
    L = n * blowup
    cap = shape["cap_height"]
    zpp = C * (-(-R // CHUNK))
    calls = []
    for width in (W, zpp):
        calls.append(("lde", "ntt", (K * width, n)))
        calls.append(("lde", "ntt", (K * width, L)))
        calls.extend([("merkle", "merkle_tree", (L, width, cap))] * K)
    calls.append(("lde", "ntt", (K * C, L)))
    calls.append(("lde", "ntt", (K * C * blowup, L)))
    calls.extend([("merkle", "merkle_tree", (L, C * blowup, cap))] * K)
    m = L
    while m > shape["final_poly_len"] * blowup:
        half = m // 2
        calls.extend([("merkle", "merkle_tree", (half, 4, min(cap, (half - 1).bit_length())))] * K)
        m = half
    calls.extend(("merkle", "poseidon_rows", (nonce + 1, 2, 4, 1)) for nonce in pow_nonces)
    calls.append(("perm_columns", "perm_columns", (K, C, R, n)))
    calls.append(("perm_quotient", "perm_quotient", (K, C, R, L)))
    calls.append(("zinv_mul", "zinv_mul", (K * C, L, blowup)))
    calls.append(("fri_initial", "fri_initial", (K, L)))
    if shape.get("poseidon_gate"):
        calls.append(("gate_quotient", "gate_quotient", (K, C, L, W)))
    return calls


def batch_work(shape: dict, K: int, pow_nonces: list) -> list:
    """(stage, bytes, multiply-adds) of each of ``batch_calls``."""
    fns = {"ntt": ntt, "merkle_tree": merkle_tree, "poseidon_rows": poseidon_rows,
           "perm_columns": perm_columns, "perm_quotient": perm_quotient, "zinv_mul": zinv_mul,
           "fri_initial": fri_initial, "gate_quotient": gate_quotient}
    return [(stage, *fns[fn](*args)) for stage, fn, args in batch_calls(shape, K, pow_nonces)]
