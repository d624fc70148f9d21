"""A plain verifier of the program's proofs (Plonky2's protocol as the
reference's engine runs it: Poseidon transcript, a permutation argument over
chunks of 7 routed wires, the quotient identity at zeta, arity-2 FRI with
Merkle caps and proof-of-work).

``verify(circuit, proof)`` raises ``Rejected`` with the first check that
fails.  ``circuit`` is the verifier key as the configuration states it: the
circuit's size, its gates, its public-input count, the constants/sigmas cap,
whose digest must equal the configuration's ``circuit_digest``, and the FRI
parameters; ``proof`` is the proof as plain lists of integers."""

from __future__ import annotations

from . import field as f
from .gates import GATES
from .poseidon import P, hash_no_pad, permute, two_to_one

CHUNK = 7  # routed wires per partial product of the permutation argument


class Rejected(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Rejected(what)


class Transcript:
    """The duplex sponge of plonky2's ``Challenger``: buffered observations,
    a permutation on demand, challenges taken from the back of the rate."""

    def __init__(self):
        self.state = [0] * 12
        self.inputs: list = []
        self.outputs: list = []

    def observe(self, xs) -> None:
        for x in xs:
            check(0 <= int(x) < P, "a transcript element is not canonical")
            self.inputs.append(int(x))
            if len(self.inputs) == 8:
                self._duplex()

    def observe_cap(self, cap) -> None:
        for digest in cap:
            self.observe(digest)

    def _duplex(self) -> None:
        self.state[: len(self.inputs)] = self.inputs
        self.inputs = []
        self.state = permute(self.state)
        self.outputs = list(self.state[:8])

    def challenge(self) -> int:
        if self.inputs or not self.outputs:
            self._duplex()
        return self.outputs.pop()

    def ext_challenge(self):
        return (self.challenge(), self.challenge())


def circuit_digest(circuit) -> tuple:
    return hash_no_pad([x for d in circuit["constants_sigmas_cap"] for x in d]
                       + [circuit["n"], circuit["num_wires"], circuit["num_challenges"]])


def merkle_ok(leaf, index: int, path, cap) -> bool:
    digest = tuple((list(leaf) + [0, 0, 0, 0])[:4]) if len(leaf) <= 4 else hash_no_pad(leaf)
    for sibling in path:
        digest = two_to_one(sibling, digest) if index & 1 else two_to_one(digest, sibling)
        index >>= 1
    return index < len(cap) and digest == tuple(cap[index])


def verify(circuit, proof) -> None:
    n = circuit["n"]
    log_n = n.bit_length() - 1
    blowup = 1 << circuit["rate_bits"]
    lde_n = n * blowup
    C = circuit["num_challenges"]
    R = circuit["num_routed_wires"]
    nch = -(-R // CHUNK)
    gate_ids = circuit["gate_ids"]
    n_const = max(GATES[g][1] for g in gate_ids)
    check(n == 1 << log_n, "the circuit's size is not a power of two")
    check(circuit_digest(circuit) == tuple(circuit["circuit_digest"]),
          "the constants/sigmas cap is not the configuration's circuit")
    pis = [int(v) for v in proof["public_inputs"]]
    check(len(pis) == circuit["num_public_inputs"], "wrong number of public inputs")
    check(all(0 <= v < P for v in pis), "a public input is not canonical")
    ops = {k: [tuple(int(x) for x in v) for v in vs] for k, vs in proof["openings"].items()}
    sizes = {"constants_sigmas": len(gate_ids) + n_const + R, "wires": circuit["num_wires"],
             "zs_pp": C * nch, "quotient": C * blowup, "zs_next": C}
    for name, size in sizes.items():
        check(len(ops.get(name, ())) == size, f"openings of {name}: wrong count")

    # the transcript
    pi_hash = hash_no_pad(pis)
    tr = Transcript()
    tr.observe(circuit["circuit_digest"])
    tr.observe(pi_hash)
    tr.observe_cap(proof["wires_cap"])
    betas = [tr.challenge() for _ in range(C)]
    gammas = [tr.challenge() for _ in range(C)]
    tr.observe_cap(proof["zs_pp_cap"])
    alphas = [tr.challenge() for _ in range(C)]
    tr.observe_cap(proof["quotient_cap"])
    zeta = tr.ext_challenge()
    for name in ("constants_sigmas", "wires", "zs_pp", "quotient", "zs_next"):
        for o in ops[name]:
            tr.observe(o)
    alpha_fri = tr.ext_challenge()

    # the constraints, the permutation argument and the quotient at zeta
    cs_z = ops["constants_sigmas"]
    sel, consts, sigmas = (cs_z[: len(gate_ids)], cs_z[len(gate_ids) : len(gate_ids) + n_const],
                           cs_z[len(gate_ids) + n_const :])
    wires = ops["wires"]
    zs, pps = ops["zs_pp"][:C], ops["zs_pp"][C:]
    gate_terms = []
    for gi, gate in enumerate(gate_ids):
        gate_terms.extend(f.mul(sel[gi], c) for c in GATES[gate][0](wires, consts, pi_hash))
    zeta_n = f.ext_pow(zeta, n)
    z_h = f.sub(zeta_n, (1, 0))
    l0 = f.mul(z_h, f.ext_inv(f.mul((n, 0), f.sub(zeta, (1, 0)))))
    k_is = [pow(7, j, P) for j in range(R)]
    for c in range(C):
        pp = pps[c * (nch - 1) : (c + 1) * (nch - 1)]
        terms = [f.mul(l0, f.sub(zs[c], (1, 0)))]
        prev = zs[c]
        for j in range(nch):
            num, den = (1, 0), (1, 0)
            for i in range(j * CHUNK, min((j + 1) * CHUNK, R)):
                num = f.mul(num, f.add(f.add(wires[i], f.scale(zeta, k_is[i] * betas[c] % P)),
                                       (gammas[c], 0)))
                den = f.mul(den, f.add(f.add(wires[i], f.scale(sigmas[i], betas[c])),
                                       (gammas[c], 0)))
            nxt = ops["zs_next"][c] if j == nch - 1 else pp[j]
            terms.append(f.sub(f.mul(nxt, den), f.mul(prev, num)))
            if j < nch - 1:
                prev = pp[j]
        terms.extend(gate_terms)
        vanishing, apow = (0, 0), (1, 0)
        for t in terms:
            vanishing = f.add(vanishing, f.mul(apow, t))
            apow = f.scale(apow, alphas[c])
        q, zpow = (0, 0), (1, 0)
        for chunk in ops["quotient"][c * blowup : (c + 1) * blowup]:
            q = f.add(q, f.mul(zpow, chunk))
            zpow = f.mul(zpow, zeta_n)
        check(vanishing == f.mul(z_h, q), f"the quotient identity fails at zeta (challenge {c})")

    # FRI: the transcript's remainder
    fri = proof["fri"]
    n_layers, final_len = 0, n
    while final_len > circuit["final_poly_len"]:
        final_len //= 2
        n_layers += 1
    check(len(fri["caps"]) == n_layers, "wrong number of FRI layers")
    check(len(fri["final_poly"]) == final_len, "wrong length of the final polynomial")
    check(len(fri["query_rounds"]) == circuit["num_query_rounds"], "wrong number of FRI queries")
    check(len(proof["initial_openings"]) == circuit["num_query_rounds"],
          "wrong number of initial openings")
    fri_betas = []
    for cap in fri["caps"]:
        tr.observe_cap(cap)
        fri_betas.append(tr.ext_challenge())
    for coef in fri["final_poly"]:
        tr.observe(coef)
    bits = circuit["proof_of_work_bits"]
    nonce = int(fri["pow_witness"])
    check(0 <= nonce < P, "the proof-of-work witness is not canonical")
    check(hash_no_pad([tr.challenge(), nonce])[0] < (1 << (64 - bits)),
          "the proof of work is short of its bits")
    tr.observe([nonce])

    flat = ops["constants_sigmas"] + ops["wires"] + ops["zs_pp"] + ops["quotient"]
    apows, apow = [], (1, 0)
    for _ in range(len(flat) + C):
        apows.append(apow)
        apow = f.mul(apow, alpha_fri)
    at_zeta = (0, 0)
    for i, y in enumerate(flat):
        at_zeta = f.add(at_zeta, f.mul(apows[i], y))
    at_gzeta = (0, 0)
    for j, y in enumerate(ops["zs_next"]):
        at_gzeta = f.add(at_gzeta, f.mul(apows[len(flat) + j], y))
    gzeta = f.scale(zeta, f.root_of_unity(log_n))
    caps = {"constants_sigmas": circuit["constants_sigmas_cap"], "wires": proof["wires_cap"],
            "zs_pp": proof["zs_pp_cap"], "quotient": proof["quotient_cap"]}
    widths = {name: sizes[name] for name in caps}
    w_lde = f.root_of_unity(lde_n.bit_length() - 1)
    half_inv = f.inv(2)
    for qn, (initial, layers) in enumerate(zip(proof["initial_openings"], fri["query_rounds"])):
        idx = tr.challenge() % lde_n
        x = f.GENERATOR * pow(w_lde, idx, P) % P
        values = []
        for name, cap in caps.items():
            leaf, path = initial[name]
            check(len(leaf) == widths[name], f"query {qn}: {name} leaf of the wrong width")
            check(merkle_ok(leaf, idx, path, cap), f"query {qn}: {name} Merkle path fails")
            values.extend(int(v) for v in leaf)
        comb1 = (0, 0)
        for i, v in enumerate(values):
            comb1 = f.add(comb1, f.scale(apows[i], v))
        comb2 = (0, 0)
        for j in range(C):
            comb2 = f.add(comb2, f.scale(apows[len(flat) + j], int(initial["zs_pp"][0][j])))
        value = f.add(f.mul(f.sub(comb1, at_zeta), f.ext_inv(f.sub((x, 0), zeta))),
                      f.mul(f.sub(comb2, at_gzeta), f.ext_inv(f.sub((x, 0), gzeta))))
        check(len(layers) == n_layers, f"query {qn}: wrong number of FRI layers opened")
        q, m, shift = idx, lde_n, f.GENERATOR
        for layer, (leaf, path) in enumerate(layers):
            half = m // 2
            qi = q % half
            check(len(leaf) == 4, f"query {qn}: FRI layer {layer} leaf of the wrong width")
            check(merkle_ok(leaf, qi, path, fri["caps"][layer]),
                  f"query {qn}: FRI layer {layer} Merkle path fails")
            pos, neg = (int(leaf[0]), int(leaf[1])), (int(leaf[2]), int(leaf[3]))
            check((pos if q < half else neg) == value,
                  f"query {qn}: FRI layer {layer} disagrees with the layer below")
            x = shift * pow(f.root_of_unity(m.bit_length() - 1), qi, P) % P
            value = f.add(f.scale(f.add(pos, neg), half_inv),
                          f.mul(f.scale(f.sub(pos, neg), f.inv(2 * x % P)), fri_betas[layer]))
            q, m, shift = qi, half, shift * shift % P
        x = shift * pow(f.root_of_unity(m.bit_length() - 1), q % m, P) % P
        acc = (0, 0)
        for coef in reversed(fri["final_poly"]):
            acc = f.add(f.scale(acc, x), tuple(int(c) for c in coef))
        check(acc == value, f"query {qn}: the final polynomial disagrees")


def _rejects(job) -> bool:
    try:
        verify(*job)
    except Rejected:
        return True
    return False


def count_rejected(jobs: list) -> int:
    """How many of ``jobs``, each (circuit, proof), ``verify`` rejects; the
    jobs are verified side by side in worker processes on the host's cores
    (one left for the parent), each of which has ended when this returns."""
    import os
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    workers = min(len(jobs), 8, max(1, len(os.sched_getaffinity(0)) - 1))
    if workers <= 1:
        return sum(map(_rejects, jobs))
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
        return sum(pool.map(_rejects, jobs))
