"""The plain reference against literal vectors: plonky2's Poseidon test
vectors, the partial rounds' affine forms against the straight permutation,
and sparse Merkle roots frozen here."""

import random

from port_bench.reference import poseidon as ps
from port_bench.reference.smt import ZERO, SparseMerkleTree

P = ps.P

VECTORS = [
    ([0] * 12,
     [0x3c18a9786cb0b359, 0xc4055e3364a246c3, 0x7953db0ab48808f4, 0xc71603f33a1144ca,
      0xd7709673896996dc, 0x46a84e87642f44ed, 0xd032648251ee0b3c, 0x1c687363b207df62,
      0xdf8565563e8045fe, 0x40f5b37ff4254dae, 0xd070f637b431067c, 0x1792b1c4342109d7]),
    (list(range(12)),
     [0xd64e1e3efc5b8e9e, 0x53666633020aaa47, 0xd40285597c6a8825, 0x613a4f81e81231d2,
      0x414754bfebd051f0, 0xcb1f8980294a023f, 0x6eb2a9e4d54a9d0f, 0x1902bc3af467e056,
      0xf045d5eafdc6021f, 0xe4150f77caaa3be5, 0xc9bfd01d39b50cce, 0x5c0a27fcb0e1459b]),
    ([P - 1] * 12,
     [0xbe0085cfc57a8357, 0xd95af71847d05c09, 0xcf55a13d33c1c953, 0x95803a74f4530e82,
      0xfcd99eb30a135df1, 0xe095905e913a3029, 0xde0392461b42919b, 0x7d3260e24e81d031,
      0x10d3d0465d9deaa0, 0xa87571083dfc2a47, 0xe18263681e9958f8, 0xe28e96f1ae5e60d3]),
]


def test_poseidon_vectors():
    for state, want in VECTORS:
        assert ps.permute(state) == want
        assert ps.permute_plain(state) == want


def test_straight_line_permutation_equals_the_rounds():
    rng = random.Random(3)
    for _ in range(8):
        state = [rng.randrange(P) for _ in range(12)]
        assert ps.permute(state) == ps.permute_plain(state)


def test_partial_round_tables_reproduce_the_permutation():
    """b_i = A_i . basis and the state entering round 26 = B . basis, on the
    intermediate values of a straight run of the rounds."""
    a_rows, b_rows = ps.partial_round_tables()
    rng = random.Random(5)
    state = [rng.randrange(P) for _ in range(12)]
    s = list(state)
    for rnd in range(ps.HALF_FULL):
        rc = ps.ROUND_CONSTANTS[12 * rnd : 12 * rnd + 12]
        s = [ps._sbox((a + c) % P) for a, c in zip(s, rc)]
        ys = s
        s = [sum(m * a for m, a in zip(row, s)) % P for row in ps.MDS]
    xs = []
    for i in range(ps.N_PARTIAL):
        rc = ps.ROUND_CONSTANTS[12 * (4 + i) : 12 * (5 + i)]
        s = [(a + c) % P for a, c in zip(s, rc)]
        basis = [1] + ys + xs + [0] * (ps.N_PARTIAL - i)
        assert s[0] == sum(c * v for c, v in zip(a_rows[i], basis)) % P
        s[0] = ps._sbox(s[0])
        xs.append(s[0])
        s = [sum(m * a for m, a in zip(row, s)) % P for row in ps.MDS]
    basis = [1] + ys + xs
    assert s == [sum(c * v for c, v in zip(row, basis)) % P for row in b_rows]


# roots after setting keys 5, 9, 12 and 5 again (an update) to the values
# below, then removing 9, as the reference's tree states them
SMT_STEPS = [(5, (1, 2, 3, 4)), (9, (5, 6, 7, 8)), (12, (9, 10, 11, 12)), (5, (13, 14, 15, 16)),
             (9, (0, 0, 0, 0))]


def test_smt_empty_and_single_leaf():
    tree = SparseMerkleTree()
    assert tree.root() == ZERO
    assert tree.set(5, (1, 2, 3, 4)) == ps.hash_pad([5, 0, 0, 0, 1, 2, 3, 4, 1])


def test_smt_roots_frozen():
    tree = SparseMerkleTree()
    roots = [tree.set(k, v) for k, v in SMT_STEPS]
    assert roots == SMT_ROOTS
    assert SparseMerkleTree().set(12, (9, 10, 11, 12)) != roots[-1]


SMT_ROOTS = [
    (13171087249497044796, 3017945688521979954, 10033452637807715854, 17443566191700127538),
    (326570010574739069, 7221099470770491020, 1636405483970837279, 5036125576957954183),
    (1768380401499235680, 4511287031085601619, 7231586370402536777, 13563043480098065842),
    (7780210844384317874, 7456037593726174507, 8797570473248689155, 15582625858292323455),
    (9198493297290553295, 3571490239086524536, 6540176919330928972, 449653659115855856),
]
