"""The kernels' domain on the CPU: the launch plan of ``ntt_cuda`` at every
length and row count the JAX package's NTT takes, its outer four-step
replayed with small limits against the JAX package's NTT, and the Poseidon
gate quotient's challenge groups.  The launches themselves run only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.ops import ntt as jnt
from intmax_zkp_core_tpu_torch.ops import cuda_build as cb
from intmax_zkp_core_tpu_torch.ops import gate_quotient_cuda as gqc
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
from intmax_zkp_core_tpu_torch.ops import ntt_cuda as nc

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001


def _field(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def test_ntt_launch_plan():
    # (rows, log2 length, launches): one launch up to 2^11 at any row count;
    # the four-step's two up to 2^22, twice per 65,535 rows; above, the outer
    # four-step: its column launch, the rows' four-step, the transposed copy
    for rows, log_n, launches in ((1, 0, 1), (1, 11, 1), (1 << 20, 11, 1), (1, 12, 2),
                                  (135, 22, 2), (70_000, 12, 4), (1, 23, 4), (2, 24, 4),
                                  (1, 32, 4), (40, 23, 6)):
        plan = nc.plan(rows, 1 << log_n)
        assert len(plan) == nc.launches_for(1 << log_n, rows) == launches, (rows, log_n)
        passes = 0
        for kind, *shape in plan:
            if kind == "local":
                log_len, n_seq, batch = shape
                assert log_len <= nc.LOCAL_LOG_MAX and n_seq < 1 << 31
                assert batch <= cb.MAX_GRID_YZ
                passes += n_seq * batch << log_len
            else:
                assert kind == "transpose" and shape[:2] == [1 << 11, 1 << (log_n - 11)]
                assert shape[2] <= cb.MAX_GRID_YZ
        # every element goes once through each local pass of its length
        assert passes == (1 if log_n <= 11 else 2 if log_n <= 22 else 3) * rows << log_n
    with pytest.raises(ValueError):
        nc.plan(1, 1 << 33)


class _Replay:
    """The card's launches in plain PyTorch: the local transform by its
    strides, the transposed copy, the real twiddle tables."""

    @staticmethod
    def local(src, dst, log_len, n_seq, batch, batch_stride, in_strides, out_strides, inverse,
              post=None, scale=None):
        y = torch.arange(batch)[:, None, None]
        q = torch.arange(n_seq)[None, :, None]
        k = torch.arange(1 << log_len)[None, None, :]
        seqs = src.reshape(-1)[y * batch_stride + q * in_strides[0] + k * in_strides[1]]
        t = nc.ntt_plain(seqs.reshape(-1, 1 << log_len), inverse).reshape(seqs.shape)
        if inverse:  # the kernel's inverse transform leaves out the 1/N
            t = gl.mul(t, torch.tensor(1 << log_len))
        if post is not None:
            t = gl.mul(t, post[0].reshape(-1)[k * post[1] + q])
        if scale is not None:
            t = gl.mul(t, torch.tensor(gl.i64(scale)))
        dst.view(-1)[y * batch_stride + q * out_strides[0] + k * out_strides[1]] = t

    @staticmethod
    def transpose(src, dst, rows, cols):
        dst.view(-1, cols, rows).copy_(src.view(-1, rows, cols).transpose(1, 2))

    @staticmethod
    def twiddles(log_n1, log_n2, inverse, device, outer=False):
        return nc.twiddle_table(log_n1, log_n2, inverse, device, log_n1 if outer else None)


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_outer_four_step_replayed_equals_jax(inverse):
    # local transforms of at most 2^2 points and 3 rows a launch: 2^9 takes
    # the outer four-step three times over, then the four-step and row chunks
    a = _field(90 + inverse, (5, 1 << 9))
    want = np.asarray((jnt.intt if inverse else jnt.ntt)(jnp.asarray(a)))
    x = gl.from_u64(a, "cpu")
    out = torch.empty_like(x)
    nc._transform(x, out, 9, inverse, _Replay, local_log_max=2, max_rows=3)
    assert (gl.to_u64(out) == want).all()


def test_gate_quotient_challenge_groups():
    K, C, L = 2, 9, 48
    args = [gl.from_u64(_field(s, shape), "cpu") for s, shape in
            ((70, (K, 135, L)), (71, (L,)), (72, (K, C)), (73, (K, C, L)), (74, (K, C)))]
    want = gqc.poseidon_gate_quotient_plain(*args)
    got = gqc.challenge_groups(gqc.poseidon_gate_quotient_plain, *args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
