"""intmax_zkp_core_tpu_torch — the PyTorch/CUDA port of ``intmax_zkp_core_tpu``.

A ZK-rollup proving framework (Goldilocks field, Poseidon-12, NTT/LDE, FRI,
Plonk-style circuit builder / prover / verifier) whose tensor code is plain
PyTorch on int64 bit patterns and whose Poseidon hashing runs in CUDA kernels
written by hand for Hopper (``csrc/``, built with ``nvcc`` at first use).

The layout and the function names follow the JAX package, so each module has
its counterpart there; this package imports nothing of it.

Layout:
  ops/       field arithmetic, Poseidon (plain + CUDA wrappers), NTT, Merkle
  csrc/      CUDA C++ sources of the kernels
  engine/    proving system: circuit IR, prover, verifier, FRI, transcript
  models/    application circuits (zkDSA and a Poseidon hash chain so far)
  utils/     hex codecs, wrapped digest types

Device rule: an entry point takes ``device=None``, which means the CUDA
device and raises when there is none; pass ``device="cpu"`` to run on the
host (the tests do).
"""

__version__ = "0.1.0"
