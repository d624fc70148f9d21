"""Host C++ of the port, built with g++ at first use and loaded with ctypes:
the Poseidon permutation and sponge (``poseidon_native.cpp``) that the
transcript, the verifier and the host tree walks call one state at a time,
and the witness-generation engine (``witness_native.cpp``) that runs a
circuit's generator records to their fixpoint.  A failed build raises; there
is no Python fallback behind these entry points (the Python versions,
``ops.poseidon.permute_s`` and ``engine.witness.WitnessFill``, are the plain
versions the tests hold them against)."""

from .loader import native_hash_no_pad, native_permute_batch  # noqa: F401
