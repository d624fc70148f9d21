"""The proving engine: circuit IR, Plonk-style prover/verifier with FRI commitments."""
