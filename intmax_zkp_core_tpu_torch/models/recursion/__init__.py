from .gadgets import RecursiveProofTarget  # noqa: F401
