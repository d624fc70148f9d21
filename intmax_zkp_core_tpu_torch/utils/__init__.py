"""Host-side value types and codecs (hex digests, field packing)."""

from .hash_out import HashOut  # noqa: F401
