"""Rollup layer: block production (reference ``src/rollup/``).  The port has
the block flow's first stages (``block_flow.py``); the rollup circuits, the
block data model and their gadgets are not ported yet."""
