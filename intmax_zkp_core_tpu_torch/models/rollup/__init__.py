"""Rollup layer: block production (reference ``src/rollup/``): the data model
(``block.py``, ``address_list.py``, ``deposit.py``), the gadgets of the block
circuit (``gadgets/``), the block-production circuit (``circuits.py``), the
flow that proves it (``block_flow.py``) and its smallest form
(``mini_block.py``)."""
