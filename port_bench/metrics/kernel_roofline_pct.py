"""The kernels' share of their roofline in the traced requests: the least
time the counted work needs (``harness/roofline.py``, from the proofs'
shapes; the integer peak there is derived, half the float32 rate, not
published) over the device time of the kernels that do that work
(``roofline/stages/*.json``), in percent."""

from port_bench.harness.trace import roofline_pct


def read(run):
    return roofline_pct(run)
