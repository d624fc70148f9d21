"""The share of the traced window in which no operation runs on the card
(the union of device intervals in the torch.profiler trace; the mean over
the cards), in percent."""

from port_bench.harness.trace import idle_pct


def read(run):
    return idle_pct(run)
