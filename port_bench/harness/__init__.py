"""The general part of the benchmark: discovery by name, the measured
window, the trace's reduction and the roofline arithmetic."""
