"""The general parts of the benchmark: the cell's files by name, the
window, the device trace, the probes and the result line."""
