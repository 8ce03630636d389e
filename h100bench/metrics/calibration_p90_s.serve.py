"""The 90th percentile of the time from a calibration's submit to its
final front, over the calibrations that finished in the window."""

from h100bench.harness.stats import p90


def read(run):
    return p90(run.latencies)
