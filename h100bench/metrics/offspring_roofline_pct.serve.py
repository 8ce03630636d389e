"""The fused offspring kernel's share of its roofline in the profiled
step: the least time its launches could take, their bytes at the H100's
3.35 TB/s (the step is bound by bytes: about 1.6 floating-point
operations a byte), over their device time. Every tenth launch is
counted, bytes and time alike; the bytes come from the benchmark's
frozen count (``harness/bytecount.py``). Stated against the published
peak at 700 W."""

from h100bench.harness.bytecount import offspring_bytes
from h100bench.harness.peaks import HBM_BYTES_PER_S


def read(run):
    cap, probe = run.capture, run.offspring
    if cap is None or probe is None or not probe.samples:
        return None
    launches = sorted((s, d) for name, s, d in cap.kernels if "offspring_kernel" in name)
    if len(launches) != probe.launches:
        return None  # the trace and the launches disagree: nothing sound to read
    nbytes = sum(offspring_bytes(args, tags) for _, args, tags in probe.samples)
    dur = sum(launches[i][1] for i, _, _ in probe.samples)
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / dur if dur > 0 else None
