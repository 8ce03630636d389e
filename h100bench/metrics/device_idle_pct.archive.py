"""The card's idle share of the profiled calibration: 100 x (1 - the union of its
kernel, copy and set intervals / its wall)."""


def read(run):
    cap = run.capture
    if cap is None or cap.wall_s <= 0:
        return None
    return 100.0 * (1.0 - cap.busy_s / cap.wall_s)
