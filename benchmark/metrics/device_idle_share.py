"""1 − (the union of the device's busy intervals ÷ the traced window), in
%, over the traced steps (``_trace``). The profiler slows the host, so it
reads higher than an untraced run would."""

UNIT = "%"
LAYER = "device"
MOVES = "train_pairs_per_s"


def read(run):
    report = run.trace()
    if report["window_s"] <= 0 or report["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - report["busy_s"] / report["window_s"])
