"""Σ floor ÷ Σ device time of the K1, K2 and K3 launches of the traced
steps, in %. The floor of a launch is its bytes (``_kernel_work``, the
frozen ``work(...)`` formulas) over 3.35 TB/s; device time is matched by
the kernels' symbols. Nothing matched: no reading."""

from benchmark.metrics import _kernel_work

UNIT = "%"
LAYER = "kernels: ops/*.py and csrc/*.cu"
MOVES = "train_pairs_per_s"


def read(run):
    report = run.trace()
    seconds = sum(s for name, s in report["ops"].items() if _kernel_work.label(name))
    if seconds <= 0 or not report["valid_rows"]:
        return None
    return 100.0 * run.kernel_floor_s() / seconds
