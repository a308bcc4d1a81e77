"""The window's model FLOPs (``_flops``: the steps completed in it, each at
its batch's occupancy) over the window's seconds times the H100 SXM's
dense bf16 peak, 989 TFLOP/s, in %."""

UNIT = "%"
LAYER = "train step (training.steps)"
MOVES = "train_pairs_per_s"
PEAK_FLOPS = 989e12


def read(run):
    if not run.window_items:
        return None
    flops = sum(run.step_flops(ids) for ids in run.window_items)
    return 100.0 * flops / (run.window_s * PEAK_FLOPS)
