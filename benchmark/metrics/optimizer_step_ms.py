"""Device ms a traced step of Adam (``training.optim.Adam``): the device
time launched under the step's ``optimizer`` span (``_spans``, the device
pass)."""

from benchmark.metrics import _spans

UNIT = "ms"
LAYER = "train step (training.steps)"
MOVES = "train_pairs_per_s"


def read(run):
    return _spans.device_ms(run, "optimizer")
