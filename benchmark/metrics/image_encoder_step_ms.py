"""Device ms a traced step of the image encoder inside the real step: the
device time launched under its ``forward.image`` and ``backward.image``
spans (``_spans``, the device pass)."""

from benchmark.metrics import _spans

UNIT = "ms"
LAYER = "models: models.mvcnn and models.resnet"
MOVES = "train_pairs_per_s"


def read(run):
    return _spans.device_ms(run, "forward.image", "backward.image")
