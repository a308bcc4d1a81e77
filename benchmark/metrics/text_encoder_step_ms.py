"""Device ms a traced step of the text encoder inside the real step: the
device time launched under its ``forward.text`` and ``backward.text``
spans (``_spans``, the device pass)."""

from benchmark.metrics import _spans

UNIT = "ms"
LAYER = "models: models.bigru"
MOVES = "train_pairs_per_s"


def read(run):
    return _spans.device_ms(run, "forward.text", "backward.text")
