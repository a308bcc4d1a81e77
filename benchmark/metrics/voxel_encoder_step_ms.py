"""Device ms a traced step of the voxel encoder inside the real step: the
device time launched under its ``forward.voxel`` and ``backward.voxel``
spans (``_spans``, the device pass)."""

from benchmark.metrics import _spans

UNIT = "ms"
LAYER = "models: models.voxel_cnn with ops K1/K2/K3"
MOVES = "train_pairs_per_s"


def read(run):
    return _spans.device_ms(run, "forward.voxel", "backward.voxel")
