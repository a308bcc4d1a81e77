"""Device ms a traced step of the voxel encoder's dense stage inside the
real step: blocks 3-5 on the dense grids and the head, under
``forward.voxel.dense`` and ``backward.voxel.dense`` (``_voxel_stages``,
the program's tracing level 2)."""

from benchmark.metrics import _voxel_stages

UNIT = "ms"
LAYER = "models: models.voxel_cnn with ops K1/K2/K3"
MOVES = "train_pairs_per_s"


def read(run):
    return _voxel_stages.reading(run, "dense_ms")
