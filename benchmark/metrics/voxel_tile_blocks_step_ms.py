"""Device ms a traced step of the voxel encoder's tile stage inside the
real step: the unpack, blocks 1-2 on the tile rows and both scatters, under
``forward.voxel.tiles`` and ``backward.voxel.tiles`` (``_voxel_stages``,
the program's tracing level 2)."""

from benchmark.metrics import _voxel_stages

UNIT = "ms"
LAYER = "models: models.voxel_cnn with ops K1/K2/K3"
MOVES = "train_pairs_per_s"


def read(run):
    return _voxel_stages.reading(run, "tile_ms")
