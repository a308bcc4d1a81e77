"""The share of the voxel encoder's tile rows that are padding, in %: 1 −
the loader's active tiles (``loader.voxel_active_tiles``) over the
encoder's tile rows (``voxel.tile_rows``, B·k a step), batch by batch over
``_voxel_stages``' pass."""

from benchmark.metrics import _voxel_stages

UNIT = "%"
LAYER = "models: models.voxel_cnn with ops K1/K2/K3"
MOVES = "train_pairs_per_s"


def read(run):
    return _voxel_stages.reading(run, "padding_share")
