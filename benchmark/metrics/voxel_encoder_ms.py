"""Forward + backward ms of ``model.voxel_encoder`` on one of the cell's
batches: the median of 10 calls between CUDA events after the window."""

UNIT = "ms"
LAYER = "models: models.voxel_cnn with ops K1/K2/K3"
MOVES = "train_pairs_per_s"


def read(run):
    return run.encoder_ms("voxel")
