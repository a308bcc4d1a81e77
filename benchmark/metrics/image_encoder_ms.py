"""Forward + backward ms of ``model.image_encoder`` on one of the cell's
batches: the median of 10 calls between CUDA events after the window."""

UNIT = "ms"
LAYER = "models: models.mvcnn and models.resnet"
MOVES = "train_pairs_per_s"


def read(run):
    return run.encoder_ms("image")
