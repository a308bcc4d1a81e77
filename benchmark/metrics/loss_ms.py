"""Forward + backward ms of the configuration's NT-Xent pairs (through the
port's K4-K6 kernels) on seeded unit embeddings at the cell's batch: the
median of 10 calls between CUDA events after the window."""

UNIT = "ms"
LAYER = "loss: losses.nt_xent with ops.nt_xent K4-K6"
MOVES = "train_pairs_per_s"


def read(run):
    return run.loss_ms()
