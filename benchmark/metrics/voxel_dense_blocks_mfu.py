"""The voxel encoder's dense stage (blocks 3-5 and the head): the model's
FLOPs by ``_flops``' count on the traced batches' active sites at D/4, D/8
and D/16, over the stage's device seconds a step times the H100 SXM's
dense bf16 peak, 989 TFLOP/s, in % (``_voxel_stages``). The count is the
work whatever implements it, so a tail that skipped inactive sites would
be credited."""

from benchmark.metrics import _voxel_stages

UNIT = "%"
LAYER = "models: models.voxel_cnn with ops K1/K2/K3"
MOVES = "train_pairs_per_s"


def read(run):
    return _voxel_stages.reading(run, "dense_mfu")
