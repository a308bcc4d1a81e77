"""The tile blocks' weight gradients against their floor: the floor of
blocks 1-2's weight gradients on the step's B·k window rows (input and
output gradient read, weights written, at 3.35 TB/s, or their FLOPs at 989
TFLOP/s, whichever takes longer) over the device time a step of the
``*wgrad*`` kernels launched under ``backward.voxel.tiles``, in %
(``_voxel_stages``). At 128³ that is cuDNN's batch-chunked path: block 1's
convolution has more than 2^31 output elements there."""

from benchmark.metrics import _voxel_stages

UNIT = "%"
LAYER = "kernels: ops/*.py and csrc/*.cu"
MOVES = "train_pairs_per_s"


def read(run):
    return _voxel_stages.reading(run, "wgrad_roofline")
