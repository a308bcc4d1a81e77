"""Device ms a traced step of the loss inside the real step: the device
time launched under ``loss.forward`` (the outputs' cast to f32 and the
pair losses) and ``backward.loss`` (their backward, down to the encoders'
outputs) (``_spans``, the device pass)."""

from benchmark.metrics import _spans

UNIT = "ms"
LAYER = "loss: losses.nt_xent with ops.nt_xent K4-K6"
MOVES = "train_pairs_per_s"


def read(run):
    return _spans.device_ms(run, "loss.forward", "backward.loss")
