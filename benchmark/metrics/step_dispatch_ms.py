"""Mean host ms of the ``step`` span on the dispatching thread less its
``step.prepare`` child, tracing on and no profiler (``_spans``, the host
pass): the time the host takes to launch the forward, the loss, the
backward and the optimizer. ``step.prepare`` is left out because the host
waits there for the device (a stream sync in the images' normalisation):
with it the number would follow the device's work, not the dispatch."""

from benchmark.metrics import _spans

UNIT = "ms"
LAYER = "train step (training.steps)"
MOVES = "train_pairs_per_s"


def read(run):
    return _spans.host(run, "step_dispatch_ms")
