"""Device kernels a traced step whose launch lies in a span of the
``step`` tree (``_spans``, the device pass): the launches the host pays
for, the port's kernels and every library kernel."""

from benchmark.metrics import _spans

UNIT = "launches"
LAYER = "kernels: ops/*.py and csrc/*.cu"
MOVES = "train_pairs_per_s"


def read(run):
    found = _spans.passes(run)
    if found is None or found["device"] is None:
        return None
    return found["device"]["kernels_per_step"]
