"""Mean host ms a batch of the loader's prefetch thread, its
``loader.collate`` plus its ``loader.pin`` span, over the batches whose
collation began with tracing on (``_spans``, the host pass)."""

from benchmark.metrics import _spans

UNIT = "ms"
LAYER = "train loop (data.loader.BatchIterator)"
MOVES = "train_pairs_per_s"


def read(run):
    return _spans.host(run, "loader_produce_ms")
