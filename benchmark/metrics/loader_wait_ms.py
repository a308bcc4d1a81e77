"""Mean host ms a window step blocks in the loader iterator's ``next()``:
the span is the benchmark's own, around the call."""

UNIT = "ms"
LAYER = "train loop (data.loader.BatchIterator)"
MOVES = "train_pairs_per_s"


def read(run):
    return 1e3 * sum(run.waits) / len(run.waits) if run.waits else None
