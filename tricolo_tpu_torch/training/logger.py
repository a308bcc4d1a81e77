"""Metric logging: a JSONL stream always, WandB when available and asked for.

The port's copy of ``tricolo_tpu.training.logger``. ``MetricsLogger``
appends one row per ``log(...)`` to ``{logger.save_dir}/metrics.jsonl``
(``step``, ``time``, ``epoch`` and the metrics as floats) — the source of
truth, which works without a network. ``logger.backend``: ``auto`` also
logs to WandB when the package imports (and stays silent when it does
not), ``wandb`` requires it, ``jsonl`` and ``none`` write the JSONL only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricsLogger:
    def __init__(self, cfg):
        log_cfg = cfg.logger
        self.save_dir = log_cfg.save_dir
        os.makedirs(self.save_dir, exist_ok=True)
        self._file = open(os.path.join(self.save_dir, "metrics.jsonl"), "a")
        self._wandb = None
        backend = log_cfg.get("backend", "auto")
        if backend in ("auto", "wandb"):
            try:
                import wandb

                self._wandb = wandb.init(project=log_cfg.project, name=log_cfg.name,
                                         dir=self.save_dir, config=cfg.to_dict())
            except Exception:  # no package, no login, no network: JSONL only
                if backend == "wandb":
                    self._file.close()
                    raise

    def log(self, metrics: Mapping[str, float], step: int, epoch: int | None = None) -> None:
        row = {"step": int(step), "time": time.time()}
        if epoch is not None:
            row["epoch"] = int(epoch)
        row.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(row) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def close(self) -> None:
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
