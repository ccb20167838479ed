"""Experiment tracking (counterpart of ``aat_tpu/utils/tracking.py``): a
JSONL tracker, one metrics dict per line, that forwards to ``wandb`` when
that package imports and ``WANDB_MODE`` does not disable it."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class JsonlTracker:
    def __init__(self, path: str, project: str = "tokenized_speech_lm",
                 config: Optional[dict] = None):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._file = open(path, "a", buffering=1)
        self._step = 0
        self._wandb = None
        if os.environ.get("WANDB_MODE", "") not in ("disabled", "offline-disabled"):
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=project, config=config or {})
            except Exception:  # noqa: BLE001 — wandb absent or offline is normal
                self._wandb = None
        if config:
            self._file.write(json.dumps({"_config": config}) + "\n")

    def log(self, metrics: Dict[str, float]):
        self._step += 1
        record = {"_time": time.time(), "_step": self._step}
        record.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(record) + "\n")
        logger.info("step %d %s", self._step, {
            k: round(v, 5) for k, v in metrics.items() if not k.startswith("_")})
        if self._wandb is not None:
            self._wandb.log(metrics)

    def finish(self):
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
