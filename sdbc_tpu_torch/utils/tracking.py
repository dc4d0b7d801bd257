"""Experiment tracking (counterpart of ``sdbc_tpu/utils/tracking.py``): a
local ``events.jsonl`` and ``hyperparams.json`` under
``<output_dir>/runs/<run_id>/``, with the JAX package's records (one JSON
object a line: ``ts``, ``step`` and the float metrics).

wandb is not taken: the CLIs refuse ``--wandb_key`` (the card's machine
has no wandb and no network), and ``Tracker`` raises when given a key.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class Tracker:
    def __init__(self, output_dir: str, run_id: str,
                 config: Optional[dict] = None,
                 wandb_key: Optional[str] = None):
        if wandb_key:
            raise NotImplementedError("wandb tracking is not ported to "
                                      "sdbc_tpu_torch; the JSONL log is")
        self.dir = os.path.join(output_dir, "runs", run_id)
        os.makedirs(self.dir, exist_ok=True)
        self.events_path = os.path.join(self.dir, "events.jsonl")
        self._events = open(self.events_path, "a")
        if config:
            with open(os.path.join(self.dir, "hyperparams.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        rec = {"ts": time.time(),
               **({"step": step} if step is not None else {}),
               **{k: float(v) for k, v in metrics.items()}}
        self._events.write(json.dumps(rec) + "\n")
        self._events.flush()

    def log_artifact(self, path: str, name: str = "stable_diffusion_model",
                     type_: str = "model") -> None:
        """A checkpoint saved (the JAX package uploads it to wandb when
        keyed; here the event log records it)."""
        self.log({"artifact_saved": 1.0})

    def finish(self) -> None:
        self._events.close()
