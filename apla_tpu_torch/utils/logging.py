"""Run logging: the JSONL metrics stream.

Counterpart of `apla_tpu/utils/logging.py:RunLogger`, the part the side-car
loops use: one JSON record per `log` call, `{"iters", "t", **metrics}`, in
`<save_dir>/<run_name>.metrics.jsonl`.  The wandb sink is not ported
(ROADMAP A 10).
"""

from __future__ import annotations

import json
import os
import time


class RunLogger:
    def __init__(self, save_dir: str | None, run_name: str = "run"):
        self.path = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self.path = os.path.join(save_dir, f"{run_name}.metrics.jsonl")
        self.t0 = time.time()

    def log(self, metrics: dict, step: int):
        rec = {"iters": int(step), "t": round(time.time() - self.t0, 2)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
