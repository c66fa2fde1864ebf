"""Run logging: the JSONL metrics stream and the optional wandb run.

Counterpart of `apla_tpu/utils/logging.py`: one JSON record per `log`
call, `{"iters", "t", **metrics}`, in `<save_dir>/<run_name>.metrics.jsonl`,
and a wandb run beside it when `log_params` asks for one and the package
imports.  wandb is imported inside `RunLogger`, never at import time: a
failed import or `wandb.init` means no wandb run, as in the JAX package
(the sink is optional; the JSONL file is always written).  `--debug` sets
`WANDB_MODE=dryrun`; an offline run ends with a `wandb sync` of its run
directory.

One process per rank (`parallel.launch`): only rank 0 writes the JSONL
file and opens the wandb run, where the JAX package's single process
writes it once and attaches wandb on `jax.process_index() == 0`.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import time


def _is_rank0() -> bool:
    from ..parallel.collectives import is_rank0
    return is_rank0()


class RunLogger:
    def __init__(self, save_dir: str | None, run_name: str = "run",
                 use_wandb: bool = False, config: dict | None = None,
                 project: str = "APLA", offline: bool = False,
                 debug: bool = False, resume: bool = False):
        rank0 = _is_rank0()
        self.path = None
        if save_dir and rank0:
            os.makedirs(save_dir, exist_ok=True)
            self.path = os.path.join(save_dir, f"{run_name}.metrics.jsonl")
        self.wandb_run = None
        self._offline = offline
        if use_wandb and rank0:
            try:
                import wandb
                if debug:
                    os.environ["WANDB_MODE"] = "dryrun"
                kwargs = dict(project=project, name=run_name,
                              config=config or {}, resume=bool(resume))
                if save_dir:
                    kwargs["dir"] = save_dir
                if offline:
                    kwargs["mode"] = "offline"
                self.wandb_run = wandb.init(**kwargs)
            except Exception:
                self.wandb_run = None
        self.t0 = time.time()

    def log(self, metrics: dict, step: int):
        rec = {"iters": int(step), "t": round(time.time() - self.t0, 2)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.wandb_run is not None:
            self.wandb_run.log(metrics, step=step)

    def finish(self):
        if self.wandb_run is None:
            return
        run, self.wandb_run = self.wandb_run, None
        run.finish()
        if self._offline:
            base = getattr(run, "dir", None) or "."
            root = base.split("wandb")[0] or "."
            matches = glob.glob(os.path.join(root, "wandb",
                                             f"offline-run-*-{run.id}"))
            if matches:
                print(f"Syncing offline wandb run: {matches[0]}")
                subprocess.run(["wandb", "sync", matches[0]], check=False)


def make_run_logger(wrapper, trainer) -> RunLogger:
    """The trainer's RunLogger from `log_params`: run_name
    "DEFINED_BY_MODEL_NAME" becomes the model name; wandb on unless
    `log_params.use_wandb` is false (off without `log_params`); dry runs
    write no file; `offline` and `restore_session` from
    `training_params`."""
    lp = wrapper.parameters.get("log_params") or {}
    run_name = lp.get("run_name", "DEFINED_BY_MODEL_NAME")
    if run_name == "DEFINED_BY_MODEL_NAME":
        run_name = trainer.model_name
    tp = wrapper.training_params
    return RunLogger(
        None if trainer.is_dry else trainer.save_dir,
        run_name=run_name,
        use_wandb=bool(lp.get("use_wandb", bool(lp))),
        config=dict(wrapper.parameters),
        project=lp.get("project_name", "APLA"),
        offline=bool(tp.get("offline", False)),
        debug=trainer.is_debug,
        resume=bool(tp.get("restore_session", False)))
