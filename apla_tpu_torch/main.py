"""Command line: train and test a recipe with the port.

  python -m apla_tpu_torch.main --params_path params/.../apla.yml [--test]
         [--knn] [--byol | --simsiam | --dino | --dinov2] [--device cpu]
         [--epochs N] [--batch_size N] ...

Mirrors the JAX package's `main.py:144-170`, with copies of its
`parse_arguments` and `update_params_from_args` (that file lives outside
both packages).  The run is on the CUDA card; `--device cpu` (or
`system_params.device`) is the only way to the CPU.  `--byol`, `--simsiam`
(`ssl/byol.py`), `--dino` (`ssl/dino.py`) and `--dinov2` (`ssl/dinov2.py`)
train a self-supervised objective; `--test` then runs its kNN test table
on a checkpoint.  `--n_devices N` (or `--gpu 0,1`; unset: every visible
card, one on the CPU) above one runs N ranks in all through
`parallel.launch` (spawned, or the ranks `torchrun` started; on the CPU
and for ranks that share a card the backend is gloo, else NCCL):
`--tensor_parallel T` (T divides N) makes them an N/T x T (data x model)
mesh, tensor-parallel under `--param_sharding tp` (its default there),
`--sequence_parallel` splits the token stream over the model axis too,
and `--param_sharding fsdp` shards the frozen backbone over the data
axis.  `--pipeline_parallel S` (S divides N) makes the model axis a
GPipe pipeline of S stages (`parallel.pipeline`) with
`--pp_microbatches M` microbatches (default S) a rank's micro-step, each
rank keeping its stage's blocks under `--param_sharding pp` (its default
there); every objective and wrapper takes it.
"""

from __future__ import annotations

import argparse
import os
import sys

from .utils.config import load_merged_params


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--params_path", type=str, required=True)
    p.add_argument("--n_devices", type=int,
                   help="ranks to train on, in all (data x model)")
    p.add_argument("--gpu", type=str,
                   help="comma list of device ids ('0,1') -> device count")
    p.add_argument("--param_sharding", type=str,
                   choices=["replicated", "fsdp", "tp", "pp"])
    p.add_argument("--tensor_parallel", type=int)
    p.add_argument("--pipeline_parallel", type=int)
    p.add_argument("--pp_microbatches", type=int)
    p.add_argument("--sequence_parallel", action="store_true", default=False)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--val_every", type=float)
    p.add_argument("--log_every", type=int)
    p.add_argument("--mixed_precision", action="store_true", default=False)
    p.add_argument("--num_workers", type=str)
    p.add_argument("--prefetch_factor", type=str)
    p.add_argument("--lr", type=float)
    p.add_argument("--warmup", type=int)
    p.add_argument("--epochs", type=int)
    p.add_argument("--wd", type=float)
    p.add_argument("--dpr", type=float)   # drop path rate
    p.add_argument("--dr", type=float)    # drop rate
    p.add_argument("--adr", type=float)   # attn drop rate
    p.add_argument("--model_name", type=str)
    p.add_argument("--pretrained_path", type=str)
    p.add_argument("--save_dir", type=str)
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--dry", action="store_true", default=False)
    p.add_argument("--job_id", type=str)
    p.add_argument("--offline", action="store_true", default=False)
    p.add_argument("--test", action="store_true", default=False)
    p.add_argument("--knn", action="store_true", default=False)
    p.add_argument("--byol", action="store_true", default=False)
    p.add_argument("--simsiam", action="store_true", default=False)
    p.add_argument("--dino", action="store_true", default=False)
    p.add_argument("--dinov2", action="store_true", default=False)
    p.add_argument("--device", type=str,
                   help="torch device (default cuda; 'cpu' to run there)")
    return p.parse_args(argv)


def update_params_from_args(params, args):
    """CLI overrides of YAML keys (the JAX `main.py:74-141`)."""
    if args.warmup:
        params.optimization_params.default.scheduler.params.LinearWarmup\
            .warmup_iters = args.warmup
    if args.epochs:
        params.training_params.epochs = args.epochs
    loaders = ("trainloader", "valloader", "testloader")
    if args.num_workers:
        for ld in loaders:
            params.dataloader_params[ld].num_workers = int(args.num_workers)
    if args.prefetch_factor:
        pf = None if args.prefetch_factor == "None" \
            else int(args.prefetch_factor)
        for ld in loaders:
            params.dataloader_params[ld].prefetch_factor = pf
    if args.pretrained_path:
        params.transfer_learning_params.pretrained_path = args.pretrained_path
    if args.lr:
        params.optimization_params.default.optimizer.params.lr = args.lr
    if args.wd is not None:
        params.optimization_params.default.optimizer.params.weight_decay = \
            args.wd
    tp = params.model_params.transformers_params
    if args.dpr is not None:
        tp.drop_path_rate = args.dpr
    if args.dr is not None:
        tp.drop_rate = args.dr
    if args.adr is not None:
        tp.attn_drop_rate = args.adr
    sp = params.system_params
    if args.device:
        sp.device = args.device
    if args.n_devices:
        sp.n_devices = args.n_devices
    elif args.gpu:
        sp.n_devices = len([g for g in str(args.gpu).split(",") if g.strip()])
    if args.param_sharding:
        sp.param_sharding = args.param_sharding
    if args.tensor_parallel:
        sp.tensor_parallel = args.tensor_parallel
    if args.pipeline_parallel:
        sp.pipeline_parallel = args.pipeline_parallel
    if args.pp_microbatches:
        sp.pp_microbatches = args.pp_microbatches
    if args.sequence_parallel:
        sp.sequence_parallel = True
    if args.model_name:
        params.training_params.model_name = args.model_name
    if args.save_dir:
        params.training_params.save_dir = args.save_dir
    if args.batch_size:
        for ld in loaders:
            params.dataloader_params[ld].batch_size = args.batch_size
    if args.val_every is not None:
        params.training_params.val_every = args.val_every
    if args.log_every is not None:
        params.training_params.log_every = args.log_every
    if args.job_id is not None:
        params.training_params.job_id = args.job_id
    if args.mixed_precision:
        params.training_params.use_mixed_precision = True
    params.training_params.is_dry = args.dry
    params.training_params.is_debug = args.debug
    params.training_params.offline = args.offline
    if args.knn:
        if not args.test:
            raise ValueError("--knn goes with --test")
        for ld in loaders:
            params.dataloader_params[ld].shuffle = False
        params.training_params.knn_eval = True
        params.model_params.freeze_backbone = True
    return params


def main(parameters, args):
    if args.byol and args.simsiam:
        raise ValueError("BYOL or SimSiam can be on but not both")
    if args.byol or args.simsiam or args.dino or args.dinov2:
        from .ssl import get_ssl_wrapper_and_trainer
        wrapper_cls, trainer_cls = get_ssl_wrapper_and_trainer(args)
    else:
        from .train.trainer import Trainer as trainer_cls
        from .wrapper import DefaultWrapper as wrapper_cls
    wrapper = wrapper_cls(parameters)
    wrapper.instantiate()
    trainer = trainer_cls(wrapper)
    if args.test:
        if not args.pretrained_path:
            raise ValueError("--test needs --pretrained_path")
        return trainer.test(chpt_path=args.pretrained_path)
    trainer.train()
    if trainer._preempted:
        print("Preempted: checkpoint saved, skipping test.")
        return None
    # as in the JAX package, an SSL run trains and checkpoints; its kNN
    # test table comes from --test on the checkpoint
    return trainer.test() if wrapper.is_supervised else None


def _cli_params(argv):
    args = parse_arguments(argv)
    parameters = update_params_from_args(
        load_merged_params(args.params_path), args)
    if args.test and args.pretrained_path:
        # --test reads the checkpoint, not a transfer source
        parameters.transfer_learning_params.pretrained_path = ""
    return parameters, args


def run_rank(argv):
    """One rank of a data-parallel CLI run (`parallel.launch` calls it
    on every rank)."""
    from .wrapper import set_float32_precision
    set_float32_precision()
    parameters, args = _cli_params(argv)
    return main(parameters, args)


def run_cli(argv=None):
    from .parallel.launch import launch, torchrun_env, visible_ranks
    from .wrapper import set_float32_precision
    set_float32_precision()
    argv = list(sys.argv[1:] if argv is None else argv)
    parameters, args = _cli_params(argv)
    print(f"USING PARAMS FROM PATH: {os.path.abspath(args.params_path)}")
    sp = parameters.system_params
    device = sp.get("device") or "cuda"
    n = int(sp["n_devices"]) if sp.get("n_devices") else None
    ranks = visible_ranks(device) if n is None else n
    if torchrun_env() or ranks > 1:
        return launch(run_rank, n, args=(argv,), device=device)
    return main(parameters, args)


if __name__ == "__main__":
    run_cli()
