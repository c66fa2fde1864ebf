"""GPipe pipeline parallelism for the ViT trunk over the mesh's model axis.

Counterpart of `apla_tpu/parallel/pipeline.py`.  JAX shards the stacked
blocks [L, ...] over the 'model' axis and runs the schedule inside one
`shard_map`: every device computes every tick, activations rotate with
`ppermute` for M + S - 1 ticks, a `psum` over the stages makes the last
stage's outputs replicated again, and autodiff transposes the schedule
into the reverse one.  Here each rank is a process and stage s is its
model index: it runs blocks [s L / S, (s + 1) L / S) of every ViT whose
`pipeline` is set (`parallel.mesh.shard_params`).

- Forward (`pipeline_blocks`): the rank's rows of the micro-step split
  into M microbatches, rows [m b / M, (m + 1) b / M); stage 0 feeds
  microbatch m, every other stage receives it from the stage before
  (`collectives.stage_recv`); each stage runs its blocks and sends the
  result on (`stage_send`, not waited for until the schedule ends, so a
  stage only ever waits on the one before it).  The last stage's outputs
  go to every stage of the model group (`stage_broadcast`): the final
  norm, the heads and the loss run on every stage, as JAX's replicated
  outputs have them.
- Backward: one `torch.autograd.Function` a trunk call, whose inputs are
  the token stream and the stage's trainable tensors, so `loss.backward()`
  leaves their gradients in `.grad` as it does for any parameter.  Its
  backward receives each microbatch's cotangent from the stage after (the
  last stage takes its own rows of the output's cotangent: the S stages'
  cotangents are the same, and summing them would scale every gradient
  by S), runs the blocks' backward on the graph its forward kept, and
  sends the input's cotangent to the stage before.  Stage 0 alone gives
  the stream a cotangent, so token prep's gradients are summed over the
  model group (`parallel.mesh.pp_plan`'s "sum" rule), as JAX's transposed
  `pvary` does.
- A step with several pipelined calls (the DINOv2 teacher, the student's
  global and local crops) makes one autograd node each.  Every stage
  builds the same graph (the heads and the loss run everywhere), so the
  autograd engine runs the nodes' backward in the same order on every
  rank, and every message carries the same tag
  (`collectives.PIPE_TAG`): the sends and receives of two ranks pair in
  order.
- Dropout and drop-path: each block draws from its own generator
  (`mesh.block_seeds`, as the one-rank trunk does), re-seeded for every
  microbatch, whose draw is made for the rank's micro-step rows and
  sliced (`mesh.micro_rows`): a pipelined run draws the one-rank run's
  values.
- Refused as JAX refuses them (`apla_tpu/parallel/pipeline.py:91-97`): a
  depth that S does not divide, and in training a batch that M does not
  divide.  A deterministic call (eval, the kNN embeddings, a teacher)
  with such a batch pads it with its last row and drops the padding,
  where JAX falls back to the unpipelined trunk (`train/steps.py:
  _usable_pipeline`): under "pp" a rank holds only its stage's blocks.
"""

from __future__ import annotations

import dataclasses

import torch

from . import collectives
from .mesh import Mesh, micro_rows


@dataclasses.dataclass(frozen=True, eq=False)
class PipelineSpec:
    """`n_stages` S = the mesh's model axis; `n_micro` M microbatches a
    rank's micro-step (the bubble is (S - 1) / (M + S - 1))."""
    mesh: Mesh
    n_stages: int
    n_micro: int

    def __post_init__(self):
        if self.n_stages < 1 or self.n_micro < 1:
            raise ValueError(f"pipeline of {self.n_stages} stages and "
                             f"{self.n_micro} microbatches")
        if self.mesh.n_model != self.n_stages:
            raise ValueError(f"a pipeline of {self.n_stages} stages on a "
                             f"mesh {self.mesh.shape}")

    def stage_blocks(self, depth: int) -> range:
        """This rank's blocks of a trunk of `depth` blocks."""
        if depth % self.n_stages:
            raise ValueError(f"depth {depth} not divisible by "
                             f"{self.n_stages} stages")
        per = depth // self.n_stages
        s = self.mesh.model_index
        return range(s * per, (s + 1) * per)


class _Schedule:
    """One trunk call's GPipe schedule on this stage: `run(h, m)` applies
    the stage's blocks to microbatch m."""

    def __init__(self, spec: PipelineSpec, run, rows: int, mb: int):
        self.S, self.M = spec.n_stages, spec.n_micro
        self.s = spec.mesh.model_index
        self.run, self.rows, self.mb = run, rows, mb

    def _stage(self, h, m):
        with micro_rows(m * self.mb, (m + 1) * self.mb, self.rows):
            return self.run(h, m)

    def forward(self, x, graph: bool, x_grad: bool = False):
        """The stream's output on every stage; with `graph` also each
        microbatch's (input, output) with their autograd graph."""
        S, s, mb = self.S, self.s, self.mb
        outs, kept, sends = [], [], []
        for m in range(self.M):
            if s == 0:
                h = x[m * mb:(m + 1) * mb]
            else:
                h = collectives.stage_recv((mb,) + tuple(x.shape[1:]),
                                           x.dtype, x.device, s - 1)
            if graph:
                h = h.detach().requires_grad_(s > 0 or x_grad)
                with torch.enable_grad():
                    y = self._stage(h, m)
                kept.append((h, y))
            else:
                y = self._stage(h, m)
            if s < S - 1:
                sends.append(collectives.stage_send(y, s + 1))
            else:
                outs.append(y.detach())
        for w in sends:
            w.wait()
        out = torch.cat(outs) if s == S - 1 else x.new_empty(
            (self.rows,) + tuple(x.shape[1:]))
        return collectives.stage_broadcast(out, S - 1), kept

    def backward(self, kept, dout, params, x_shape, x_grad: bool):
        """(the stream's cotangent or None, the params' gradients)."""
        S, s, mb = self.S, self.s, self.mb
        grads = [None] * len(params)
        live = [i for i, p in enumerate(params) if p.requires_grad]
        dx = dout.new_zeros(x_shape) if s == 0 and x_grad else None
        sends = []
        for m, (h, y) in enumerate(kept):
            if s == S - 1:
                dy = dout[m * mb:(m + 1) * mb]
            else:
                dy = collectives.stage_recv(y.shape, y.dtype, y.device,
                                            s + 1)
            inputs = ([h] if h.requires_grad else []) + \
                [params[i] for i in live]
            got = torch.autograd.grad(y, inputs, dy, allow_unused=True) \
                if y.grad_fn is not None and inputs else [None] * len(inputs)
            dh = got[0] if h.requires_grad else None
            for i, g in zip(live, got[len(got) - len(live):]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            if s > 0:
                sends.append(collectives.stage_send(
                    dh if dh is not None else torch.zeros_like(h), s - 1))
            elif dx is not None and dh is not None:
                dx[m * mb:(m + 1) * mb] = dh
            kept[m] = None
        for w in sends:
            w.wait()
        return dx, grads


class _Pipelined(torch.autograd.Function):
    """The schedule as one autograd node: inputs (the stream, the stage's
    trainable tensors), output the trunk's stream on every stage."""

    @staticmethod
    def forward(ctx, sched, x, *params):
        out, kept = sched.forward(x, True, x.requires_grad)
        ctx.sched, ctx.kept, ctx.params = sched, kept, params
        ctx.x_shape = tuple(x.shape)
        return out

    @staticmethod
    def backward(ctx, dout):
        dx, grads = ctx.sched.backward(ctx.kept, dout.contiguous(),
                                       ctx.params, ctx.x_shape,
                                       ctx.needs_input_grad[1])
        ctx.kept = None
        return (None, dx) + tuple(grads)


def pipeline_blocks(x, spec: PipelineSpec, depth: int, run_block, params,
                    deterministic: bool, trainable: bool):
    """The trunk's blocks on x [b, N, D] (this rank's rows, the same on
    every stage of the model group) as a pipeline; returns [b, N, D] on
    every stage.  `run_block(h, i, m)` applies block i to microbatch m;
    `params` are the stage's trainable tensors; `trainable`: whether any
    block tensor of the trunk takes a gradient (the same on every
    stage)."""
    blocks = spec.stage_blocks(depth)
    b, M = x.shape[0], spec.n_micro
    pad = -b % M
    if pad:
        if not deterministic:
            raise ValueError(f"per-device batch {b} not divisible by {M} "
                             "microbatches")
        x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    rows = b + pad

    def run(h, m):
        for i in blocks:
            h = run_block(h, i, m)
        return h

    sched = _Schedule(spec, run, rows, rows // M)
    if torch.is_grad_enabled() and (x.requires_grad or trainable):
        out = _Pipelined.apply(sched, x, *params)
    else:
        out, _ = sched.forward(x, False)
    return out[:b] if pad else out
