"""Tensor and sequence parallelism of the ViT trunk on the mesh's model
axis (Megatron's layout).

JAX annotates the placements (`apla_tpu/parallel/mesh.py:tp_sharding_tree`,
`apla_tpu/models/vit.py:token_sharding`) and GSPMD inserts the
collectives; here each rank computes its share and issues them itself
(`parallel.collectives`).  The function is the one-rank function: only the
f32 order of the head-group sums differs.

- Column-parallel, head-aligned: qkv, fc1, SwiGLU's w12.  Rank m keeps the
  q, k and v columns of its H/T heads (`shard_index("qkv", ...)`), so its
  qkv output is the packed [B, N, 3 C/T] that the attention kernels take;
  of w12 it keeps matching column slices of both halves, so `chunk(2)`
  still pairs x1 with x2.  (JAX's contiguous column shard of the packed
  [q|k|v] is not head-aligned, and GSPMD re-gathers there.)
- Row-parallel: proj, fc2, w3.  The rank multiplies its C/T (hidden/T)
  rows; the partial products are summed over the model group in f32, the
  bias is added once after that, and the sum is rounded once.
- Everything else stays whole: norms, embeddings, LayerScale, the biases
  of row-parallel layers, the heads.  APLA's trainable columns `w_t`
  [C, k] and a trainable projection enter the row-parallel product by the
  rank's rows; a trainable column-parallel tensor (a full fine-tune) by
  its columns.  A tensor is used as the rank's share when the placement
  stored it so (`parallel.mesh.shard_params(..., "tp")`), and sliced at
  use when it is held whole: the shapes tell them apart.
- W8A8 (`ops.quant.QuantizedKernel`): the int8 tensors stay whole, as
  JAX's rule leaves them.  An int8 qkv is computed whole and the rank
  keeps its heads' columns; an int8 MLP runs whole on the rank's
  activations, because the int8 kernel quantizes x per row over all of K
  and a row-parallel fc2 would quantize with a partial row maximum.
- Sequence parallelism: between blocks the token stream [B, N, D] is
  split over the model group (`collectives.token_split`, uneven N: 257
  over 2); norms, residuals, LayerScale and drop-path run on the rank's
  tokens, an all-gather along N comes before qkv and fc1 and a
  reduce-scatter after proj and fc2 (in place of TP's all-reduce).  The
  trunk's end gathers the stream back (`collectives.gather_trunk`, whose
  backward keeps the rank's slice: the two kinds of gather are set out in
  `collectives`).
- Random draws (dropout, drop-path) are drawn for the global tensor
  (`parallel.mesh.rand_rows`) and sliced, by heads or hidden columns under
  TP and by tokens under SP, so a T-rank run draws the one-rank run's
  values.
"""

from __future__ import annotations

import dataclasses

import torch

from . import collectives


@dataclasses.dataclass(frozen=True)
class Placement:
    """The trunk's share on this rank of a model group of `n_model` ranks:
    TP (`sequence_parallel` False) or TP + SP."""
    n_model: int
    index: int
    sequence_parallel: bool = False


def shard_index(kind: str, n: int, T: int, m: int) -> torch.Tensor:
    """Indices, along the sharded dim of length n, of rank m's share:
    "qkv" the q, k and v columns of its heads (n = 3 C), "w12" its slice of
    each half (n = 2 h), "col" / "row" a contiguous 1/T."""
    if kind == "qkv":
        c = n // 3
        own = torch.arange(m * c // T, (m + 1) * c // T)
        return torch.cat([own + j * c for j in range(3)])
    if kind == "w12":
        h = n // 2
        own = torch.arange(m * h // T, (m + 1) * h // T)
        return torch.cat([own, own + h])
    return torch.arange(m * n // T, (m + 1) * n // T)


def unshard(parts: list, kind: str, dim: int) -> torch.Tensor:
    """The whole tensor from the T ranks' shares (in rank order) along
    `dim`: the inverse of `shard_index`."""
    if kind in ("qkv", "w12"):
        pieces = [p.chunk(3 if kind == "qkv" else 2, dim=dim) for p in parts]
        return torch.cat([pc[j] for j in range(len(pieces[0]))
                          for pc in pieces], dim=dim)
    return torch.cat(parts, dim=dim)


def local(t: torch.Tensor, kind: str, dim: int, whole: int,
          pl: Placement) -> torch.Tensor:
    """The rank's share of `t` along `dim`: `t` itself when it holds the
    share (its length there is `whole` / T), else the share's indices
    taken from the whole tensor (a gradient reaches those entries only)."""
    if t.shape[dim] == whole // pl.n_model:
        return t
    if t.shape[dim] != whole:
        raise ValueError(f"a tensor of {tuple(t.shape)} is neither whole "
                         f"({whole}) nor a 1/{pl.n_model} share on dim "
                         f"{dim}")
    idx = shard_index(kind, whole, pl.n_model, pl.index).to(t.device)
    return t.index_select(dim, idx)


def drawn_slice(x, rate, generator, deterministic, dim, whole, start):
    """Dropout of x, a slice [start, start + x.shape[dim]) along `dim` of a
    tensor `whole` long there: the mask drawn for the whole tensor."""
    from .mesh import rand_rows
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    shape[dim] = whole
    mask = rand_rows(shape, generator=generator, device=x.device) \
        .narrow(dim, start, x.shape[dim]) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def drawn_index(x, rate, generator, deterministic, dim, whole, index):
    """Dropout of x, the entries `index` along `dim` of a tensor `whole`
    long there: the mask drawn for the whole tensor."""
    from .mesh import rand_rows
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    shape[dim] = whole
    mask = rand_rows(shape, generator=generator, device=x.device) \
        .index_select(dim, index.to(x.device)) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _summed_dx(g, w, sp: bool) -> torch.Tensor:
    """A column-parallel product's dx: the rank's share g w^T in f32,
    summed over the model group (SP: the rank's tokens kept), not yet
    rounded."""
    dx = torch.matmul(g.float(), w.float().t())
    if sp:
        return collectives.reduce_scatter_dim1(dx)
    return collectives.all_reduce_(dx.contiguous(), "model",
                                   collectives.MODEL)


class _ColumnProduct(torch.autograd.Function):
    """A column-parallel product: y = x @ w + b in x's dtype, x the whole
    stream (SP: the rank's tokens, gathered first), w and b the rank's
    columns.  Backward: the rank's share of dx = g w^T in f32, summed over
    the model group (SP: and the rank's tokens kept) and rounded once, as
    the one-rank product's dx is rounded once; dw and db as autograd gives
    them for the one-rank product's columns."""

    @staticmethod
    def forward(ctx, x, w, b, sp, n):
        xg = collectives.gather_dim1(x, n) if sp else x
        y = torch.matmul(xg, w.to(xg.dtype))
        if b is not None:
            y = y + b.to(y.dtype)
        ctx.save_for_backward(xg, w)
        ctx.sp, ctx.b_dtype = sp, None if b is None else b.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        xg, w = ctx.saved_tensors
        dx = _summed_dx(g, w.to(g.dtype), ctx.sp).to(xg.dtype)
        dw = db = None
        g2 = g.reshape(-1, g.shape[-1])
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(xg.reshape(-1, xg.shape[-1]).t(), g2) \
                .to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g2.sum(dim=0).to(ctx.b_dtype)
        return dx, dw, db, None, None


class _QuantizedColumn(torch.autograd.Function):
    """An int8 qkv on the placement: the whole int8 product of the whole
    stream (SP: gathered first), the rank's columns `idx` kept; the frozen
    bias, if any, in the kernel's epilogue.  Backward as
    `_ColumnProduct`'s: the rank's share of dx = g W[:, idx]^T, W
    dequantized as `ops.quant.Int8Matmul`'s backward dequantizes it, in
    f32, summed over the model group and rounded once."""

    @staticmethod
    def forward(ctx, x, q, bias, idx, sp, n):
        from ..ops.quant import maybe_quantized_dot
        xg = collectives.gather_dim1(x, n) if sp else x
        ctx.save_for_backward(q.w_int8, q.scale, idx)
        ctx.sp, ctx.x_dtype = sp, x.dtype
        return maybe_quantized_dot(xg, q, bias).index_select(-1, idx)

    @staticmethod
    def backward(ctx, g):
        w_i8, scale, idx = ctx.saved_tensors
        w = (w_i8.to(g.dtype) * scale[None, :].to(g.dtype)).index_select(
            1, idx)
        dx = _summed_dx(g, w, ctx.sp).to(ctx.x_dtype)
        return dx, None, None, None, None, None


def quantized_qkv(x, q, bias, pl: Placement, n: int):
    """The rank's heads' columns of the int8 qkv of the rank's stream `x`
    (its tokens under SP, of a stream of n): `q` and `bias` whole."""
    C3 = q.w_int8.shape[1]
    idx = shard_index("qkv", C3, pl.n_model, pl.index).to(x.device)
    frozen = bias is None or not bias.requires_grad
    y = _QuantizedColumn.apply(x, q, bias if frozen else None, idx,
                               pl.sequence_parallel, int(n))
    if not frozen:
        y = y + bias.index_select(0, idx).to(y.dtype)
    return y


def column(x, w, b, pl: Placement, n: int):
    """The column-parallel product of the rank's stream `x` (the rank's
    tokens under SP, of a stream of n) with its columns `w` [C, d/T], `b`."""
    return _ColumnProduct.apply(x, w, b, pl.sequence_parallel, int(n))


def leave(partial, pl: Placement, dtype, bias=None):
    """Out of a row-parallel product: the f32 partials summed over the
    model group (SP: and the rank's tokens kept), rounded once to `dtype`,
    then the bias added in `dtype`."""
    y = (collectives.scatter_tokens(partial) if pl.sequence_parallel
         else collectives.reduce_from_model(partial)).to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y


def out_dropout(y, rate, generator, deterministic, pl: Placement, n: int):
    """Dropout of a row-parallel layer's output: the whole stream's draw,
    the rank's tokens of it under SP."""
    if not pl.sequence_parallel:
        from ..ops.attention import dropout
        return dropout(y, rate, generator, deterministic)
    start, _ = collectives.own_tokens(n)
    return drawn_slice(y, rate, generator, deterministic, 1, n, start)


def row_partial(x, w) -> torch.Tensor:
    """x [..., K/T] @ w [K/T, N] (w rounded to x's dtype, as the one-rank
    product takes it) with f32 products and sums: a row-parallel product's
    partial."""
    return torch.matmul(x.float(), w.to(x.dtype).float())


def mlp(x, p, cfg, generator, deterministic, pl: Placement, n: int):
    """The block's MLP (`models.vit._mlp`) on the placement:
    column-parallel fc1 (w12), row-parallel fc2 (w3); whole on the rank's
    activations when W8A8 kernels are in it.  `x`: the normed stream (the
    rank's tokens under SP); `n`: the whole stream's length."""
    from ..models.vit import _mlp
    from ..ops.quant import QuantizedKernel
    first, second = (p.w12, p.w3) if cfg.use_swiglu else (p.fc1, p.fc2)
    drop = lambda y: out_dropout(  # noqa: E731
        y, cfg.drop_rate, generator, deterministic, pl, n)
    if isinstance(first.kernel, QuantizedKernel) or isinstance(
            second.kernel, QuantizedKernel):
        # whole on the rank's activations (replicated over the model group
        # under TP alone), the whole stream's dropout draws
        return _mlp(x, p, cfg, generator, deterministic, drop)
    hidden, T, m = cfg.mlp_hidden, pl.n_model, pl.index
    kind, width = ("w12", 2 * hidden) if cfg.use_swiglu else ("col", hidden)

    def up(h, layer):
        return column(h, local(layer.kernel, kind, 1, width, pl),
                      local(layer.bias, kind, 0, width, pl), pl, n)

    def down(h, layer):
        w = local(layer.kernel, "row", 0, hidden, pl)
        return leave(row_partial(h, w), pl, x.dtype, layer.bias)

    return _mlp(x, p, cfg, generator, deterministic, drop, up, down,
                lambda h: drawn_slice(h, cfg.drop_rate, generator,
                                      deterministic, -1, hidden,
                                      m * hidden // T))


def attention(x, attn, cfg, generator, deterministic, pl: Placement, n: int,
              segment_len: int = 0):
    """The block's attention on the placement: the rank's H/T heads from a
    head-aligned qkv (`ops.attention.attend` on them), then the
    row-parallel projection (APLA's, fused or not, or the plain one).
    `x`: the normed stream (the rank's tokens under SP); returns the
    projected output in x's dtype, proj dropout applied."""
    from ..ops.apla_proj import apla_proj
    from ..ops.attention import attend, check_fused_dropout
    from ..ops.fused_apla_attn import fused_apla_attention
    from ..ops.quant import QuantizedKernel
    dt = x.dtype
    C, H, T, m = cfg.embed_dim, cfg.num_heads, pl.n_model, pl.index
    if H % T:
        raise ValueError(f"{H} heads do not split over {T} model ranks")
    h_loc = H // T
    if isinstance(attn.qkv.kernel, QuantizedKernel):
        qkv = quantized_qkv(x, attn.qkv.kernel, attn.qkv.bias, pl, n)
    else:
        k = local(attn.qkv.kernel, "qkv", 1, 3 * C, pl)
        b = None if attn.qkv.bias is None else \
            local(attn.qkv.bias, "qkv", 0, 3 * C, pl)
        qkv = column(x, k, b, pl, n)
    scale = float(cfg.scale)
    apla = attn.inds is not None
    w_t, b_t = ((attn.proj_wt, attn.proj_bt) if attn.proj_wt is not None
                else (attn.proj.kernel, attn.proj.bias))
    w_frozen = local(attn.proj.kernel, "row", 0, C, pl)
    if apla and cfg.use_fused_apla:
        check_fused_dropout(cfg.attn_drop_rate, deterministic)
        partial = fused_apla_attention(
            qkv, local(w_t, "row", 0, C, pl), b_t, w_frozen,
            attn.proj.bias, attn.inds, h_loc, scale, int(segment_len),
            partial=True)
    else:
        heads = torch.arange(m * h_loc, (m + 1) * h_loc)
        o = attend(qkv, h_loc, scale, cfg.attn_drop_rate,
                   lambda a: drawn_index(a, cfg.attn_drop_rate, generator,
                                         deterministic, 1, H, heads),
                   cfg.use_flash, cfg.attn_logits_f32, segment_len)
        if apla:
            partial = apla_proj(o, local(w_t, "row", 0, C, pl), b_t,
                                w_frozen, attn.proj.bias, attn.inds,
                                partial=True)
        else:
            partial = row_partial(o, w_frozen)
    if apla:
        bias = attn.proj.bias.index_copy(0, attn.inds,
                                         b_t.to(attn.proj.bias.dtype))
    else:
        bias = attn.proj.bias
    y = leave(partial, pl, dt, bias)
    return out_dropout(y, cfg.drop_rate, generator, deterministic, pl, n)
