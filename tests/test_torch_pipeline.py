"""Pipeline parallelism on the mesh's model axis
(`apla_tpu_torch/parallel/pipeline.py`), on the CPU against JAX's
1-device run and JAX's pipelined run.

`tests/test_pipeline.py`'s contract: the collective pipeline is a pure
placement change.  Its classifier (img 32, patch 8, dim 64, depth 4, 4
heads, APLA-8, f32, b16) runs as the port on gloo ranks spawned through
`parallel.launch`, at (D, S, M) = (1, 2, 2), (2, 2, 2), (1, 4, 4),
(2, 2, 4) and (1, 4, 1): the first update's loss and reduced gradients
against JAX's `value_and_grad` at one device and through JAX's pipeline
at the same (D, S, M) (loss rtol 1e-5, atol 1e-6; gradients rtol 1e-4,
atol 1e-5: `tests/test_pipeline.py:68-72`), and three AdamW updates
with clip 1.0 against JAX's 1-device train step (losses rtol 1e-5, the
trainables rtol 1e-4, atol 1e-6: `tests/test_pipeline.py:110-113`), at
accumulation 1 and 2.  At (1, 2, 2) also: one LAMB update (its trust
ratio over JAX's block-stacked leaf, which spans the stages), the fused
APLA path (the port's rows 1 and 2 plain; JAX's kernel in interpret
mode), W8A8 against JAX's 1-device W8A8 step (at depth 2: one block a
stage), a full fine-tune (token
prep's gradients, which stage 0 alone receives, summed over the stages),
"replicated" (and "fsdp" at D = 2), which give "pp"'s numbers, and
dropout with drop-path 0.2, equal to the port's one-rank run.  Two
deliberate faults of the gradient rule, the head summed over the stages
and token prep left unsummed, must each fail the bound on the tensors
they touch.

Also: `pp_plan` against JAX's `pp_sharding_tree` tensor by tensor; an
eval batch that M does not divide, padded; the knobs as
`apla_tpu/wrapper.py:141-183` reads them; every refusal (PP with TP, PP
with SP, `pack_local_crops`, a depth that S does not divide, a training
batch that M does not divide).  The SSL objectives at S = 2 and a
checkpoint under "pp": tests/test_torch_pipeline_ssl.py.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.apla.core import AplaConfig as JAplaConfig
from apla_tpu.models.classifier import classifier_forward as jforward
from apla_tpu.models.classifier import init_classifier as jinit
from apla_tpu.models.vit import ViTConfig as JViTConfig
from apla_tpu.ops import pallas_apla_attn
from apla_tpu.ops.quant import quantize_frozen_backbone as jquantize
from apla_tpu.parallel.mesh import make_mesh as jmesh, pp_sharding_tree
from apla_tpu.parallel.mesh import shard_batch as jshard_batch
from apla_tpu.parallel.mesh import shard_params as jshard
from apla_tpu.parallel.pipeline import PipelineSpec as JPipelineSpec
from apla_tpu.train.losses import cross_entropy as jce
from apla_tpu.train.optim import build_optimizer as jbuild
from apla_tpu.train.steps import make_train_step as jmake_step
from apla_tpu.train.train_state import TrainState as JState
from apla_tpu_torch.models.classifier import classifier_from_state
from apla_tpu_torch.models.vit import ViTConfig
from apla_tpu_torch.parallel import launch as tlaunch, runs
from apla_tpu_torch.parallel.mesh import Mesh, pp_plan
from apla_tpu_torch.parallel.pipeline import PipelineSpec, pipeline_blocks
from apla_tpu_torch.utils.pretrained import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=4)
LR, WD = 1e-3, 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_RTOL, W_TOL = 1e-5, dict(rtol=1e-4, atol=1e-6)
DROP = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n_steps=3, rows=16):
    rng = np.random.default_rng(0)
    return [{"image": rng.standard_normal((rows, 32, 32, 3)).astype(
        np.float32), "label": rng.integers(0, 10, rows).astype(np.int64)}
        for _ in range(n_steps)]


def _jax_init(apla=True, fused=False, quantize=False):
    # W8A8 at depth 2 (one block a stage), as tests/test_torch_tensor_
    # parallel.py runs it: at depth 4 the int8 rounding of activations
    # turns f32 sum-order noise into moves outside the bound, between
    # JAX's and the port's one-rank runs already
    vit = dict(VIT, depth=2) if quantize else VIT
    cfg = JViTConfig(compute_dtype=jnp.float32, use_fused_apla=fused, **vit)
    trainable, frozen = jinit(jax.random.PRNGKey(0), cfg, n_classes=10,
                              apla_cfg=JAplaConfig(partial_size=8)
                              if apla else None)
    if quantize:
        frozen = jquantize(frozen)
    return cfg, trainable, frozen


def _port_names(tree):
    out, _ = params_from_jax(jax.tree.map(np.asarray, tree),
                             {"backbone": {}})
    return out


def _jax_run(batches, accum=1, apla=True, fused=False, quantize=False,
             optimizer="AdamW"):
    """JAX's 1-device run: the initial (trainable, frozen) state in the
    port's names, the losses, the final trainables, and the first batch's
    loss and gradients."""
    cfg, trainable, frozen = _jax_init(apla, fused, quantize)
    state0 = params_from_jax(jax.tree.map(np.asarray, trainable),
                             jax.tree.map(np.asarray, frozen))
    loss, grads = _jax_loss_and_grads(cfg, trainable, frozen, batches[0])
    tx = jbuild(optimizer, {"lr": LR, "weight_decay": WD}, trainable,
                grad_clip=1.0)
    state = JState.create(trainable, tx)
    step = jmake_step(cfg, tx, jce, accum_steps=accum)
    losses = []
    for b in batches:
        state, m = step(state, frozen, {k: jnp.asarray(v)
                                        for k, v in b.items()}, LR,
                        jax.random.PRNGKey(7))
        losses.append(float(m["loss"]))
    return {"state0": state0, "losses": losses,
            "final": _port_names(state.trainable),
            "loss0": loss, "grads0": grads}


def _jax_loss_and_grads(cfg, trainable, frozen, batch, pipeline=None):
    def loss_fn(t):
        logits = jforward(t, frozen, batch["image"], cfg,
                          deterministic=True, pipeline=pipeline)
        return jce(logits, batch["label"])
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    return float(loss), _port_names(grads)


def _jax_pipelined(batch, D, S, M, apla=True):
    """`tests/test_pipeline.py`'s pipelined loss and gradients at
    (D, S, M)."""
    cfg, trainable, frozen = _jax_init(apla)
    mesh = jmesh(n_data=D, n_model=S, devices=jax.devices()[:D * S])
    spec = JPipelineSpec(mesh, S, M)
    return _jax_loss_and_grads(cfg, jshard(trainable, mesh, policy="pp"),
                               jshard(frozen, mesh, policy="pp"),
                               jshard_batch(batch, mesh), spec)


def _spec(state0, batches, **kw):
    vit = dict(VIT, **kw.pop("vit", {}))
    opt = kw.pop("optimizer", "AdamW")
    return dict(vit=vit, state=state0, batches=batches,
                optimizer=(opt, {"lr": LR, "weight_decay": WD}),
                grad_clip=1.0, lr=LR, device="cpu", **kw)


def _launch(fn, n, tmp_path, *args):
    return tlaunch.launch(fn, n, args=args, device="cpu",
                          store_dir=str(tmp_path), timeout=600)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's 1-device runs (plain, accumulation 2, fused in interpret
    mode, W8A8, LAMB, a full fine-tune) and its pipelined loss and
    gradients at every (D, S, M) of CASES."""
    batches = _batches()
    pallas_apla_attn.INTERPRET = True
    saved = os.environ.get("APLA_FUSED_MIN_N")
    os.environ["APLA_FUSED_MIN_N"] = "0"
    try:
        fused = _jax_run(batches, fused=True)
    finally:
        pallas_apla_attn.INTERPRET = False
        if saved is None:
            os.environ.pop("APLA_FUSED_MIN_N")
        else:
            os.environ["APLA_FUSED_MIN_N"] = saved
    out = {"batches": batches, "plain": _jax_run(batches),
           "accum": _jax_run(batches, accum=2), "fused": fused,
           "w8a8": _jax_run(batches, quantize=True),
           "lamb": _jax_run(batches[:1], optimizer="LAMB"),
           "full": _jax_run(batches, apla=False)}
    out["pipelined"] = {dsm: _jax_pipelined(batches[0], *dsm)
                        for dsm in {CASES[c][0] for c in CASES}}
    out["pipelined_full"] = _jax_pipelined(batches[0], 1, 2, 2, apla=False)
    return out


# case -> ((D, S, M), classifier_run keywords, JAX run)
CASES = {
    "pp_1x2_m2": ((1, 2, 2), {}, "plain"),
    "pp_2x2_m2": ((2, 2, 2), {}, "plain"),
    "pp_1x4_m4": ((1, 4, 4), {}, "plain"),
    "pp_2x2_m4": ((2, 2, 4), {}, "plain"),
    "pp_1x4_m1": ((1, 4, 1), {}, "plain"),
    "pp_1x2_m2_accum2": ((1, 2, 2), dict(accum=2), "accum"),
    "pp_2x2_m2_accum2": ((2, 2, 2), dict(accum=2), "accum"),
    "fused_pp_1x2_m2": ((1, 2, 2), dict(vit=dict(use_fused_apla=True)),
                        "fused"),
    "w8a8_pp_1x2_m2": ((1, 2, 2), dict(quantize=True, vit=dict(depth=2)),
                       "w8a8"),
    "lamb_pp_1x2_m2": ((1, 2, 2), dict(optimizer="LAMB"), "lamb"),
    "full_pp_1x2_m2": ((1, 2, 2), {}, "full"),
    # JAX's warning path: another placement under the pipeline
    "replicated_1x2_m2": ((1, 2, 2), dict(policy="replicated"), "plain"),
    "fsdp_2x2_m2": ((2, 2, 2), dict(policy="fsdp", min_size=1024),
                    "plain"),
}
FAULTS = {"sum_head": "plain", "skip_prep_sum": "full"}


def _case_spec(jax_runs, case):
    (D, S, M), kw, ref = CASES[case]
    kw = dict(kw)
    batches = jax_runs["batches"][:1] if ref == "lamb" \
        else jax_runs["batches"]
    kw.setdefault("policy", "pp")
    return _spec(jax_runs[ref]["state0"], batches, pipeline_parallel=S,
                 pp_microbatches=M, **kw)


@pytest.fixture(scope="module")
def two_ranks(jax_runs, tmp_path_factory):
    """Every (1, 2, M) case, the faults, the dropout run and the padded
    embed step in one group of two ranks."""
    names = [c for c in CASES if CASES[c][0][0] * CASES[c][0][1] == 2]
    calls = [("classifier_run", (_case_spec(jax_runs, c),), {})
             for c in names]
    calls += [("classifier_run", (_spec(
        jax_runs[ref]["state0"], jax_runs["batches"], policy="pp",
        pipeline_parallel=2, pp_microbatches=2, fault=f),), {})
        for f, ref in FAULTS.items()]
    calls += [("classifier_run", (_spec(
        jax_runs["plain"]["state0"], jax_runs["batches"], policy="pp",
        pipeline_parallel=2, pp_microbatches=2, vit=DROP),), {})]
    # the embed step on 13 images: M = 4 does not divide them
    calls += [("classifier_run", (_spec(
        jax_runs["plain"]["state0"], jax_runs["batches"][:1], policy="pp",
        pipeline_parallel=2, pp_microbatches=4, embed_rows=13),), {})]
    out = _launch(runs.sequence, 2, tmp_path_factory.mktemp("pp2"), calls)
    n, f = len(names), len(FAULTS)
    return {"cases": dict(zip(names, out[:n])),
            "faults": dict(zip(FAULTS, out[n:n + f])),
            "dropout": out[n + f], "padded": out[n + f + 1]}


@pytest.fixture(scope="module")
def four_ranks(jax_runs, tmp_path_factory):
    names = [c for c in CASES if CASES[c][0][0] * CASES[c][0][1] == 4]
    calls = [("classifier_run", (_case_spec(jax_runs, c),), {})
             for c in names]
    out = _launch(runs.sequence, 4, tmp_path_factory.mktemp("pp4"), calls)
    return dict(zip(names, out))


def _run(two_ranks, four_ranks, case):
    D, S, _ = CASES[case][0]
    return two_ranks["cases"][case] if D * S == 2 else four_ranks[case]


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax(jax_runs, two_ranks, four_ranks, case):
    """Every update's loss and the final trainables against JAX's 1-device
    run; the first update's loss and reduced gradients against JAX's
    1-device `value_and_grad` and, on the plain path, JAX's pipeline at
    the same (D, S, M)."""
    run = _run(two_ranks, four_ranks, case)
    (D, S, M), kw, ref = CASES[case]
    want = jax_runs[ref]
    # a full fine-tune's weights are not held: AdamW's first updates
    # move a coordinate whose gradient is near 0 by ~lr either way on f32
    # sum-order noise (any two runs: JAX's and the port's one-rank run
    # already differ so); its losses and gradients are held
    final = {} if ref == "full" else want["final"]
    np.testing.assert_allclose(run["losses"], want["losses"],
                               rtol=STEP_RTOL, err_msg=case)
    assert set(run["trainable"]) == set(want["final"])
    for name, w in final.items():
        np.testing.assert_allclose(run["trainable"][name].numpy(),
                                   np.asarray(w), **W_TOL,
                                   err_msg=f"{case}: {name}")
    refs = [(want["loss0"], want["grads0"])]
    if ref == "plain" and not kw.get("accum"):
        refs.append(jax_runs["pipelined"][(D, S, M)])
    if ref == "full":
        refs.append(jax_runs["pipelined_full"])
    accum = kw.get("accum", 1)
    for loss, grads in refs if accum == 1 else []:
        np.testing.assert_allclose(run["losses"][0], loss, **LOSS_TOL)
        assert set(run["grads"]) == set(grads)
        for name, g in grads.items():
            np.testing.assert_allclose(run["grads"][name].numpy(),
                                       np.asarray(g), **GRAD_TOL,
                                       err_msg=f"{case}: d {name}")
        # every stage's copy of what every stage holds
        assert len(run["stage_grads"]) == S
        for stage in run["stage_grads"]:
            for name, g in stage.items():
                np.testing.assert_allclose(g.numpy(), np.asarray(
                    grads[name]), **GRAD_TOL, err_msg=f"{case}: d {name}")
    assert (run["world"], run["n_model"]) == (D, S)
    counts = run["counts"][0]
    if kw.get("policy", "pp") == "pp":
        # rank 0 (stage 0) sent M microbatches and received their
        # cotangents, and took part in the output's broadcast: three
        # times its rows of the stream, whatever M and the accumulation
        assert counts["pipeline"] == 3 * (16 // D) * 17 * 64 * 4
        assert "model_gradients" not in counts or ref == "full"
    if case.startswith("replicated"):
        # every rank keeps every block, and adds the gradients of its
        # stage's over the model group
        assert run["plan"] == {} and counts["model_gradients"] > 0


def test_pp_keeps_a_stage_of_blocks(two_ranks, four_ranks):
    """Under "pp" each rank keeps its stage's blocks: the resident frozen
    bytes fall by the blocks' bytes times (S - 1) / S; "replicated" keeps
    every block."""
    rep = two_ranks["cases"]["replicated_1x2_m2"]["frozen_bytes"]
    for case, S in (("pp_1x2_m2", 2), ("pp_1x4_m4", 4)):
        run = _run(two_ranks, four_ranks, case)
        blocks = sum(1 for n in run["plan"] if n.startswith(
            "backbone.blocks."))
        assert blocks and len(set(run["plan"].values())) == S
        got = run["frozen_bytes"]
        assert len(set(got)) == 1 and got[0] < rep[0]
        # the blocks' frozen tensors and APLA's indices, of depth 4
        per_block = (rep[0] - got[0]) / (4 - 4 // S)
        assert per_block == 4 * (64 * 192 + 192 + 64 * 64 + 64 + 64 * 256
                                 + 256 + 256 * 64 + 64 + 4 * 64) + 8 * 8


@pytest.mark.parametrize("fault,ref", list(FAULTS.items()))
def test_gradient_rule_faults_fail_the_bound(jax_runs, two_ranks, fault,
                                             ref):
    """The head's gradient summed over the stages (S times it) and token
    prep's left unsummed (stage 1 holds zeros: a full fine-tune) each
    break the agreement on the tensors they touch, on some stage."""
    run = two_ranks["faults"][fault]
    grads = jax_runs[ref]["grads0"]
    touched = [n for n in grads if (n.startswith("fc.")
                                    if fault == "sum_head" else
                                    n.startswith(("backbone.patch_embed.",
                                                  "backbone.cls_token",
                                                  "backbone.pos_embed")))]
    assert touched
    # a stage without the gradient (left unsummed, never filled) holds 0
    worst = max(float(np.max(np.abs(stage.get(n, torch.zeros(())).numpy()
                                    - np.asarray(grads[n]))
                             / (GRAD_TOL["atol"] + GRAD_TOL["rtol"]
                                * np.abs(np.asarray(grads[n])))))
                for stage in run["stage_grads"] for n in touched)
    assert worst > 10.0, (fault, worst)


def test_dropout_draws_as_one_rank(jax_runs, two_ranks):
    """Dropout, attention dropout and drop-path 0.2 in a pipeline of two
    stages draw the port's one-rank values: each block's generator is
    re-seeded for every microbatch, whose draw is made for the rank's
    rows and sliced."""
    one = runs.classifier_run(_spec(jax_runs["plain"]["state0"],
                                    jax_runs["batches"], vit=DROP))
    got = two_ranks["dropout"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=STEP_RTOL)
    for n, t in one["trainable"].items():
        np.testing.assert_allclose(got["trainable"][n].numpy(), t.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
    assert abs(one["losses"][0] - jax_runs["plain"]["losses"][0]) > 1e-4


@pytest.mark.parametrize("case", ["pp_1x2_m2", "pp_2x2_m4"])
def test_knn_embeddings_through_the_pipeline(jax_runs, two_ranks,
                                             four_ranks, case):
    """The embed step (kNN's bank and queries) through the pipeline gives
    the one-rank run's embeddings of the same weights."""
    one = runs.classifier_run(_spec(jax_runs["plain"]["state0"],
                                    jax_runs["batches"]))
    got = _run(two_ranks, four_ranks, case)["embed"]
    assert got.shape == (16, 64)
    np.testing.assert_allclose(got.numpy(), one["embed"].numpy(),
                               rtol=1e-4, atol=1e-6)


def test_deterministic_calls_pad_to_the_microbatches(jax_runs, two_ranks):
    """An eval or embed batch that M does not divide (13 rows, M = 4) is
    padded with its last row and the padding dropped (JAX falls back to
    the unpipelined trunk there, which a "pp" rank no longer holds): the
    one-rank run's embeddings, row by row."""
    one = runs.classifier_run(_spec(jax_runs["plain"]["state0"],
                                    jax_runs["batches"][:1], embed_rows=13))
    got = two_ranks["padded"]["embed"]
    assert got.shape == (13, 64)
    np.testing.assert_allclose(got.numpy(), one["embed"].numpy(),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", ["test_config", "vit_tiny_width", "w8a8",
                                  "uneven_depth"])
def test_pp_plan_matches_jax_rule(case):
    """`tests/test_pipeline.py:297-311` read against the port: every
    tensor of a block (JAX's stacked leaf, sharded over "model" on the
    depth) belongs to stage i // (L / S), every other one to every rank;
    where S does not divide the depth JAX leaves the leaf whole, and so
    does the port.  Gradient rules: the blocks' trainable tensors are
    the stage's own, token prep's summed, the head kept."""
    cfg_kw = {"test_config": VIT, "vit_tiny_width": dict(
        VIT, embed_dim=192, num_heads=3), "w8a8": VIT,
        "uneven_depth": dict(VIT, depth=6)}[case]
    S = 4
    cfg = JViTConfig(compute_dtype=jnp.float32, **cfg_kw)
    trainable, frozen = jinit(jax.random.PRNGKey(0), cfg, n_classes=10,
                              apla_cfg=JAplaConfig(partial_size=8))
    if case == "w8a8":
        frozen = jquantize(frozen)
    mesh = jmesh(n_data=2, n_model=S, devices=jax.devices()[:2 * S])
    L = cfg_kw["depth"]

    def staged(tree):
        """Each leaf filled with 1 where JAX shards it over "model", else
        0, in the port's names (`params_from_jax` splits the blocks)."""
        specs = pp_sharding_tree(mesh, tree)
        flags = jax.tree.map(lambda x, sh: np.full(
            x.shape, list(sh.spec) == ["model"], np.int8), tree, specs)
        return flags

    t_flags, f_flags = params_from_jax(staged(trainable), staged(frozen))
    want = {}
    for n, flag in {**t_flags, **f_flags}.items():
        on = bool(np.asarray(flag).any())
        if not n.startswith("backbone.blocks."):
            assert not on, n
            want[n] = None
        else:
            i = int(n.split(".")[2])
            want[n] = i // (L // S) if on else None
    t_state, f_state = params_from_jax(jax.tree.map(np.asarray, trainable),
                                       jax.tree.map(np.asarray, frozen))
    model = classifier_from_state(ViTConfig(compute_dtype=torch.float32,
                                            **cfg_kw),
                                  t_state, f_state, torch.device("cpu"))
    plan = pp_plan(model, S)
    got = {n: e.stage for n, e in plan.items() if n in want}
    assert set(got) == set(want)
    assert got == want
    if case == "w8a8":
        assert plan["backbone.blocks.0.attn.qkv.kernel.w_kmajor"].stage == 0
    # the gradient rules of the trainable tensors
    rules = {n: e.grad for n, e in plan.items() if n in t_state}
    staged = "stage" if case != "uneven_depth" else "sum"
    assert rules == {n: (staged if ".blocks." in n else "keep")
                     for n in t_state}
    if case != "test_config":
        return
    from apla_tpu_torch.models.classifier import init_classifier
    full = pp_plan(init_classifier(     # a full fine-tune
        ViTConfig(**VIT), 10, generator=torch.Generator().manual_seed(0),
        device=torch.device("cpu")), 2)
    assert full["backbone.patch_embed.kernel"].grad == "sum"
    assert full["backbone.pos_embed"].grad == "sum"
    assert full["backbone.norm.scale"].grad == "keep"
    assert full["fc.kernel"].grad == "keep"


# --------------------------------------------------------------------------- #
# the knobs and the refusals
# --------------------------------------------------------------------------- #

def _mesh_wrapper(monkeypatch, capsys, wrapper_cls=None, **system):
    """A wrapper's knobs read against a stand-in mesh (no group): returns
    (printed text, what make_mesh got, the wrapper or the error)."""
    from apla_tpu_torch import wrapper as twrapper
    from apla_tpu_torch.utils.config import load_merged_params
    params = load_merged_params(os.path.join(
        ROOT, "params", "synthetic", "vit_tiny", "apla.yml"))
    params.system_params.device = "cpu"
    params.system_params.update(system)
    seen = {}

    def fake(n_data=None, n_model=1, sequence_parallel=False):
        seen.update(n_data=n_data, n_model=n_model)
        return Mesh(world=n_data or 1, n_model=n_model,
                    sequence_parallel=sequence_parallel)

    monkeypatch.setattr(twrapper, "make_mesh", fake)
    try:
        w = (wrapper_cls or twrapper.DefaultWrapper)(params)
    except ValueError as e:
        w = e
    return capsys.readouterr().out, seen, w


@pytest.mark.parametrize("case", ["pp_default", "explicit_replicated",
                                  "explicit_fsdp", "microbatches",
                                  "uneven_total", "pp_with_tp",
                                  "pp_with_sp"])
def test_pipeline_knobs_as_jax_reads_them(monkeypatch, capsys, case):
    system = {
        "pp_default": dict(n_devices=4, pipeline_parallel=2),
        "explicit_replicated": dict(n_devices=2, pipeline_parallel=2,
                                    param_sharding="replicated"),
        "explicit_fsdp": dict(n_devices=4, pipeline_parallel=2,
                              param_sharding="fsdp"),
        "microbatches": dict(n_devices=4, pipeline_parallel=4,
                             pp_microbatches=8),
        "uneven_total": dict(n_devices=3, pipeline_parallel=2),
        "pp_with_tp": dict(pipeline_parallel=2, tensor_parallel=2),
        "pp_with_sp": dict(pipeline_parallel=2, sequence_parallel=True),
    }[case]
    out, seen, w = _mesh_wrapper(monkeypatch, capsys, **system)
    if case == "pp_default":
        assert w.system_params.param_sharding == "pp"
        assert "defaulting param_sharding to 'pp'" in out
        assert (seen["n_data"], seen["n_model"]) == (2, 2)
        assert (w.pipeline_spec.n_stages, w.pipeline_spec.n_micro) == (2, 2)
    elif case.startswith("explicit"):
        assert w.system_params.param_sharding == case.split("_")[1]
        assert "WARNING: pipeline_parallel=2" in out
    elif case == "microbatches":
        assert (w.pipeline_spec.n_stages, w.pipeline_spec.n_micro) == (4, 8)
        assert seen["n_data"] == 1
    elif case == "uneven_total":
        assert isinstance(w, ValueError) and "does not split" in str(w)
    elif case == "pp_with_tp":
        assert isinstance(w, ValueError) and "pick one" in str(w)
    else:
        assert isinstance(w, ValueError)
        assert "composes with tensor_parallel" in str(w)


def test_pipeline_refusals(monkeypatch, capsys):
    """JAX's assertions as exceptions: a depth that S does not divide, a
    training batch that M does not divide (a deterministic call pads it
    instead), `return_layers` and crop packing through the pipeline, and
    DINOv2's `pack_local_crops` under `pipeline_parallel`."""
    spec = PipelineSpec(Mesh(n_model=2), 2, 4)
    with pytest.raises(ValueError, match="not divisible by 2 stages"):
        spec.stage_blocks(5)
    x = torch.zeros((6, 3, 8))
    with pytest.raises(ValueError, match="not divisible by 4 microbatches"):
        pipeline_blocks(x, spec, 4, None, [], False, True)
    with pytest.raises(ValueError, match="2 stages"):
        PipelineSpec(Mesh(n_model=1), 2, 2)
    from apla_tpu_torch.models.vit import ViT, vit_features
    vit = ViT(ViTConfig(**VIT))
    vit.pipeline = PipelineSpec(Mesh(n_model=2), 2, 2)
    img = torch.zeros((2, 32, 32, 3))
    with pytest.raises(ValueError, match="return_layers"):
        vit_features(vit, img, vit.cfg, return_layers=True)
    with pytest.raises(ValueError, match="crop packing"):
        vit_features(vit, img, vit.cfg, pack_segments=2)
    from apla_tpu_torch.ssl.dinov2 import Dinov2Trainer
    trainer = Dinov2Trainer.__new__(Dinov2Trainer)
    trainer.wrapper = type("W", (), {
        "model_params": {"transformers_params": {
            "student": {"pack_local_crops": True}}},
        "pipeline_spec": spec})()
    with pytest.raises(ValueError, match="pack_local_crops"):
        trainer.get_step(False)
