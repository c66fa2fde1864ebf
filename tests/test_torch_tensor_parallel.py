"""Tensor and sequence parallelism on the mesh's model axis
(`apla_tpu_torch/parallel/tensor.py`), and W8A8 training at more than one
rank, on the CPU against JAX's 1-device run.

`tests/test_parallel.py:74-92`'s contract: for the same global batch a
(data x model) mesh gives the 1-device run's losses and updates.  Its
classifier (img 32, patch 8, dim 64, depth 2, 4 heads, APLA-8, AdamW,
clip 1.0, b16, 3 steps, f32) runs as the port on gloo ranks spawned
through `parallel.launch`: (D, T) = (1, 2), (2, 2) and (1, 4), under "tp"
with and without `sequence_parallel` (17 tokens: 9 + 8 over two ranks,
5 + 4 + 4 + 4 over four), at accumulation 2, and on the fused APLA path
(the port's rows 1 and 2 run their plain versions at the rectangular
shape, qkv [B, N, 3 C/T] and W [C/T, C]; JAX's Pallas kernel in interpret
mode).  Losses at rtol 1e-5, every trainable tensor's update at rtol 1e-5,
atol 1e-7: JAX's own tolerances.  Two deliberate faults of the model-axis
gradient rule (APLA's columns left unsummed; the head summed) must each
fail that bound on the tensors they touch.

Also: `tp_plan` against JAX's `tp_sharding_tree` tensor by tensor (the
head-aligned qkv share equal to the rank's heads' q, k and v columns,
SwiGLU's paired w12 halves, W8A8's int8 leaves whole); the model axis's
operators at uneven N (17 and 257 tokens over 2 and 4 ranks) with their
gradients, the end-of-trunk gather's backward keeping the rank's slice;
dropout and drop-path at T = 2 drawing the T = 1 run's values; W8A8
training at W = 2 (replicated and fsdp, whose int8 buffers each rank
holds half of) and at T = 2 against JAX's 1-device W8A8 step; the knobs
as `apla_tpu/wrapper.py:141-214` reads them; a checkpoint written under
"tp" holding whole tensors, loading at one rank and resuming under "tp".
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.apla.core import AplaConfig as JAplaConfig
from apla_tpu.models.classifier import init_classifier as jinit
from apla_tpu.models.vit import ViTConfig as JViTConfig
from apla_tpu.ops import pallas_apla_attn
from apla_tpu.ops.quant import quantize_frozen_backbone as jquantize
from apla_tpu.parallel.mesh import make_mesh as jmesh, tp_sharding_tree
from apla_tpu.train.losses import cross_entropy as jce
from apla_tpu.train.optim import build_optimizer as jbuild
from apla_tpu.train.steps import make_train_step as jmake_step
from apla_tpu.train.train_state import TrainState as JState
from apla_tpu_torch.models.classifier import classifier_from_state
from apla_tpu_torch.models.vit import ViTConfig
from apla_tpu_torch.parallel import collectives, launch as tlaunch, runs
from apla_tpu_torch.parallel.mesh import tp_plan
from apla_tpu_torch.parallel.tensor import shard_index
from apla_tpu_torch.utils.pretrained import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
LR, WD = 1e-3, 1e-5
RTOL, ATOL = 1e-5, 1e-7
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


def _jax_run(batches, accum=1, fused=False, quantize=False):
    """JAX's 1-device run: the initial (trainable, frozen) state in the
    port's names, the losses, the final trainables."""
    cfg = JViTConfig(compute_dtype=jnp.float32, use_fused_apla=fused, **VIT)
    trainable, frozen = jinit(jax.random.PRNGKey(0), cfg, n_classes=10,
                              apla_cfg=JAplaConfig(partial_size=8))
    if quantize:
        frozen = jquantize(frozen)
    state0 = params_from_jax(jax.tree.map(np.asarray, trainable),
                             jax.tree.map(np.asarray, frozen))
    tx = jbuild("AdamW", {"lr": LR, "weight_decay": WD}, trainable,
                grad_clip=1.0)
    state = JState.create(trainable, tx)
    step = jmake_step(cfg, tx, jce, accum_steps=accum)
    losses = []
    for b in batches:
        state, m = step(state, frozen, {k: jnp.asarray(v)
                                        for k, v in b.items()}, LR,
                        jax.random.PRNGKey(7))
        losses.append(float(m["loss"]))
    final, _ = params_from_jax(jax.tree.map(np.asarray, state.trainable),
                               {"backbone": {}})
    return state0, losses, final


def _spec(state0, batches, **kw):
    vit = dict(VIT, **kw.pop("vit", {}))
    return dict(vit=vit, state=state0, batches=batches,
                optimizer=("AdamW", {"lr": LR, "weight_decay": WD}),
                grad_clip=1.0, lr=LR, device="cpu", **kw)


def _launch(fn, n, tmp_path, *args):
    return tlaunch.launch(fn, n, args=args, device="cpu",
                          store_dir=str(tmp_path), timeout=600)


def _close(run, losses, trainable, what):
    np.testing.assert_allclose(run["losses"], losses, rtol=RTOL,
                               err_msg=what)
    assert set(run["trainable"]) == set(trainable)
    for name, want in trainable.items():
        np.testing.assert_allclose(run["trainable"][name].numpy(),
                                   np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's 1-device runs: plain, accumulation 2, fused (interpret mode),
    W8A8."""
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
    return {"batches": batches, "plain": _jax_run(batches),
            "accum": _jax_run(batches, accum=2), "fused": fused,
            "w8a8": _jax_run(batches, quantize=True)}


# case -> (ranks, spec keywords, JAX run)
TWO = {
    "tp_1x2": (dict(policy="tp", tensor_parallel=2), "plain"),
    "sp_1x2": (dict(policy="tp", tensor_parallel=2, sequence_parallel=True),
               "plain"),
    "tp_1x2_accum2": (dict(policy="tp", tensor_parallel=2, accum=2),
                      "accum"),
    "sp_1x2_accum2": (dict(policy="tp", tensor_parallel=2,
                           sequence_parallel=True, accum=2), "accum"),
    "fused_tp_1x2": (dict(policy="tp", tensor_parallel=2,
                          vit=dict(use_fused_apla=True)), "fused"),
    "fused_sp_1x2_accum2": (dict(policy="tp", tensor_parallel=2,
                                 sequence_parallel=True, accum=2,
                                 vit=dict(use_fused_apla=True)), "fused"),
    # JAX's warning path: the model axis with the compute replicated
    "replicated_1x2": (dict(policy="replicated", tensor_parallel=2),
                       "plain"),
}
FOUR = {
    "tp_2x2": (dict(policy="tp", tensor_parallel=2), "plain"),
    "sp_2x2": (dict(policy="tp", tensor_parallel=2, sequence_parallel=True),
               "plain"),
    "tp_1x4": (dict(policy="tp", tensor_parallel=4), "plain"),
    "sp_1x4_accum2": (dict(policy="tp", tensor_parallel=4,
                           sequence_parallel=True, accum=2), "accum"),
}
FAULTS = ("skip_wt_sum", "sum_head")
W8A8 = {"replicated_w2": dict(policy="replicated"),
        "fsdp_w2": dict(policy="fsdp", min_size=1024),
        "tp_1x2": dict(policy="tp", tensor_parallel=2)}


@pytest.fixture(scope="module")
def two_ranks(jax_runs, tmp_path_factory):
    """Every two-rank case in one group: TWO, the faults, the dropout
    draws at T = 2 (TP and SP), W8A8, the operators' probe."""
    b = jax_runs["batches"]
    calls = [("classifier_run", (_spec(jax_runs[ref][0], b, **dict(kw)),),
              {}) for kw, ref in TWO.values()]
    calls += [("classifier_run", (_spec(jax_runs["plain"][0], b,
                                        policy="tp", tensor_parallel=2,
                                        fault=f),), {}) for f in FAULTS]
    calls += [("classifier_run", (_spec(jax_runs["plain"][0], b,
                                        policy="tp", tensor_parallel=2,
                                        sequence_parallel=sp, vit=DROP),),
               {}) for sp in (False, True)]
    calls += [("classifier_run", (_spec(jax_runs["w8a8"][0], b, **kw),), {})
              for kw in W8A8.values()]
    calls += [("model_axis_probe", (2,), {}),
              ("no_model_axis_probe", (), {})]
    out = _launch(runs.sequence, 2, tmp_path_factory.mktemp("tp2"), calls)
    n = len(TWO)
    return {"cases": dict(zip(TWO, out[:n])),
            "faults": dict(zip(FAULTS, out[n:n + 2])),
            "dropout": out[n + 2:n + 4],
            "w8a8": dict(zip(W8A8, out[n + 4:n + 4 + len(W8A8)])),
            "probe": out[-2], "no_model_axis": out[-1]}


@pytest.fixture(scope="module")
def four_ranks(jax_runs, tmp_path_factory):
    b = jax_runs["batches"]
    calls = [("classifier_run", (_spec(jax_runs[ref][0], b, **dict(kw)),),
              {}) for kw, ref in FOUR.values()]
    calls += [("model_axis_probe", (4,), {})]
    out = _launch(runs.sequence, 4, tmp_path_factory.mktemp("tp4"), calls)
    return {"cases": dict(zip(FOUR, out[:-1])), "probe": out[-1]}


@pytest.mark.parametrize("case", list(TWO))
def test_two_ranks_on_a_model_axis_match_jax(jax_runs, two_ranks, case):
    run = two_ranks["cases"][case]
    _, losses, final = jax_runs[TWO[case][1]]
    _close(run, losses, final, case)
    assert (run["world"], run["n_model"]) == (1, 2)
    counts = run["counts"][0]
    if case.startswith("replicated"):
        assert "model" not in counts and "model_gradients" not in counts
    else:
        # the operators ran, and APLA's columns were summed over the group
        assert counts["model"] > 0
        assert counts["model_gradients"] >= 2 * (64 * 8) * 4
        assert len(run["plan"]) == 2 * 6      # qkv, fc1 (kernel, bias),
        #                                       proj, fc2 kernels, a block


@pytest.mark.parametrize("case", list(FOUR))
def test_four_ranks_on_a_model_axis_match_jax(jax_runs, four_ranks, case):
    run = four_ranks["cases"][case]
    _, losses, final = jax_runs[FOUR[case][1]]
    _close(run, losses, final, case)
    T = FOUR[case][0]["tensor_parallel"]
    assert (run["world"], run["n_model"]) == (4 // T, T)
    if run["world"] > 1:
        assert run["counts"][0]["gradients"] == run["trainable_bytes"]


@pytest.mark.parametrize("fault", FAULTS)
def test_gradient_rule_faults_fail_the_bound(jax_runs, two_ranks, fault):
    """APLA's columns left unsummed (each rank keeps the gradient of its
    rows only) and the head summed (T times its gradient) each break the
    agreement on the tensors they touch."""
    run = two_ranks["faults"][fault]
    _, _, final = jax_runs["plain"]
    touched = [n for n in final if (n.endswith("attn.proj_wt")
                                    if fault == "skip_wt_sum"
                                    else n.startswith("fc."))]
    assert touched
    worst = max(float(np.max(np.abs(run["trainable"][n].numpy()
                                    - np.asarray(final[n]))
                             / (ATOL + RTOL * np.abs(np.asarray(final[n])))))
                for n in touched)
    assert worst > 10.0, (fault, worst)


@pytest.mark.parametrize("sp", [False, True])
def test_dropout_draws_at_two_model_ranks(jax_runs, two_ranks, sp):
    """Dropout, attention dropout and drop-path draw for the whole tensor
    and slice the rank's heads, hidden columns or tokens: T = 2 is the
    port's T = 1 run (JAX's draws are not torch's)."""
    one = runs.classifier_run(_spec(jax_runs["plain"][0],
                                    jax_runs["batches"], vit=DROP))
    got = two_ranks["dropout"][int(sp)]
    _close(got, one["losses"], {k: v.numpy()
                                for k, v in one["trainable"].items()},
           f"dropout sp={sp}")
    plain = runs.classifier_run(_spec(jax_runs["plain"][0],
                                      jax_runs["batches"]))
    assert abs(one["losses"][0] - plain["losses"][0]) > 1e-4


@pytest.mark.parametrize("case", list(W8A8))
def test_w8a8_training_at_two_ranks_matches_jax(jax_runs, two_ranks, case):
    """JAX trains W8A8 through the same placements: at W = 2 replicated
    and fsdp, and at T = 2, where the int8 qkv runs whole (the rank keeps
    its heads' columns) and the int8 MLP runs whole."""
    run = two_ranks["w8a8"][case]
    _, losses, final = jax_runs["w8a8"]
    _close(run, losses, final, f"w8a8 {case}")
    if case == "fsdp_w2":
        rep = two_ranks["w8a8"]["replicated_w2"]
        int8 = [n for n in run["plan"] if n.endswith(".w_int8")]
        assert len(int8) == 2 * 3
        assert all(n[:-len("w_int8")] + "w_kmajor" in run["plan"]
                   for n in int8)
        state = jax_runs["w8a8"][0][1]
        halved = sum(state[n].numel() * state[n].element_size()
                     for n in run["plan"] if n in state)
        kmajor = sum(state[n[:-len("w_kmajor")] + "w_int8"].numel()
                     for n in run["plan"] if n.endswith("w_kmajor"))
        for got in run["frozen_bytes"]:
            assert got == rep["frozen_bytes"][0] - (halved + kmajor) // 2
    if case == "tp_1x2":
        assert not [n for n in run["plan"] if ".w_int8" in n]


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("n", [17, 257])
def test_model_axis_operators_at_uneven_tokens(two_ranks, four_ranks, T, n):
    """split -> gather_trunk gives the stream back and its backward keeps
    the rank's slice (the whole cotangent, not T times it); a column
    product's gather (SP) sums the ranks' shares of dx into the rank's
    tokens; scatter_tokens sums the partials and keeps the rank's tokens;
    a column product's dx (TP) and reduce_from_model sum once."""
    probe = (two_ranks if T == 2 else four_ranks)["probe"]
    r = probe[n]
    x = torch.arange(2 * n * 3, dtype=torch.float32).reshape(2, n, 3)
    w = x + 1.0
    tri = T * (T + 1) / 2
    split = collectives.token_split(n, T)
    assert [ln for _, ln in split] == [-(-n // T)] * (n % T) + \
        [n // T] * (T - n % T)
    s0, l0 = split[0]
    assert torch.equal(r["split"], x[:, s0:s0 + l0])
    assert torch.equal(r["trunk"], x)
    assert torch.equal(r["trunk_grad"], w)
    assert torch.equal(r["tokens"], x)
    assert torch.equal(torch.cat(r["tokens_grad"], 1), w * tri)
    assert torch.equal(torch.cat(r["scatter"], 1), x * tri)
    assert torch.equal(r["scatter_grad"], w)
    assert torch.equal(r["reduce"], x * tri)
    assert torch.equal(r["copy_grad"], w * tri)


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("n", [17, 257])
def test_nccl_reduce_scatter_branch_at_uneven_tokens(two_ranks, four_ranks,
                                                      T, n):
    """`reduce_scatter_dim1`'s NCCL branch (each rank's tokens padded to
    the longest share, one `reduce_scatter_tensor`, the padding dropped)
    gives what the gloo branch (an all-reduce and a slice) gives: the
    partials summed, each rank's own tokens."""
    r = (two_ranks if T == 2 else four_ranks)["probe"][n]
    x = torch.arange(2 * n * 3, dtype=torch.float32).reshape(2, n, 3)
    want = x * (T * (T + 1) / 2)
    for got in (r["reduce_scatter"], r["reduce_scatter_nccl"]):
        assert [t.shape[1] for t in got] == \
            [ln for _, ln in collectives.token_split(n, T)]
        assert torch.equal(torch.cat(got, 1), want)


def test_model_collectives_without_a_model_axis_are_idle(two_ranks):
    """On a data-only mesh of two ranks, MODEL is the empty axis: a
    collective over it returns its input, never a sum over the world."""
    r = two_ranks["no_model_axis"]
    assert torch.equal(r["all_reduce"], r["x"])
    assert torch.equal(r["all_gather"], r["x"])
    assert r["counts"] == {}


def _jax_model(cfg_kw, quantize=False):
    cfg = JViTConfig(compute_dtype=jnp.float32, **cfg_kw)
    trainable, frozen = jinit(jax.random.PRNGKey(0), cfg, n_classes=10,
                              apla_cfg=JAplaConfig(partial_size=8))
    if quantize:
        frozen = jquantize(frozen)
    return trainable, frozen


@pytest.mark.parametrize("case", ["test_config", "vit_tiny_width", "swiglu",
                                  "w8a8"])
def test_tp_plan_matches_jax_rule(case):
    """`tests/test_parallel.py:94-112` read against the port: every frozen
    tensor JAX's `tp_sharding_tree` shards over "model" is a share in
    `tp_plan` on the same dim (JAX dim d of a stacked leaf is the port's
    d - 1), and every tensor JAX leaves whole stays whole."""
    cfg_kw = {"test_config": VIT,
              "vit_tiny_width": dict(VIT, embed_dim=192, num_heads=3),
              "swiglu": dict(VIT, use_swiglu=True),
              "w8a8": VIT}[case]
    T = 3 if case == "vit_tiny_width" else 4
    trainable, frozen = _jax_model(cfg_kw, quantize=case == "w8a8")
    specs = tp_sharding_tree(jmesh(n_data=2, n_model=T,
                                   devices=jax.devices()[:2 * T]), frozen)
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        spec = list(sh.spec)
        if keys[:2] != ["backbone", "blocks"]:
            assert "model" not in spec, keys     # outside the blocks: whole
            want[".".join(keys)] = None
            continue
        d = spec.index("model") - 1 if "model" in spec else None
        rest = ".".join(keys[2:])
        for i in range(cfg_kw["depth"]):
            want[f"backbone.blocks.{i}.{rest}"] = d
    t_state, f_state = params_from_jax(jax.tree.map(np.asarray, trainable),
                                       jax.tree.map(np.asarray, frozen))
    model = classifier_from_state(ViTConfig(compute_dtype=torch.float32,
                                            **cfg_kw),
                                  t_state, f_state, torch.device("cpu"))
    plan = tp_plan(model, T)
    # APLA's `inds` is a buffer in the port, a frozen leaf in JAX
    want = {n: d for n, d in want.items() if not n.endswith(".inds")}
    if case == "w8a8":
        # JAX shards an int8 layer's float bias as a column layer's; the
        # port runs that layer whole (the int8 kernel's epilogue adds the
        # whole bias), so the bias, C floats, stays whole
        for n in want:
            if n.endswith(("qkv.bias", "fc1.bias")):
                assert want[n] == 0
                want[n] = None
    got = {n: e.dim for n, e in plan.items() if n in want}
    assert set(got) == set(want)
    assert got == want
    assert any(d is not None for d in want.values()) or case == "w8a8"
    kinds = {n.split(".", 3)[-1]: e.kind for n, e in plan.items()
             if n.startswith("backbone.blocks.0.") and e.kind}
    if case == "w8a8":
        # the int8 layers whole, the float projection row-parallel
        assert kinds == {"attn.proj.kernel": "row"}
        assert plan["backbone.blocks.0.attn.qkv.kernel.w_int8"].kind is None
    elif case == "swiglu":
        assert kinds["mlp.w12.kernel"] == "w12"
    else:
        assert kinds["attn.qkv.kernel"] == "qkv"
    # every trainable: APLA's columns summed, the rest kept (TP alone)
    rules = {n: e.grad for n, e in plan.items() if n in t_state}
    assert {n for n, g in rules.items() if g == "sum"} == {
        n for n in t_state if n.endswith("attn.proj_wt")}
    # the head-aligned qkv share: the rank's heads' q, k and v columns
    if case == "test_config":
        C, heads = cfg_kw["embed_dim"], cfg_kw["num_heads"]
        dh = C // heads
        for m in range(T):
            idx = shard_index("qkv", 3 * C, T, m)
            own = [h for h in range(heads) if h * T // heads == m]
            expect = [j * C + h * dh + e for j in range(3) for h in own
                      for e in range(dh)]
            assert idx.tolist() == expect
    if case == "swiglu":
        h = model.backbone.cfg.mlp_hidden
        idx = shard_index("w12", 2 * h, 2, 1)
        assert idx.tolist() == list(range(h // 2, h)) + \
            list(range(h + h // 2, 2 * h))


def _mesh_wrapper(monkeypatch, capsys, **system):
    """A DefaultWrapper's knobs read against a stand-in mesh (no group):
    returns (printed text, the make_mesh call, the error or None)."""
    from apla_tpu_torch import wrapper as twrapper
    from apla_tpu_torch.parallel.mesh import Mesh
    from apla_tpu_torch.utils.config import load_merged_params
    params = load_merged_params(os.path.join(
        ROOT, "params", "synthetic", "vit_tiny", "apla.yml"))
    params.system_params.device = "cpu"
    params.system_params.update(system)
    seen = {}

    def fake(n_data=None, n_model=1, sequence_parallel=False):
        seen.update(n_data=n_data, n_model=n_model, sp=sequence_parallel)
        return Mesh(world=n_data or 1, n_model=n_model,
                    sequence_parallel=sequence_parallel)

    monkeypatch.setattr(twrapper, "make_mesh", fake)
    err = None
    try:
        w = twrapper.DefaultWrapper(params)
        seen["policy"] = w.system_params.get("param_sharding")
    except (ValueError, NotImplementedError, AssertionError) as e:
        err = e
    return capsys.readouterr().out, seen, err


@pytest.mark.parametrize("case", ["tp_default", "explicit_replicated",
                                  "explicit_fsdp", "sp", "sp_without_model",
                                  "pp_with_tp", "pp", "pp_microbatches",
                                  "param_sharding_pp", "uneven_total"])
def test_knobs_as_jax_reads_them(monkeypatch, capsys, case):
    system = {
        "tp_default": dict(n_devices=4, tensor_parallel=2),
        "explicit_replicated": dict(n_devices=4, tensor_parallel=2,
                                    param_sharding="replicated"),
        "explicit_fsdp": dict(n_devices=4, tensor_parallel=2,
                              param_sharding="fsdp"),
        "sp": dict(n_devices=2, tensor_parallel=2, sequence_parallel=True),
        "sp_without_model": dict(sequence_parallel=True),
        "pp_with_tp": dict(pipeline_parallel=2, tensor_parallel=2),
        "pp": dict(pipeline_parallel=2),
        "pp_microbatches": dict(pp_microbatches=2),
        "param_sharding_pp": dict(param_sharding="pp"),
        "uneven_total": dict(n_devices=3, tensor_parallel=2),
    }[case]
    out, seen, err = _mesh_wrapper(monkeypatch, capsys, **system)
    if case == "tp_default":
        assert err is None and seen["policy"] == "tp"
        assert "defaulting param_sharding to 'tp'" in out
        assert (seen["n_data"], seen["n_model"]) == (2, 2)
    elif case.startswith("explicit"):
        assert err is None and seen["policy"] == case.split("_")[1]
        assert "WARNING: tensor_parallel=2" in out
    elif case == "sp":
        assert err is None and seen["sp"] and seen["n_data"] == 1
        assert "token stream sharded over the model axis" in out
    elif case == "sp_without_model":
        assert isinstance(err, ValueError) and "model axis" in str(err)
    elif case == "pp_with_tp":
        assert isinstance(err, ValueError) and "pick one" in str(err)
    elif case == "uneven_total":
        assert isinstance(err, ValueError) and "does not split" in str(err)
    elif case == "pp":
        # the pipeline's own knobs: tests/test_torch_pipeline.py
        assert err is None and seen["policy"] == "pp"
        assert "defaulting param_sharding to 'pp'" in out
        assert (seen["n_data"], seen["n_model"]) == (None, 2)
    else:
        # not read without a pipeline; "pp" on a model axis of one is the
        # replicated placement (JAX's rule)
        assert err is None and seen["n_model"] == 1


def test_tp_checkpoint_whole_loads_at_one_rank_and_resumes(tmp_path):
    """The supervised recipe at `tensor_parallel: 2` (vit_small: 6 heads;
    48 images, f32) through `DefaultWrapper` -> `Trainer` gives the
    one-rank losses; its checkpoint holds whole tensors, which a one-rank
    model loads, and `load_session` under "tp" places them again
    (JAX's `test_fsdp_placement_survives_resume` pattern)."""
    from apla_tpu_torch.train.checkpoint import load_checkpoint
    from apla_tpu_torch.utils.config import load_merged_params
    params = load_merged_params(os.path.join(
        ROOT, "params", "synthetic", "vit_tiny", "apla.yml"))
    params.model_params.backbone_type = "vit_small"
    params.training_params.update(epochs=1, log_every=1,
                                  use_mixed_precision=False,
                                  save_dir=str(tmp_path / "t1"))
    params.dataset_params.synthetic_size = 48
    params.system_params.device = "cpu"
    for ld in params.dataloader_params.values():
        ld.num_workers = 0
        ld.batch_size = 16
    one = runs.trainer_run(params)
    params.training_params.save_dir = str(tmp_path / "t2")
    params.system_params.update(n_devices=2, tensor_parallel=2)
    two = _launch(runs.trainer_run, 2, tmp_path, params, "supervised", True)
    losses = [[r["train_loss"] for _, r in run["history"]
               if "train_loss" in r] for run in (one, two)]
    assert len(losses[0]) == 3
    np.testing.assert_allclose(losses[1], losses[0], rtol=RTOL)
    assert two["plan"] and two["sharded_after_resume"]
    # each rank holds its share of the column- and row-parallel tensors
    assert two["frozen_bytes"][0] < one["frozen_bytes"][0]
    ckpt = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "t2")
            for d in ds if os.path.exists(os.path.join(r, d, "frozen.pt"))]
    assert ckpt
    frozen = torch.load(os.path.join(ckpt[0], "frozen.pt"))
    qkv = frozen["backbone.blocks.0.attn.qkv.kernel"]
    assert tuple(qkv.shape) == (384, 3 * 384)
    from apla_tpu_torch.wrapper import DefaultWrapper
    params.system_params.update(n_devices=None, tensor_parallel=None,
                                param_sharding=None)
    w = DefaultWrapper(params)
    w.instantiate()
    load_checkpoint(ckpt[0], w.state)
    assert torch.equal(w.model.backbone.blocks[0].attn.qkv.kernel, qkv)


@pytest.mark.parametrize("case", ["tp_1x2", "sp_1x2", "fused_tp_1x2"])
def test_knn_embeddings_on_a_model_axis(jax_runs, two_ranks, case):
    """The embed step (kNN's bank and queries) at T = 2 gives the one-rank
    run's embeddings of the same weights."""
    kw, ref = TWO[case]
    one = runs.classifier_run(_spec(jax_runs[ref][0], jax_runs["batches"],
                                    vit=dict(kw.get("vit", {}))))
    got = two_ranks["cases"][case]["embed"]
    assert got.shape == (16, 64)
    np.testing.assert_allclose(got.numpy(), one["embed"].numpy(),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("b,n,heads,width,k", [(8, 257, 6, 768, 128),
                                               (2, 17, 1, 128, 8)])
def test_rectangular_rows_1_and_2_route_through_their_kernels(
        monkeypatch, b, n, heads, width, k):
    """Rows 1 and 2 at a tensor-parallel rank's shape (ViT-B over two
    ranks: qkv [8, 257, 1152] of 6 heads, W [384, 768], k = 128), with the
    C entries replaced by recorders: the forward's GEMM gets K = 384, N =
    768 and the f32 output, the backward K and the projection's width and
    returns dW_t's rows [384, k]; their plain versions give the f32
    partial whose sum over the ranks is the one-rank product."""
    import contextlib
    import types

    from apla_tpu_torch.ops import apla_proj_gemm as pg
    from apla_tpu_torch.ops import fused_apla_attn as tfa
    from apla_tpu_torch.ops import mha as tmha
    from tests.test_torch_apla_proj_gemm import _Recorder
    from tests.test_torch_fused_apla_attn_bwd import _Lib
    kk = heads * 64
    mlib, glib, blib = _Recorder("mha_fwd"), _Recorder("apla_proj_gemm"), \
        _Lib()
    for module, lib in ((tmha, mlib), (pg, glib)):
        monkeypatch.setattr(module, "device_smem", lambda *a: 232448)
        monkeypatch.setattr(module, "_fwd_library" if module is tmha
                            else "_library", lambda lib=lib: lib)
    monkeypatch.setattr(tfa, "_bwd_library", lambda: blib)
    monkeypatch.setattr(tfa, "device_index", lambda t: 0)
    monkeypatch.setattr(tfa, "device_smem", lambda *a: 232448)
    monkeypatch.setattr(tfa.mha, "device_smem", lambda *a: 232448)
    monkeypatch.setattr(tfa, "launch_context",
                        lambda t: contextlib.nullcontext(7))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    bf = torch.bfloat16
    qkv = torch.zeros((b, n, 3 * kk), dtype=bf)
    w = torch.zeros((kk, width), dtype=bf)
    out = tfa._launch(qkv, w, heads, 0.125, 0, out_f32=True)
    assert out.shape == (b, n, width) and out.dtype == torch.float32
    (g_args,) = glib.calls["apla_proj_gemm"]
    plan = pg.gemm_plan(b * n, width)
    assert g_args[3:10] == (b * n, kk, width, plan.bn, plan.stages,
                            plan.smem_bytes, 1)
    g = torch.zeros((b, n, width), dtype=bf)
    dqkv, dwt = tfa._launch_bwd(qkv, w, g, torch.arange(k), heads, 0.125, 0)
    assert dqkv.shape == qkv.shape and dwt.shape == (kk, k)
    (args,) = blib.calls
    assert args[10:16] == (b, n, kk, width, heads, -(-k // 64) * 64)
    with pytest.raises(ValueError, match="g must be"):
        tfa._launch_bwd(qkv, w, torch.zeros((b, n, kk), dtype=bf),
                        torch.arange(k), heads, 0.125, 0)
    # the plain versions: two ranks' f32 partials sum to the whole product
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 9, 3 * 128), generator=gen)
    wf = torch.randn((128, 128), generator=gen)
    whole = tfa.fused_apla_attn_fwd_reference(q, wf, 2, 0.125)
    parts = sum(tfa.fused_apla_attn_fwd_reference(
        q[..., shard_index("qkv", 3 * 128, 2, m)], wf[m * 64:(m + 1) * 64],
        1, 0.125, out_f32=True) for m in range(2))
    torch.testing.assert_close(parts, whole, rtol=1e-5, atol=1e-5)
