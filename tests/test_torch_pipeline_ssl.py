"""The SSL objectives of the port through a pipeline of two stages (gloo
ranks on the CPU, spawned through `parallel.launch`), against JAX's
1-device step and the port's one-rank step; and a checkpoint written
under "pp" by the supervised trainer (in the same group of ranks).

One step each of BYOL (BatchNorm over the batch, the EMA target on the
student's modules), DINO v1 (its center) and DINOv2 (KoLeo, softmax
centering, iBOT, the teacher's global crops and the student's global and
local crops: three pipelined trunk calls a step, two of them with a
backward, whose messages must pair in the same order on both stages) at
`pipeline_parallel: 2`, `pp_microbatches: 2`, through each objective's
parity harness (tests/test_torch_{byol,dino,dinov2_step}.py: f32, SGD,
the plain path, vit_tiny: 6 blocks a stage).  Held to the port's
one-rank step within 1e-5 of each tensor's largest magnitude (loss terms
1e-5 relative), and to JAX's step at the harnesses' own tolerances, which
are within `tests/test_pipeline.py`'s for these objectives.

The checkpoint: the supervised recipe at `pipeline_parallel: 2` through
`DefaultWrapper` -> `Trainer` gives the one-rank losses, writes whole
tensors (frozen, trainable, the optimizer's moments) that a one-rank
model loads, and a run resumed from its first epoch under "pp" gives the
uninterrupted run's second-epoch losses.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import pytest
import torch

from apla_tpu_torch.parallel import launch as tlaunch, runs

import tests.test_torch_byol as hb
import tests.test_torch_dino as hd
import tests.test_torch_dinov2_step as hd2
from tests.test_torch_parallel_ssl import (_d2_call, _dinov2_params,
                                           _dinov2_payload, _hold_to_one_rank,
                                           _payload, _port_steps)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipelined(params):
    p = copy.deepcopy(params)
    p.system_params.update(n_devices=2, pipeline_parallel=2,
                           pp_microbatches=2)
    return p


@pytest.fixture(scope="module")
def ssl_cases():
    """Each objective's JAX step, the port's one-rank step and the
    pipeline's inputs, from one JAX init."""
    cases = {}
    params = hb._params(1, False)
    views = hb._views(1)
    init, jstates = hb._jax_run(params, True, views)
    st, port = hb._port_run(params, True, init, views)
    p = copy.deepcopy(params)
    p.system_params.device = "cpu"
    w = hb.tb.BYOLWrapper(copy.deepcopy(p), use_momentum=True)
    w.instantiate()
    hb._port_state(w, st)
    cases["byol"] = dict(params=_pipelined(p), payload=_payload(w),
                         batches=views,
                         calls=[{"lr": hb.LR, "momentum": hb.MOMENTA[0]}],
                         jax=jstates, st=st, port=port)
    params = hd._params(1, False)
    crops = hd._crops(1)
    init, jstates = hd._jax_run(params, crops)
    st, port = hd._port_run(params, init, crops)
    p = copy.deepcopy(params)
    p.system_params.device = "cpu"
    w = hd.td.DINOWrapper(copy.deepcopy(p))
    w.instantiate()
    w.model.load_state_dict({**st["frozen"], **st["trainable"]})
    w.state.load_aux({**{f"teacher.{n}": v for n, v in st["teacher"].items()},
                      "center": st["center"]})
    mom, wd, tt, freeze = hd.SCHEDULE[0]
    cases["dino"] = dict(params=_pipelined(p), payload=_payload(w),
                         batches=crops,
                         calls=[dict(lr=hd.LR, wd=wd, momentum=mom,
                                     teacher_temp=tt, freeze=freeze)],
                         jax=jstates, st=st, port=port)
    params = hd2._params(False, 1, 16)
    batches = hd2._batches(1)
    init, jstates = hd2._jax_run(params, batches)
    st, port = hd2._port_run(params, init, batches)
    cases["dinov2"] = dict(params=_pipelined(_dinov2_params(params)),
                           st=st, payload=_dinov2_payload(params, st),
                           batches=batches, calls=[_d2_call(0)],
                           jax=jstates, port=port)
    return cases


@pytest.fixture(scope="module")
def ssl_pipeline(ssl_cases, tmp_path_factory):
    """Every objective through two stages, then the checkpoint's three
    trainer runs, in one group."""
    calls = [("ssl_steps_run", (name, c["params"], c["payload"],
                                c["batches"], c["calls"]), {})
             for name, c in ssl_cases.items()]
    tmp = tmp_path_factory.mktemp("pp_ckpt")
    calls += [("trainer_run", (p,), {}) for p in _checkpoint_params(tmp)]
    out = tlaunch.launch(runs.sequence, 2, args=(calls,), device="cpu",
                         store_dir=str(tmp_path_factory.mktemp("ssl_pp")),
                         timeout=900)
    n = len(ssl_cases)
    res = dict(zip(ssl_cases, out[:n]))
    res.update(checkpoint=out[n:], tmp=tmp)
    return res


@pytest.mark.parametrize("name", ["byol", "dino", "dinov2"])
def test_ssl_step_through_the_pipeline(ssl_cases, ssl_pipeline, name):
    c = ssl_cases[name]
    two = ssl_pipeline[name]
    _hold_to_one_rank(two, _port_steps(name, c["port"]))
    tr2, aux2, m2 = two[0]
    teacher = {n[len("teacher."):]: t for n, t in aux2.items()
               if n.startswith("teacher.")}
    # whole tensors: every stage's blocks, the teacher's among them
    assert any(".blocks.11." in n for n in tr2)
    assert any(".blocks.11." in n for n in teacher)
    if name == "byol":
        hb._check_steps(True, c["st"], [(tr2, teacher, {
            n[len("model_state."):]: t for n, t in aux2.items()
            if n.startswith("model_state.")}, m2)], c["jax"])
    elif name == "dino":
        hd._check_steps(c["st"], [(tr2, teacher, aux2["center"], m2)],
                        c["jax"])
    else:
        hd2._check_steps(c["st"], [(tr2, teacher, aux2["dino_center"],
                                    aux2["ibot_center"], m2)], c["jax"])
        assert m2["koleo_loss"] > 0 and m2["ibot_loss"] > 0


# --------------------------------------------------------------------------- #
# a checkpoint under "pp"
# --------------------------------------------------------------------------- #

def _recipe(tmp, n_devices, epochs, name, resume=False):
    from apla_tpu_torch.utils.config import load_merged_params
    params = load_merged_params(os.path.join(
        ROOT, "params", "synthetic", "vit_tiny", "apla.yml"))
    params.training_params.update(epochs=epochs, log_every=1,
                                  model_name="pp",
                                  use_mixed_precision=False,
                                  save_dir=str(tmp / name),
                                  restore_session=resume)
    params.dataset_params.synthetic_size = 48
    params.system_params.device = "cpu"
    if n_devices > 1:
        params.system_params.update(n_devices=n_devices,
                                    pipeline_parallel=2, pp_microbatches=2)
    for ld in params.dataloader_params.values():
        ld.num_workers = 0
        ld.batch_size = 16
    return params


def _checkpoint_params(tmp):
    """Under "pp": two epochs straight; one epoch; the second epoch
    resumed from the first's checkpoint."""
    return [_recipe(tmp, 2, 2, "a"), _recipe(tmp, 2, 1, "b"),
            _recipe(tmp, 2, 2, "b", True)]


def _train_losses(run):
    return [r["train_loss"] for _, r in run["history"] if "train_loss" in r]


def test_pp_checkpoint_whole_loads_at_one_rank_and_resumes(ssl_pipeline):
    """The supervised recipe at `pipeline_parallel: 2` (vit_tiny, 12
    blocks: 6 a stage; 48 images, f32) through `DefaultWrapper` ->
    `Trainer` gives the one-rank losses; its checkpoint holds whole
    tensors (frozen, trainable, the optimizer's moments), which a one-rank
    model loads; and a run resumed from the first epoch's checkpoint
    under "pp" gives the uninterrupted run's second-epoch losses."""
    from apla_tpu_torch.train.checkpoint import load_checkpoint
    from apla_tpu_torch.wrapper import DefaultWrapper
    tmp = ssl_pipeline["tmp"]
    straight, first, resumed = ssl_pipeline["checkpoint"]
    one = runs.trainer_run(_recipe(tmp, 1, 2, "one"))
    np.testing.assert_allclose(_train_losses(straight), _train_losses(one),
                               rtol=1e-5)
    assert len(_train_losses(straight)) == 6
    assert _train_losses(first) == _train_losses(straight)[:3]
    np.testing.assert_allclose(_train_losses(resumed),
                               _train_losses(straight)[3:], rtol=1e-6)
    assert straight["test"]["test_accuracy"] == pytest.approx(
        one["test"]["test_accuracy"])
    # a rank keeps its stage's blocks
    assert len({s for s in straight["plan"].values()}) == 2
    assert straight["frozen_bytes"][0] < one["frozen_bytes"][0]
    ckpt = str(tmp / "a" / "pp")
    frozen = torch.load(os.path.join(ckpt, "frozen.pt"))
    payload = torch.load(os.path.join(ckpt, "state.pt"), weights_only=False)
    assert tuple(frozen["backbone.blocks.11.attn.qkv.kernel"].shape) == \
        (192, 576)
    assert tuple(payload["trainable"]["backbone.blocks.11.attn.proj_wt"]
                 .shape) == (192, 16)
    w = DefaultWrapper(_recipe(tmp, 1, 2, "load"))
    w.instantiate()
    load_checkpoint(ckpt, w.state)
    blk = w.model.backbone.blocks[11]
    assert torch.equal(blk.attn.qkv.kernel,
                       frozen["backbone.blocks.11.attn.qkv.kernel"])
    opt = w.optimizer.state_dict()["state"]
    assert len(opt) == len(payload["optimizer"]["state"]) == \
        len(w.state.trainable())
    assert all(v["exp_avg"].numel() for v in opt.values())
