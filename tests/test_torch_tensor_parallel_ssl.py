"""The SSL objectives of the port on a model axis (gloo ranks on the CPU,
spawned through `parallel.launch`), against JAX's 1-device step and the
port's one-rank step; and the reductions over samples, which run over the
data group.

- One step each of BYOL (BatchNorm over the global batch), DINO v1 (its
  center) and DINOv2 (KoLeo, softmax centering, iBOT, the local crops
  packed into one sequence per image) at `tensor_parallel: 2` (DINOv2
  also with `sequence_parallel`), through each objective's parity harness
  (tests/test_torch_{byol,dino,dinov2_step}.py: f32, SGD, the plain path)
  with the backbone widened to vit_small (6 heads: vit_tiny's 3 do not
  split over 2 ranks).  Held to the port's one-rank step within 1e-5 of
  each tensor's largest magnitude (loss terms 1e-5 relative), and to
  JAX's step at the harnesses' own tolerances.
- The data group: on a 1 x 2 mesh, BatchNorm's statistics and gradient,
  the DINO center, KoLeo and Sinkhorn-Knopp equal the one-process values.
  Run over the world with the world's size, as the reductions ran before
  the model axis, the means hold (every row counted T times is the same
  mean) and KoLeo does not: its gathered batch holds each row twice.
"""

from __future__ import annotations

import copy

import pytest
import torch

from apla_tpu_torch.parallel import launch as tlaunch, runs

import tests.test_torch_byol as hb
import tests.test_torch_dino as hd
import tests.test_torch_dinov2_step as hd2
from tests.test_torch_parallel_ssl import (_d2_call, _dinov2_params,
                                           _dinov2_payload, _hold_to_one_rank,
                                           _payload, _port_steps)

BACKBONE = "vit_small"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launch(fn, n, tmp_path, *args):
    return tlaunch.launch(fn, n, args=args, device="cpu",
                          store_dir=str(tmp_path), timeout=900)


def _model_axis(params, sp=False):
    p = copy.deepcopy(params)
    p.system_params.update(n_devices=2, tensor_parallel=2,
                           sequence_parallel=sp)
    return p


@pytest.fixture(scope="module")
def ssl_cases():
    """Each objective's JAX step, the port's one-rank step and the
    model-axis inputs, from one JAX init."""
    hd2.ppc.INTERPRET = True
    cases = {}
    try:
        params = hb._params(1, False)
        params.model_params.backbone_type = BACKBONE
        views = hb._views(1)
        init, jstates = hb._jax_run(params, True, views)
        st, port = hb._port_run(params, True, init, views)
        p = copy.deepcopy(params)
        p.system_params.device = "cpu"
        w = hb.tb.BYOLWrapper(copy.deepcopy(p), use_momentum=True)
        w.instantiate()
        hb._port_state(w, st)
        cases["byol"] = dict(params=_model_axis(p), payload=_payload(w),
                             batches=views,
                             calls=[{"lr": hb.LR,
                                     "momentum": hb.MOMENTA[0]}],
                             jax=jstates, st=st, port=port)
        params = hd._params(1, False)
        params.model_params.backbone_type = BACKBONE
        crops = hd._crops(1)
        init, jstates = hd._jax_run(params, crops)
        st, port = hd._port_run(params, init, crops)
        p = copy.deepcopy(params)
        p.system_params.device = "cpu"
        w = hd.td.DINOWrapper(copy.deepcopy(p))
        w.instantiate()
        w.model.load_state_dict({**st["frozen"], **st["trainable"]})
        w.state.load_aux({**{f"teacher.{n}": v
                             for n, v in st["teacher"].items()},
                          "center": st["center"]})
        mom, wd, tt, freeze = hd.SCHEDULE[0]
        cases["dino"] = dict(params=_model_axis(p), payload=_payload(w),
                             batches=crops,
                             calls=[dict(lr=hd.LR, wd=wd, momentum=mom,
                                         teacher_temp=tt, freeze=freeze)],
                             jax=jstates, st=st, port=port)
        params = hd2._params(False, 1, 16)
        params.model_params.backbone_type = BACKBONE
        params.model_params.transformers_params.student.pack_local_crops = \
            True
        batches = hd2._batches(1)
        init, jstates = hd2._jax_run(params, batches)
        st, port = hd2._port_run(params, init, batches)
        cases["dinov2"] = dict(params=_model_axis(_dinov2_params(params),
                                                  sp=True),
                               st=st, payload=_dinov2_payload(params, st),
                               batches=batches, calls=[_d2_call(0)],
                               jax=jstates, port=port)
    finally:
        hd2.ppc.INTERPRET = False
    return cases


@pytest.fixture(scope="module")
def ssl_model_axis(ssl_cases, tmp_path_factory):
    """Every objective at T = 2, and the data-group probes, in one
    group."""
    calls = [("ssl_steps_run", (name, c["params"], c["payload"],
                                c["batches"], c["calls"]), {})
             for name, c in ssl_cases.items()]
    calls += [("data_group_probe", (2,), {}),
              ("data_group_probe", (2, True), {})]
    out = _launch(runs.sequence, 2, tmp_path_factory.mktemp("ssl_tp"),
                  calls)
    res = dict(zip(ssl_cases, out[:len(ssl_cases)]))
    res["probe"], res["probe_world"] = out[-2:]
    return res


@pytest.mark.parametrize("name", ["byol", "dino", "dinov2"])
def test_ssl_step_on_a_model_axis(ssl_cases, ssl_model_axis, name):
    c = ssl_cases[name]
    two = ssl_model_axis[name]
    _hold_to_one_rank(two, _port_steps(name, c["port"]))
    tr2, aux2, m2 = two[0]
    teacher = {n[len("teacher."):]: t for n, t in aux2.items()
               if n.startswith("teacher.")}
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


@pytest.mark.parametrize("what", ["bn_mean", "bn_var", "bn_grad", "center",
                                  "koleo", "koleo_grad", "sinkhorn"])
def test_sample_reductions_run_over_the_data_group(ssl_model_axis, what):
    one = runs.data_group_probe(1)
    got = ssl_model_axis["probe"][what]
    assert torch.allclose(got, one[what], rtol=1e-6, atol=1e-7), what
    world = ssl_model_axis["probe_world"][what]
    if what.startswith("koleo"):
        # each row's duplicate from the other model rank is its nearest
        assert not torch.allclose(world, one[what], rtol=1e-3, atol=1e-5)
    else:
        assert torch.allclose(world, one[what], rtol=1e-6, atol=1e-7)
