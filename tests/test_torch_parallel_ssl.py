"""The SSL objectives, the loaders and the side-car loops of the port at
two ranks (gloo on the CPU, spawned through `parallel.launch`), against
the port's one-rank run and JAX's 1-device run.

- One step each of BYOL (BatchNorm over the global batch), DINO v1 (its
  center) and DINOv2 (KoLeo on, softmax centering and iBOT; and Sinkhorn-
  Knopp centering) on `params/synthetic/vit_tiny/{byol,dino,dinov2}.yml`,
  from the JAX wrapper's init, through each objective's parity harness
  (tests/test_torch_{byol,dino,dinov2_step}.py: f32, SGD, the plain path).
  W = 2 against the port's W = 1 within 1e-5 of each tensor's largest
  magnitude (the loss terms 1e-5 relative), and against JAX's step at the
  harnesses' own tolerances (the port's W = 1 is held there too).
- KoLeo in bf16 (ROADMAP C 2): the DINOv2 harness's step with mixed
  precision on; the port's `koleo_loss` term at W = 1 equals JAX's, and
  the global-batch KoLeo at W = 2 equals it to 1e-6.
- The mixup / cutmix collate at W = 2: each rank's rows of the 1-device
  batch, pixels and soft targets bit for bit, from its rows and their
  flip partners only; the iBOT collate's rank rows against the global
  collate's masks.
- `segdet det` (a three-stage Swin, `--param_sharding fsdp`) and `seg`
  with `--n_devices 2` against `--n_devices 1`: per-step losses and the
  per-epoch metric.
- ROADMAP C 1: the port's `segdet.train_segmentation` against the JAX
  package's for 2 epochs on tests/test_torch_segdet.py's ADE20K set with a
  small f32 ViT from the same initial weights (the JAX loop's init,
  handed to the port as a `seg_last` checkpoint of epoch -1 that
  `--resume` starts from); per-step losses at 1e-4 relative and the
  per-epoch mIoU equal; then `--n_devices 2` to the same numbers.
"""

from __future__ import annotations

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu_torch.parallel import launch as tlaunch, runs
from apla_tpu_torch.parallel.mesh import Mesh

import tests.test_torch_byol as hb
import tests.test_torch_dino as hd
import tests.test_torch_dinov2_step as hd2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launch(fn, n, tmp_path, *args, **kwargs):
    return tlaunch.launch(fn, n, args=args, kwargs=kwargs, device="cpu",
                          store_dir=str(tmp_path), timeout=600)


def _payload(w):
    return {"model": {k: v.detach().clone()
                      for k, v in w.model.state_dict().items()},
            "aux": {k: v.detach().clone()
                    for k, v in w.state.aux().items()}}


def _tight(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    # a floor for what exact arithmetic leaves at 0 (BYOL's residue
    # biases, the predictor BN's running mean): rounding noise either side
    bound = max(1e-5 * np.abs(want).max(), 1e-7)
    assert np.abs(got - want).max() <= bound, (name, np.abs(got - want)
                                               .max(), bound)


def _hold_to_one_rank(two, one):
    """W = 2's steps against W = 1's: (trainable, aux, metrics) each."""
    for i, ((tr2, aux2, m2), (tr1, aux1, m1)) in enumerate(zip(two, one)):
        assert set(m2) == set(m1)
        for k, v in m1.items():
            assert abs(m2[k] - v) <= 1e-5 * max(abs(v), 1e-3), (i, k)
        for n, t in tr1.items():
            _tight(f"step {i} {n}", tr2[n], t)
        for n, t in aux1.items():
            _tight(f"step {i} aux {n}", aux2[n], t)


# --------------------------------------------------------------------------- #
# the SSL objectives
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def ssl_cases():
    """Each objective's JAX step, the port's W = 1 step and the W = 2
    inputs, from one JAX init."""
    cases = {}
    # BYOL, b8
    params = hb._params(1, False)
    views = hb._views(1)
    init, jstates = hb._jax_run(params, True, views)
    st, port = hb._port_run(params, True, init, views)
    p = copy.deepcopy(params)
    p.system_params.device = "cpu"
    w = hb.tb.BYOLWrapper(copy.deepcopy(p), use_momentum=True)
    w.instantiate()
    hb._port_state(w, st)
    cases["byol"] = dict(params=p, payload=_payload(w), batches=views,
                         calls=[{"lr": hb.LR, "momentum": hb.MOMENTA[0]}],
                         jax=jstates, st=st, port=port)
    # DINO v1, b4
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
    cases["dino"] = dict(params=p, payload=_payload(w), batches=crops,
                         calls=[dict(lr=hd.LR, wd=wd, momentum=mom,
                                     teacher_temp=tt, freeze=freeze)],
                         jax=jstates, st=st, port=port)
    # DINOv2, b4: softmax centering, Sinkhorn-Knopp, and in bf16 with the
    # recipe's LayerScale (the harness's 1.0 is for its f32 weights)
    for name, centering in (("dinov2", "centering"),
                            ("dinov2_sk", "sinkhorn_knopp"),
                            ("dinov2_bf16", "centering")):
        params = hd2._params(False, 1, 16)
        params.model_params.dinov2.centering = centering
        if name == "dinov2_bf16":
            params.training_params.use_mixed_precision = True
            params.model_params.transformers_params.student.layerscale = \
                1e-5
        batches = hd2._batches(1)
        init, jstates = hd2._jax_run(params, batches)
        st, port = hd2._port_run(params, init, batches)
        cases[name] = dict(params=_dinov2_params(params), st=st,
                           payload=_dinov2_payload(params, st),
                           batches=batches, calls=[_d2_call(0)],
                           jax=jstates, port=port)
    return cases


def _dinov2_params(params):
    p = copy.deepcopy(params)
    p.system_params.device = "cpu"
    return p


def _dinov2_payload(params, st):
    w = hd2.td.DINOv2Wrapper(_dinov2_params(params))
    w.instantiate()
    w.model.load_state_dict({**st["frozen"], **st["trainable"]})
    with torch.no_grad():
        for n, v in st["teacher"].items():
            w.state.teacher[n].copy_(v)
        w.state.dino_center.copy_(st["dino_center"])
        w.state.ibot_center.copy_(st["ibot_center"])
    return _payload(w)


def _d2_call(i):
    mom, tt, freeze = hd2.SCHEDULE[i]
    return dict(lr=hd2.LR, wd=hd2.WD, momentum=mom, teacher_temp=tt,
                freeze=freeze)


@pytest.fixture(scope="module")
def ssl_two_ranks(ssl_cases, tmp_path_factory):
    """Every case at W = 2, in one group."""
    names = list(ssl_cases)
    calls = [("ssl_steps_run", ("dinov2" if name.startswith("dinov2")
                                else name, c["params"], c["payload"],
                                c["batches"], c["calls"]), {})
             for name, c in ssl_cases.items()]
    out = _launch(runs.sequence, 2, tmp_path_factory.mktemp("ssl"), calls)
    return dict(zip(names, out))


def _port_steps(name, port):
    """A harness's port steps as (trainable, aux-like, metrics)."""
    if name == "byol":
        return [(tr, {**{f"teacher.{n}": t for n, t in te.items()},
                      **{f"model_state.{n}": t for n, t in ms.items()}}, m)
                for tr, te, ms, m in port]
    if name == "dino":
        return [(tr, {**{f"teacher.{n}": t for n, t in te.items()},
                      "center": c}, m) for tr, te, c, m in port]
    return [(tr, {**{f"teacher.{n}": t for n, t in te.items()},
                  "dino_center": dc, "ibot_center": ic}, m)
            for tr, te, dc, ic, m in port]


@pytest.mark.parametrize("name", ["byol", "dino", "dinov2", "dinov2_sk"])
def test_ssl_step_two_ranks(ssl_cases, ssl_two_ranks, name):
    c = ssl_cases[name]
    two = ssl_two_ranks[name]
    one = _port_steps(name, c["port"])
    _hold_to_one_rank(two, one)
    # and against JAX's 1-device step, as the harness holds W = 1
    tr2, aux2, m2 = two[0]
    if name == "byol":
        port2 = [(tr2, {n[len("teacher."):]: t for n, t in aux2.items()
                        if n.startswith("teacher.")},
                  {n[len("model_state."):]: t for n, t in aux2.items()
                   if n.startswith("model_state.")}, m2)]
        hb._check_steps(True, c["st"], port2, c["jax"])
    elif name == "dino":
        port2 = [(tr2, {n[len("teacher."):]: t for n, t in aux2.items()
                        if n.startswith("teacher.")}, aux2["center"], m2)]
        hd._check_steps(c["st"], port2, c["jax"])
    else:
        port2 = [(tr2, {n[len("teacher."):]: t for n, t in aux2.items()
                        if n.startswith("teacher.")}, aux2["dino_center"],
                  aux2["ibot_center"], m2)]
        hd2._check_steps(c["st"], port2, c["jax"])
    if name == "dinov2":
        assert m2["koleo_loss"] > 0


def test_koleo_bf16_pinned_one_and_two_ranks(ssl_cases, ssl_two_ranks):
    """ROADMAP C 2: KoLeo under bf16 through the DINOv2 harness: the
    port's term equals JAX's at W = 1, and the global-batch KoLeo at W = 2
    equals it."""
    c = ssl_cases["dinov2_bf16"]
    want = c["jax"][0][1]["koleo_loss"]
    got1 = c["port"][0][4]["koleo_loss"]
    got2 = ssl_two_ranks["dinov2_bf16"][0][2]["koleo_loss"]
    assert got1 == pytest.approx(want, rel=1e-6, abs=0), (got1, want)
    assert got2 == pytest.approx(want, rel=1e-6, abs=0), (got2, want)


# --------------------------------------------------------------------------- #
# the loaders
# --------------------------------------------------------------------------- #

class _Toy:
    """Records whose pixels and labels follow the index."""

    def __len__(self):
        return 10

    def __getitem__(self, i, rng=None):
        img = np.full((4, 4, 3), float(i), np.float32) \
            + rng.random((4, 4, 3)).astype(np.float32)
        return {"image": img, "label": i % 5}


@pytest.mark.parametrize("accum", [1, 2])
def test_mixup_collate_rank_rows(accum):
    from apla_tpu_torch.data.loader import DataLoader
    from apla_tpu_torch.data.mixup import AdvancedAugCollate
    aug = {"mixup_alpha": 0.8, "cutmix_alpha": 1.0, "prob": 1.0,
           "switch_prob": 0.5, "num_classes": 5}

    def batches(mesh=None):
        # the train loader's last batch of 2 splits into 2 micro-batches
        # over 2 ranks only whole: accumulation drops it, as recipes do
        loader = DataLoader(_Toy(), batch_size=8, shuffle=True,
                            drop_last=accum > 1, num_workers=0,
                            collate_fn=AdvancedAugCollate(aug))
        if mesh is not None:
            loader.shard(mesh, accum)
        out = []
        for epoch in range(3):          # cutmix and mixup both drawn
            loader.set_epoch(epoch)
            out += list(loader)
        return out

    full = batches()
    loaded = []

    class _Count(_Toy):
        def __getitem__(self, i, rng=None):
            loaded.append(i)
            return super().__getitem__(i, rng)

    from apla_tpu_torch.parallel.mesh import padded_rows, rank_rows
    for r in range(2):
        mesh = Mesh(world=2, rank=r)
        part = batches(mesh)
        for b_full, b_rank in zip(full, part):
            n = b_full["label"].shape[0]
            rows = rank_rows(padded_rows(n, 2), mesh, accum)
            src = torch.as_tensor(np.minimum(rows, n - 1))
            assert torch.equal(b_rank["image"], b_full["image"][src])
            assert torch.equal(b_rank["label"], b_full["label"][src])
            assert b_rank["valid"].tolist() == (rows < n).tolist()
    # a rank loads its rows and their partners: at most 2 / W of a batch
    from apla_tpu_torch.data.loader import DataLoader as DL
    loader = DL(_Count(), batch_size=8, num_workers=0,
                collate_fn=AdvancedAugCollate(aug)).shard(
        Mesh(world=2, rank=0), accum)
    next(iter(loader))
    assert len(loaded) <= 8


def test_ibot_collate_rank_rows():
    """Each rank's iBOT buffers hold the global collate's masks of its
    rows; the masked patches of both ranks are the global set."""
    from apla_tpu_torch.ssl.dinov2 import (IBotCollate, MaskingGenerator,
                                           ibot_mask_rows)
    collate = IBotCollate(2, 2, (0.1, 0.5), 0.5, 16,
                          MaskingGenerator((4, 4), max_num_patches=8),
                          seed=3)
    rng = np.random.default_rng(0)
    samples = [{"image": [rng.random((8, 8, 3)) for _ in range(4)],
                "label": i} for i in range(4)]
    full = collate(samples, batch_key=(0, 1))
    total = 0
    for r in range(2):
        pos = np.arange(2 * r, 2 * r + 2)
        part = collate.collate_rows([samples[p] for p in pos], pos, 4, None,
                                    batch_key=(0, 1))
        assert np.array_equal(part["collated_masks"],
                              full["collated_masks"][
                                  np.r_[pos, 4 + pos]])
        m = int(part["n_masked_patches"][0])
        flat = part["mask_indices_list"][:m]
        rebuilt = np.zeros(part["collated_masks"].size, bool)
        rebuilt[flat] = True
        assert np.array_equal(rebuilt.reshape(
            part["collated_masks"].shape), part["collated_masks"])
        assert part["mask_valid"].sum() == m
        assert np.array_equal(
            ibot_mask_rows(full, pos, 4, 2, collate.n_masked_max)[
                "mask_indices_list"], part["mask_indices_list"])
        total += m
    assert total == int(full["n_masked_patches"][0])


# --------------------------------------------------------------------------- #
# the side-car loops
# --------------------------------------------------------------------------- #

def _metrics(save_dir, run_name):
    rows = [json.loads(line) for line in open(
        os.path.join(save_dir, f"{run_name}.metrics.jsonl"))]
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    evals = [r for r in rows if "train_loss" not in r]
    return losses, evals


def test_detection_two_ranks_fsdp(tmp_path):
    """`det` with a three-stage Swin at 112 px (its stage-2 MLP kernels
    pass JAX's 2^16 threshold: FSDP shards them) at `--n_devices 2
    --param_sharding fsdp` against `--n_devices 1`."""
    from apla_tpu_torch import segdet
    from tests.test_torch_segdet import make_coco
    img_dir, ann = make_coco(tmp_path, n_images=4, size=(112, 112))
    kw = dict(img_size=112, batch_size=2, lr=1e-3, embed_dim=32,
              depths=(2, 2, 2), num_heads=(1, 2, 4), num_workers=0,
              log_every=1, device="cpu", epochs=1)
    one = segdet.train_detection(img_dir, ann, save_dir=str(tmp_path / "1"),
                                 **kw)
    two = segdet.train_detection(img_dir, ann, save_dir=str(tmp_path / "2"),
                                 n_devices=2, param_sharding="fsdp", **kw)
    l1, e1 = _metrics(tmp_path / "1", "det")
    l2, e2 = _metrics(tmp_path / "2", "det")
    assert len(l1) == 2
    np.testing.assert_allclose(l2, l1, rtol=1e-4)
    assert [r["train_map50"] for r in e2] == [r["train_map50"] for r in e1]
    assert two["best_map50"] == one["best_map50"]
    best = segdet.load_checkpoint(str(tmp_path / "2" / "det_best.pt"))
    ref = segdet.load_checkpoint(str(tmp_path / "1" / "det_best.pt"))
    for n, t in ref["frozen"].items():       # written whole by rank 0
        assert torch.equal(best["frozen"][n], t), n


SEG_VIT = dict(img_size=32, patch_size=8, embed_dim=64, depth=2,
               num_heads=4)
SEG_KW = dict(img_size=32, patch_size=8, batch_size=2, lr=1e-3, channels=16,
              num_workers=0, log_every=1, epochs=2)


def test_segmentation_matches_jax_and_two_ranks(tmp_path, monkeypatch):
    """ROADMAP C 1: the port's loop against the JAX loop, then at two
    ranks under `fsdp`."""
    import apla_tpu.models.seg as jseg
    from apla_tpu import segdet as jsegdet
    from apla_tpu.models.vit import ViTConfig as JViTConfig
    from apla_tpu_torch import segdet
    from apla_tpu_torch.models.vit import ViTConfig
    from apla_tpu_torch.utils.pretrained import seg_state_from_jax
    from tests.test_torch_segdet import make_ade

    root = make_ade(tmp_path / "ade")
    captured = {}
    original = jseg.init_segmenter

    def capture(*a, **k):
        trees = original(*a, **k)
        # copied now: the JAX step donates its input buffers
        captured["trees"] = jax.tree.map(np.array, trees)
        return trees

    monkeypatch.setattr(jseg, "init_segmenter", capture)
    jout = jsegdet.train_segmentation(
        root, save_dir=str(tmp_path / "jax"),
        vit_cfg=JViTConfig(compute_dtype=jnp.float32, **SEG_VIT), **SEG_KW)
    jl, je = _metrics(tmp_path / "jax", "seg")
    trainable, frozen = seg_state_from_jax(
        *captured["trees"])
    cfg = ViTConfig(compute_dtype=torch.float32, **SEG_VIT)
    results = []
    for n_devices in (1, 2):
        ck = str(tmp_path / f"port{n_devices}")
        segdet._save(ck, "seg_last", trainable, frozen,
                     {"epoch": -1, "miou": -1.0})
        out = segdet.train_segmentation(
            root, save_dir=ck, vit_cfg=cfg, resume=True, device="cpu",
            n_devices=n_devices,
            param_sharding="fsdp" if n_devices == 2 else "replicated",
            **SEG_KW)
        results.append((out,) + _metrics(ck, "seg"))
    assert len(jl) == 4 and len(je) == 2
    for out, losses, evals in results:
        np.testing.assert_allclose(losses, jl, rtol=1e-4)
        assert [r["val_miou"] for r in evals] == pytest.approx(
            [r["val_miou"] for r in je], abs=1e-5)
        assert out["best_miou"] == pytest.approx(jout["best_miou"],
                                                 abs=1e-5)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-5)
