"""chip_smoke.py holds the shipped recipes and refuses to run here.

The script builds its models and its training runs from Python dicts (the
card's machine has no PyYAML); every value in them must be the ImageNet
ViT-B APLA-128 recipe's and the ISIC2019 DINOv2 recipe's as
`load_merged_params` reads them, and every change the script makes is in
its cuts dicts.  Without a CUDA device the script must exit non-zero and
print no `"ok": true` line.  Its supervised, SSL, full-projection,
detection, segmentation and real-weights phases (5, 6b, 7b, 8b, 9b, 11,
12) are rehearsed here on tiny models, with the kernels' plain versions
counted as launches; the segmentation recipe is held against the JAX
`segdet seg` CLI, and phase 12's recipes against the ImageNet YAML as
shipped (`pretrained: true`).
"""

import copy
import dataclasses
import importlib.util
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch.wrapper import build_apla_config, build_vit_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE_YML = "params/finetune/dinov2/ImageNet/vit_b/apla.yml"
SSL_YML = "params/pretrain/dinov2/ISIC2019/vit_b/apla.yml"
# Phase 11's bounds for the tiny model on the CPU (|dloss|, worst
# ||de||/||e|| over the backbone's calls, worst backbone ||dg||/||g||
# under the plain arm's head cotangent), at the recipe's LayerScale 1e-5:
# it reads |dloss| 0, embeddings 0 and a worst gradient error of 0.0022
# (BYOL), 0.0026 (SimSiam) and 7.5e-5 (DINO), so the rehearsal holds the
# gradients about 5x above those; the controls read 8.7e-6-9.0e-6 in the
# embeddings (forward halved), 0.050 and 0.89-1.0 in the gradients, and
# must still fail them.
V1_CPU_TOLS = {"byol": (1e-4, 1e-6, 0.011), "simsiam": (1e-4, 1e-6, 0.013),
               "dino": (1e-4, 1e-6, 3.75e-4)}

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_fields(params):
    mp = params["model_params"]
    tp = mp["transformers_params"]
    return {
        "backbone_type": mp["backbone_type"],
        "transformers_params": {
            k: tp[k] for k in ("img_size", "patch_size",
                               "is_memory_efficient", "gelu_tanh",
                               "use_fused_apla", "block_conf")},
        "adaptation": mp["adaptation"],
        "use_mixed_precision": params["training_params"][
            "use_mixed_precision"],
    }


def test_recipe_dict_matches_yaml():
    smoke = _chip_smoke()
    yml = load_merged_params(os.path.join(ROOT, RECIPE_YML))
    assert _model_fields(smoke.RECIPE) == _model_fields(yml)
    # and the configs the port derives from either are the same model;
    # 518 is the pos-embed grid, the smoke test serves the 224 crop
    assert build_vit_config(smoke.RECIPE) == build_vit_config(yml)
    assert build_apla_config(smoke.RECIPE) == build_apla_config(yml)
    cfg = build_vit_config(yml)
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.patch_size) == \
        (768, 12, 12, 14)
    assert (smoke.SERVE_IMG // cfg.patch_size) ** 2 + 1 == 257
    assert cfg.img_size == 518


def _subdict_mismatches(part, whole, path=""):
    """Paths where `part` is not a sub-dict of `whole` (lists as values)."""
    if isinstance(part, dict):
        if not isinstance(whole, dict):
            return [path]
        return [p for k, v in part.items()
                for p in _subdict_mismatches(v, whole.get(k, _MISSING),
                                             f"{path}.{k}")]
    if isinstance(part, (list, tuple)):
        return [] if list(part) == list(whole) else [path]
    return [] if part == whole else [path]


_MISSING = object()


def test_recipe_dict_is_the_yaml():
    """Every field of RECIPE, the training fields included (optimizer,
    schedule, clip, accum, batch, loaders, device augmentation, mixup), has
    the YAML's value; the training phase's changes are only in
    SMOKE_CUTS."""
    smoke = _chip_smoke()
    yml = load_merged_params(os.path.join(ROOT, RECIPE_YML))
    assert _subdict_mismatches(smoke.RECIPE, yml) == []
    tp = smoke.RECIPE["training_params"]
    assert (tp["accum_steps"], tp["grad_clipping"]) == (8, 1.0)
    assert smoke.RECIPE["dataset_params"]["device_augment"] is True
    assert set(smoke.SMOKE_CUTS) == {"dataset_params", "training_params"}
    assert smoke.SMOKE_CUTS["dataset_params"]["synthetic_classes"] == 1000


def test_ssl_recipe_dict_is_the_yaml():
    """Every field of SSL_RECIPE has the ISIC2019 DINOv2 recipe's value;
    phase 6b's changes are all in SSL_CUTS, and the run they give is the
    ViT-B/14 APLA-128 DINO + iBOT recipe the script claims."""
    from apla_tpu_torch.ssl.dinov2 import DINOv2Wrapper
    smoke = _chip_smoke()
    yml = load_merged_params(os.path.join(ROOT, SSL_YML))
    assert _subdict_mismatches(smoke.SSL_RECIPE, yml) == []
    cuts = smoke.SSL_CUTS
    assert cuts["dataset_params"] == {
        "dataset": "Synthetic", "synthetic_classes": 8,
        "synthetic_size": 256, "synthetic_img_size": 256,
        "device_augment": True}
    assert cuts["model_params"]["pretrained"] is False
    apla = cuts["model_params"]["adaptation"]["params"]
    assert apla["partial_size"] == 128
    assert apla["inds_path"] == yml.model_params.adaptation.params.inds_path
    assert cuts["training_params"] == {"epochs": 1, "log_every": 1}
    assert set(cuts) == {"dataset_params", "model_params",
                         "training_params"}
    # what the port builds from the recipe with its cuts
    params = smoke._run_params(smoke.SSL_RECIPE, cuts, "/nonexistent",
                               torch.device("cpu"))
    w = DINOv2Wrapper(params)
    cfg = w.build_vit_config()
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.patch_size,
            cfg.img_size) == (768, 12, 12, 14, 518)
    assert cfg.gelu_tanh and cfg.use_fused_apla and cfg.has_layerscale
    assert cfg.layerscale_init == 1e-5
    w.set_crops_params()
    assert dict(w.crops_params) == {"n_global_crops": 2, "n_local_crops": 8,
                                    "global_crops_size": 224,
                                    "local_crops_size": 98}
    d2 = params["model_params"]["dinov2"]
    assert d2["fused_proto_ce"] == "ibot"
    assert d2["dino"]["head_n_prototypes"] == 65536
    assert (224 // 14) ** 2 + 1 == 257 and (98 // 14) ** 2 + 1 == 50
    # the iBOT buffer at b64: 2 global crops x 64 x ceil(256 * 0.5)
    assert 2 * 64 * 128 == smoke.PROTO_CASES[0][0]


def test_full_recipe_dict_is_the_yaml():
    """FULL_RECIPE is the ImageNet recipe, value by value, with the
    adaptation of the ISIC2019 recipe: `partial_size: "full"` and no index
    file; the port builds ViT-B/14 from it with the memory-efficient
    attention on (`is_memory_efficient: true`)."""
    smoke = _chip_smoke()
    yml = load_merged_params(os.path.join(ROOT, RECIPE_YML))
    ssl = load_merged_params(os.path.join(ROOT, SSL_YML))
    full = smoke.FULL_RECIPE
    assert _subdict_mismatches(full, yml) == [
        ".model_params.adaptation.params.partial_size"]
    assert full["model_params"]["adaptation"] == {
        "mode": yml.model_params.adaptation.mode,
        "params": {"partial_size":
                   ssl.model_params.adaptation.params.partial_size}}
    assert full["model_params"]["adaptation"]["params"]["partial_size"] \
        == "full"
    assert smoke.RECIPE["model_params"]["adaptation"]["params"][
        "partial_size"] == 128            # RECIPE itself is left as it was
    cfg = build_vit_config(full)
    assert cfg == build_vit_config(yml)
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.patch_size,
            cfg.img_size) == (768, 12, 12, 14, 518)
    assert cfg.use_flash and cfg.use_fused_apla and cfg.gelu_tanh
    assert (cfg.has_layerscale, cfg.layerscale_init) == (True, 1.0)
    apla = build_apla_config(full)
    assert (apla.partial_size, apla.inds_path) == ("full", None)
    # phase 7b's training cuts: SMOKE_CUTS, loaders in-process
    cuts = copy.deepcopy(smoke.FULL_CUTS)
    assert {k: v["num_workers"] for k, v in
            cuts.pop("dataloader_params").items()} == {
        "trainloader": 0, "valloader": 0, "testloader": 0}
    assert cuts == smoke.SMOKE_CUTS


def _tiny_recipe(recipe):
    """`recipe` cut to a 12-block ViT-Ti/8 at 32 px, b16, in-process
    loaders (the adaptation is the caller's)."""
    tiny = copy.deepcopy(recipe)
    mp = tiny["model_params"]
    mp["backbone_type"] = "vit_tiny"
    mp["transformers_params"].update(img_size=[32], patch_size=8)
    dp = tiny["dataset_params"]
    resize = {"apply": True, "height": 40, "width": 40}
    dp["train_transforms"]["Resize"] = resize
    dp["train_transforms"]["RandomResizedCrop"]["size"] = 32
    dp["val_transforms"] = dp["test_transforms"] = {
        "Resize": resize, "CenterCrop": {"apply": True, "height": 32,
                                         "width": 32}, "Normalize": True}
    for ld in tiny["dataloader_params"].values():
        ld.update(batch_size=16, num_workers=0)
    return tiny


_TINY_CUTS = {
    "dataset_params": {"dataset": "Synthetic", "synthetic_classes": 10,
                       "synthetic_size": 64, "synthetic_img_size": 40},
    "training_params": {"epochs": 1, "val_every": 1.0, "log_every": 1}}


def test_full_phase_rehearsal(monkeypatch):
    """Phase 7b on the tiny model at `partial_size: "full"` on the CPU:
    served (12 attention calls per served call, the kernel arm within the
    slice bounds of the plain arm, two forward faults outside them) and
    trained (12 forwards per micro-step and eval call, 11 backwards per
    micro-step: block 0's attention has no trainable input; finite losses,
    frozen kept, all 24 projection tensors and the head moved, the
    checkpoint, the gradient bounds and their two backward faults)."""
    smoke = _chip_smoke()
    tiny = _tiny_recipe(smoke.FULL_RECIPE)
    assert tiny["model_params"]["adaptation"]["params"] == {
        "partial_size": "full"}
    monkeypatch.setattr(smoke, "FULL_RECIPE", tiny)
    monkeypatch.setattr(smoke, "FULL_CUTS", _TINY_CUTS)
    monkeypatch.setattr(smoke, "SERVE_IMG", 32)
    monkeypatch.setattr(smoke, "N_CLASSES", 10)
    monkeypatch.setattr(smoke, "REQUESTS", (1, 9, 20))
    monkeypatch.setattr(smoke, "BATCH_SIZES", (1, 8))
    monkeypatch.setattr(smoke, "_time_ms", lambda fn, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "_train_rate", lambda *a: (1.0, 0.0))
    monkeypatch.setattr(smoke, "_profile_step",
                        lambda fn: (1.0, 1.0, {}, [], []))
    _count_plain_versions(monkeypatch)
    # the script's gradient bounds are set from ViT-B's readings on the
    # card; this model on the CPU reads |dloss| 4.2e-4 and a worst
    # per-tensor gradient error of 0.0103, so the rehearsal holds it about
    # 7x above those (the controls read 0.78 and 0.53 and must still fail)
    monkeypatch.setattr(smoke, "LOSS_TOL", 3e-3)
    monkeypatch.setattr(smoke, "GRAD_REL_TOL", 0.08)
    serve, train = smoke.phase_full(torch.device("cpu"))
    n_calls = 1 + 2 + 3               # 1 -> b1; 9 -> b8 + b1; 20 -> 8, 8, 8
    assert serve[0] == 12 * n_calls
    launches, rates, profiles = train
    assert launches == (12 * (4 * 8 + 8), 11 * 4 * 8)
    assert set(rates) == {("plain", 8), ("plain", 1), ("kernel", 8),
                          ("kernel", 1)}
    assert set(profiles) == {8, 1}


def _tiny_ssl(smoke, monkeypatch):
    """SSL_RECIPE cut to the tiny synthetic DINOv2 model (ViT-Ti/8 at 32 px,
    1024 prototypes of 64), b16, 4 steps, in-process loaders, with the
    rehearsal's bounds."""
    tiny = copy.deepcopy(smoke.SSL_RECIPE)
    mp = tiny["model_params"]
    mp["backbone_type"] = "vit_tiny"
    mp["transformers_params"]["student"].update(pre_img_size=32,
                                                patch_size=8)
    for h in ("dino", "ibot"):
        mp["dinov2"][h].update(head_n_prototypes=1024,
                               head_bottleneck_dim=64, head_hidden_dim=256)
    dp = tiny["dataset_params"]
    dp.update(ssl_global_size=32, ssl_local_size=16)
    resize = {"apply": True, "height": 32, "width": 32}
    dp["train_transforms"]["Resize"] = resize
    dp["val_transforms"] = dp["test_transforms"] = {
        "Resize": resize, "CenterCrop": {"apply": True, "height": 32,
                                         "width": 32}, "Normalize": True}
    for ld in tiny["dataloader_params"].values():
        ld.update(batch_size=16, num_workers=0)
    cuts = copy.deepcopy(smoke.SSL_CUTS)
    cuts["dataset_params"].update(synthetic_size=64, synthetic_img_size=32)
    cuts["model_params"]["adaptation"]["params"] = {"partial_size": 16}
    del tiny["model_params"]["adaptation"]["params"]["inds_path"]
    monkeypatch.setattr(smoke, "SSL_RECIPE", tiny)
    monkeypatch.setattr(smoke, "SSL_CUTS", cuts)
    monkeypatch.setattr(smoke, "_ssl_rate",
                        lambda *a: (1.0, 0.0, (lambda *b: None, None, None)))
    monkeypatch.setattr(smoke, "_profile_step",
                        lambda fn: (1.0, 1.0, {}, [], []))
    # the script's bounds are set from ViT-B's readings on the card; this
    # model on the CPU reads |dloss|/|loss| 4.4e-5 (ibot_loss) and a worst
    # per-tensor gradient error of 0.0020, so the rehearsal holds it about
    # 5x above those (the controls read 0.27 and 0.32 and must still fail)
    monkeypatch.setattr(smoke, "SSL_LOSS_REL_TOL", 2.5e-4)
    monkeypatch.setattr(smoke, "SSL_GRAD_REL_TOL", 0.01)


def _count_plain_versions(monkeypatch):
    """On CPU tensors the wrappers run the plain versions, which count
    here as the kernels' launches."""
    from apla_tpu_torch.ops import fused_apla_attn as fa
    from apla_tpu_torch.ops import fused_swin_attn as fs
    from apla_tpu_torch.ops import int8_matmul as im
    from apla_tpu_torch.ops import mha
    from apla_tpu_torch.ops import proto_ce as pc

    def counting(module, ref, wrapper):
        fn = getattr(module, ref)

        def counted(*args, **kwargs):
            getattr(module, wrapper).launches += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, ref, counted)

    for module, names in ((fa, ("fused_apla_attn_fwd",
                                "fused_apla_attn_bwd")),
                          (pc, ("proto_ce_fwd", "proto_ce_dxs",
                                "proto_ce_dws")),
                          (mha, ("mha_fwd", "mha_bwd")),
                          (fs, ("fused_swin_attn_fwd",
                                "fused_swin_attn_bwd")),
                          (im, ("fused_int8_matmul",))):
        for name in names:
            # the counts go back to what they were when the test ends
            monkeypatch.setattr(getattr(module, name), "launches", 0)
            counting(module, f"{name}_reference", name)


def test_ssl_phase_rehearsal(monkeypatch):
    """Phase 6b on the tiny DINOv2 model on the CPU: the launch counts
    (36 fused forwards, 24 backwards and one of each prototype-CE kernel
    per step, 12 forwards per kNN embed call), finite loss terms, frozen
    weights kept, the teacher and centers moved, the checkpoint, and the
    fused-vs-plain bounds with their two backward faults."""
    smoke = _chip_smoke()
    _tiny_ssl(smoke, monkeypatch)
    _count_plain_versions(monkeypatch)
    launches, rates = smoke.phase_ssl(torch.device("cpu"))
    embed_calls = 2 * 4 + 4 + 4
    assert launches == (12 * (3 * 4 + embed_calls), 12 * 2 * 4, 4, 4, 4)
    assert set(rates) == {"plain", "fused"}


def _jax_vit_fields(jcfg, tcfg):
    """The fields a JAX ViTConfig and the port's share, as (JAX, port)
    pairs that differ; dtypes compared by name."""
    out = {}
    for f in dataclasses.fields(tcfg):
        if not hasattr(jcfg, f.name):
            continue
        j, t = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "compute_dtype":
            j, t = np.dtype(j).name, str(t).removeprefix("torch.")
        if j != t:
            out[f.name] = (j, t)
    return out


@pytest.mark.parametrize("objective", ["byol", "simsiam", "dino"])
def test_v1_recipes_are_what_the_jax_wrappers_build(objective):
    """BYOL_RECIPE and DINO_RECIPE with V1_CUTS: the JAX wrappers build
    from the same dicts the ViT config, APLA config, crops and DINO
    arguments the port's wrappers do; the backbone is phase 6b's (ViT-B/14
    at the 518 grid, LayerScale 1e-5, tanh GELU, bf16, fused APLA-128 from
    the ISIC2019 index file, AdamW, clip 3.0, b64, device crops), the crops
    are 2 x 224 (+ 8 x 96 for DINO: 37 tokens)."""
    from apla_tpu.ssl import byol as jb
    from apla_tpu.ssl import dino as jd
    from apla_tpu_torch.ssl.byol import BYOLWrapper
    from apla_tpu_torch.ssl.dino import DINOWrapper
    from apla_tpu_torch.ssl.multicrop import resolve_strategy_spec
    smoke = _chip_smoke()
    recipe = smoke.DINO_RECIPE if objective == "dino" else smoke.BYOL_RECIPE
    params = smoke._run_params(recipe, smoke.V1_CUTS, "/nonexistent",
                               torch.device("cpu"))
    if objective == "dino":
        jw, tw = jd.DINOWrapper(params), DINOWrapper(params)
    else:
        momentum = objective == "byol"
        jw = jb.BYOLWrapper(params, use_momentum=momentum)
        tw = BYOLWrapper(params, use_momentum=momentum)
    tcfg = build_vit_config(tw.parameters)
    assert _jax_vit_fields(jw.build_vit_config(), tcfg) == {}
    assert (tcfg.embed_dim, tcfg.depth, tcfg.num_heads, tcfg.patch_size,
            tcfg.img_size) == (768, 12, 12, 14, 518)
    assert tcfg.gelu_tanh and tcfg.use_fused_apla and not tcfg.use_flash
    assert (tcfg.has_layerscale, tcfg.layerscale_init) == (True, 1e-5)
    assert str(tcfg.compute_dtype) == "torch.bfloat16"
    japla, tapla = jw.build_apla_config(), build_apla_config(tw.parameters)
    assert (japla.partial_size, japla.inds_path) == \
        (tapla.partial_size, tapla.inds_path) == (
            128, os.path.join(ROOT, "params/pretrain/dinov2/ISIC2019/vit_b/"
                                    "inds-vit_b-rand_128.json"))
    spec = resolve_strategy_spec(tw.parameters, tw.strategy_name)
    assert [kind for kind, _ in spec["crops"]] == ["global"] * 2 + (
        ["local"] * 8 if objective == "dino" else [])
    assert (spec["global_size"], spec["local_size"]) == (
        (224, 96) if objective == "dino" else (224, None))
    assert (224 // 14) ** 2 + 1 == 257 and (96 // 14) ** 2 + 1 == 37
    assert smoke.V1_KERNEL_SHAPE == (8 * 64, 37, 3 * 768)
    tp = tw.training_params
    assert (tp.grad_clipping, tp.epochs, tp.log_every) == (3.0, 1, 1)
    opt = tw.optimization_params.default.optimizer
    assert (opt.type, opt.params.lr) == ("AdamW", 0.001)
    dp = tw.dataset_params
    assert (dp.dataset, dp.synthetic_size, dp.synthetic_img_size,
            dp.device_augment) == ("Synthetic", 128, 256, True)
    assert {ld.batch_size for ld in tw.dataloader_params.values()} == {64}
    if objective == "dino":
        assert tw.model_params.DINO == jw.model_params.DINO == {
            "projection_size": 4096, "moving_average_decay": 0.99,
            "warmup_teacher_temp": 0.04, "teacher_temp": 0.07}
    # the rest is SSL_RECIPE's: everything but the backbone's schema, the
    # DINOv2 knobs and DINO's arguments
    ssl = smoke.SSL_RECIPE
    for key in ("dataset_params", "dataloader_params", "optimization_params",
                "system_params"):
        assert recipe[key] == ssl[key], key
    assert {k: v for k, v in recipe["training_params"].items()} == {
        k: v for k, v in ssl["training_params"].items()
        if k != "freeze_last_layer_epochs"}


def _tiny_v1(smoke, monkeypatch):
    """BYOL_RECIPE and DINO_RECIPE cut to the tiny synthetic model
    (ViT-Ti/8 at 32 px: 32-px global and 16-px local crops, APLA-16), b16,
    4 steps, in-process loaders."""
    for name in ("BYOL_RECIPE", "DINO_RECIPE"):
        tiny = copy.deepcopy(getattr(smoke, name))
        mp = tiny["model_params"]
        mp["backbone_type"] = "vit_tiny"
        mp["transformers_params"].update(img_size=[32], patch_size=8)
        del mp["adaptation"]["params"]["inds_path"]
        dp = tiny["dataset_params"]
        dp.update(ssl_global_size=32, ssl_local_size=16)
        resize = {"apply": True, "height": 32, "width": 32}
        dp["train_transforms"]["Resize"] = resize
        dp["val_transforms"] = dp["test_transforms"] = {
            "Resize": resize, "CenterCrop": {"apply": True, "height": 32,
                                             "width": 32}, "Normalize": True}
        for ld in tiny["dataloader_params"].values():
            ld.update(batch_size=16)
        monkeypatch.setattr(smoke, name, tiny)
    cuts = copy.deepcopy(smoke.V1_CUTS)
    # stored at the raw size the wrappers decode to, int(32 * 8 / 7), as
    # phase 11 stores its images at 256 for its 224 crops
    cuts["dataset_params"].update(synthetic_size=64, synthetic_img_size=36)
    cuts["model_params"]["adaptation"]["params"] = {"partial_size": 16}
    monkeypatch.setattr(smoke, "V1_CUTS", cuts)


def test_ssl_v1_phase_rehearsal(monkeypatch):
    """Phase 11 on the tiny model on the CPU, for BYOL, SimSiam and DINO
    v1: the launch counts (per step 4 forwards and 2 backwards in every
    block for BYOL and SimSiam, 3 and 2 for DINO; every block of every kNN
    embed call), finite losses, frozen weights kept, the trainables, the
    teacher (not SimSiam's) and the BN running stats or the center moved,
    the checkpoint reloaded through test(), and the kernel-vs-plain bounds
    with each objective's three faults."""
    smoke = _chip_smoke()
    _tiny_v1(smoke, monkeypatch)
    _count_plain_versions(monkeypatch)
    monkeypatch.setattr(smoke, "_v1_kernels", lambda device: {})
    monkeypatch.setattr(smoke, "_v1_rate",
                        lambda *a: (1.0, 0.0, lambda: None))
    monkeypatch.setattr(smoke, "_profile_step",
                        lambda fn: (1.0, 1.0, {}, [], []))
    # the script's bounds are set from ViT-B's readings on the card
    monkeypatch.setattr(smoke, "V1_TOLS", V1_CPU_TOLS)
    kernels, launches, rates = smoke.phase_ssl_v1(torch.device("cpu"))
    depth, steps, embed_calls = 12, 4, 2 * 4 + 4 + 4
    assert launches == {
        "byol": (depth * (4 * steps + embed_calls), depth * 2 * steps),
        "simsiam": (depth * (4 * steps + embed_calls), depth * 2 * steps),
        "dino": (depth * (3 * steps + embed_calls), depth * 2 * steps)}
    assert set(rates) == {"byol", "simsiam", "dino"}
    assert all(set(r) == {"plain", "kernel"} for r in rates.values())


def test_ssl_v1_rehearsal_resized_images(monkeypatch):
    """Phase 11 on the tiny model with its images stored at 32 px, so that
    the SSL wrappers resize them (BICUBIC) to the raw size they decode at,
    int(32 * 8 / 7) = 36.  There the kernel arm reads a |dloss| past the
    rehearsal's 1e-4 (BYOL 0.0167), which is why `_tiny_v1` stores 36 px.
    This shows where that gap comes from: two runs of the plain arm on
    the resized batch agree exactly (the resize hands every arm the same
    images), and the kernel arm's backbone embeddings agree with the plain
    arm's within the rehearsal's 1e-6, so the loss gap arises in the
    random heads (BatchNorm over near-equal embeddings), after the
    backbone.  The phase's other checks run on the resized images."""
    smoke = _chip_smoke()
    _tiny_v1(smoke, monkeypatch)
    smoke.V1_CUTS["dataset_params"]["synthetic_img_size"] = 32
    _count_plain_versions(monkeypatch)
    monkeypatch.setattr(smoke, "_v1_kernels", lambda device: {})
    monkeypatch.setattr(smoke, "_v1_rate",
                        lambda *a: (1.0, 0.0, lambda: None))
    monkeypatch.setattr(smoke, "_profile_step",
                        lambda fn: (1.0, 1.0, {}, [], []))
    readings = {}

    def readings_only(tag, wrapper, objective, cfg, plain_cfg, images):
        assert tuple(images.shape[1:3]) == (36, 36)
        ref = smoke._v1_grads(wrapper, objective, plain_cfg, images)
        again = smoke._v1_grads(wrapper, objective, plain_cfg, images)
        kernel = smoke._v1_grads(wrapper, objective, cfg, images,
                                 ref["cots"])
        assert again["loss"] == ref["loss"], objective
        for a, b in zip(again["embs"], ref["embs"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for n, g in ref["grads"].items():
            torch.testing.assert_close(again["grads"][n], g, rtol=0, atol=0)
        readings[objective] = (
            abs(kernel["loss"] - ref["loss"]),
            max(smoke._v1_rel(e, r)
                for e, r in zip(kernel["embs"], ref["embs"])))
        return True, True

    monkeypatch.setattr(smoke, "_v1_readings", readings_only)
    _, launches, _ = smoke.phase_ssl_v1(torch.device("cpu"))
    assert set(readings) == set(launches) == {"byol", "simsiam", "dino"}
    print("kernel arm vs plain arm at 32 px stored (|dloss|, worst "
          "||de||/||e||):", readings)
    for objective, (_, emb) in readings.items():
        assert emb <= V1_CPU_TOLS[objective][1], (objective, emb)


def test_training_phase_rehearsal(monkeypatch):
    """Phase 5 on a 12-block ViT-Ti at 32 px (b16, accum 8): counts,
    finite losses, frozen/trainable checks, the checkpoint, the fused-vs-
    plain gradient bounds and their controls, on the CPU."""
    smoke = _chip_smoke()
    tiny = _tiny_recipe(smoke.RECIPE)
    tiny["model_params"]["adaptation"]["params"] = {"partial_size": 16}
    monkeypatch.setattr(smoke, "RECIPE", tiny)
    monkeypatch.setattr(smoke, "SMOKE_CUTS", _TINY_CUTS)
    _count_plain_versions(monkeypatch)
    monkeypatch.setattr(smoke, "_train_rate", lambda *a: (1.0, 0.0))
    # the script's gradient bounds are set from ViT-B's readings on the
    # card; this model on the CPU reads |dloss| 6.6e-4 and a worst
    # per-tensor gradient error of 0.0156, so the rehearsal holds it about
    # 5x above those (the controls read 1.0 and 0.75 and must still fail)
    monkeypatch.setattr(smoke, "LOSS_TOL", 3e-3)
    monkeypatch.setattr(smoke, "GRAD_REL_TOL", 0.08)
    launches, rates = smoke.phase_train(torch.device("cpu"))
    assert launches == (12 * (4 * 8 + 8), 12 * 4 * 8)
    assert set(rates) == {("plain", 8), ("plain", 1), ("fused", 8),
                          ("fused", 1)}
    assert np.isfinite([r for r, _ in rates.values()]).all()


def test_det_recipe_is_the_segdet_recipe():
    """DET_RECIPE is `segdet det --use_fused --bf16` with the four-stage
    Swin-T: the JAX SwinConfig defaults and the JAX loop's optimizer
    settings; the kernels' window batches follow from it."""
    import inspect

    from apla_tpu import segdet as jsegdet
    from apla_tpu.models.swin import SwinConfig
    smoke = _chip_smoke()
    r = smoke.DET_RECIPE
    jcfg = SwinConfig()
    assert (r["embed_dim"], r["depths"], r["num_heads"], r["window_size"],
            r["img_size"]) == (jcfg.embed_dim, tuple(jcfg.depths),
                               tuple(jcfg.num_heads), jcfg.window_size,
                               jcfg.img_size)
    defaults = {k: v.default for k, v in inspect.signature(
        jsegdet.train_detection).parameters.items()}
    assert (r["lr"], r["weight_decay"], r["max_boxes"]) == (
        defaults["lr"], defaults["weight_decay"], defaults["max_boxes"])
    assert r["use_fused"] and r["bf16"] and r["batch_size"] == 16
    windows = {stage: r["batch_size"] * ((56 >> stage) // 7) ** 2
               for stage in range(4)}
    assert windows == {0: 1024, 1: 256, 2: 64, 3: 16}
    assert [case[:2] for case in smoke.SWIN_CASES[:7:2]] == [
        (16, 0), (16, 1), (16, 2), (16, 3)]


def _tiny_det(smoke, monkeypatch):
    """Phase 8b cut to a two-stage Swin (embed 32, depths 2 and 4) at 56 px
    in f32, b4 over 8 written PNGs of 3 categories."""
    monkeypatch.setattr(smoke, "DET_RECIPE", {
        **smoke.DET_RECIPE, "img_size": 56, "embed_dim": 32,
        "depths": (2, 4), "num_heads": (1, 2), "batch_size": 4,
        "bf16": False})
    # the script's bounds are set from Swin-T's bf16 readings on the card;
    # this float32 model on the CPU reads |dloss| 0 and a worst per-tensor
    # gradient error of 1e-8, and dqkv halved moves a gradient by less
    # (0.06 over 4 blocks of a stage, 0.15 over Swin-T's 6) than there
    monkeypatch.setattr(smoke, "DET_GRAD_REL_TOL", 0.02)
    monkeypatch.setattr(smoke, "DET_IMAGES", 8)
    monkeypatch.setattr(smoke, "DET_CLASSES", 3)
    monkeypatch.setattr(smoke, "_det_rates", lambda *a: {("train", "x"):
                                                         (1.0, 0.0)})
    monkeypatch.setattr(smoke, "_profile_step",
                        lambda fn: (1.0, 1.0, {}, [], []))


def test_det_phase_rehearsal(monkeypatch):
    """Phase 8b on a two-stage Swin (embed 32, heads of 32, depths 2 and 4)
    at 56 px on the CPU, b4 over 8 written PNGs: the window kernels (their
    plain versions, counted) in every block of every step and eval call,
    finite losses, frozen kept and every trainable tensor moved, --resume,
    --eval_only, the plain arm, the export and the served detector, the
    W8A8 export (`export_det --quantize_frozen`) served with the int8
    kernel in each qkv, fc1 and fc2 of every call, and the kernel-vs-plain
    bounds with their two backward faults."""
    smoke = _chip_smoke()
    _tiny_det(smoke, monkeypatch)
    _count_plain_versions(monkeypatch)
    launches, rates = smoke.phase_det(torch.device("cpu"))
    depth, steps, evals = 6, 2, 2
    # train, resume, eval-only, then detect at b1 and b8 (one call each);
    # the W8A8 artifact asked for 1 and 8 images (one call each)
    assert launches == (depth * (2 * (steps + evals) + evals + 2),
                        depth * 2 * steps, 3 * depth * 2)
    assert rates == {("train", "x"): (1.0, 0.0)}


def test_det_masks_phase_rehearsal(monkeypatch):
    """Phase 8c on phase 8b's two-stage Swin at 56 px on the CPU, b4 over
    8 written PNGs (polygon, RLE, compressed RLE and no segmentation): the
    first step's kernel arm against the plain arm (the mask loss and the
    mask branch's gradients) with its control, the `--masks` loop trained
    until box and mask mAP@50 read above 0 with the window kernels (their
    plain versions, counted) in every block of every step and eval call,
    --resume, --eval_only equal to the best checkpoint, the served masks
    equal to the in-process decode, `serve eval` equal to the loop, the
    f32 and W8A8 exports."""
    smoke = _chip_smoke()
    _tiny_det(smoke, monkeypatch)
    monkeypatch.setattr(smoke, "DET_MASK_IMAGES", 8)
    monkeypatch.setattr(smoke, "DET_MASK_PROTOS", 8)
    monkeypatch.setattr(smoke, "_gpu_line", lambda: "no card (CPU)")
    _count_plain_versions(monkeypatch)
    (fwd, bwd, int8), readings = smoke.phase_det_masks(torch.device("cpu"))
    depth, steps, evals = 6, 2, 2
    epochs = readings["epochs"]
    assert epochs % smoke.DET_MASK_EPOCHS == 0
    assert readings["steps_to_map"] <= epochs * steps
    assert min(readings["best"]) > 0
    # training, --resume, --eval_only, detect b8, serve eval (one call of
    # the artifact's largest batch, 16)
    assert fwd == depth * ((epochs + 1) * (steps + evals) + evals + 1 + 1)
    assert bwd == depth * (epochs + 1) * steps
    assert int8 == 3 * depth * 2


def test_multilabel_phase_rehearsal(monkeypatch, tmp_path):
    """Phase 14 on the 12-block ViT-Ti at 32 px (b16, accum 8) on the CPU:
    `main` on SyntheticMultiLabel (BCE, the multi-label metrics), rows 1
    and 2 counted in every block of every micro-step and eval call, the
    kernel arm against the plain arm and its control, `--test --knn` on
    the checkpoint, the LAMB run moving every trainable tensor."""
    smoke = _chip_smoke()
    tiny = _tiny_recipe(smoke.RECIPE)
    tiny["model_params"]["adaptation"]["params"] = {"partial_size": 16}
    monkeypatch.setattr(smoke, "RECIPE", tiny)
    cuts = copy.deepcopy(smoke.ML_CUTS)
    assert cuts["dataset_params"]["dataset"] == "SyntheticMultiLabel"
    cuts["dataset_params"].update(synthetic_classes=10, synthetic_size=16,
                                  synthetic_img_size=40)
    monkeypatch.setattr(smoke, "ML_CUTS", cuts)
    monkeypatch.setattr(smoke, "LOSS_TOL", 3e-3)
    monkeypatch.setattr(smoke, "GRAD_REL_TOL", 0.08)
    _count_plain_versions(monkeypatch)
    launches, readings = smoke.phase_multilabel(torch.device("cpu"))
    # per run: 1 update of 8 micro-steps, val and test 1 batch each; the
    # kNN test: the test set evaluated, the bank (1 batch) and the test
    # set embedded
    assert launches == (12 * (2 * (8 + 2) + 3), 12 * 2 * 8)
    assert set(readings["val"]) == {"mAP", "roc_auc", "precision", "recall",
                                    "f1", "accuracy"}
    assert "knn_test_mAP" in readings["knn"]
    assert len(readings["lamb_loss"]) == 1


def test_seg_recipe_is_the_segdet_recipe():
    """SEG_RECIPE is the JAX `segdet seg` at the reference recipe's flags
    (`--backbone vit_large --patch_size 16 --img_size 512 --use_fused
    --aux_heads 3 --head_lr_mult 10`) and the JAX loop's defaults for
    everything else, value by value; the kernels' shape follows from it."""
    import inspect

    from apla_tpu import segdet as jsegdet
    from apla_tpu.models.vit import VIT_BUILDERS as JVIT
    smoke = _chip_smoke()
    r = smoke.SEG_RECIPE
    defaults = {k: v.default for k, v in inspect.signature(
        jsegdet.train_segmentation).parameters.items()}
    for key in ("backbone", "patch_size", "img_size", "batch_size", "lr",
                "weight_decay", "partial_size", "channels"):
        assert r[key] == defaults[key], key
    # the flags the reference recipe passes, through the JAX CLI's parser
    seen = {}
    real = jsegdet.train_segmentation
    try:
        jsegdet.train_segmentation = lambda root, **kw: seen.update(kw) or {}
        jsegdet.main(["seg", "--root", "x", "--backbone", "vit_large",
                      "--patch_size", "16", "--img_size", "512",
                      "--use_fused", "--aux_heads", "3", "--head_lr_mult",
                      "10"])
    finally:
        jsegdet.train_segmentation = real
    for key in ("backbone", "patch_size", "img_size", "batch_size", "lr",
                "aux_heads", "head_lr_mult", "use_fused"):
        assert r[key] == seen[key], key
    jcfg = JVIT[r["backbone"]](img_size=r["img_size"],
                               patch_size=r["patch_size"])
    n = (r["img_size"] // r["patch_size"]) ** 2 + 1
    assert smoke.SEG_KERNEL_CASES[0] == (r["batch_size"], n, jcfg.embed_dim)
    assert smoke.SEG_HEADS == jcfg.num_heads and jcfg.depth == 24


def _tiny_seg(smoke, monkeypatch):
    """Phase 9b cut to a 12-block ViT-Ti at 32 px (patch 8, PUP channels
    16) in f32, b2 over 4 + 9 written images, sliding at 48."""
    monkeypatch.setattr(smoke, "SEG_RECIPE", {
        **smoke.SEG_RECIPE, "backbone": "vit_tiny", "patch_size": 8,
        "img_size": 32, "batch_size": 2, "channels": 16})
    monkeypatch.setattr(smoke, "SEG_TRAIN", 4)
    monkeypatch.setattr(smoke, "SEG_VAL", 9)
    monkeypatch.setattr(smoke, "SEG_SLIDE_SIZE", 48)
    monkeypatch.setattr(smoke, "_seg_rates", lambda *a: {("train", "x"):
                                                         (1.0, 0.0)})
    monkeypatch.setattr(smoke, "_profile_step",
                        lambda fn: (1.0, 1.0, {}, [], []))
    # float32 compute: the script's bounds are set for bf16 on the card;
    # this model in f32 on the CPU reads |dloss| 0 and gradients equal to
    # 1e-6, and the backward and forward faults still fail them
    from apla_tpu_torch import segdet
    bf16_config = segdet.seg_vit_config
    monkeypatch.setattr(segdet, "seg_vit_config", lambda *a, **kw: (
        dataclasses.replace(bf16_config(*a, **kw),
                            compute_dtype=torch.float32)))


def test_seg_phase_rehearsal(monkeypatch):
    """Phase 9b on a 12-block ViT-Ti at 32 px (patch 8, PUP channels 16) on
    the CPU, b2 over 4 + 9 written images: the fused kernels (their plain
    versions, counted) in every block of every step and eval call, finite
    losses, frozen kept and every trainable tensor moved, --resume,
    --eval_only, the sliding-window evaluation, the export and the served
    segmenter, the W8A8 export (`export_seg --quantize_frozen`) served with
    the int8 kernel in each qkv, fc1 and fc2 of every call, and the
    kernel-vs-plain bounds with their two backward and three forward
    faults."""
    smoke = _chip_smoke()
    _tiny_seg(smoke, monkeypatch)
    _count_plain_versions(monkeypatch)
    launches, rates = smoke.phase_seg(torch.device("cpu"))
    depth, steps, evals, windows = 12, 2, 5, 4
    # train, resume (a step and an eval call per batch each), eval-only,
    # sliding eval-only (4 windows a batch); then served: b1, 9 images (a
    # b8 and a b1 call), 1 image slid (4 windows: one b8 call), 9 images
    # slid (36 windows: 5 b8 calls); the W8A8 artifact asked for 1 and 2
    # images (three b1 calls)
    assert launches == (depth * (2 * (steps + evals) + evals
                                 + evals * windows + 9 + 3),
                        depth * 2 * steps, 3 * depth * 3)
    assert rates == {("train", "x"): (1.0, 0.0)}


def test_w8a8_phase_rehearsal(monkeypatch):
    """Phase 10b on the tiny recipe (ViT-Ti/8 at 32 px) on the CPU: the
    float and W8A8 artifacts, the int8 kernel (its plain version, counted)
    in each qkv, fc1 and fc2 and the attention kernel in every block of
    every call, the served outputs against the in-process quantized module,
    the kernel arm within phase 3's bounds of the plain arm and the sw
    fault outside them, and the W8A8 artifact's cosine to the float one."""
    smoke = _chip_smoke()
    tiny = _tiny_recipe(smoke.RECIPE)
    tiny["model_params"]["adaptation"]["params"] = {"partial_size": 16}
    monkeypatch.setattr(smoke, "RECIPE", tiny)
    monkeypatch.setattr(smoke, "SERVE_IMG", 32)
    monkeypatch.setattr(smoke, "N_CLASSES", 10)
    monkeypatch.setattr(smoke, "REQUESTS", (1, 9, 20))
    monkeypatch.setattr(smoke, "BATCH_SIZES", (1, 8))
    monkeypatch.setattr(smoke, "_time_ms", lambda fn, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "_peak_above", lambda device, fn: 0.0)
    monkeypatch.setattr(smoke, "_profile_step",
                        lambda fn: (1.0, 1.0, {}, [], []))
    _count_plain_versions(monkeypatch)
    launches, rates = smoke.phase_w8a8(torch.device("cpu"))
    n_calls = 1 + 2 + 3               # 1 -> b1; 9 -> b8 + b1; 20 -> 8, 8, 8
    assert launches == (3 * 12 * n_calls, 12 * n_calls)
    assert set(rates) == {"w8a8 kernel", "w8a8 plain", "float kernel"}


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_exits_nonzero_without_a_card(tmp_path, where):
    """Here (no CUDA device) and in a directory holding nothing of the repo
    but the script, it fails and prints no result."""
    cwd = ROOT
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_import_recipes_are_the_yaml(tmp_path):
    """Phase 12's recipes: IMPORT_RECIPE is the ImageNet YAML as shipped,
    `pretrained: true` and its checkpoint path included; W8A8_RECIPE adds
    `quantize_frozen` and nothing else; the cuts are phase 5's data at 128
    images with in-process loaders (12d's split at the 518 grid), and the
    checkpoint path is rewritten to the file the phase writes."""
    smoke = _chip_smoke()
    yml = load_merged_params(os.path.join(ROOT, RECIPE_YML))
    assert yml.model_params.pretrained is True
    assert _subdict_mismatches(smoke.IMPORT_RECIPE, yml) == []
    assert smoke.IMPORT_RECIPE["model_params"]["pretrained_checkpoint"] \
        == yml.model_params.pretrained_checkpoint
    assert _subdict_mismatches(smoke.W8A8_RECIPE, yml) == [
        ".model_params.quantize_frozen"]
    assert smoke.W8A8_RECIPE["model_params"]["quantize_frozen"] is True
    for recipe in (smoke.IMPORT_RECIPE, smoke.W8A8_RECIPE):
        assert build_vit_config(recipe) == build_vit_config(yml)
        assert build_apla_config(recipe) == build_apla_config(yml)
    cuts = copy.deepcopy(smoke.IMPORT_CUTS)
    assert {k: v["num_workers"] for k, v in
            cuts.pop("dataloader_params").items()} == {
        "trainloader": 0, "valloader": 0, "testloader": 0}
    assert cuts["dataset_params"].pop("synthetic_size") == 128
    smoke_cuts = copy.deepcopy(smoke.SMOKE_CUTS)
    smoke_cuts["dataset_params"].pop("synthetic_size")
    assert cuts == smoke_cuts
    ev = smoke.EVAL_CUTS["dataset_params"]
    assert (ev["synthetic_size"], ev["synthetic_img_size"]) == (64, 518)
    assert build_vit_config(yml).img_size == 518
    path, params = smoke._recipe_file(str(tmp_path), "x", smoke.IMPORT_RECIPE,
                                      smoke.IMPORT_CUTS, "cpu", "/w.pth")
    assert params["model_params"]["pretrained"] is True
    assert params["model_params"]["pretrained_checkpoint"] == "/w.pth"
    import json
    with open(path) as f:
        assert json.load(f) == params


def _tiny_import(smoke, monkeypatch):
    """Phase 12's recipes on the tiny supervised model (ViT-Ti/8 at 32 px,
    APLA-16, b16 at accum 8), 64 images; 12d's split at 32 px."""
    for name in ("IMPORT_RECIPE", "W8A8_RECIPE"):
        tiny = _tiny_recipe(getattr(smoke, name))
        tiny["model_params"]["adaptation"]["params"] = {"partial_size": 16}
        monkeypatch.setattr(smoke, name, tiny)
    cuts = {**copy.deepcopy(_TINY_CUTS), "dataloader_params": {
        n: {"num_workers": 0} for n in ("trainloader", "valloader",
                                        "testloader")}}
    monkeypatch.setattr(smoke, "IMPORT_CUTS", cuts)
    ev = copy.deepcopy(cuts)
    ev["dataset_params"]["synthetic_img_size"] = 32
    ev["dataset_params"].update({split: {
        "Resize": {"apply": True, "height": 32, "width": 32},
        "CenterCrop": {"apply": False}, "Normalize": True}
        for split in ("val_transforms", "test_transforms")})
    monkeypatch.setattr(smoke, "EVAL_CUTS", ev)
    monkeypatch.setattr(smoke, "N_CLASSES", 10)
    monkeypatch.setattr(smoke, "_train_rate", lambda *a: (1.0, 0.0))
    # the script's bounds are set from ViT-B's readings on the card; this
    # model in bf16 on the CPU reads |dloss| 2.0e-4 and a worst per-tensor
    # gradient error of 0.0143, so the rehearsal holds it 5x and 2.8x above
    # those (the truncated codes read 0.054, the other controls more)
    monkeypatch.setattr(smoke, "W8A8_LOSS_TOL", 1e-3)
    monkeypatch.setattr(smoke, "W8A8_GRAD_REL_TOL", 0.04)


def test_import_phase_rehearsal(monkeypatch, tmp_path):
    """Phase 12 on the CPU at tiny sizes, after the tiny 6b, 8b and 9b that
    leave it a DINOv2 checkpoint and two artifacts: 12a (import through
    `main`, three layouts bit-equal, two updates), 12b (transfer, export,
    served), 12c (W8A8 training: the int8 product's plain version, counted,
    in each qkv, fc1, fc2 of every micro-step and eval call; the faults),
    12d (`serve eval` against the loops' own evaluations)."""
    smoke = _chip_smoke()
    _tiny_ssl(smoke, monkeypatch)
    _tiny_det(smoke, monkeypatch)
    _tiny_seg(smoke, monkeypatch)
    _tiny_import(smoke, monkeypatch)
    _count_plain_versions(monkeypatch)
    cpu, keep = torch.device("cpu"), {"dir": str(tmp_path)}
    smoke.phase_ssl(cpu, keep)
    smoke.phase_det(cpu, keep)
    smoke.phase_seg(cpu, keep)
    assert set(keep) == {"dir", "ssl_ckpt", "det", "seg"}
    launches, rates = smoke.phase_import(cpu, {("fused", 8): (1.0, 0.0),
                                               ("fused", 1): (1.0, 0.0)},
                                         keep)
    depth, accum, steps, evals = 12, 8, 4, 8
    train = depth * (steps * accum + evals)
    # 12a, 12b (one update of 64 at b16: 4 steps), 12c train; 12b's served
    # call; 12d's two b64 calls (bank, test split)
    assert launches["fwd"] == 3 * train + depth + 2 * 4 * depth
    assert launches["bwd"] == 3 * depth * steps * accum
    assert launches["int8"] == 3 * train
    assert launches["swin_fwd"] == 6
    assert launches["seg_fwd"] == 12 * (2 + 5)
    assert set(rates) == {("plain", 8), ("plain", 1), ("kernel", 8),
                          ("kernel", 1)}


def test_data_recipes_are_the_yaml():
    """Phase 13's recipes: 13c runs IMPORT_RECIPE (the YAML as shipped, see
    above) with only the data location and one epoch changed; 13d's host
    path turns `device_augment` off and runs apla.yml's train transforms as
    shipped, TrivialAugment and RandomErasing among them, with one cut:
    RandomErasing's `value` 0 for the YAML's "random" (on which the JAX
    package raises); every transform the YAML switches on is there, and
    nothing else is."""
    smoke = _chip_smoke()
    yml = load_merged_params(os.path.join(ROOT, RECIPE_YML))
    assert smoke.DATA_CUTS == {
        "training_params": {"epochs": 1, "val_every": 1.0, "log_every": 1},
        "dataloader_params": {"valloader": {"num_workers": 0},
                              "testloader": {"num_workers": 0}}}
    params = smoke._run_params(smoke.IMPORT_RECIPE, smoke.DATA_CUTS, "/x",
                               "cpu")
    assert params["dataloader_params"]["trainloader"] == \
        yml.dataloader_params.trainloader
    assert params["dataloader_params"]["trainloader"]["num_workers"] == 8
    params = smoke._run_params(smoke.IMPORT_RECIPE, smoke.HOST_CUTS, "/x",
                               "cpu")
    dp = params["dataset_params"]
    assert dp["dataset"] == yml.dataset_params.dataset == "ImageNet"
    assert dp["device_augment"] is False
    assert yml.dataset_params.device_augment is True
    tt, ytt = dp["train_transforms"], yml.dataset_params.train_transforms
    erasing = dict(ytt["RandomErasing"])
    assert erasing.pop("value") == "random"
    assert tt["RandomErasing"] == {**erasing, "value": 0}
    assert tt["TrivialAugment"] == ytt["TrivialAugment"]
    for name, value in tt.items():
        if name != "RandomErasing":
            assert value == ytt[name], name
    for name, value in ytt.items():
        if name not in tt:
            assert name == "SimpleMultiCrop" or not value.get("apply"), name
    on = [n for n, v in ytt.items()
          if v is True or isinstance(v, dict) and v.get("apply")]
    assert set(on) <= set(tt) and {"TrivialAugment", "RandomErasing"} <= \
        set(on)
    from apla_tpu_torch.data.transforms import build_transform
    steps = [type(x).__name__ for x in build_transform(
        tt, (0.5,) * 3, (0.25,) * 3).transforms]
    assert steps == ["Resize", "RandomResizedCrop", "RandomHorizontalFlip",
                     "TrivialAugmentWide", "NativeToArrayNormalize",
                     "RandomErasing"]
    for split in ("val_transforms", "test_transforms"):
        assert dp[split] == yml.dataset_params[split]
    assert {k: v["num_workers"] for k, v in
            params["dataloader_params"].items()} == {
        "trainloader": 0, "valloader": 0, "testloader": 0}
    assert params["model_params"]["pretrained"] is True
    assert (smoke.DATA_TRAIN, smoke.DATA_VAL, smoke.DATA_CLASSES) == \
        (256, 64, 8)


def test_host_crop_phases_are_phase_11_and_the_jax_strategies():
    """13k(b) runs BYOL_RECIPE and DINO_RECIPE with phase 11's cuts, but for
    the data: 13i's ISIC2019 tree, `device_augment` unset (so the host
    multi-crop), the val loader keeping its short batch as 13i's; 13i's
    recipe sets no `device_augment` either.  The strategies those runs
    take (dinov2 for 13i, byol and dino for 13k) are the JAX package's, and
    13k(a)'s manifest is the one the CPU tests hold."""
    from apla_tpu.ssl import multicrop as jmc
    from apla_tpu_torch.ssl import multicrop as tmc
    smoke = _chip_smoke()
    cuts = smoke._host_v1_cuts("/tree")
    v1 = copy.deepcopy(smoke.V1_CUTS)
    assert v1["dataset_params"]["device_augment"] is True
    assert cuts["dataset_params"] == {"data_location": "/tree"}
    assert {k: v for k, v in cuts.items() if k != "dataset_params"} == {
        **{k: v for k, v in v1.items() if k != "dataset_params"},
        "dataloader_params": {**v1["dataloader_params"], "valloader": {
            "num_workers": 0, "drop_last": False}}}
    for recipe in (smoke.BYOL_RECIPE, smoke.DINO_RECIPE):
        params = smoke._run_params(recipe, cuts, "/x", "cpu")
        assert "device_augment" not in params["dataset_params"]
        assert params["dataset_params"]["dataset"] == "ISIC2019"
        assert build_vit_config(params).embed_dim == 768
        assert build_apla_config(params).partial_size == 128
    params = smoke._run_params(smoke.SSL_RECIPE, smoke.ISIC_CUTS, "/x", "cpu")
    assert "device_augment" not in params["dataset_params"]
    assert smoke.HOST_V1_OBJECTIVES == ("byol", "dino")
    for name in ("byol", "dino", "dinov2"):
        assert tmc.STRATEGIES[name] == jmc.STRATEGIES[name], name
    spec = tmc.STRATEGIES["dinov2"]
    assert [c["RandomResizedCrop"]["size"] for _, c in spec["crops"]] == \
        [224] * 2 + [98] * 8
    assert smoke.TRANSFORM_MANIFEST == os.path.join(
        ROOT, "tests", "data", "transforms", "manifest.json")


def _imports(path):
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_chip_smoke_and_native_import_no_jax_package():
    """chip_smoke.py and the native host library's bindings (the BMP, GIF
    and TIFF parsers among them) import nothing of the JAX package, JAX,
    Pillow, PyYAML, pandas, sklearn or wandb."""
    native = os.path.join(ROOT, "apla_tpu_torch", "native")
    for path in [os.path.join(ROOT, "chip_smoke.py")] + [
            os.path.join(native, n) for n in os.listdir(native)
            if n.endswith(".py")]:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("apla_tpu", "jax", "jaxlib", "flax", "PIL",
                               "yaml", "pandas", "sklearn", "wandb"), \
                (path, name)


def test_jpeg_fixtures_stay_small():
    d = os.path.join(ROOT, "tests", "data", "jpeg")
    names = os.listdir(d)
    assert len([n for n in names if n != "manifest.json"]) <= 12
    assert sum(os.path.getsize(os.path.join(d, n)) for n in names) \
        < 400 * 1024


def test_data_phase_rehearsal(monkeypatch, tmp_path):
    """Phase 13 on the CPU on the tiny supervised model (its raw size the
    manifest's 256): the fixtures against the manifest, the ImageNet tree
    through `main` with rows 1 and 2 counted in every block of every
    micro-step and eval call, the first batch against the manifest, the
    loader's rate, the host path as shipped (TrivialAugment, RandomErasing)
    through `main` and its loader's rate."""
    smoke = _chip_smoke()
    _tiny_import(smoke, monkeypatch)
    tiny = copy.deepcopy(smoke.IMPORT_RECIPE)
    tiny["dataset_params"]["train_transforms"]["Resize"] = {
        "apply": True, "height": 256, "width": 256}
    monkeypatch.setattr(smoke, "IMPORT_RECIPE", tiny)
    monkeypatch.setattr(smoke, "DATA_TRAIN", 64)
    monkeypatch.setattr(smoke, "DATA_VAL", 16)
    monkeypatch.setattr(smoke, "HOST_TRAIN", 16)
    monkeypatch.setattr(smoke, "HOST_VAL", 8)
    monkeypatch.setattr(smoke, "DATA_LOADER_WORKERS", 0)
    monkeypatch.setattr(smoke, "DATA_RATE_REPEAT", 1)
    monkeypatch.setattr(smoke, "_gpu_line", lambda: "no card (CPU)")
    _count_plain_versions(monkeypatch)
    launches, rates = smoke.phase_data(torch.device("cpu"),
                                       {"dir": str(tmp_path)},
                                       {("fused", 8): (1.0, 0.0)})
    depth, accum = 12, 8
    # 13c: 64 images = 4 updates of b16 (8 micro-steps of 2 each), val
    # and test 1 batch each; 13d: 16 images = 1 update, val and test 1
    # batch each (its loader alone: the 16 four times, one batch of 64)
    steps = 64 // 16 + 16 // 16
    evals = 2 + 2
    assert launches == (depth * (steps * accum + evals),
                        depth * steps * accum)
    assert rates["loader_img_s"] > 0 and rates["train_img_s"] > 0
    assert rates["host_loader_img_s"] > 0 and rates["host_update_img_s"] > 0
    assert rates["synthetic_img_s"] is None
    assert rates["resident_img_s"] == 1.0


NABIRDS_YML = "params/finetune/dinov2/NABirds/vit_b/apla.yml"


def test_nabirds_recipe_dict_is_the_yaml():
    """Every field of NABIRDS_RECIPE has the NABirds recipe's value (APLA
    rank 8 without an index file, ColorJitter on, no mixup, lr 3e-5), and
    the YAML's train transforms are all in it; 13h's cuts are 13c's; 13i's
    are one epoch and in-process val / test loaders, the val loader keeping
    its short batch."""
    smoke = _chip_smoke()
    yml = load_merged_params(os.path.join(ROOT, NABIRDS_YML))
    assert _subdict_mismatches(smoke.NABIRDS_RECIPE, yml) == []
    assert smoke.NABIRDS_RECIPE["dataset_params"]["train_transforms"] == \
        yml.dataset_params.train_transforms
    assert build_apla_config(yml).partial_size == 8
    assert yml.model_params.adaptation.params == {"partial_size": 8}
    params = smoke._run_params(smoke.NABIRDS_RECIPE, smoke.DATA_CUTS, "/x",
                               "cpu")
    assert params["dataloader_params"]["trainloader"] == \
        yml.dataloader_params.trainloader
    cfg = build_vit_config(params)
    assert (cfg.embed_dim, cfg.depth, cfg.img_size, cfg.use_fused_apla) == \
        (768, 12, 518, True)
    assert smoke.ISIC_CUTS == {
        "training_params": {"epochs": 1, "log_every": 1},
        "dataloader_params": {
            "valloader": {"num_workers": 0, "drop_last": False},
            "testloader": {"num_workers": 0}}}
    yml = load_merged_params(os.path.join(ROOT, SSL_YML))
    assert yml.model_params.adaptation.params.partial_size == "full"
    assert smoke.SSL_RECIPE["model_params"]["adaptation"]["params"][
        "partial_size"] == "full"
    # 80 images: 64 train (one update of b64), 8 val, 8 test
    assert smoke.ISIC_IMAGES - int(0.2 * smoke.ISIC_IMAGES) == 64


def test_recipes_phase_rehearsal(monkeypatch, tmp_path):
    """Phases 13h-13k on the CPU at tiny sizes: the NABirds recipe (APLA-8)
    through `main` on its tree with rows 1 and 2 counted in every block of
    every micro-step and eval call, the first batch against the manifest,
    the kernel arm against the plain arm and the two backward faults; the
    ISIC2019 DINOv2 recipe ("full") through `main --dinov2` with rows 10-12
    counted once each, the split sizes and finite loss terms and kNN
    validation on the host multi-crop; the PNG fixtures against their
    manifest and a VTAB tree through the loader, raw and host; the
    transforms against their manifest and `main --byol` and `main --dino`
    on the host multi-crop, rows 1 and 2 counted."""
    smoke = _chip_smoke()
    _tiny_import(smoke, monkeypatch)
    _tiny_ssl(smoke, monkeypatch)
    tiny = _tiny_recipe(smoke.NABIRDS_RECIPE)
    tiny["dataset_params"]["train_transforms"]["Resize"] = {
        "apply": True, "height": 256, "width": 256}
    monkeypatch.setattr(smoke, "NABIRDS_RECIPE", tiny)
    assert smoke.SSL_RECIPE["model_params"]["adaptation"]["params"] == {
        "partial_size": "full"} and smoke.SSL_RECIPE["model_params"][
            "pretrained"]
    monkeypatch.setattr(smoke, "NABIRDS_TRAIN", 16)
    monkeypatch.setattr(smoke, "NABIRDS_EVAL", 8)
    monkeypatch.setattr(smoke, "ISIC_IMAGES", 20)
    monkeypatch.setattr(smoke, "PNG_TRAIN", 64)
    monkeypatch.setattr(smoke, "DATA_LOADER_WORKERS", 0)
    monkeypatch.setattr(smoke, "DATA_RATE_REPEAT", 1)
    monkeypatch.setattr(smoke, "_gpu_line", lambda: "no card (CPU)")
    timed = {"ms": 1.0, "graph_ms": 1.0, "host_ms": 1.0, "plain_ms": 1.0,
             "library_two_calls_ms": 1.0, "bound_ms": 1.0,
             "bound_by": "ops"}
    monkeypatch.setattr(smoke, "_bwd_times", lambda *a: dict(timed))
    monkeypatch.setattr(smoke, "_fused_fwd_times", lambda *a: dict(timed))
    monkeypatch.setattr(smoke, "_print_fwd_times", lambda *a: None)
    monkeypatch.setattr(smoke, "LOSS_TOL", 3e-3)
    monkeypatch.setattr(smoke, "GRAD_REL_TOL", 0.08)
    _tiny_v1(smoke, monkeypatch)
    _count_plain_versions(monkeypatch)
    apla, proto, rates = smoke.phase_recipes(torch.device("cpu"),
                                             {"dir": str(tmp_path)}, 100.0)
    # 13h: 16 images = 1 update of b16 (8 micro-steps of 2), val and test 1
    # batch each; 13k: BYOL and DINO one update of b16 each (4 and 3
    # forwards, 2 backwards), one validation (the feature bank's batch and
    # the val loader's)
    assert apla == (12 * (8 + 2) + 12 * (4 + 2) + 12 * (3 + 2),
                    12 * 8 + 2 * 12 * 2)
    assert proto == (1, 1, 1)
    assert set(rates["host_v1"]) == {"byol", "dino"}
    assert set(rates["transforms_s"]) == {"native", "plain"}
    assert rates["nabirds"]["bwd_k8"]["max_abs_err"] == 0.0
    assert rates["isic"]["knn"] and rates["png"]["raw_img_s"] > 0


@pytest.mark.parametrize("tag", ["17a", "17b", "17c", "17a full"])
def test_pipeline_recipes_are_what_the_jax_wrapper_builds(monkeypatch,
                                                          tmp_path, tag):
    """Phase 17's recipes (RECIPE, 15c's DINOv2, 16d's W8A8 and the full
    fine-tune of 17a's token-prep control, at `pipeline_parallel` 2 and
    `pp_microbatches` 2 on 2 ranks): JAX's wrapper reads their knobs as a
    1 x 2 mesh with a pipeline of 2 stages and 2 microbatches under
    "pp", and so does the port's; the objective, the adaptation and W8A8
    are the recipes' (no packed local crops: JAX refuses them with a
    pipeline)."""
    from apla_tpu.utils.config import EDict
    from apla_tpu.wrapper import DefaultWrapper as JWrapper
    from apla_tpu_torch import wrapper as twrapper
    from apla_tpu_torch.parallel.mesh import Mesh
    smoke = _chip_smoke()
    dev = torch.device("cpu")
    params = smoke._run_params(smoke.RECIPE, smoke.PAR_CUTS,
                               str(tmp_path / "r"), dev)
    ssl = smoke._run_params(smoke.SSL_RECIPE,
                            smoke._eval_in_process(smoke.SSL_CUTS),
                            str(tmp_path / "s"), dev)
    w8 = copy.deepcopy(params)
    w8["model_params"]["quantize_frozen"] = True
    recipe = smoke.pipeline_recipes(params, ssl, w8, str(tmp_path))[tag]
    sp = recipe["system_params"]
    assert (sp["n_devices"], sp["pipeline_parallel"],
            sp["pp_microbatches"]) == (2, 2, 2)
    # JAX's wrapper on its 8 CPU devices
    jw = JWrapper.__new__(JWrapper)
    jw.system_params = EDict({k: v for k, v in sp.items()
                              if k != "device"})
    mesh = jw.init_mesh()
    assert dict(mesh.shape) == {"data": 1, "model": 2}
    assert (jw.pipeline_spec.n_stages, jw.pipeline_spec.n_micro) == (2, 2)
    assert jw.system_params["param_sharding"] == "pp"
    # the port's, against a stand-in mesh (no group)
    monkeypatch.setattr(twrapper, "make_mesh",
                        lambda n_data=None, n_model=1, sequence_parallel=False:
                        Mesh(world=n_data or 1, n_model=n_model))
    tw = twrapper.DefaultWrapper.__new__(twrapper.DefaultWrapper)
    tw.system_params = copy.deepcopy(sp)
    tw.pipeline_spec = None
    tmesh = tw.init_mesh()
    assert tmesh.shape == dict(mesh.shape)
    assert (tw.pipeline_spec.n_stages, tw.pipeline_spec.n_micro) == (2, 2)
    assert tw.system_params["param_sharding"] == "pp"
    # what the recipe trains
    mp = recipe["model_params"]
    if tag == "17a full":
        assert build_apla_config(recipe) is None
        assert mp["adaptation"]["mode"] != "apla"
    else:
        assert build_apla_config(recipe).partial_size == 128
    assert bool(mp.get("quantize_frozen")) == (tag == "17c")
    if tag == "17b":
        assert not mp["transformers_params"]["student"].get(
            "pack_local_crops", False)
        assert recipe["dataset_params"]["dataset"] == "Synthetic"
    else:
        assert recipe["training_params"]["accum_steps"] == 8
        assert recipe["dataloader_params"]["trainloader"][
            "batch_size"] == 64


def test_formats_phase_rehearsal(monkeypatch, tmp_path):
    """Phase 18 on the CPU: 18a the BMP, GIF and TIFF fixtures against
    their manifests through both arms, the refused streams, the decode
    rates; 18b the host path at `img_channels: 1` on the tiny supervised
    model through `main` on a tree of every format: rows 1 and 2 counted
    in every block of every micro-step and eval call, the kernel arm
    against the plain arm with its two faults, the metrics file."""
    smoke = _chip_smoke()
    _tiny_import(smoke, monkeypatch)
    monkeypatch.setattr(smoke, "GREY_TRAIN", 16)
    monkeypatch.setattr(smoke, "GREY_VAL", 8)
    monkeypatch.setattr(smoke, "FORMAT_RATE_REPEAT", 2)
    monkeypatch.setattr(smoke, "GRAD_REL_TOL", 0.08)
    monkeypatch.setattr(smoke, "_gpu_line", lambda: "no card (CPU)")
    _count_plain_versions(monkeypatch)
    launches, readings = smoke.phase_formats(torch.device("cpu"),
                                             {"dir": str(tmp_path)},
                                             (None, None))
    # 16 images: one update of b16 (8 micro-steps of 2); val and test one
    # batch each
    assert launches == (12 * (8 + 2), 12 * 8)
    assert set(readings["decode"]) == {"bmp", "gif", "tiff"}
    assert all(r["native_img_s"] > 0 for r in readings["decode"].values())
    assert readings["grey"]["records"] == 3      # a step, val, test
    assert readings["grey"]["images"] == 24


def test_phase_list_and_kernels_line_name_every_row():
    """The script's docstring lists phases 1-18, main runs each, and the
    kernels line counts phase 18's launches in rows 1 and 2 beside every
    TPU row's entry."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    doc = src.split('"""')[1]
    for n in range(1, 19):
        assert re.search(rf"^  {n}[a-z]?\. ", doc, re.M), n
    main = src[src.index("def main() -> int:"):]
    for tag in ["1", "2", "3", "4", "5", "6a", "6b", "7a", "7b", "8a", "8b",
                "8c", "9a", "9b", "10a", "10b", "11", "12", "13", "13h-k",
                "14", "15", "16", "17", "18"]:
        assert f'timed("{tag}"' in main or f'"{tag}", phase' in main, tag
    for row in ("pallas_apla_attn.py:105", "pallas_apla_attn.py:131",
                "pallas_apla_attn.py:197", "pallas_apla_attn.py:203",
                "pallas_apla_attn_long.py:110", "pallas_apla_attn_long.py:141",
                "pallas_mha.py:66", "pallas_mha.py:81",
                "pallas_proto_ce.py:73", "pallas_proto_ce.py:130",
                "pallas_proto_ce.py:150", "pallas_int8_matmul.py:33"):
        assert f'"{row}"' in main, row
    assert main.count("fmt_launches[0]") == 2 \
        and main.count("fmt_launches[1]") == 2
