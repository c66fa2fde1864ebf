"""chip_smoke.py holds the shipped recipe's model and refuses to run here.

The script builds its model from a Python dict (the card's machine has no
PyYAML); that dict must agree with the ImageNet ViT-B APLA-128 recipe's model
fields as `load_merged_params` reads them.  Without a CUDA device the script
must exit non-zero and print no `"ok": true` line.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

from apla_tpu.utils.config import load_merged_params
from apla_tpu_torch.wrapper import build_apla_config, build_vit_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE_YML = "params/finetune/dinov2/ImageNet/vit_b/apla.yml"


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
