"""`apla_tpu_torch` imports no jax, flax or optax.

A fresh interpreter with a `sys.meta_path` blocker on those packages imports
every module of the port, runs a tiny APLA classifier forward through the
fused path, and round-trips it through a serving artifact.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys, tempfile

BLOCKED = ("jax", "jaxlib", "flax", "optax")


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocker())

import numpy as np
import torch
import apla_tpu_torch

names = [m.name for m in pkgutil.walk_packages(apla_tpu_torch.__path__,
                                               "apla_tpu_torch.")]
for name in names:
    importlib.import_module(name)

from apla_tpu_torch.apla.core import AplaConfig
from apla_tpu_torch.models.classifier import classifier_forward, init_classifier
from apla_tpu_torch.models.vit import ViTConfig
from apla_tpu_torch.serve import export_classifier, load_predictor

cfg = ViTConfig(img_size=32, patch_size=8, embed_dim=128, depth=2,
                num_heads=2, has_layerscale=True, use_fused_apla=True)
model = init_classifier(cfg, 10, AplaConfig(partial_size=16),
                        generator=torch.Generator().manual_seed(0),
                        device=torch.device("cpu"))
x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(np.float32)
with torch.no_grad():
    logits = classifier_forward(model, torch.from_numpy(x), cfg)
assert logits.shape == (3, 10) and torch.isfinite(logits.float()).all()
with tempfile.TemporaryDirectory() as tmp:
    export_classifier(tmp, model, cfg, batch_sizes=(1, 2))
    served = load_predictor(tmp, "cpu").predict(x)
assert np.array_equal(served, logits.float().numpy())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("MODULES", len(names))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_modules = int(proc.stdout.split("MODULES")[-1])
    assert n_modules >= 14, proc.stdout
