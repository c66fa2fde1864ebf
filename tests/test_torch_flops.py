"""The port's FLOP model (`apla_tpu_torch/utils/flops.py`) against the JAX
package's: `vit_train_step_flops` equal as floats over ViT-Ti, -B and -L
at APLA-k 0, 8, 128, "full" and "finetune", with SwiGLU and register
tokens; `mfu` equal under `APLA_PEAK_TFLOPS`; the H100's peak from
NVIDIA's datasheet; NaN for a card the table does not name."""

import math

import pytest

from apla_tpu.utils import flops as jflops
from apla_tpu_torch.models.vit import VIT_BUILDERS
from apla_tpu_torch.utils import flops as tflops


def _cfg(name, **kw):
    return VIT_BUILDERS[name](img_size=224, patch_size=14, **kw)


@pytest.mark.parametrize("name", ["vit_tiny", "vit_base", "vit_large"])
@pytest.mark.parametrize("apla_k", [0, 8, 128, "full", "finetune"])
@pytest.mark.parametrize("variant", ["plain", "swiglu_registers"])
def test_train_step_flops_match_jax(name, apla_k, variant):
    kw = {} if variant == "plain" else {"use_swiglu": True,
                                        "num_register_tokens": 4}
    cfg = _cfg(name, **kw)
    got = tflops.vit_train_step_flops(cfg, 1000, 64, apla_k)
    want = jflops.vit_train_step_flops(cfg, 1000, 64, apla_k)
    assert got == want
    assert got["total_flops"] == got["fwd_flops"] + got["bwd_flops"] > 0


def test_mfu_matches_jax(monkeypatch):
    monkeypatch.setenv("APLA_PEAK_TFLOPS", "500")
    for ips, fpi in ((1000.0, 1.5e11), (3.3, 7e9)):
        assert tflops.mfu(ips, fpi) == jflops.mfu(ips, fpi)
    assert tflops.peak_tflops() == 500.0


def test_peak_tflops(monkeypatch):
    monkeypatch.delenv("APLA_PEAK_TFLOPS", raising=False)
    assert tflops.peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert tflops.peak_tflops("NVIDIA H100 PCIe") == 756.0
    assert tflops.peak_tflops("cpu") == 1.0
    assert math.isnan(tflops.peak_tflops("NVIDIA GeForce RTX 4090"))
    out = tflops.mfu(100.0, 1e12, "NVIDIA H100 80GB HBM3")
    assert out == {"model_tflops": 100.0, "peak_tflops": 989.4,
                   "mfu_pct": round(100 * 100.0 / 989.4, 1)}
    assert tflops.mfu(100.0, 1e12, "unknown") == {"model_tflops": 100.0}
