"""Dropout and drop-path in the port's ViT, against the JAX package's rules.

The two packages draw from different generators (a JAX PRNG key, a
`torch.Generator`), so the masks are not compared element by element; what
is compared is what defines them: the keep rate (statistically, on 2^16
draws: a 5-sigma band), the 1/keep scaling of what is kept, one mask per
sample for drop-path (per packed segment with segments), the per-block
rates `linspace(0, drop_path_rate, depth)` against the JAX package's, and
the identity when deterministic.  Also: training with attention dropout on
the fused path raises (the kernel has no dropout on p, in JAX or here).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apla_tpu.models import vit as jvit
from apla_tpu_torch.apla.core import AplaConfig
from apla_tpu_torch.models.classifier import classifier_forward, init_classifier
from apla_tpu_torch.models.vit import ViTConfig, drop_path, drop_path_rates
from apla_tpu_torch.ops.attention import dropout


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scaling(rate):
    x = torch.ones(1 << 16)
    y = dropout(x, rate, _gen(), deterministic=False)
    kept = y != 0
    keep = 1.0 - rate
    sigma = np.sqrt(keep * rate / x.numel())
    assert abs(kept.float().mean().item() - keep) < 5 * sigma
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / keep))


def test_dropout_identity_when_deterministic_or_off():
    x = torch.randn(4, 9)
    assert dropout(x, 0.3, _gen(), deterministic=True) is x
    assert dropout(x, 0.0, _gen(), deterministic=False) is x
    assert dropout(x, 0.3, None, deterministic=False) is x


def test_dropout_keeps_dtype():
    x = torch.ones(64, dtype=torch.bfloat16)
    assert dropout(x, 0.2, _gen(), deterministic=False).dtype == torch.bfloat16


def test_drop_path_one_mask_per_sample():
    x = torch.ones(4096, 5, 3)
    y = drop_path(x, 0.25, _gen(), deterministic=False)
    per_sample = y.reshape(4096, -1)
    # every sample is all kept (scaled by 1/keep) or all dropped
    assert torch.all((per_sample == 0).all(1) | (per_sample == 1 / 0.75).all(1))
    frac = (per_sample[:, 0] != 0).float().mean().item()
    assert abs(frac - 0.75) < 5 * np.sqrt(0.75 * 0.25 / 4096)
    assert drop_path(x, 0.25, _gen(), deterministic=True) is x


def test_drop_path_one_mask_per_segment():
    x = torch.ones(512, 12, 2)
    y = drop_path(x, 0.5, _gen(), deterministic=False, segment_len=4)
    seg = y.reshape(512, 3, 4 * 2)
    assert torch.all((seg == 0).all(-1) | (seg == 2.0).all(-1))
    # the segments of one sample draw independently
    dropped = (seg == 0).all(-1)
    assert (dropped.any(1) & ~dropped.all(1)).any()


@pytest.mark.parametrize("rate,depth", [(0.1, 12), (0.3, 5), (0.0, 4)])
def test_drop_path_rates_match_jax_ramp(rate, depth):
    ours = drop_path_rates(ViTConfig(depth=depth, drop_path_rate=rate))
    ref = np.asarray(jnp.linspace(0.0, rate, depth))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-7)
    assert ours[0] == 0.0


TINY = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
            compute_dtype=torch.float32)


def _model(**over):
    cfg = ViTConfig(**{**TINY, **over})
    model = init_classifier(cfg, 10, AplaConfig(partial_size=16),
                            generator=_gen(0), device=torch.device("cpu"))
    return cfg, model


def test_forward_deterministic_ignores_rates():
    """With deterministic=True every rate is inert: the output equals the
    rate-free model's (inference ignores attn_drop_rate, fused or not)."""
    x = torch.randn(3, 32, 32, 3, generator=_gen(1))
    cfg, model = _model()
    base = classifier_forward(model, x, cfg)
    for fused in (False, True):
        noisy = dataclasses.replace(cfg, drop_rate=0.3, attn_drop_rate=0.2,
                                    drop_path_rate=0.4, use_fused_apla=fused)
        out = classifier_forward(model, x, noisy, deterministic=True,
                                 generator=_gen(2))
        torch.testing.assert_close(out, base, rtol=1e-5, atol=1e-5)


def test_forward_training_draws_from_the_generator():
    x = torch.randn(3, 32, 32, 3, generator=_gen(1))
    cfg, model = _model(drop_rate=0.2, drop_path_rate=0.3,
                        attn_drop_rate=0.1)
    a = classifier_forward(model, x, cfg, deterministic=False,
                           generator=_gen(5))
    b = classifier_forward(model, x, cfg, deterministic=False,
                           generator=_gen(5))
    c = classifier_forward(model, x, cfg, deterministic=False,
                           generator=_gen(6))
    torch.testing.assert_close(a, b)
    assert not torch.allclose(a, c)


def test_fused_training_with_attention_dropout_raises():
    x = torch.randn(2, 32, 32, 3, generator=_gen(1))
    cfg, model = _model(use_fused_apla=True, attn_drop_rate=0.1)
    with pytest.raises(ValueError, match="no dropout to the attention"):
        classifier_forward(model, x, cfg, deterministic=False,
                           generator=_gen(0))
    # proj/MLP dropout and drop-path train on the fused path
    cfg = dataclasses.replace(cfg, attn_drop_rate=0.0, drop_rate=0.1,
                              drop_path_rate=0.2)
    out = classifier_forward(model, x, cfg, deterministic=False,
                             generator=_gen(0))
    assert torch.isfinite(out).all()


def test_jax_config_fields_carry_the_same_rates():
    """The port's ViTConfig carries the three rates under the JAX names."""
    names = {f.name for f in dataclasses.fields(jvit.ViTConfig)}
    for rate in ("drop_rate", "attn_drop_rate", "drop_path_rate"):
        assert rate in names
        assert rate in {f.name for f in dataclasses.fields(ViTConfig)}
