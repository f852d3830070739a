"""The port's LPIPS (models/lpips.py, convert.lpips_from_flax) and
evaluation metrics (train/metrics.py) against the JAX package's on the CPU.

LPIPS runs with the JAX twin's own ``make_lpips_fn()`` weights
(``jax.random.key(0)``) carried across by ``lpips_from_flax``, on inputs from
numpy seeds, at the shapes of the train step's patches ([4, 32, 32, 3]) and
lips window ([1, 64, 64, 3]), with and without ``normalize``. Tolerances:
- the distance: 1e-5 relative (the five convolutions sum in another order;
  1.1e-7 read);
- its gradient with respect to the prediction: 2e-5 of its largest entry
  (3.5e-6 read);
- the converters: both packages' outputs from the same seeded state dicts
  equal, bit for bit (a rename and transposes);
- PSNR and SSIM: 1e-6 relative (f32 means in another order); the landmark
  distance and the meter: the same numpy and Python arithmetic, equal.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.models import lpips as jlpips
from mere_fusion_tpu_torch.convert import lpips_from_flax
from mere_fusion_tpu_torch.models import lpips
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
VALUE_RTOL = 1e-5
GRAD_REL = 2e-5


@pytest.fixture(scope="module")
def jax_variables():
    """The variables of the JAX package's make_lpips_fn() with no files."""
    return jax.jit(jlpips.LPIPS().init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                        jnp.zeros((1, 32, 32, 3)))


def port_module(variables) -> lpips.LPIPS:
    module = lpips.LPIPS()
    module.load_state_dict(lpips_from_flax(jax.tree_util.tree_map(np.array, variables)),
                           strict=True)
    return module


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "normalize"])
@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (1, 64, 64, 3)], ids=["patches", "lips"])
def test_lpips_value_and_gradient_match_jax(jax_variables, shape, normalize):
    rng = np.random.default_rng(sum(shape))
    pred = rng.uniform(0, 1, shape).astype(np.float32)
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    jfn = jlpips.make_lpips_fn(variables=jax_variables, normalize=normalize)
    want, want_grad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(pred), jnp.asarray(gt))
    fn = lpips.make_lpips_fn(module=port_module(jax_variables), normalize=normalize,
                             device=CPU)
    assert not any(p.requires_grad for p in fn.module.parameters())
    x = torch.from_numpy(pred).requires_grad_(True)
    got = fn(x, torch.from_numpy(gt))
    got.backward()
    got = got.detach()
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=VALUE_RTOL)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=0,
                               atol=GRAD_REL * float(np.abs(want_grad).max()))
    # a distance: zero on equal inputs, symmetric
    assert abs(float(fn(x.detach(), x.detach()))) < 1e-6
    np.testing.assert_allclose(float(fn(torch.from_numpy(gt), x.detach())), float(got),
                               rtol=1e-6)


def seeded_state_dicts(layout: str, seed: int = 5) -> tuple[dict, dict]:
    """An AlexNet state dict in torchvision's layout or in an lpips full
    dump's, and lin heads under ``lin{i}`` or ``lins.{i}`` keys."""
    gen = torch.Generator().manual_seed(seed)
    ref = lpips.AlexNetFeatures().features
    alex, lins = {}, {}
    for s, j in enumerate(lpips.ALEX_CONVS, start=1):
        w = torch.randn(ref[j].weight.shape, generator=gen) * 0.05
        b = torch.randn(ref[j].bias.shape, generator=gen) * 0.05
        prefix = f"features.{j}" if layout == "torchvision" else f"net.slice{s}.{j}"
        alex[f"{prefix}.weight"], alex[f"{prefix}.bias"] = w, b
    for i, c in enumerate(lpips.ALEX_CHANNELS):
        key = f"lin{i}.model.1.weight" if layout == "torchvision" else f"lins.{i}.model.1.weight"
        lins[key] = torch.rand((1, c, 1, 1), generator=gen) * 0.2
    if layout == "lpips_dump":
        alex.update(lins)         # a full dump holds the heads too
    return alex, lins


@pytest.mark.parametrize("layout", ["torchvision", "lpips_dump"])
def test_convert_lpips_matches_jax(layout):
    alex, lins = seeded_state_dicts(layout)
    got = lpips.convert_lpips(alex, lins)
    want = lpips_from_flax(jlpips.convert_lpips(alex, lins))
    assert set(got) == set(want) == set(lpips.LPIPS().state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    # the converted weights give the JAX twin's distance
    rng = np.random.default_rng(3)
    pred, gt = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    module = lpips.LPIPS()
    module.load_state_dict(got, strict=True)
    value = lpips.make_lpips_fn(module=module, device=CPU)(torch.from_numpy(pred),
                                                         torch.from_numpy(gt))
    ref = jax.jit(jlpips.LPIPS().apply)(jlpips.convert_lpips(alex, lins), jnp.asarray(pred),
                                        jnp.asarray(gt))
    np.testing.assert_allclose(float(value), float(ref), rtol=VALUE_RTOL)


def test_convert_lpips_missing_lin_raises_as_jax():
    alex, lins = seeded_state_dicts("torchvision")
    del lins["lin3.model.1.weight"]
    with pytest.raises(KeyError) as want:
        jlpips.convert_lpips(alex, lins)
    with pytest.raises(KeyError) as got:
        lpips.convert_lpips(alex, lins)
    assert str(got.value) == str(want.value) == "'lin3 weight not found in lpips state dict'"


def test_make_lpips_fn_loads_files_as_jax(tmp_path):
    alex, lins = seeded_state_dicts("torchvision", seed=9)
    alex_path, lins_path = str(tmp_path / "alexnet.pth"), str(tmp_path / "alex.pth")
    torch.save(alex, alex_path)
    torch.save(lins, lins_path)
    rng = np.random.default_rng(4)
    pred, gt = (rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want = jax.jit(jlpips.make_lpips_fn(alex_path, lins_path))(jnp.asarray(pred),
                                                               jnp.asarray(gt))
    fn = lpips.make_lpips_fn(alex_path, lins_path, device=CPU)
    np.testing.assert_allclose(float(fn(torch.from_numpy(pred), torch.from_numpy(gt))),
                               float(want), rtol=VALUE_RTOL)
    # without files: seeded random heads, the same on every call, non-negative lins
    a, b = (lpips.make_lpips_fn(device=CPU).module for _ in range(2))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert all(float(lin.model[1].weight.min()) >= 0 for lin in a.lins)


def test_metrics_match_jax():
    from mere_fusion_tpu.train import metrics as jmetrics
    from mere_fusion_tpu_torch.train import metrics

    rng = np.random.default_rng(11)
    pred = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.05, pred.shape), 0, 1).astype(np.float32)
    for name in ("psnr", "ssim"):
        want = float(getattr(jmetrics, name)(jnp.asarray(pred), jnp.asarray(gt)))
        got = float(getattr(metrics, name)(torch.from_numpy(pred), torch.from_numpy(gt)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    # SSIM's variances are the population's, as jnp.var takes them
    assert float(metrics.ssim(torch.from_numpy(pred), torch.from_numpy(pred))) == 1.0
    flat = np.full((8, 8, 3), 0.5, np.float32)
    assert float(metrics.psnr(torch.from_numpy(flat), torch.from_numpy(flat))) == float(
        jmetrics.psnr(jnp.asarray(flat), jnp.asarray(flat))) == 120.0
    lms_a, lms_b = rng.uniform(0, 64, (2, 3, 20, 2))
    assert metrics.landmark_distance(lms_a, lms_b) == jmetrics.landmark_distance(lms_a, lms_b)
    meters = [(mod.MetricMeter(mod.psnr, "PSNR"), cast)
              for mod, cast in ((jmetrics, jnp.asarray), (metrics, torch.from_numpy))]
    assert [m.mean for m, _ in meters] == [0.0, 0.0]
    for k in range(3):
        for meter, cast in meters:
            meter.update(cast(pred), cast(np.clip(gt + 0.01 * k, 0, 1)))
    (jm, _), (pm, _) = meters
    assert pm.count == jm.count == 3 and pm.name == jm.name
    np.testing.assert_allclose(pm.mean, jm.mean, rtol=1e-6)
    assert pm.report() == f"PSNR = {pm.mean:.4f}"
