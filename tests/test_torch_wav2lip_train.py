"""Wav2Lip training in the PyTorch port against the JAX package.

From one state (the generator, discriminator and SyncNet trees of
tests/test_torch_wav2lip.py, batch 2 at 96 px, inputs from numpy seeds):
the GAN step's losses, generator and discriminator gradients and the
BatchNorm running statistics after it, the L1 + sync + disc step's loss and
gradients, and Adam on JAX's gradients. JAX's gradients are read through an
optax transformation that returns them as its state.

The gradients are held in float64 in both packages. In float32 this step is
ill-conditioned at any seeded state: the forward of two float32
implementations differs by ~1e-5 of each activation's scale, which flips a
few ReLU masks in every layer, and a flipped entry moves its gradient by a
few percent of the largest (BatchNorm in training mode over batch 2 at the
1×1 maps adds more). The port's and JAX's float32 gradients differ by up to
46% of a leaf's largest entry, and each is as far from the float64 gradient;
float32 is held by that: the port's float32 gradient no further from the
float64 one than JAX's float32 gradient is, times F32_MARGIN.

PR 13's rule, in float64: each leaf within 2e-5 of its own largest entry,
which must exceed 1e-6. A conv's bias that feeds a BatchNorm in training
mode has a gradient of exactly 0 in exact arithmetic (the batch mean removes
it): there both packages must read below 1e-6 of the largest entry of that
conv's kernel gradient. Adam on JAX's gradients: two updates within 2e-5 of
each leaf's largest value.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mere_fusion_tpu.models.syncnet import SyncNet as JaxSyncNet
from mere_fusion_tpu.models.wav2lip import Wav2Lip as JaxWav2Lip
from mere_fusion_tpu.models.wav2lip import Wav2LipDisc as JaxDisc
from mere_fusion_tpu.train import wav2lip_train as jax_train
from mere_fusion_tpu_torch.convert import (
    syncnet_from_flax,
    wav2lip_disc_from_flax,
    wav2lip_from_flax,
)
from mere_fusion_tpu_torch.models.syncnet import SyncNet
from mere_fusion_tpu_torch.models.wav2lip import ConvBNRelu, Wav2Lip, Wav2LipDisc
from mere_fusion_tpu_torch.train import wav2lip_train as train
from tests.test_torch_wav2lip import disc_tree, generator_tree, syncnet_tree
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 2e-5
FLOOR = 1e-6
F32_MARGIN = 2.0
# the plain step's weights (make_train_step's defaults) and the GAN step's
# that make its generator loss C times the plain step's:
# sync_wt·sync + disc_wt·perc + C·L1 with C = 1 − sync_wt − disc_wt
SYNC_WT, DISC_WT = 0.03, 0.07
C = 1.0 / (1.0 + SYNC_WT + DISC_WT)

# optax transformation whose state is the gradient it was given
CAPTURE = optax.GradientTransformation(
    lambda params: {}, lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def trees():
    return generator_tree(seed=21), disc_tree(seed=22), syncnet_tree(seed=23)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(24)
    return {"mel": rng.standard_normal((2, 80, 16)),
            "faces": rng.random((2, 96, 96, 6)),
            "target": rng.random((2, 96, 96, 3))}


def _numpy(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


def _jax_gan(trees, batch, dtype):
    """JAX's GAN step at disc_wt C·DISC_WT and sync_wt C·SYNC_WT in dtype
    (float64 inside a scoped x64): (new state, metrics) as numpy."""
    gen, disc, sync = (_numpy(t, dtype) for t in trees)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    with jax.enable_x64(dtype == np.float64):
        step = jax_train.make_gan_train_step(
            JaxWav2Lip(dtype=jdt), JaxDisc(dtype=jdt), CAPTURE, CAPTURE,
            syncnet=JaxSyncNet(dtype=jdt), syncnet_vars=sync, disc_wt=C * DISC_WT)
        state = jax_train.GANTrainState(
            gen=jax_train.TrainState(gen["params"], gen["batch_stats"], {},
                                     jnp.zeros((), jnp.int32)),
            disc_params=disc["params"], disc_opt_state={})
        new, metrics = jax.jit(step)(state, _numpy(batch, dtype), C * SYNC_WT)
        return jax.tree.map(np.asarray, new), {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def jax_gan64(trees, batch):
    return _jax_gan(trees, batch, np.float64)


def _port(trees, dtype=torch.float64):
    gen, disc, sync = trees
    modules = []
    for cls, state in ((Wav2Lip, wav2lip_from_flax(gen)), (Wav2LipDisc, wav2lip_disc_from_flax(disc)),
                       (SyncNet, syncnet_from_flax(sync))):
        m = cls(dtype)
        m.load_state_dict(state)
        modules.append(m.to(dtype).train())
    return modules


def _port_gan(trees, batch, dtype=torch.float64):
    model, d, s = _port(trees, dtype)
    grads_fn, _ = train.make_gan_train_step(syncnet=s, disc_wt=C * DISC_WT)
    state = train.GANTrainState(train.TrainState(model, None), d, None)
    out = grads_fn(state, {k: torch.from_numpy(v).to(dtype) for k, v in batch.items()},
                   C * SYNC_WT)
    return model, d, out


def _gen_ref(grads, trees) -> dict:
    return wav2lip_from_flax({"params": grads, "batch_stats": trees[0]["batch_stats"]})


def assert_grads_match(got: dict, ref: dict, module: torch.nn.Module, what: str,
                       scale: float = 1.0):
    """Each leaf of scale·got within RTOL of ref's largest entry (> FLOOR); a
    bias that feeds a training-mode BatchNorm near 0 in both, against its
    kernel's gradient."""
    bn_blocks = {name for name, m in module.named_modules() if isinstance(m, ConvBNRelu)}
    worst = 0.0
    for name, _ in module.named_parameters():
        g, r = scale * got[name].double().numpy(), ref[name].double().numpy()
        assert g.shape == r.shape, name
        block = name.rsplit(".", 3)[0]
        if name.endswith("conv_block.0.bias") and block in bn_blocks:
            kernel = np.abs(ref[f"{block}.conv_block.0.weight"].double().numpy()).max()
            for side in (g, r):
                assert np.abs(side).max() <= FLOOR * kernel, (what, name, np.abs(side).max())
            continue
        top = np.abs(r).max()
        assert top > FLOOR, (what, name, top)
        err = np.abs(g - r).max() / top
        worst = max(worst, err)
        assert err <= RTOL, (what, name, err)
    print(f"{what}: worst leaf {worst:.2e} of its largest entry")


def test_gan_step_matches_jax(trees, batch, jax_gan64):
    new, metrics = jax_gan64
    model, d, (got, gen_grads, disc_grads) = _port_gan(trees, batch)
    assert set(got) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), metrics[k], rtol=RTOL, err_msg=k)
    assert got["sync"] > 0 and got["perceptual"] > 0 and got["disc_fake"] > 0
    assert_grads_match(gen_grads, _gen_ref(new.gen.opt_state, trees), model, "GAN, generator")
    assert_grads_match(disc_grads, wav2lip_disc_from_flax({"params": new.disc_opt_state}), d,
                       "GAN, discriminator")
    # the forward moved the running statistics as flax does (momentum 0.9,
    # the biased batch variance), not as torch's BatchNorm2d would
    ref = wav2lip_from_flax({"params": trees[0]["params"], "batch_stats": new.gen.batch_stats})
    port = model.state_dict()
    for key, value in ref.items():
        if key.endswith(("running_mean", "running_var")):
            r = value.double().numpy()
            np.testing.assert_allclose(port[key].numpy(), r, rtol=0,
                                       atol=RTOL * np.abs(r).max(), err_msg=key)
    assert int(model.face_encoder_blocks[6][1].conv_block[1].num_batches_tracked) == 1


def test_train_step_matches_jax(trees, batch, jax_gan64):
    """make_train_step's L1 + SYNC_WT·sync + DISC_WT·(−log D) is the GAN
    step's generator loss over C at the fixture's weights (D stays inside
    the clips of both forms)."""
    new, metrics = jax_gan64
    model, d, s = _port(trees)
    grads_fn, _ = train.make_train_step(syncnet=s, disc=d, syncnet_wt=SYNC_WT, disc_wt=DISC_WT)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        scores = d(model.eval()(tb["mel"], tb["faces"]))
    assert bool(((scores > 1e-7) & (scores < 1 - 1e-7)).all())
    loss, grads = grads_fn(train.TrainState(model.train(), None), tb)
    np.testing.assert_allclose(C * float(loss), metrics["loss"], rtol=RTOL)
    assert_grads_match(grads, _gen_ref(new.gen.opt_state, trees), model,
                       "L1 + sync + disc step", scale=C)


def test_float32_step_is_as_close_to_float64_as_jax(trees, batch, jax_gan64):
    """float32 against the float64 gradient (the module docstring): over
    the generator's and the discriminator's leaves together."""
    new64, _ = jax_gan64
    new32, _ = _jax_gan(trees, batch, np.float32)
    model, d, (_, gen32, disc32) = _port_gan(trees, batch, torch.float32)
    truth = {**_gen_ref(new64.gen.opt_state, trees),
             **{f"disc.{k}": v for k, v in
                wav2lip_disc_from_flax({"params": new64.disc_opt_state}).items()}}
    jax32 = {**_gen_ref(new32.gen.opt_state, trees),
             **{f"disc.{k}": v for k, v in
                wav2lip_disc_from_flax({"params": new32.disc_opt_state}).items()}}
    port32 = {**gen32, **{f"disc.{k}": v for k, v in disc32.items()}}

    def distance(g: dict) -> float:
        num = sum(float(((g[k].double() - truth[k].double()) ** 2).sum()) for k in port32)
        return (num / sum(float((truth[k].double() ** 2).sum()) for k in port32)) ** 0.5

    port_err, jax_err = distance(port32), distance(jax32)
    print(f"float32 gradient from float64: port {port_err:.2e}, JAX {jax_err:.2e}")
    assert port_err <= F32_MARGIN * jax_err


def test_adam_matches_optax_on_jax_grads(trees, jax_gan64):
    """Two float32 updates of the generator from JAX's gradients (the second
    at half of them, so the bias correction moves): torch.optim.Adam at
    optax.adam's settings against optax.adam, at lr 1e-3 so that each update
    is well above the tolerance."""
    gen = _numpy(trees[0], np.float32)
    grads = _numpy(jax_gan64[0].gen.opt_state, np.float32)
    lr = 1e-3
    tx = optax.adam(lr)

    @jax.jit
    def two_updates(params, grads):
        opt = tx.init(params)
        for scale in (1.0, 0.5):
            upd, opt = tx.update(jax.tree.map(lambda g: g * scale, grads), opt, params)
            params = optax.apply_updates(params, upd)
        return params

    params = two_updates(gen["params"], grads)
    ref = wav2lip_from_flax({"params": _numpy(params, np.float32),
                             "batch_stats": gen["batch_stats"]})
    start = wav2lip_from_flax(gen)
    g = _gen_ref(grads, trees)
    model = Wav2Lip()
    model.load_state_dict(start)
    optimizer = train.adam(model.parameters(), lr)
    for scale in (1.0, 0.5):
        for name, p in model.named_parameters():
            p.grad = g[name] * scale
        optimizer.step()
    worst = 0.0
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        top = np.abs(r).max()
        err = np.abs(p.detach().numpy() - r).max() / top
        worst = max(worst, err)
        assert err <= RTOL, (name, err)
        assert np.abs(r - start[name].numpy()).max() > 10 * RTOL * top or (
            name.endswith("conv_block.0.bias")), name
    print(f"Adam on JAX's gradients: worst leaf {worst:.2e} of its largest value")


def test_gan_train_step_runs(batch):
    """init_gan_state and the step from seeds in float32: every leaf and
    running statistic moves, the metrics are finite and the step count
    advances."""
    state = train.init_gan_state(seed=0, device="cpu")
    _, step = train.make_gan_train_step(syncnet=SyncNet())
    before = {k: v.clone() for k, v in state.gen.model.state_dict().items()}
    disc_before = {k: v.clone() for k, v in state.disc.state_dict().items()}
    metrics = step(state, {k: torch.from_numpy(v).float() for k, v in batch.items()}, 0.0)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert state.gen.step == 1
    after = state.gen.model.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert all(not torch.equal(v, state.disc.state_dict()[k]) for k, v in disc_before.items())
    assert train.SYNC_GATE_THRESHOLD == jax_train.SYNC_GATE_THRESHOLD
