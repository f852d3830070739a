"""The Wav2Lip models of the PyTorch port against the JAX package.

The generator, its discriminator and SyncNet at their published widths
(96 px faces), batch 2. Weights come from numpy seeds in the JAX modules'
own tree (``jax.eval_shape`` of their init): kernels N(0, 1/fan_in), biases
N(0, 0.1), BatchNorm scales U(0.8, 1.2) and biases N(0, 0.1), and the
running statistics randomised (mean N(0, 0.2), variance U(0.5, 2)), so a
statistic that maps to the wrong place cannot hide. Tolerances: 2e-5 in
float32 (the conv rule); in bfloat16 the uint8 frames of both packages may
differ by 1 LSB at rounding boundaries, and no more than BF16_SHARE of
values may differ by more.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.models.syncnet import SyncNet as JaxSyncNet
from mere_fusion_tpu.models.syncnet import convert_syncnet as jax_convert_syncnet
from mere_fusion_tpu.models.wav2lip import Wav2Lip as JaxWav2Lip
from mere_fusion_tpu.models.wav2lip import Wav2LipDisc as JaxDisc
from mere_fusion_tpu.utils import torch_convert as jax_convert
from mere_fusion_tpu_torch.convert import (
    syncnet_from_flax,
    wav2lip_disc_from_flax,
    wav2lip_from_flax,
)
from mere_fusion_tpu_torch.device import random_init_
from mere_fusion_tpu_torch.models.syncnet import SyncNet
from mere_fusion_tpu_torch.models.wav2lip import (
    AUDIO_ENCODER,
    FACE_DECODER,
    FACE_ENCODER,
    Wav2Lip,
    Wav2LipDisc,
)
from mere_fusion_tpu_torch.utils.torch_convert import (
    convert_syncnet,
    convert_wav2lip,
    convert_wav2lip_disc,
    load_torch_checkpoint,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

B = 2
ATOL = 2e-5
# bf16: share of uint8 values more than 1 LSB apart between the packages'
# bf16 frames. Both round at the same places (conv output, bias add, BN
# output, residual add), so only sums in another order differ; measured 0
BF16_SHARE = 1e-3


def _fill(rng):
    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['kernel']"):
            # flax convs are [kh, kw, in, out]; the transposed convs keep
            # torch's (cin, cout, k, k)
            transposed = "['conv']" not in name and not any(
                f"'{m}'" in name for m in ("out_1", "pred"))
            fan_in = shape[0] * shape[2] * shape[3] if transposed else np.prod(shape[:-1])
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name.endswith("['mean']"):
            return (0.2 * rng.standard_normal(shape)).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return fill


def seeded_tree(module, *shapes, seed: int = 0) -> dict:
    """The module's variables with every leaf drawn from a numpy seed."""
    abstract = jax.eval_shape(module.init, jax.random.key(0),
                              *[jnp.zeros(s) for s in shapes])
    return jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(seed)), abstract)


def generator_tree(seed: int = 0) -> dict:
    return seeded_tree(JaxWav2Lip(), (1, 80, 16), (1, 96, 96, 6), seed=seed)


def disc_tree(seed: int = 1) -> dict:
    return seeded_tree(JaxDisc(), (1, 96, 96, 3), seed=seed)


def syncnet_tree(seed: int = 2) -> dict:
    return seeded_tree(JaxSyncNet(), (1, 80, 16), (1, 48, 96, 15), seed=seed)


def generator_inputs(seed: int = 3, batch: int = B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, 80, 16)).astype(np.float32),
            rng.random((batch, 96, 96, 6)).astype(np.float32))


def port_module(cls, state, dtype=torch.float32):
    module = cls(dtype)
    module.load_state_dict(state, strict=True)
    return module.eval()


def to_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(x * 255.0, 0, 255).astype(np.uint8).astype(np.int64)


@pytest.fixture(scope="module")
def gen_tree():
    return generator_tree()


@pytest.fixture(scope="module")
def inputs():
    return generator_inputs()


def test_generator_matches_jax_f32(gen_tree, inputs):
    mel, faces = inputs
    ref = np.asarray(jax.jit(JaxWav2Lip().apply)(gen_tree, mel, faces))
    model = port_module(Wav2Lip, wav2lip_from_flax(gen_tree))
    with torch.no_grad():
        got = model(torch.from_numpy(mel), torch.from_numpy(faces)).numpy()
    assert got.shape == ref.shape == (B, 96, 96, 3)
    # the comparison means something only off the sigmoid's tails
    assert ((ref > 0.02) & (ref < 0.98)).mean() > 0.9
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    # NHWC mel with a trailing channel is the same input
    with torch.no_grad():
        again = model(torch.from_numpy(mel)[..., None], torch.from_numpy(faces)).numpy()
    np.testing.assert_allclose(again, ref, atol=ATOL, rtol=0)


def test_generator_bf16_rounds_where_jax_rounds(gen_tree, inputs):
    mel, faces = inputs
    ref = np.asarray(jax.jit(JaxWav2Lip(dtype=jnp.bfloat16).apply)(gen_tree, mel, faces))
    model = port_module(Wav2Lip, wav2lip_from_flax(gen_tree), torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(mel), torch.from_numpy(faces))
    assert got.dtype == torch.float32           # the sigmoid runs in f32
    diff = np.abs(to_u8(got.numpy()) - to_u8(ref))
    share = float((diff > 1).mean())
    print(f"bf16 frames: share of values more than 1 LSB apart {share:.2e}, "
          f"largest {diff.max()} LSB")
    assert share <= BF16_SHARE


@pytest.mark.parametrize("which", ["disc", "syncnet"])
def test_scorers_match_jax_f32(which):
    rng = np.random.default_rng(4)
    if which == "disc":
        tree = disc_tree()
        faces = rng.random((B, 96, 96, 3)).astype(np.float32)
        ref = np.asarray(jax.jit(JaxDisc().apply)(tree, faces))
        model = port_module(Wav2LipDisc, wav2lip_disc_from_flax(tree))
        with torch.no_grad():
            got = model(torch.from_numpy(faces)).numpy()
        assert got.shape == (B, 1)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
        return
    tree = syncnet_tree()
    mel = rng.standard_normal((B, 80, 16)).astype(np.float32)
    faces = rng.random((B, 48, 96, 15)).astype(np.float32)
    ref = [np.asarray(r) for r in jax.jit(JaxSyncNet().apply)(tree, mel, faces)]
    model = port_module(SyncNet, syncnet_from_flax(tree))
    with torch.no_grad():
        got = [g.numpy() for g in model(torch.from_numpy(mel), torch.from_numpy(faces))]
    for g, r in zip(got, ref):
        assert g.shape == (B, 512)
        np.testing.assert_allclose(np.linalg.norm(g, axis=-1), 1.0, atol=1e-6)
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)


def _reference_layout(state: dict, keep_count: bool) -> dict:
    """The port's state as a reference checkpoint saves it: ``module.``
    prefixed, with or without BatchNorm's batch counts (older torch)."""
    return {f"module.{k}": v.clone() for k, v in state.items()
            if keep_count or not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("family", ["wav2lip", "disc", "syncnet"])
def test_reference_converter_matches_flax_path(family, tmp_path):
    tree, from_flax, convert, jax_from_ref = {
        "wav2lip": (generator_tree(seed=5), wav2lip_from_flax, convert_wav2lip,
                    jax_convert.convert_wav2lip),
        "disc": (disc_tree(seed=6), wav2lip_disc_from_flax, convert_wav2lip_disc,
                 jax_convert.convert_wav2lip_disc),
        "syncnet": (syncnet_tree(seed=7), syncnet_from_flax, convert_syncnet,
                    jax_convert_syncnet),
    }[family]
    state = from_flax(tree)
    for keep_count in (True, False):
        ref = _reference_layout(state, keep_count)
        got = convert(ref)
        assert set(got) == set(state)
        for k in state:
            torch.testing.assert_close(got[k], state[k], rtol=0, atol=0)
        # the JAX package's converter reads the same file back to the tree:
        # the port's names are the reference's
        back = jax_from_ref(ref)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                     back, jax.tree.map(np.asarray, dict(tree)))
    path = str(tmp_path / "ckpt.pth")
    torch.save({"state_dict": _reference_layout(state, True), "global_step": 3}, path)
    loaded = convert(load_torch_checkpoint(path))
    assert all(torch.equal(loaded[k], state[k]) for k in state)
    bad = _reference_layout(state, True)
    bad["module.extra.weight"] = torch.zeros(1)
    with pytest.raises(KeyError, match="extra"):
        convert(bad)
    bad = _reference_layout(state, True)
    bad.pop(next(k for k in bad if k.endswith(".weight")))
    with pytest.raises(KeyError, match="missing"):
        convert(bad)


def test_random_init_sets_batchnorm_to_identity():
    model = random_init_(Wav2Lip().to_empty(device="cpu"), seed=0)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    # every conv block of the encoders and the decoder, and output_block.0
    assert len(bns) == (len(AUDIO_ENCODER) + sum(map(len, FACE_ENCODER))
                        + sum(map(len, FACE_DECODER)) + 1)
    for bn in bns:
        assert torch.equal(bn.weight, torch.ones_like(bn.weight))
        assert torch.equal(bn.bias, torch.zeros_like(bn.bias))
        assert torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))
        assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
        assert int(bn.num_batches_tracked) == 0
    convs = [m for m in model.modules() if isinstance(m, (torch.nn.Conv2d,
                                                          torch.nn.ConvTranspose2d))]
    assert all(c.weight.std() > 0 and not c.bias.any() for c in convs)
    # a seeded generator is not a constant face
    mel, faces = generator_inputs(batch=1)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(mel), torch.from_numpy(faces))
    assert out.std() > 1e-3


def test_seeded_modules_without_batchnorm_are_unchanged():
    """random_init_'s BatchNorm branch touches no other family: the MuseTalk
    VAE and UNet, the whisper encoder and the ER-NeRF network carry none."""
    from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork
    from mere_fusion_tpu_torch.models.musetalk import (
        AutoencoderKL,
        UNet2DCondition,
        UNetConfig,
        VAEConfig,
    )
    from mere_fusion_tpu_torch.models.whisper import TINY, AudioEncoder

    with torch.device("meta"):
        modules = [AutoencoderKL(VAEConfig()), UNet2DCondition(UNetConfig()),
                   AudioEncoder(TINY), NeRFNetwork(NeRFNetConfig())]
    for module in modules:
        assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                       for m in module.modules()), type(module).__name__


def test_specs_are_the_jax_packages(gen_tree):
    """The port's layer specs are copies of the JAX package's (the width is
    fixed: 96 px faces, 36.30 M generator parameters)."""
    import mere_fusion_tpu.models.syncnet as jax_syncnet
    import mere_fusion_tpu.models.wav2lip as jax_wav2lip
    import mere_fusion_tpu_torch.models.syncnet as port_syncnet
    import mere_fusion_tpu_torch.models.wav2lip as port_wav2lip

    for name in ("FACE_ENCODER", "AUDIO_ENCODER", "FACE_DECODER", "DISC_ENCODER"):
        assert getattr(port_wav2lip, name) == getattr(jax_wav2lip, name), name
    for name in ("SYNC_FACE", "SYNC_AUDIO"):
        assert getattr(port_syncnet, name) == getattr(jax_syncnet, name), name
    n = sum(p.numel() for p in Wav2Lip().parameters())
    assert n == sum(np.prod(x.shape) for x in jax.tree.leaves(gen_tree["params"]))
    assert n == 36_298_035
