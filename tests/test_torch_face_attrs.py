"""The port's face-attribute nets (models/face_attrs.py, utils/keras_convert.py)
against the JAX package's, at width 0.125 on the CPU.

Weights come from numpy seeds in the flax modules' own trees (kernels
N(0, 1/fan_in), biases N(0, 0.1)) and reach the port through
``convert.face_attrs_from_flax``, or through a DeepFace-layout Keras ``.h5``
file written with h5py and read by both packages' converters. Tolerances:
VGGFaceAttr's probabilities 3e-4 and EmotionNet's 2e-5 (the JAX package's
own against its torch twins, tests/test_face_attrs.py); ``analyze``'s
distributions, in percent, 3e-2.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.models import face_attrs as jfa
from mere_fusion_tpu.utils import keras_convert as jkeras
from mere_fusion_tpu_torch.convert import face_attrs_from_flax
from mere_fusion_tpu_torch.models import face_attrs
from mere_fusion_tpu_torch.utils import keras_convert
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
WIDTH = 0.125
VGG_ATOL = 3e-4
EMOTION_ATOL = 2e-5
PERCENT_ATOL = 3e-2
TASKS = {"age": 101, "gender": 2, "race": 6}


def _seeded(module, shape, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
                    ).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    abstract = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros(shape))
    return jax.tree_util.tree_map_with_path(fill, abstract)


@pytest.fixture(scope="module")
def trees():
    """Seeded flax variables of every task at WIDTH."""
    out = {task: _seeded(jfa.VGGFaceAttr(n, width=WIDTH), (1, 224, 224, 3), seed=i)
           for i, (task, n) in enumerate(TASKS.items())}
    out["emotion"] = _seeded(jfa.EmotionNet(width=WIDTH), (1, 48, 48, 1), seed=9)
    return out


def _port_net(task, tree):
    net = face_attrs.EmotionNet(width=WIDTH) if task == "emotion" else \
        face_attrs.VGGFaceAttr(TASKS[task], width=WIDTH)
    net.load_state_dict(face_attrs_from_flax(tree, TASKS.get(task), width=WIDTH), strict=True)
    return net.eval()


@pytest.mark.parametrize("task", sorted(TASKS))
def test_vggface_attr_as_jax(trees, task):
    x = np.random.default_rng(1).random((2, 224, 224, 3), np.float32)
    want = np.asarray(jax.jit(jfa.VGGFaceAttr(TASKS[task], width=WIDTH).apply)(
        trees[task], jnp.asarray(x)))
    with torch.no_grad():
        got = _port_net(task, trees[task])(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, TASKS[task]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=VGG_ATOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_emotion_net_as_jax(trees):
    x = np.random.default_rng(3).random((3, 48, 48, 1), np.float32)
    want = np.asarray(jax.jit(jfa.EmotionNet(width=WIDTH).apply)(trees["emotion"],
                                                                 jnp.asarray(x)))
    with torch.no_grad():
        got = _port_net("emotion", trees["emotion"])(
            torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, atol=EMOTION_ATOL, rtol=0)


def _write_keras_h5(path, named_arrays, nest: bool = False):
    """A Keras weight file as DeepFace ships them: ``layer_names``, each
    layer's ``weight_names`` and its kernel:0 / bias:0 datasets; ``nest``
    puts them under ``model_weights`` as a full model save does."""
    import h5py

    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights") if nest else f
        root.attrs["layer_names"] = np.array([n.encode() for n, _ in named_arrays])
        for name, arrays in named_arrays:
            g = root.create_group(name)
            if arrays is None:                       # a weightless layer (pooling …)
                g.attrs["weight_names"] = np.array([], dtype="S1")
                continue
            wn = [f"{name}/kernel:0", f"{name}/bias:0"]
            g.attrs["weight_names"] = np.array([s.encode() for s in wn])
            for s, a in zip(wn, arrays):
                g.create_dataset(s, data=a)


def _h5_from_tree(path, tree, order, nest=False):
    params = tree["params"]
    named = [("input_1", None)]
    for i, n in enumerate(order):
        named.append((f"conv2d_{i}" if "conv" in n else f"dense_{i}",
                      [np.asarray(params[n]["kernel"]), np.asarray(params[n]["bias"])]))
        if n == "conv_1":
            named.append(("max_pooling2d", None))
    _write_keras_h5(path, named, nest)


@pytest.mark.parametrize("task", ["emotion", "gender"])
def test_deepface_h5_through_both_converters(tmp_path, trees, task):
    """A DeepFace-layout .h5 through each package's converter gives the same
    probabilities: the kernels' order and layout, EmotionNet's flatten."""
    path = str(tmp_path / f"{task}.h5")
    x = np.random.default_rng(5).random((2, 48, 48, 1) if task == "emotion"
                                        else (2, 224, 224, 3), np.float32)
    if task == "emotion":
        order = [f"conv_{i}" for i in range(5)] + [f"dense_{i}" for i in range(3)]
        _h5_from_tree(path, trees[task], order)
        variables = jkeras.convert_emotion_h5(path, width=WIDTH)
        state = keras_convert.convert_emotion_h5(path, width=WIDTH)
        jm, net, atol = jfa.EmotionNet(width=WIDTH), face_attrs.EmotionNet(width=WIDTH), \
            EMOTION_ATOL
    else:
        order = [f"conv_{i}" for i in range(13)] + ["fc_0", "fc_1", "head"]
        _h5_from_tree(path, trees[task], order, nest=True)
        variables = jkeras.convert_vggface_h5(path, n_classes=2, width=WIDTH)
        state = keras_convert.convert_vggface_h5(path, n_classes=2, width=WIDTH)
        jm, net, atol = jfa.VGGFaceAttr(2, width=WIDTH), \
            face_attrs.VGGFaceAttr(2, width=WIDTH), VGG_ATOL
    net.load_state_dict(state, strict=True)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_h5_shape_mismatch_is_loud(tmp_path):
    path = str(tmp_path / "bad.h5")
    _write_keras_h5(path, [("conv2d", [np.zeros((9, 9, 1, 4), np.float32),
                                       np.zeros((4,), np.float32)])])
    with pytest.raises(ValueError, match="weighted layers"):
        keras_convert.convert_emotion_h5(path, width=WIDTH)
    slots = keras_convert.emotion_slots(WIDTH)
    named = [(n, [np.zeros(s, np.float32), np.zeros((s[-1],), np.float32)]) for n, s in slots]
    named[5] = ("dense", [np.zeros((8, 128), np.float32), np.zeros((128,), np.float32)])
    _write_keras_h5(path, named)
    with pytest.raises(ValueError, match=r"kernel \(8, 128\) does not match slot 'dense_0'"):
        keras_convert.convert_emotion_h5(path, width=WIDTH)


def test_apparent_age_expectation():
    probs = torch.zeros(1, 101)
    probs[0, 30], probs[0, 40] = 0.5, 0.5
    assert float(face_attrs.apparent_age(probs)[0]) == pytest.approx(35.0)
    assert float(face_attrs.apparent_age(probs)[0]) == float(jfa.apparent_age(
        jnp.asarray(probs.numpy()))[0])


def _analyzers(trees, detector, tasks=("age", "gender", "race", "emotion")):
    jax_an = jfa.FaceAttributeAnalyzer(**{t: trees[t] for t in tasks}, width=WIDTH,
                                       detector=detector)
    port_an = face_attrs.FaceAttributeAnalyzer(
        **{t: face_attrs_from_flax(trees[t], TASKS.get(t), width=WIDTH) for t in tasks},
        width=WIDTH, detector=detector, device=CPU)
    return jax_an, port_an


@pytest.mark.parametrize("faces", [2, 6, 0, None], ids=["two", "six", "none", "whole_frame"])
def test_analyze_as_jax(trees, faces):
    """analyze()'s dicts (DeepFace's keys: age int, distributions in percent,
    dominant_* labels, region) equal JAX's; at most MAX_FACES faces; without
    a detector the whole frame is one face."""
    boxes = [(10 + 40 * i, 10 + 5 * i, 90 + 40 * i, 110) for i in range(faces or 0)]
    detector = None if faces is None else (lambda frame: boxes)
    jax_an, port_an = _analyzers(trees, detector)
    frame = np.random.default_rng(6).integers(0, 255, (240, 320, 3), np.uint8)
    want, got = jax_an.analyze(frame), port_an.analyze(frame)
    assert len(got) == len(want) == (1 if faces is None else min(faces, face_attrs.MAX_FACES))
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert g["region"] == w["region"] and g["age"] == w["age"]
        assert isinstance(g["age"], int) and 0 <= g["age"] <= 100
        for task in ("gender", "race", "emotion"):
            assert g[f"dominant_{task}"] == w[f"dominant_{task}"]
            assert list(g[task]) == list(w[task])
            np.testing.assert_allclose(list(g[task].values()), list(w[task].values()),
                                       atol=PERCENT_ATOL)
            assert sum(g[task].values()) == pytest.approx(100.0, abs=1e-2)


def test_init_random_and_from_h5(tmp_path, trees):
    an = face_attrs.FaceAttributeAnalyzer.init_random(tasks=("age", "gender", "emotion"),
                                                      device=CPU)
    assert sorted(an.nets) == ["age", "emotion", "gender"]
    assert an.nets["age"].conv_0.out_channels == 16            # width 0.25
    frame = np.random.default_rng(7).integers(0, 255, (120, 160, 3), np.uint8)
    (face,) = an.analyze(frame)
    assert face["dominant_emotion"] in face_attrs.EMOTION_LABELS and "race" not in face
    path = str(tmp_path / "emotion.h5")
    _h5_from_tree(path, trees["emotion"],
                  [f"conv_{i}" for i in range(5)] + [f"dense_{i}" for i in range(3)])
    h5 = face_attrs.FaceAttributeAnalyzer.from_h5(emotion=path, width=WIDTH, device=CPU)
    _, port_an = _analyzers(trees, None, tasks=("emotion",))
    assert h5.analyze(frame) == port_an.analyze(frame)
