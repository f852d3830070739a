"""The port's scene-text reader (models/ocr.py, utils/torch_convert.py's
convert_craft / convert_crnn) against the JAX package's.

Weights come from numpy seeds in the flax modules' own trees (kernels
N(0, 1/fan_in), biases N(0, 0.1), BatchNorm scales U(0.8, 1.2) and biases
N(0, 0.1), running means N(0, 0.2), variances U(0.5, 2), the LSTMs'
matrices N(0, 1/hidden)) and reach the port through
``convert.craft_from_flax`` / ``crnn_from_flax``. CRAFT at width 0.125, the
CRNN at 32 output channels and hidden width 16. Tolerances: CRAFT's map
logits and the CRNN's logits 3e-4; the mean token confidences 1e-5; the
boxes from one map equal to 1e-4 px.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.models import ocr as jocr
from mere_fusion_tpu.utils import torch_convert as jconvert
from mere_fusion_tpu_torch.convert import craft_from_flax, crnn_from_flax
from mere_fusion_tpu_torch.models import ocr
from mere_fusion_tpu_torch.utils import torch_convert
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
WIDTH = 0.125
OC, HIDDEN = 32, 16
N_CLS = 1 + len(ocr.DEFAULT_CHARSET)
LOGIT_ATOL = 3e-4
CONF_ATOL = 1e-5
BOX_ATOL = 1e-4


def _seeded(module, shape, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['kernel']"):
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if "'w_" in name:                                   # LSTM matrices (4H, ·)
            return (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name.endswith("['mean']"):
            return (0.2 * rng.standard_normal(shape)).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    abstract = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros(shape))
    return jax.tree_util.tree_map_with_path(fill, abstract)


@pytest.fixture(scope="module")
def craft_tree():
    return _seeded(jocr.CRAFT(width=WIDTH), (1, 64, 64, 3), seed=0)


@pytest.fixture(scope="module")
def crnn_tree():
    return _seeded(jocr.CRNN(n_classes=N_CLS, output_channel=OC, hidden=HIDDEN),
                   (1, 64, 64, 1), seed=1)


def _port_crnn(state) -> ocr.CRNN:
    net = ocr.CRNN(N_CLS, OC, HIDDEN)
    net.load_state_dict(state, strict=True)
    return net.eval()


def _port_craft(state) -> ocr.CRAFT:
    net = ocr.CRAFT(width=WIDTH)
    net.load_state_dict(state, strict=True)
    return net.eval()


def test_craft_maps_as_jax(craft_tree):
    x = np.random.default_rng(2).standard_normal((1, 64, 96, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jocr.CRAFT(width=WIDTH).apply)(craft_tree, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_craft(craft_from_flax(craft_tree, width=WIDTH))(
            torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 32, 48, 2)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("width", [64, 256])
def test_crnn_logits_as_jax(crnn_tree, width):
    """The recognizer over crops with a zero tail (REC_WIDTH_BUCKETS'
    padding), which both directions of the BiLSTM read."""
    rng = np.random.default_rng(width)
    crops = [rng.integers(0, 255, (64, w), np.uint8) for w in (width * 5 // 8, width * 7 // 8)]
    x = np.stack([ocr.TextReader.prep_crop(c)[0] for c in crops])[..., None]
    assert x.shape == (2, 64, width, 1) and (x[0, :, -8:] == 0).all()
    want = np.asarray(jax.jit(jocr.CRNN(N_CLS, OC, HIDDEN).apply)(crnn_tree, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_crnn(crnn_from_flax(crnn_tree, N_CLS, OC, HIDDEN))(
            torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, width // 4 - 1, N_CLS)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("ids", [[0, 11, 11, 0, 12, 12], [11, 0, 11], [0, 0, 0], [],
                                 list(range(0, 96, 3)) + [95, 95, 1]])
def test_ctc_greedy_as_jax(ids):
    ids = np.array(ids, np.int64)
    assert ocr.ctc_greedy(ids) == jocr.ctc_greedy(ids)
    assert ocr.ctc_greedy(ids, "xyz" * 40) == jocr.ctc_greedy(ids, "xyz" * 40)


@pytest.fixture(scope="module")
def readers(craft_tree, crnn_tree):
    """(JAX TextReader, the port's) on the same seeded weights."""
    jr = jocr.TextReader(det_variables=craft_tree, rec_variables=crnn_tree, width=WIDTH)
    jr._rec = jax.jit(lambda v, x: jnp.argmax(
        jocr.CRNN(N_CLS, OC, HIDDEN).apply(v, x), axis=-1))
    jr._rec_conf = jax.jit(lambda v, x: jnp.max(jax.nn.softmax(
        jocr.CRNN(N_CLS, OC, HIDDEN).apply(v, x), -1), -1))
    pr = ocr.TextReader(det_state=craft_from_flax(craft_tree, width=WIDTH), width=WIDTH,
                        device=CPU)
    pr.rec = _port_crnn(crnn_from_flax(crnn_tree, N_CLS, OC, HIDDEN))
    return jr, pr


def _maps(size: int = 160) -> np.ndarray:
    maps = np.zeros((size, size, 2), np.float32)
    maps[10:14, 10:30, 0] = 0.9          # a strong word
    maps[40:44, 10:30, 0] = 0.5          # above low_text, below text_threshold
    maps[60:62, 10:12, 0] = 0.9          # a blob under the area floor
    maps[80:86, 20:90, 0] = 0.8          # a word joined to ...
    maps[82:84, 90:96, 1] = 0.6          # ... the next by affinity
    maps[80:86, 96:130, 0] = 0.75
    maps[100:130, 100:104, 0] = 0.95     # a vertical stroke
    return maps


@pytest.mark.parametrize("hw", [(320, 320), (240, 320), (720, 1280)])
def test_detect_canvas_and_boxes_as_jax(readers, hw):
    """The same detection canvas, and the same boxes from one map through
    each package's host extraction."""
    jr, pr = readers
    frame = np.random.default_rng(hw[1]).integers(0, 255, hw + (3,), np.uint8)
    canvas, scale = pr.detection_canvas(frame)
    seen = []
    maps = _maps(canvas.shape[0] // 2)
    jr._det = lambda v, x: (seen.append(np.asarray(x)), jnp.asarray(maps[None]))[1]
    want = jr.detect(frame)
    assert canvas.shape == (max(hw) if max(hw) in (320, 640, 960) else 960,) * 2 + (3,)
    np.testing.assert_array_equal(canvas, seen[0][0])
    got = pr.boxes_from_maps(maps, scale)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == (4, 2)
        np.testing.assert_allclose(g, w, atol=BOX_ATOL, rtol=0)


def test_detection_maps_as_jax(readers):
    jr, pr = readers
    frame = np.random.default_rng(3).integers(0, 255, (200, 300, 3), np.uint8)
    canvas, _ = pr.detection_canvas(frame)
    want = np.asarray(jax.jit(lambda v, x: jax.nn.sigmoid(jocr.CRAFT(width=WIDTH).apply(v, x)))(
        jr.det_variables, jnp.asarray(canvas[None])))[0]
    got = pr.detection_maps(canvas)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL / 4, rtol=0)


def test_readtext_and_recognize_as_jax(readers, monkeypatch):
    """readtext's contract, [(4-point box, text, confidence)], equal to
    JAX's on one map and the seeded recognizer; crops of several width
    buckets in one recognize call."""
    jr, pr = readers
    frame = np.random.default_rng(4).integers(0, 255, (320, 320, 3), np.uint8)
    maps = _maps()
    jr._det = lambda v, x: jnp.asarray(maps[None])
    monkeypatch.setattr(pr, "detection_maps", lambda canvas: maps)
    want, got = jr.readtext(frame), pr.readtext(frame)
    assert len(got) == len(want) > 0
    for (gq, gt, gc), (wq, wt, wc) in zip(got, want):
        assert isinstance(gq, list) and np.asarray(gq).shape == (4, 2)
        np.testing.assert_allclose(gq, wq, atol=BOX_ATOL)
        assert gt == wt and isinstance(gt, str) and gt
        assert 0.0 <= gc <= 1.0 and abs(gc - wc) <= CONF_ATOL
    rng = np.random.default_rng(5)
    crops = [rng.integers(0, 255, (20, w), np.uint8) for w in (12, 300, 900)]
    got, want = pr.recognize(crops), jr.recognize(crops)
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], atol=CONF_ATOL)
    assert pr.recognize([]) == []


# EasyOCR's module names, in the module's order (the converters go by
# order): CRNN exactly english_g2's; CRAFT in CRAFT-pytorch's style (basenet
# slices, upconv blocks, conv_cls) with the JAX package's layer counts
# (ROADMAP §3: the published CRAFT has one VGG conv fewer)
_CRNN_NAMES = {"conv_0": "FeatureExtraction.ConvNet.0", "conv_1": "FeatureExtraction.ConvNet.3",
               "conv_2": "FeatureExtraction.ConvNet.6", "conv_3": "FeatureExtraction.ConvNet.8",
               "conv_4": "FeatureExtraction.ConvNet.11", "bn_4": "FeatureExtraction.ConvNet.12",
               "conv_5": "FeatureExtraction.ConvNet.14", "bn_5": "FeatureExtraction.ConvNet.15",
               "conv_6": "FeatureExtraction.ConvNet.18",
               "rnn_0.lstm": "SequenceModeling.0.rnn", "rnn_0.proj": "SequenceModeling.0.linear",
               "rnn_1.lstm": "SequenceModeling.1.rnn", "rnn_1.proj": "SequenceModeling.1.linear",
               "head": "Prediction"}
_UP_PARTS = {"conv_0": 0, "bn_0": 1, "conv_1": 3, "bn_1": 4}


def _craft_name(module: str) -> str:
    if module in ("fc6", "fc7"):
        return f"basenet.slice6.{1 if module == 'fc6' else 2}"
    if module.startswith("up_"):
        block, part = module[len("up_"):].split(".")
        return f"upconv{int(block) + 1}.conv.{_UP_PARTS[part]}"
    if module.startswith("cls_"):
        return f"conv_cls.{2 * int(module[len('cls_'):])}"
    stage, rest = module[1:].split("_")
    j, part = rest.split(".")
    return f"basenet.slice{stage}.{3 * int(j) + (part == 'bn')}"


def _easyocr(net: torch.nn.Module, name) -> dict:
    out = {}
    for key, v in net.state_dict().items():
        module, leaf = key.rsplit(".", 1)
        out[f"module.{name(module)}.{leaf}"] = v
    return out


def _easyocr_crnn(net: ocr.CRNN) -> dict:
    return _easyocr(net, _CRNN_NAMES.__getitem__)


def _easyocr_craft(state) -> dict:
    return _easyocr(_port_craft(state), _craft_name)


def test_easyocr_layout_through_both_converters(craft_tree, crnn_tree):
    rec = _easyocr_crnn(_port_crnn(crnn_from_flax(crnn_tree, N_CLS, OC, HIDDEN)))
    assert "module.SequenceModeling.1.rnn.weight_hh_l0_reverse" in rec
    x = np.stack([ocr.TextReader.prep_crop(np.full((16, 40), 200, np.uint8))[0]])[..., None]
    want = np.asarray(jax.jit(jocr.CRNN(N_CLS, OC, HIDDEN).apply)(jconvert.convert_crnn(rec),
                                                                   jnp.asarray(x)))
    with torch.no_grad():
        got = _port_crnn(torch_convert.convert_crnn(rec))(
            torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)

    det = _easyocr_craft(craft_from_flax(craft_tree, width=WIDTH))
    assert "module.basenet.slice6.1.weight" in det and "module.upconv4.conv.4.running_var" in det
    x = np.random.default_rng(6).standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jocr.CRAFT(width=WIDTH).apply)(jconvert.convert_craft(det),
                                                              jnp.asarray(x)))
    with torch.no_grad():
        got = _port_craft(torch_convert.convert_craft(det))(
            torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)

    for convert, what in ((torch_convert.convert_craft, "CRAFT"),
                          (torch_convert.convert_crnn, "CRNN")):
        with pytest.raises(ValueError, match=f"{what} checkpoint shape"):
            convert({"a.weight": torch.zeros(4, 3, 3, 3), "a.bias": torch.zeros(4)})


def test_make_ocr_from_easyocr_files(tmp_path, craft_tree):
    """make_ocr's {craft, crnn} paths (EasyOCR .pth files) through the
    converters; "random" a width-0.25 detector on the device given."""
    from mere_fusion_tpu_torch.perception import make_ocr

    crnn_tree = _seeded(jocr.CRNN(), (1, 64, 64, 1), seed=7)
    torch.save({"state_dict": _easyocr_craft(craft_from_flax(craft_tree, width=WIDTH))},
               tmp_path / "craft.pth")
    full = ocr.CRNN()
    full.load_state_dict(crnn_from_flax(crnn_tree), strict=True)
    torch.save(_easyocr_crnn(full), tmp_path / "english_g2.pth")
    reader = make_ocr({"craft": str(tmp_path / "craft.pth"),
                       "crnn": str(tmp_path / "english_g2.pth"), "width": WIDTH}, device=CPU)
    assert reader.det.s1_0.conv.out_channels == 8 and reader.rec.rnn_0.lstm.hidden_size == 256
    frame = np.random.default_rng(8).integers(0, 255, (64, 96, 3), np.uint8)
    canvas, _ = reader.detection_canvas(frame)
    want = jax.nn.sigmoid(jax.jit(jocr.CRAFT(width=WIDTH).apply)(craft_tree,
                                                                 jnp.asarray(canvas[None])))
    np.testing.assert_allclose(reader.detection_maps(canvas), np.asarray(want)[0],
                               atol=LOGIT_ATOL / 4)
    random = make_ocr("random", device=CPU)
    assert random.det.s1_0.conv.out_channels == 16 and make_ocr(None) is None
    assert make_ocr(random) is random
