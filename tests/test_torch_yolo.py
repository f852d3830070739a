"""The port's YOLOv10 (models/yolo.py, utils/yolo_convert.py, the "yolo"
serving tree) against the JAX package's.

Weights come from numpy seeds in the flax modules' own trees (kernels
N(0, 1/fan_in), biases N(0, 0.1), BatchNorm scales U(0.8, 1.2) and biases
N(0, 0.1), running means N(0, 0.2), variances U(0.5, 2)) and reach the port
through ``convert.yolo_from_flax``. Tolerances are the JAX package's own
against its torch twin (tests/test_yolo.py): raw scores 3e-4 and boxes 3e-3
px in float32 at 64 px; a block's output within 3e-4 of its largest
magnitude; bf16 against JAX's bf16 within BF16_SCORE_ATOL (a bf16 rounding
step of a logit near 1 is 8e-3, the sigmoid's slope at most 1/4) and
BF16_BOX_ATOL px (a fraction of the stride 8; the two read 6e-4 and 0.044
px apart here).
"""
from __future__ import annotations

import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.models import yolo as jyolo
from mere_fusion_tpu.utils import yolo_convert as jconvert
from mere_fusion_tpu_torch.convert import _INDEX_NAMES, _with_stats_from_flax, yolo_from_flax
from mere_fusion_tpu_torch.engines import shared_device_tree
from mere_fusion_tpu_torch.models import yolo
from mere_fusion_tpu_torch.utils import yolo_convert
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
SCORE_ATOL = 3e-4
BOX_ATOL = 3e-3
BLOCK_REL = 3e-4
BF16_SCORE_ATOL = 2e-3
BF16_BOX_ATOL = 0.25

# every block type, RepVGGDW (lk) and a one-head PSA among them, at 64 px
TINY_SPEC = (
    (-1, 1, "Conv", (16, 3, 2)),
    (-1, 1, "Conv", (32, 3, 2)),
    (-1, 1, "C2f", (32, True)),
    (-1, 1, "Conv", (48, 3, 2)),        # P3/8
    (-1, 2, "C2f", (48, True)),
    (-1, 1, "SCDown", (64, 3, 2)),      # P4/16
    (-1, 1, "C2fCIB", (64, True)),
    (-1, 1, "SCDown", (128, 3, 2)),     # P5/32
    (-1, 1, "C2fCIB", (128, True, True)),
    (-1, 1, "SPPF", (128, 5)),
    (-1, 1, "PSA", (128,)),
    (-1, 1, "Upsample", ()),
    ((-1, 6), 1, "Concat", ()),
    (-1, 1, "C2fCIB", (64, True)),
    (-1, 1, "Upsample", ()),
    ((-1, 4), 1, "Concat", ()),
    (-1, 1, "C2f", (48,)),
    (-1, 1, "Conv", (48, 3, 2)),
    ((-1, 13), 1, "Concat", ()),
    (-1, 1, "C2fCIB", (64, True)),
    (-1, 1, "SCDown", (64, 3, 2)),
    ((-1, 10), 1, "Concat", ()),
    (-1, 1, "C2fCIB", (128, True)),
    ((16, 19, 22), 1, "Detect", ()),
)
NC = 8
IMGSZ = 64
NAMES = ["person"] + [f"c{i}" for i in range(1, NC)]


def _fill(rng):
    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['kernel']"):
            fan_in = np.prod(shape[:-1])
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name.endswith("['mean']"):
            return (0.2 * rng.standard_normal(shape)).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return fill


def seeded_tree(module, *example, seed: int = 0) -> dict:
    """The flax module's variables, every leaf drawn from a numpy seed."""
    abstract = jax.eval_shape(module.init, jax.random.key(0), *example)
    return jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(seed)), abstract)


def tiny_jax(**kw):
    return jyolo.YoloV10(scale="l", nc=NC, imgsz=IMGSZ, spec=TINY_SPEC, **kw)


@pytest.fixture(scope="module")
def tree():
    return seeded_tree(tiny_jax(), jnp.zeros((1, IMGSZ, IMGSZ, 3)), seed=0)


@pytest.fixture(scope="module")
def state(tree):
    return yolo_from_flax(tree, scale="l", nc=NC, spec=TINY_SPEC)


@pytest.fixture(scope="module")
def model(state):
    return yolo.build_yolo(state, scale="l", nc=NC, imgsz=IMGSZ, spec=TINY_SPEC, device=CPU)


def _images(seed: int, n: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (n, IMGSZ, IMGSZ, 3)).astype(np.float32)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


# (flax block, port block, input channels); every block at 16×16 but the
# attention ones at 8×8
BLOCKS = {
    "ConvBN": (lambda: jyolo.ConvBN(24, 3, 2), lambda: yolo.ConvBN(16, 24, 3, 2), 16),
    "ConvBN_depthwise": (lambda: jyolo.ConvBN(16, 3, g=16, act=False),
                         lambda: yolo.ConvBN(16, 16, 3, g=16, act=False), 16),
    "Bottleneck": (lambda: jyolo.Bottleneck(16, True), lambda: yolo.Bottleneck(16, 16, True), 16),
    "C2f": (lambda: jyolo.C2f(32, 2, True), lambda: yolo.C2f(16, 32, 2, True), 16),
    "SPPF": (lambda: jyolo.SPPF(32, 5), lambda: yolo.SPPF(16, 32, 5), 16),
    "SCDown": (lambda: jyolo.SCDown(32, 3, 2), lambda: yolo.SCDown(16, 32, 3, 2), 16),
    "RepVGGDW": (lambda: jyolo.RepVGGDW(16), lambda: yolo.RepVGGDW(16), 16),
    "CIB": (lambda: jyolo.CIB(16, True, 1.0), lambda: yolo.CIB(16, 16, True, 1.0), 16),
    "CIB_lk": (lambda: jyolo.CIB(16, True, 1.0, lk=True),
               lambda: yolo.CIB(16, 16, True, 1.0, lk=True), 16),
    "C2fCIB_lk": (lambda: jyolo.C2fCIB(32, 2, True, lk=True),
                  lambda: yolo.C2fCIB(16, 32, 2, True, lk=True), 16),
    "Attention_2heads": (lambda: jyolo.Attention(128, num_heads=2),
                         lambda: yolo.Attention(128, num_heads=2), 128),
    "PSA_1head": (lambda: jyolo.PSA(128), lambda: yolo.PSA(128), 128),
    "PSA_2heads": (lambda: jyolo.PSA(256), lambda: yolo.PSA(256), 256),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_as_jax(name):
    make_jax, make_port, c1 = BLOCKS[name]
    hw = 8 if c1 >= 128 else 16
    x = np.random.default_rng(1).standard_normal((2, hw, hw, c1)).astype(np.float32)
    jm = make_jax()
    variables = seeded_tree(jm, jnp.zeros((1, hw, hw, c1)), seed=2)
    port = make_port()
    port.load_state_dict(_with_stats_from_flax(variables, _INDEX_NAMES, make_port), strict=True)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port.eval()(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BLOCK_REL * np.abs(want).max(), rtol=0)


def test_v10detect_as_jax():
    ch = (16, 24, 32)
    feats = [np.random.default_rng(3 + i).standard_normal((2, s, s, c)).astype(np.float32)
             for i, (s, c) in enumerate(zip((8, 4, 2), ch))]
    jm = jyolo.V10Detect(NC, ch)
    variables = seeded_tree(jm, [jnp.zeros((1,) + f.shape[1:]) for f in feats], seed=4)
    port = yolo.V10Detect(NC, ch)
    port.load_state_dict(_with_stats_from_flax(variables, _INDEX_NAMES,
                                               lambda: yolo.V10Detect(NC, ch)), strict=True)
    jb, jc = jax.jit(jm.apply)(variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        tb, tc = port.eval()([_nchw(f) for f in feats])
    assert tb.shape == (2, 84, 64) and tc.shape == (2, 84, NC)
    for want, got in ((jb, tb), (jc, tc)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=BLOCK_REL * np.abs(want).max(), rtol=0)


def test_whole_model_raw_as_jax(tree, model):
    img = _images(5)
    jb, js = jax.jit(tiny_jax(return_raw=True).apply)(tree, jnp.asarray(img))
    with torch.no_grad():
        tb, ts = model(_nchw(img), raw=True)
    assert ts.shape == (2, 84, NC) and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=BOX_ATOL, rtol=0)


def test_topk_selection_as_jax(tree, model):
    img = _images(6, n=1)
    max_det = 17
    jb, js, jc = jax.jit(tiny_jax(max_det=max_det).apply)(tree, jnp.asarray(img))
    model.max_det = max_det
    try:
        with torch.no_grad():
            tb, ts, tc = model(_nchw(img))
    finally:
        model.max_det = 300
    js = np.asarray(js)
    assert (np.diff(js[0]) < 0).all()          # distinct scores: the order is defined
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), js, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=BOX_ATOL, rtol=0)


@pytest.mark.parametrize("imgsz", [64, 320, 640])
def test_make_anchors_as_jax(imgsz):
    for got, want in zip(yolo.make_anchors(imgsz), jyolo.make_anchors(imgsz)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(100, 200), (720, 1280), (480, 640), (33, 17)])
@pytest.mark.parametrize("cv2_present", [True, False], ids=["cv2", "nearest"])
def test_letterbox_byte_equal(hw, cv2_present, monkeypatch):
    if not cv2_present:
        monkeypatch.setitem(sys.modules, "cv2", None)      # import cv2 raises
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), dtype=np.uint8)
    for imgsz in (64, 640):
        got, want = yolo.letterbox(img, imgsz), jyolo.letterbox(img, imgsz)
        assert got[0].tobytes() == want[0].tobytes()
        assert got[1:] == want[1:]


def _detector_pair(tree, model, dtype):
    jdet = jyolo.YoloDetector(tree, scale="l", nc=NC, imgsz=IMGSZ, max_det=10, names=NAMES,
                              dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16,
                              spec=TINY_SPEC)
    if dtype != torch.float32:
        model = yolo.build_yolo(yolo_from_flax(tree, scale="l", nc=NC, spec=TINY_SPEC),
                                scale="l", nc=NC, imgsz=IMGSZ, max_det=10, spec=TINY_SPEC,
                                dtype=dtype, device=CPU)
    tdet = yolo.YoloDetector(model=model, names=NAMES, device=CPU)
    return jdet, tdet


def test_detect_as_jax(tree, model):
    jdet, tdet = _detector_pair(tree, model, torch.float32)
    frame = np.random.default_rng(7).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    want = jdet.detect(frame, conf=0.0)[:10]
    got = tdet.detect(frame, conf=0.0)[:10]
    assert [d[2] for d in got] == [d[2] for d in want] and len(got) == 10
    # boxes back in frame pixels: the canvas's tolerance over the gain (0.5)
    for (gb, gs, _), (wb, ws, _) in zip(got, want):
        assert gb.dtype == np.float32 and abs(gs - ws) <= SCORE_ATOL
        np.testing.assert_allclose(gb, wb, atol=BOX_ATOL / 0.5, rtol=0)
    threshold = got[4][1]
    assert len(tdet.detect(frame, conf=threshold)) == 5
    assert tdet.detect(frame, conf=1.1) == []


def test_bf16_as_jax_bf16(tree):
    """The bf16 detector (convolution kernels bf16, BatchNorm float32,
    attention/DFL/sigmoid float32) against JAX's bf16 detector."""
    jdet, tdet = _detector_pair(tree, None, torch.bfloat16)
    assert tdet.model.model[0].conv.weight.dtype == torch.bfloat16
    assert tdet.model.model[0].bn.running_var.dtype == torch.float32
    img = (_images(8, n=1) * 255).astype(np.uint8)
    jb, js = jax.jit(lambda v, u8: jdet.model.clone(return_raw=True).apply(
        v, u8.astype(jnp.float32) / 255.0))(tree, jnp.asarray(img))
    with torch.no_grad():
        tb, ts = tdet.model(torch.from_numpy(img).permute(0, 3, 1, 2).float() / 255.0, raw=True)
    assert ts.dtype == torch.float32 and tb.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=BF16_SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=BF16_BOX_ATOL, rtol=0)


def _ultralytics_layout(state) -> dict:
    """The port's state dict as an ultralytics checkpoint holds it: half
    precision, with the one-to-many head (cv2/cv3) and the DFL conv."""
    sd = {k: (v.half() if v.is_floating_point() else v) for k, v in state.items()}
    for k in [k for k in sd if ".one2one_" in k]:
        sd[k.replace(".one2one_", ".")] = sd[k].clone()
    sd["model.23.dfl.conv.weight"] = torch.arange(16, dtype=torch.float16).view(1, 16, 1, 1)
    return sd


def test_ultralytics_layout_through_both_converters(state):
    sd = _ultralytics_layout(state)
    assert "model.23.cv2.0.2.weight" in sd and "model.2.cv2.conv.weight" in sd
    variables = jconvert.convert_yolo(sd)
    port_state = yolo_convert.convert_yolo(sd)
    assert set(port_state) == set(state)
    model = yolo.build_yolo(port_state, scale="l", nc=NC, imgsz=IMGSZ, spec=TINY_SPEC,
                            device=CPU)
    img = _images(9)
    jb, js = jax.jit(tiny_jax(return_raw=True).apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        tb, ts = model(_nchw(img), raw=True)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=BOX_ATOL, rtol=0)


def test_unmapped_key_or_shape_is_loud(state):
    bad = dict(state)
    bad["model.3.extra.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match=r"unmapped keys \['model.3.extra.weight'\]"):
        yolo.build_yolo(bad, scale="l", nc=NC, imgsz=IMGSZ, spec=TINY_SPEC, device=CPU)
    with pytest.raises(ValueError, match=r"model.0.conv.weight \(16, 3, 5, 5\)"):
        yolo.build_yolo({**state, "model.0.conv.weight": torch.zeros(16, 3, 5, 5)}, scale="l",
                        nc=NC, imgsz=IMGSZ, spec=TINY_SPEC, device=CPU)
    with pytest.raises(ValueError, match="shapes"):
        yolo.build_yolo(state, scale="l", nc=NC + 1, imgsz=IMGSZ, spec=TINY_SPEC, device=CPU)


def test_tolerant_unpickler_without_the_package(tmp_path, state):
    """A checkpoint pickled with classes of a package that is not installed
    still yields its tensors, through both packages' unpicklers."""
    modfile = tmp_path / "fake_ultra.py"
    modfile.write_text(textwrap.dedent("""
        import torch.nn as nn

        class DetectionModel(nn.Module):
            def __init__(self):
                super().__init__()
                self.model = nn.Sequential(
                    nn.Conv2d(3, 4, 3, bias=False), nn.BatchNorm2d(4))
            custom_attr = "not a tensor"
    """))
    sys.path.insert(0, str(tmp_path))
    try:
        import fake_ultra

        m = fake_ultra.DetectionModel()
        want = {k: v.clone() for k, v in m.state_dict().items()}
        ckpt = tmp_path / "fake.pt"
        torch.save({"model": m, "train_args": fake_ultra.DetectionModel}, ckpt)
    finally:
        sys.path.remove(str(tmp_path))
        del sys.modules["fake_ultra"]
    os.remove(modfile)          # now the class cannot be imported: stubs step in
    got = yolo_convert.load_ultralytics_state_dict(str(ckpt))
    ref = jconvert.load_ultralytics_state_dict(str(ckpt))
    assert set(got) == set(ref) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v) and torch.equal(ref[k], v)
    with pytest.raises(Exception):
        torch.load(ckpt, map_location="cpu", weights_only=True)


def test_shared_device_tree_per_ckpt_and_device(tmp_path, state):
    """family "yolo": an ultralytics-layout .pt read once a path and placed
    once a (ckpt, device); detectors built from the tree share its tensors."""
    from mere_fusion_tpu_torch.perception import TPUYoloPerception

    path = str(tmp_path / "yolov10-tiny.pt")
    torch.save({"model": _ultralytics_layout(state), "epoch": -1}, path)
    tree = shared_device_tree("yolo", path, CPU)
    assert shared_device_tree("yolo", path, CPU) is tree
    assert shared_device_tree("yolo", path, "meta") is not tree
    assert set(tree) == set(state)
    for k, v in state.items():
        assert torch.equal(tree[k], v.half().to(v.dtype)) if v.is_floating_point() \
            else torch.equal(tree[k], v)
    half = shared_device_tree("yolo", path, CPU, torch.bfloat16, cast=lambda t: t.ndim == 4)
    assert half["model.0.conv.weight"].dtype == torch.bfloat16
    assert half["model.0.bn.running_var"].dtype == torch.float32
    a, b = (yolo.build_yolo(half, scale="l", nc=NC, imgsz=IMGSZ, spec=TINY_SPEC,
                            dtype=torch.bfloat16, device=CPU) for _ in range(2))
    assert a.model[0].conv.weight.data_ptr() == b.model[0].conv.weight.data_ptr() \
        == half["model.0.conv.weight"].data_ptr()
    with pytest.raises(ValueError, match="spec"):
        TPUYoloPerception(ckpt=path, scale="x", device=CPU)   # scale x: not this file's


def test_detector_on_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yolo.YoloDetector.init_random(scale="n")
