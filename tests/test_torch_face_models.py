"""The avatar preparation's face models in the PyTorch port against the JAX
package: S3FD, FAN and BiSeNet at their published widths on 64×64 inputs
(FAN with one hourglass module).

Weights come from numpy seeds in the JAX modules' own trees
(``jax.eval_shape`` of their init): kernels N(0, 1/fan_in), biases N(0, 0.1),
L2Norm scales U(4, 10), BatchNorm scales U(0.8, 1.2) and biases N(0, 0.1),
running means N(0, 0.2) and variances U(0.5, 2), so a statistic mapped to
the wrong place cannot hide. Tolerances: S3FD's heads 3e-4 (as
tests/test_s3fd.py holds the JAX model against the reference), FAN's
heatmaps 2e-5 of JAX's largest value, BiSeNet's logits 1e-4; argmax class
maps are compared by their share of equal pixels, since a near-tie may fall
either way.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mere_fusion_tpu.models import bisenet as jax_bisenet
from mere_fusion_tpu.models import fan as jax_fan
from mere_fusion_tpu.models import s3fd as jax_s3fd
from mere_fusion_tpu.utils import torch_convert as jax_convert
from mere_fusion_tpu_torch.convert import bisenet_from_flax, fan_from_flax, s3fd_from_flax
from mere_fusion_tpu_torch.models import bisenet, fan, s3fd
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
S3FD_ATOL = 3e-4
FAN_REL = 2e-5
BISENET_ATOL = 1e-4
MASK_EQUAL_SHARE = 0.999


def _fill(rng):
    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['kernel']"):
            fan_in = np.prod(shape[:-1])
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith("['weight']"):               # S3FD's L2Norm scales
            return rng.uniform(4.0, 10.0, shape).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name.endswith("['mean']"):
            return (0.2 * rng.standard_normal(shape)).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return fill


def seeded_tree(module, shape, seed: int) -> dict:
    """The module's variables with every leaf drawn from a numpy seed."""
    abstract = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros(shape))
    return jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(seed)), abstract)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def s3fd_tree():
    return seeded_tree(jax_s3fd.S3FD(), (1, 64, 64, 3), seed=0)


@pytest.fixture(scope="module")
def fan_tree():
    return seeded_tree(jax_fan.FAN(num_modules=1), (1, 64, 64, 3), seed=1)


@pytest.fixture(scope="module")
def bisenet_tree():
    return seeded_tree(jax_bisenet.BiSeNet(), (1, 64, 64, 3), seed=2)


@pytest.fixture(scope="module")
def s3fd_outputs(s3fd_tree):
    """JAX's and the port's six (cls, reg) heads on one seeded image."""
    x = np.random.default_rng(3).uniform(-120, 130, (2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(jax_s3fd.S3FD().apply)(s3fd_tree, jnp.asarray(x))
    model = s3fd.S3FD()
    model.load_state_dict(s3fd_from_flax(s3fd_tree), strict=True)
    with torch.no_grad():
        out = model.eval()(_nchw(x))
    return [tuple(np.asarray(t) for t in pair) for pair in ref], out


@pytest.fixture(scope="module")
def jax_decoded(s3fd_outputs):
    """JAX's decode of its own heads: [2, A, 5]."""
    ref, _ = s3fd_outputs
    return np.array(jax.jit(jax_s3fd.decode_detections)([tuple(map(jnp.asarray, p)) for p in ref]))


# ---- S3FD ----------------------------------------------------------------------

def test_s3fd_heads_match_jax(s3fd_outputs):
    ref, out = s3fd_outputs
    assert len(out) == len(ref) == 6
    for i, ((rc, rr), (c, r)) in enumerate(zip(ref, out)):
        assert _nhwc(c).shape == rc.shape and rc.shape[-1] == 2
        assert _nhwc(r).shape == rr.shape and rr.shape[-1] == 4
        assert np.abs(_nhwc(c) - rc).max() < S3FD_ATOL, i
        assert np.abs(_nhwc(r) - rr).max() < S3FD_ATOL, i
    # the first scale is at stride 4: 16×16 anchors for a 64×64 image
    assert ref[0][0].shape == (2, 16, 16, 2)


def test_s3fd_decode_matches_jax(s3fd_outputs, jax_decoded):
    """The same heads through both decodes: every anchor's box and score."""
    ref, _ = s3fd_outputs
    want = jax_decoded
    got = s3fd.decode_detections([(_nchw(c), _nchw(r)) for c, r in ref]).numpy()
    assert got.shape == want.shape == (2, sum(c.shape[1] * c.shape[2] for c, _ in ref), 5)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=1e-6)


@pytest.mark.parametrize("thresh", [0.0, 0.3, 0.7])
def test_nms_matches_jax(jax_decoded, thresh):
    """Greedy NMS keeps the same anchors, in the same order, for JAX's
    decoded boxes (overlapping priors at every scale)."""
    dets = jax_decoded[0].copy()
    dets[:, 4] = np.random.default_rng(4).permutation(len(dets)) / len(dets)  # no ties
    assert s3fd.nms(dets, thresh) == jax_s3fd.nms(dets, thresh)
    assert s3fd.nms(np.zeros((0, 5), np.float32)) == []


def test_face_detector_matches_jax(s3fd_tree):
    """FaceDetector: the uint8 frames' mean subtraction, the forward and the
    decode against JAX's FaceDetector with the same weights; detect_batch
    gives a [K, 5] array for each image."""
    imgs = np.random.default_rng(5).integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    det = s3fd.FaceDetector(state=s3fd_from_flax(s3fd_tree), device=CPU)
    jdet = jax_s3fd.FaceDetector(variables=s3fd_tree)
    jdet._compile(imgs.shape)
    want = np.asarray(jdet._fn(jnp.asarray(imgs.astype(np.float32) - jdet.MEAN_BGR)))
    got = det.decode_batch(imgs).numpy()
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=S3FD_ATOL * 512)
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=S3FD_ATOL)
    results = det.detect_batch(imgs, score_thresh=0.0)
    assert len(results) == 2 and all(r.ndim == 2 and r.shape[1] == 5 for r in results)


# ---- FAN -----------------------------------------------------------------------

def test_fan_heatmaps_match_jax(fan_tree):
    x = np.random.default_rng(6).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_fan.FAN(num_modules=1).apply)(fan_tree, jnp.asarray(x))[-1])
    model = fan.FAN(num_modules=1)
    model.load_state_dict(fan_from_flax(fan_tree, num_modules=1), strict=True)
    with torch.no_grad():
        out = model.eval()(_nchw(x))
    assert len(out) == 1 and _nhwc(out[-1]).shape == ref.shape == (2, 16, 16, 68)
    assert np.abs(_nhwc(out[-1]) - ref).max() <= FAN_REL * np.abs(ref).max()


def test_fan_geometry_matches_jax():
    """Crop, point transform and heatmap decode: the same numbers as JAX's."""
    rng = np.random.default_rng(7)
    image = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    for box in ([30.0, 20.0, 110.0, 100.0], [-10.0, -5.0, 60.0, 70.0], [90.0, 60.0, 170.0, 130.0]):
        center, scale = fan.LandmarkDetector.box_to_center_scale(np.asarray(box))
        jcenter, jscale = jax_fan.LandmarkDetector.box_to_center_scale(np.asarray(box))
        assert np.array_equal(center, jcenter) and scale == jscale
        for pt in ([1, 1], [256, 256], [17, 203]):
            assert np.array_equal(fan.transform_point(pt, center, scale, 256, invert=True),
                                  jax_fan.transform_point(pt, center, scale, 256, invert=True))
        assert np.array_equal(fan.crop_face(image, center, scale),
                              jax_fan.crop_face(image, center, scale))
    hm = rng.standard_normal((2, 64, 64, 68)).astype(np.float32)
    hm[0, 0, 5, 3] = 9.0                      # a peak on the border: no sub-pixel shift
    centers, scales = rng.uniform(50, 150, (2, 2)), rng.uniform(0.5, 2.0, 2)
    assert np.array_equal(fan.heatmaps_to_landmarks(hm, centers, scales),
                          jax_fan.heatmaps_to_landmarks(hm, centers, scales))


def test_landmarks_from_boxes_match_jax(fan_tree):
    """LandmarkDetector on a given box: crop → FAN → decode with the seeded
    weights on both sides. The heatmaps agree within 2e-5 of their largest
    value; each landmark whose peak and neighbour differences stand clear of
    that is equal."""
    tree = seeded_tree(jax_fan.FAN(num_modules=1), (1, 256, 256, 3), seed=1)
    jdet = jax_fan.LandmarkDetector(fan_variables=tree, num_modules=1)
    det = fan.LandmarkDetector(state=fan_from_flax(tree, num_modules=1), num_modules=1,
                               device=CPU)
    image = np.random.default_rng(8).integers(0, 256, (200, 240, 3), dtype=np.uint8)
    box = np.array([60, 40, 180, 170], np.float32)
    crop = fan.crop_face(image, *fan.LandmarkDetector.box_to_center_scale(box))
    crop = crop[None].astype(np.float32) / 255.0
    want_hm, got_hm = jdet.heatmaps(crop), det.heatmaps(crop)
    tol = FAN_REL * np.abs(want_hm).max()
    assert got_hm.shape == want_hm.shape == (1, 64, 64, 68)
    assert np.abs(got_hm - want_hm).max() <= tol
    got, want = det.landmarks_from_boxes(image, [box]), jdet.landmarks_from_boxes(image, [box])
    assert len(got) == len(want) == 1 and got[0].shape == want[0].shape == (68, 2)
    maps = want_hm[0].reshape(-1, 68)
    top2 = np.sort(maps, axis=0)[-2:]
    peak = maps.argmax(0)
    py, px = peak // 64, peak % 64
    near = [want_hm[0, np.clip(py + dy, 0, 63), np.clip(px + dx, 0, 63), np.arange(68)]
            for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0))]
    clear = ((top2[1] - top2[0] > 2 * tol) & (np.abs(near[0] - near[1]) > 2 * tol)
             & (np.abs(near[2] - near[3]) > 2 * tol))
    assert clear.mean() > 0.5
    assert np.array_equal(got[0][clear], want[0][clear])


# ---- BiSeNet -------------------------------------------------------------------

def test_bisenet_logits_match_jax(bisenet_tree):
    x = np.random.default_rng(9).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(jax_bisenet.BiSeNet().apply)(bisenet_tree, jnp.asarray(x))
    model = bisenet.BiSeNet()
    model.load_state_dict(bisenet_from_flax(bisenet_tree), strict=True)
    with torch.no_grad():
        out = model.eval()(_nchw(x))
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        assert _nhwc(o).shape == np.asarray(r).shape == (2, 64, 64, 19)
        assert np.abs(_nhwc(o) - np.asarray(r)).max() < BISENET_ATOL


@pytest.mark.parametrize("size", [(64, 64), (80, 56)])
def test_face_parsing_masks_match_jax(bisenet_tree, size):
    """FaceParsing: the same logits within 1e-4, the masks and the
    semantic map equal at ≥ 99.9% of pixels."""
    image = np.random.default_rng(10).integers(0, 256, (72, 60, 3), dtype=np.uint8)
    fp = bisenet.FaceParsing(state=bisenet_from_flax(bisenet_tree), device=CPU)
    jfp = jax_bisenet.FaceParsing(variables=bisenet_tree)
    got, want = fp(image, size=size), jfp(image, size=size)
    assert got.shape == want.shape == size[::-1] and got.dtype == want.dtype == np.uint8
    assert set(np.unique(got)) <= {0, 255}
    assert (got == want).mean() >= MASK_EQUAL_SHARE
    assert (fp._classes(image, size) == jfp._classes(image, size)).mean() >= MASK_EQUAL_SHARE


def test_face_parsing_semantic_map_matches_jax(bisenet_tree):
    image = np.random.default_rng(11).integers(0, 256, (48, 40, 3), dtype=np.uint8)
    fp = bisenet.FaceParsing(state=bisenet_from_flax(bisenet_tree), device=CPU)
    jfp = jax_bisenet.FaceParsing(variables=bisenet_tree)
    got, want = fp.semantic_map(image), jfp.semantic_map(image)
    assert got.shape == want.shape == (48, 40, 3)
    assert (got == want).all(-1).mean() >= MASK_EQUAL_SHARE


@pytest.mark.parametrize("src,dst", [((2, 2), (4, 4)), ((5, 3), (9, 7)), ((1, 1), (3, 3)),
                                     ((8, 8), (64, 64))])
def test_interpolate_matches_jax_upsamplers(src, dst):
    """F.interpolate (nearest; bilinear, align_corners) against the two JAX
    helpers that copy it: nearest equal, bilinear within 1e-5 (its weights
    are rounded in another order)."""
    x = np.random.default_rng(12).standard_normal((2, *src, 5)).astype(np.float32)
    near = F.interpolate(_nchw(x), dst, mode="nearest")
    assert np.array_equal(_nhwc(near), np.asarray(jax_bisenet.upsample_nearest_torch(
        jnp.asarray(x), dst)))
    bil = F.interpolate(_nchw(x), dst, mode="bilinear", align_corners=True)
    want = np.asarray(jax_bisenet.upsample_bilinear_align_corners(jnp.asarray(x), dst))
    np.testing.assert_allclose(_nhwc(bil), want, rtol=0, atol=1e-5)


# ---- checkpoints in the reference's layout ---------------------------------------

@pytest.mark.parametrize("family", ["s3fd", "fan", "bisenet"])
def test_reference_checkpoints_load_strict(tmp_path, family, s3fd_tree, fan_tree, bisenet_tree):
    """A seeded state dict written as the reference writes it (``module.``
    prefix, under ``state_dict``) loads through the port's
    ``from_checkpoint`` with strict keys, and the JAX package's own
    converter of that file gives back the JAX tree it came from: the port's
    names are the reference layout that ``convert_s3fd``, ``convert_fan``
    and ``convert_bisenet`` document."""
    tree, state, jax_convert_fn = {
        "s3fd": (s3fd_tree, s3fd_from_flax(s3fd_tree), jax_convert.convert_s3fd),
        "fan": (fan_tree, fan_from_flax(fan_tree, num_modules=1), jax_convert.convert_fan),
        "bisenet": (bisenet_tree, bisenet_from_flax(bisenet_tree), jax_convert.convert_bisenet),
    }[family]
    path = str(tmp_path / f"{family}.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in state.items()}}, path)
    if family == "s3fd":
        model = s3fd.FaceDetector.from_checkpoint(path, device=CPU).model
    elif family == "fan":
        model = fan.LandmarkDetector.from_checkpoints(path, num_modules=1, device=CPU).model
    else:
        model = bisenet.FaceParsing.from_checkpoint(path, device=CPU).model
    loaded = model.state_dict()
    assert set(loaded) == set(state)
    assert all(torch.equal(loaded[k], state[k]) for k in state)
    back = jax_convert_fn(jax_convert.load_torch_checkpoint(path))
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_tree = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_back) == len(flat_tree)
    for key, value in flat_back:
        assert np.array_equal(np.asarray(value), np.asarray(flat_tree[key])), key
    torch.save({k: v for k, v in list(state.items())[1:]}, path)   # one key short
    with pytest.raises(KeyError):
        {"s3fd": s3fd.FaceDetector.from_checkpoint,
         "fan": lambda p, **kw: fan.LandmarkDetector.from_checkpoints(p, num_modules=1, **kw),
         "bisenet": bisenet.FaceParsing.from_checkpoint}[family](path, device=CPU)


def test_seeded_face_models(monkeypatch):
    """Seeded weights: two builds give the same model; S3FD's L2Norm
    scales start at the reference's 10, 8, 5; without a device and no CUDA
    the entry points raise rather than fall back to the CPU."""
    a, b = (s3fd.FaceDetector(device=CPU).model.state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert [float(a[f"conv{n}_3_norm.weight"][0]) for n in (3, 4, 5)] == [10.0, 8.0, 5.0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (s3fd.FaceDetector, fan.LandmarkDetector, bisenet.FaceParsing):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
