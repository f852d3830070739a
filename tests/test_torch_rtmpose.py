"""The port's RTMPose wholebody landmarker against the JAX package's.

At deepen 1/3, widen 0.25 (rtmpose-s-ish, as tests/test_rtmpose.py), the
flax init's variable tree drawn from numpy seeds by its initialisers' laws
(batch statistics too) carried across by ``convert.rtmpose_from_flax``:
the SimCC logits in float32 within 3e-4 of their largest magnitude (lecun
weights make logits in the thousands), the decoded keypoints equal and the
scores within the same 3e-4; the bf16 network within 3% of the largest logit of JAX's
float32 one; ``bbox_center_scale`` and ``crop_affine`` equal to JAX's;
``convert_rtmpose`` on an mmpose-layout state dict, against JAX's converter
of the same dict. One torch thread.
"""
from __future__ import annotations

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.models import rtmpose as jrtm
from mere_fusion_tpu.utils.torch_convert import convert_rtmpose as jax_convert_rtmpose
from mere_fusion_tpu_torch.convert import rtmpose_from_flax
from mere_fusion_tpu_torch.models import rtmpose as rtm
from mere_fusion_tpu_torch.utils.torch_convert import convert_rtmpose
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

DEEPEN, WIDEN = 1.0 / 3.0, 0.25
REL = 3e-4                 # logits and scores, of the largest logit
BF16_REL = 3e-2            # the bf16 network against JAX's float32 one


def seeded_stats(tree, rng):
    """BatchNorm running statistics drawn from ``rng`` (the init's are 0 and
    1), so that parity exercises them."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "mean" in v and not isinstance(v["mean"], dict):
            out[k] = {"mean": rng.normal(0, 0.05, v["mean"].shape).astype(np.float32),
                      "var": rng.uniform(0.6, 1.4, v["var"].shape).astype(np.float32)}
        else:
            out[k] = seeded_stats(v, rng)
    return out


def seeded_params(tree, rng, path=()):
    """The flax init's parameter tree filled from ``rng`` by its initialisers'
    laws: kernels N(0, 1/fan_in) (lecun), biases 0, BatchNorm scales and
    ScaleNorm/res_scale gains 1, the GAU's gamma and beta U[0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = seeded_params(v, rng, path + (k,))
        elif k == "kernel":
            out[k] = rng.normal(0, 1 / np.sqrt(np.prod(v.shape[:-1])), v.shape).astype(np.float32)
        elif k in ("gamma", "beta"):
            out[k] = rng.uniform(0, 1, v.shape).astype(np.float32)
        elif k == "bias" and path[-1:] != ("bn",):
            out[k] = np.zeros(v.shape, np.float32)
        else:   # BatchNorm scale and bias, ScaleNorm g, res_scale
            out[k] = (np.zeros if k == "bias" else np.ones)(v.shape, np.float32)
    return out


@pytest.fixture(scope="module")
def twins():
    """(JAX variables, the port's float32 RTMPose, JAX's keypoints, scores
    and SimCC logits of one 384x288 input, that input). The variables
    have the flax init's tree (``jax.eval_shape``), seeded by numpy."""
    model = jrtm.RTMPose(deepen=DEEPEN, widen=WIDEN, dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal((1, jrtm.INPUT_H, jrtm.INPUT_W, 3)) \
        .astype(np.float32)
    shapes = flax.core.unfreeze(jax.eval_shape(model.init, jax.random.PRNGKey(0), x))
    variables = {"params": seeded_params(shapes["params"], np.random.default_rng(2)),
                 "batch_stats": seeded_stats(shapes["batch_stats"], np.random.default_rng(1))}
    (kpts, score), inter = jax.jit(lambda v, a: model.apply(
        v, a, capture_intermediates=lambda m, _: m.name == "head"))(variables, jnp.asarray(x))
    logits = inter["intermediates"]["head"]["__call__"][0]
    net = rtm.RTMPose(DEEPEN, WIDEN)
    net.load_state_dict(rtmpose_from_flax(variables, DEEPEN, WIDEN), strict=True)
    return variables, net.eval(), np.asarray(kpts), np.asarray(score), \
        [np.asarray(v) for v in logits], x


def test_simcc_logits_and_decode_match_jax(twins):
    _, net, kpts, score, (lx, ly), x = twins
    with torch.no_grad():
        px, py = net(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    scale = max(np.abs(lx).max(), np.abs(ly).max())
    assert scale > 1.0
    np.testing.assert_allclose(px.numpy(), lx, rtol=0, atol=REL * scale)
    np.testing.assert_allclose(py.numpy(), ly, rtol=0, atol=REL * scale)
    got_k, got_s = rtm.simcc_decode(px, py)
    np.testing.assert_array_equal(got_k.numpy(), kpts)
    np.testing.assert_allclose(got_s.numpy(), score, rtol=0, atol=REL * scale)


def test_bf16_network_within_its_bound_of_jax(twins):
    _, net, _, _, (lx, ly), x = twins
    bf = rtm.compute_dtype_(rtm.RTMPose(DEEPEN, WIDEN), torch.bfloat16)
    bf.load_state_dict(net.state_dict())
    with torch.no_grad():
        px, py = bf.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)).to(torch.bfloat16))
    assert px.dtype == torch.bfloat16
    scale = max(np.abs(lx).max(), np.abs(ly).max())
    err = max(np.abs(px.float().numpy() - lx).max(), np.abs(py.float().numpy() - ly).max())
    assert err <= BF16_REL * scale, (err, scale)


def test_crop_pipeline_equals_jax():
    boxes = np.array([[10.0, 20.0, 110.0, 200.0], [0.0, 0.0, 30.0, 400.0]], np.float32)
    for got, want in zip(rtm.bbox_center_scale(boxes), jrtm.bbox_center_scale(boxes)):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(2)
    frames = rng.uniform(0, 255, (2, 200, 160, 3)).astype(np.float32)
    center = np.array([[80.0, 100.0], [60.0, 130.0]], np.float32)
    scale = np.array([[160.0, 200.0], [250.0, 333.3]], np.float32)   # the second reaches out
    want = np.asarray(jrtm.crop_affine(jnp.asarray(frames), jnp.asarray(center),
                                       jnp.asarray(scale)))
    got = rtm.crop_affine(torch.from_numpy(frames), torch.from_numpy(center),
                          torch.from_numpy(scale))
    assert got.shape == (2, rtm.INPUT_H, rtm.INPUT_W, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_convert_rtmpose_reads_an_mmpose_state_dict(twins):
    """The port's state dict written as mmpose's checkpoint (``state_dict``
    wrapper, ``module.`` prefix, a key of mmpose's data preprocessor, no
    ``num_batches_tracked``): converted back equal; JAX's converter of the
    same dict gives the JAX variables; a missing tensor raises KeyError."""
    variables, net, *_ = twins
    sd = {f"module.{k}": v for k, v in net.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    sd["module.data_preprocessor.mean"] = torch.zeros(3)
    got = convert_rtmpose(sd, deepen=DEEPEN, widen=WIDEN)
    for k, v in net.state_dict().items():
        assert torch.equal(got[k], v), k
    back = jax_convert_rtmpose(sd, deepen=DEEPEN, widen=WIDEN)
    flat = lambda tree: {"/".join(map(str, p)): np.asarray(v)
                         for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    want, have = flat(variables), flat(back)
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    del sd["module.head.gau.gamma"]
    with pytest.raises(KeyError, match="head.gau.gamma"):
        convert_rtmpose(sd, deepen=DEEPEN, widen=WIDEN)


def test_landmarker_contract(twins, tmp_path):
    """``from_checkpoint`` of an mmpose-layout file, the 68 face points of
    the whole frame for each box, frame coordinates inside the frame's
    reach."""
    _, net, *_ = twins
    path = str(tmp_path / "dw.pth")
    torch.save({"state_dict": net.state_dict()}, path)
    lm = rtm.WholebodyLandmarker.from_checkpoint(path, dtype=torch.float32, deepen=DEEPEN,
                                                 widen=WIDEN, device=torch.device("cpu"))
    img = np.random.default_rng(3).integers(0, 255, (240, 320, 3)).astype(np.uint8)
    out = lm.landmarks_from_boxes(img, [np.array([10, 10, 60, 60]), np.array([0, 0, 9, 9])])
    assert len(out) == 2 and out[0].shape == (68, 2) and out[0].dtype == np.float32
    kpts, score = lm.wholebody(img[None], np.array([[0, 0, 320, 240]], np.float32))
    assert kpts.shape == (1, rtm.NUM_KEYPOINTS, 2) and score.shape == (1, rtm.NUM_KEYPOINTS)
    np.testing.assert_array_equal(out[0], kpts[0, rtm.FACE_SLICE])
    # the full frame padded by 1.25 and fixed to 288:384
    assert kpts[..., 0].min() >= -80 and kpts[..., 0].max() <= 400
