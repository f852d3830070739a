"""The port's renderers and photometric refinement against the JAX package's.

The synthetic face of tests/test_render_3dmm.py (a bumpy grid surface with
smooth shape bases and textures): ``geometry_world``, ``render_splat``,
``render_mesh_soft``/``_ss`` and ``blur_hw`` within 2e-5;
``rasterize_topk``'s face ids equal to JAX's; one ``_lm_minimize`` solve
and one stage of each ``refine_photometric`` path (the mesh path's LM with
the anchor-and-chunks split, the splat path's Adam) within 1e-4, absolute
and of the largest entry; ``pose_errors`` as JAX's. The JAX tests' runs to
convergence are not repeated: convergence is checked on the card.

JAX's rasterizer scans under XLA, which contracts a multiply and an add
into one fused operation; where a pixel centre sits on an edge (the grid
seen head-on) the sign of that edge's value then differs by an ulp from
the separately rounded product, and so may the face picked. The port rounds
each operation as eager JAX does, and on the card as on the CPU; so the ids
and the mesh renders are held to JAX's functions run eagerly
(``jax.disable_jit``), and the refinement, which jits its residuals as JAX
always does, to 1e-4. One torch thread.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.tools import face_tracking as jft
from mere_fusion_tpu.tools import render_3dmm as jr
from mere_fusion_tpu_torch.tools import face_tracking as ft
from mere_fusion_tpu_torch.tools import render_3dmm as tr
from tests.test_render_3dmm import bump_texture, grid_faces, gt_poses, synthetic_face
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
ATOL = 2e-5                 # renders, geometry, blur
SOLVE = 1e-4                # LM and Adam results
HW = (64, 64)
FOCAL = 1150.0


@pytest.fixture(scope="module")
def scene():
    """The face at the three ground-truth poses: (model, colors, faces,
    JAX points [3, N, 3], the port's points)."""
    model, colors = synthetic_face(n_side=16)   # two chunks of JAX's scan
    euler, trans = gt_poses()
    pj = jr.geometry_world(model, jnp.zeros(4), jnp.zeros((3, 4)), jnp.asarray(euler),
                           jnp.asarray(trans))
    pt = tr.geometry_world(model, torch.zeros(4), torch.zeros(3, 4), torch.from_numpy(euler),
                           torch.from_numpy(trans))
    return model, colors, grid_faces(16), pj, pt


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def test_geometry_splat_and_blur_match_jax(scene):
    _, colors, _, pj, pt = scene
    # ~600-unit coordinates: within 2e-5 of their size
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=ATOL)
    for i in (0, 2):
        want = jr.render_splat(pj[i], jnp.asarray(colors), FOCAL, (32.0, 32.0), HW)
        got = tr.render_splat(pt[i], t(colors), FOCAL, (32.0, 32.0), HW)
        for g, w in zip(got, want):
            close(g.numpy(), w)
    batched = tr.render_splat(pt, t(colors), FOCAL, (32.0, 32.0), HW)
    close(batched[0][2].numpy(), got[0].numpy(), atol=0)
    img = np.random.default_rng(0).random((2, 16, 20, 3)).astype(np.float32)
    for sigma in (0.0, 0.25, 1.0):
        close(tr.blur_hw(t(img), sigma).numpy(), jr.blur_hw(jnp.asarray(img), sigma))


def test_mesh_renders_match_jax(scene):
    """The soft render at 64² and the supersampled one at 32² (both
    rasterize 64², so JAX's eager operations compile for one shape)."""
    _, colors, faces, pj, pt = scene
    half = (HW[0] // 2, HW[1] // 2)
    with jax.disable_jit():
        soft = jr.render_mesh_soft(pj[0], jnp.asarray(faces), jnp.asarray(colors), FOCAL,
                                   (32.0, 32.0), HW)
        ss = jr.render_mesh_ss(pj[2], jnp.asarray(faces), jnp.asarray(colors), FOCAL / 2,
                               (16.0, 16.0), half)
    got_soft = tr.render_mesh_soft(pt[0], t(faces), t(colors), FOCAL, (32.0, 32.0), HW)
    got_ss = tr.render_mesh_ss(pt, t(faces), t(colors), FOCAL / 2, (16.0, 16.0), half)
    for g, w in zip(got_soft, soft):
        close(g.numpy(), w)
    for g, w in zip(got_ss, ss):
        close(g[2].numpy(), w)
    assert float(got_ss[1][2].max()) > 0.95 and float(got_ss[1][2][0, 0]) < 1e-3


def test_rasterize_topk_ids_equal_jax(scene):
    """At the three poses (the middle one head-on, its grid edges on pixel
    centres), at two skirt widths, and on the occluding quads of
    tests/test_render_3dmm.py; a batch of frames gives each frame's ids."""
    _, _, faces, pj, pt = scene
    uvs, zns = [], []
    for i in range(3):
        uv = jft.project(pj[i], FOCAL, (32.0, 32.0))
        z = jnp.maximum(-pj[i][..., 2], 1e-4)
        zn = (z.max() - z) / (z.max() - z.min() + 1e-6)
        uvs.append(np.array(uv))
        zns.append(np.array(zn))
    ids = {}
    for i, d_max in ((0, 1.2), (1, 2.4), (2, 1.2)):
        with jax.disable_jit():
            want = np.asarray(jr.rasterize_topk(jnp.asarray(uvs[i]), jnp.asarray(zns[i]),
                                                jnp.asarray(faces), HW, d_max=d_max))
        got = tr.rasterize_topk(t(uvs[i]), t(zns[i]), t(faces), HW, d_max=d_max)
        assert got.dtype == torch.int32 and (want >= 0).sum() > 1_000
        np.testing.assert_array_equal(got.numpy(), want)
        ids[i] = got
    batch = tr.rasterize_topk(t(np.stack(uvs)), t(np.stack(zns)), t(faces), HW, d_max=1.2)
    for i in (0, 2):
        np.testing.assert_array_equal(batch[i].numpy(), ids[i].numpy())

    verts = np.asarray([[-5, -5, -100], [5, -5, -100], [-5, 5, -100], [5, 5, -100],
                        [-5, -5, -200], [5, -5, -200], [-5, 5, -200], [5, 5, -200]],
                       np.float32)
    quad = np.asarray([[0, 1, 2], [1, 3, 2], [4, 5, 6], [5, 7, 6]], np.int32)
    uv = np.asarray([[32 + 8 * (v[0] / 5), 32 + 8 * (v[1] / 5)] for v in verts], np.float32)
    zn = np.asarray([1.0] * 4 + [0.0] * 4, np.float32)
    with jax.disable_jit():
        want = np.asarray(jr.rasterize_topk(jnp.asarray(uv), jnp.asarray(zn),
                                            jnp.asarray(quad), HW, d_max=2.0))
    np.testing.assert_array_equal(tr.rasterize_topk(t(uv), t(zn), t(quad), HW, d_max=2.0),
                                  want)


def test_lm_minimize_matches_jax():
    """One LM solve of a landmark residual (pose of 2 frames, 68 points)."""
    rng = np.random.default_rng(4)
    mean = rng.normal(0, 40, (68, 3)).astype(np.float32)
    euler = rng.normal(0, 0.2, (2, 3)).astype(np.float32)
    trans = np.asarray([[3.0, -2.0, -600.0], [-4.0, 1.0, -620.0]], np.float32)
    cam = np.einsum("fij,nj->fni", np.asarray(jft.euler_to_rot(jnp.asarray(euler))),
                    mean) + trans[:, None]
    lmk = np.asarray(jft.project(jnp.asarray(cam), FOCAL, (256.0, 256.0)))

    def resid_j(v):
        e, tt = v[:6].reshape(2, 3), v[6:].reshape(2, 3) * 100.0
        pts = jnp.einsum("fij,nj->fni", jft.euler_to_rot(e), jnp.asarray(mean)) + tt[:, None]
        return (jft.project(pts, FOCAL, (256.0, 256.0)) - lmk).ravel()

    def resid_t(v):
        e, tt = v[:6].reshape(2, 3), v[6:].reshape(2, 3) * 100.0
        pts = torch.einsum("fij,nj->fni", ft.euler_to_rot(e), t(mean)) + tt[:, None]
        return (ft.project(pts, FOCAL, (256.0, 256.0)) - t(lmk)).reshape(-1)

    v0 = np.concatenate([np.zeros(6), [0.0, 0.0, -6.0, 0.0, 0.0, -6.0]]).astype(np.float32)
    want, want_cost = jr._lm_minimize(resid_j, jnp.asarray(v0), 6)
    got, got_cost = tr._lm_minimize(resid_t, t(v0), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SOLVE, atol=SOLVE)
    assert got_cost == pytest.approx(want_cost, rel=1e-3, abs=1e-6)
    assert got_cost < 1e-3 * float(resid_t(t(v0)) @ resid_t(t(v0)))


@pytest.fixture(scope="module")
def small_scene():
    """The face on a 12×12 grid with the bump texture at 32², two frames
    rendered eagerly by JAX's supersampled mesh renderer, and a perturbed
    fit with landmark anchors."""
    model, _ = synthetic_face(n_side=12)
    colors, faces = bump_texture(n_side=12), grid_faces(12)
    euler, trans = gt_poses(2)
    focal, center, hw = 900.0, (16.0, 16.0), (32, 32)
    pj = jr.geometry_world(model, jnp.zeros(4), jnp.zeros((2, 4)), jnp.asarray(euler),
                           jnp.asarray(trans))
    with jax.disable_jit():
        frames = np.stack([np.asarray(jr.render_mesh_ss(pj[i], jnp.asarray(faces),
                                                        jnp.asarray(colors), focal, center,
                                                        hw)[0]) for i in range(2)])
    rng = np.random.default_rng(0)
    fit = {"euler": (euler + rng.normal(0, 0.02, euler.shape)).astype(np.float32),
           "trans": (trans + rng.normal(0, 1, trans.shape)).astype(np.float32),
           "exp": np.zeros((2, 4), np.float32), "id": np.zeros(4, np.float32),
           "focal": 950.0}
    lmk_idx = np.arange(0, model.mean.shape[0], 7)
    lmk = np.asarray(jft.project(pj[:, lmk_idx], focal, center)).astype(np.float32)
    port_model = ft.MorphableModel(model.mean, model.base_id, model.base_exp)
    return model, port_model, colors, faces, frames, fit, lmk, lmk_idx


def assert_refined_close(got: dict, want: dict, keys) -> None:
    for key in keys:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64),
                                   rtol=SOLVE, atol=SOLVE, err_msg=key)


def test_mesh_refine_stage_matches_jax(small_scene):
    """One blur stage of LM on the mesh path, its Jacobian split as a long
    capture's is: the budget holds one frame, so frame 0 anchors the shared
    id and focal and frame 1 is solved as a chunk against them."""
    model, port_model, colors, faces, frames, fit, lmk, lmk_idx = small_scene
    budget = 32 * 32 * 3 * (2 * 10 + 5) - 1          # one frame jointly, then chunks of one
    kw = dict(colors=colors, faces=faces, landmarks=lmk, lmk_vertex_idx=lmk_idx,
              lm_schedule=((0.5, 0.1, 2),), lm_frame_budget=budget)
    want = jr.refine_photometric(model, fit, frames, **kw)
    got = tr.refine_photometric(port_model, fit, frames, device=CPU, **kw)
    assert_refined_close(got, want, ("euler", "trans", "exp", "id", "focal", "photo_rmse"))
    assert got["photo_rmse"] < 0.1


def test_splat_refine_stage_matches_jax(small_scene):
    """Adam on pose and the learned albedo (the splat path without
    topology): the albedo phase, then the pose phase."""
    model, port_model, _, _, frames, fit, _, _ = small_scene
    want = jr.refine_photometric(model, fit, frames, iters=6)
    got = tr.refine_photometric(port_model, fit, frames, iters=6, device=CPU)
    assert_refined_close(got, want, ("euler", "trans", "colors", "photo_rmse"))
    with pytest.raises(ValueError, match="refine_pose"):
        tr.refine_photometric(port_model, fit, frames, iters=1, colors=np.zeros((144, 3)),
                              refine_pose=False, device=CPU)


def test_pose_errors_match_jax():
    rng = np.random.default_rng(9)
    a, b = (rng.normal(0, 0.3, (4, 3)).astype(np.float32) for _ in range(2))
    ta, tb = (rng.normal(0, 5, (4, 3)).astype(np.float32) for _ in range(2))
    got, want = tr.pose_errors(a, ta, b, tb), jr.pose_errors(a, ta, b, tb)
    assert got == pytest.approx(want, rel=1e-5)
