"""Kernel K3's plain version (mere_fusion_tpu_torch/ops/hash_lookup.py)
against the JAX package's Pallas hash lookup (ops/hash_mxu.py) in interpret
mode, as tests/test_hash_mxu.py runs it on the CPU, and the autograd
plumbing of the port's ``Lookup`` function.

Toy sizes: 4 levels, 2^10 tables, tables U(−1, 1), inputs from numpy seeds.
Tolerances, with their reasons (ROADMAP's figures from test_hash_mxu.py):
- values 2.4e-7 absolute, two f32 ulps at 1: both select exact table rows
  and sum the four weighted corners in the same order, but XLA contracts
  some products and sums into FMAs (1.2e-7 read); the plain version that
  drops one corner fails this limit;
- table gradients 1e-5 absolute: the one-hot transposed matmul and the
  plain scatter-add sum each row's contributions in another order;
- the input gradient through the corner weights: 1e-5 relative, 1e-6
  absolute (a chain of f32 products in another order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.ops import hash_mxu
from mere_fusion_tpu.ops.hashgrid import GridSpec as JGridSpec
from mere_fusion_tpu_torch.models.ernerf import network as pnetwork
from mere_fusion_tpu_torch.ops import hash_lookup as hl
from mere_fusion_tpu_torch.ops.hashgrid import GridSpec, corner_indices_weights

SPEC_KW = dict(input_dim=2, num_levels=4, level_dim=1, base_resolution=16,
               log2_hashmap_size=10, desired_resolution=64)
SPEC = GridSpec(**SPEC_KW)
JSPEC = JGridSpec(**SPEC_KW)
BOUND = 1.0


@pytest.fixture(autouse=True)
def _force_mxu():
    hash_mxu.FORCE = True
    yield
    hash_mxu.FORCE = None


def inputs(n: int, seed: int, spec: GridSpec = SPEC):
    rng = np.random.default_rng(seed)
    planes = [rng.uniform(-1, 1, (spec.total_params, spec.level_dim)).astype(np.float32)
              for _ in range(3)]
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    gout = rng.standard_normal((n, 3 * spec.num_levels * spec.level_dim)).astype(np.float32)
    return planes, xyz, gout


def jax_encode(planes, xyz, spec=JSPEC):
    return hash_mxu.triplane_encode_mxu(*planes, xyz, spec, BOUND, interpret=True)


def corners(xyz: torch.Tensor, spec: GridSpec = SPEC):
    return hl.triplane_corners(xyz, spec, BOUND)


@pytest.mark.parametrize("n", [1024, 1500], ids=["one_block", "padded"])
def test_plain_and_triplane_encode_match_pallas(n):
    planes, xyz, _ = inputs(n, seed=0)
    ref = np.asarray(jax_encode([jnp.asarray(p) for p in planes], jnp.asarray(xyz)))
    tables = [torch.from_numpy(p) for p in planes]
    idx, w = corners(torch.from_numpy(xyz))
    plain = hl.lookup_plain(tables, idx, w, SPEC)
    assert plain.shape == ref.shape == (n, 3 * SPEC.num_levels)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=2.4e-7)
    before = (hl.fwd_launches, hl.bwd_launches)
    enc = hl.triplane_encode(*tables, torch.from_numpy(xyz), SPEC, BOUND)
    assert (hl.fwd_launches, hl.bwd_launches) == before, "CPU tensors take the plain version"
    np.testing.assert_allclose(enc.numpy(), ref, rtol=0, atol=2.4e-7)
    # the limit catches a lookup that drops one corner
    dropped = w.clone()
    dropped[..., 3] = 0
    assert np.abs(hl.lookup_plain(tables, idx, dropped, SPEC).numpy() - ref).max() > 2.4e-7


@pytest.mark.parametrize("gridtype", ["hash", "tiled"])
def test_corners_outside_the_box_match_jax(gridtype):
    """Points outside [−bound, bound] (the training step's jitter points
    are rays_o + rays_d) take the reference's cell: XLA saturates the
    float → uint32 cast of a negative cell coordinate to 0."""
    from mere_fusion_tpu.ops import hashgrid as jhash

    kw = dict(SPEC_KW, gridtype=gridtype)
    x = np.random.default_rng(2).uniform(-3, 3, (512, 2)).astype(np.float32)
    ji, jw = jhash.corner_indices_weights(jnp.asarray(x), jhash.GridSpec(**kw), BOUND)
    pi, pw = corner_indices_weights(torch.from_numpy(x), GridSpec(**kw), BOUND)
    assert pi.dtype == torch.int32, "4-byte rows, as the TPU kernel's f32 indices"
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji).astype(np.int64))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    planes, _, _ = inputs(1, seed=2)
    xyz = np.random.default_rng(3).uniform(-3, 3, (1024, 3)).astype(np.float32)
    ref = np.asarray(jax_encode([jnp.asarray(p) for p in planes], jnp.asarray(xyz)))
    got = hl.triplane_encode(*[torch.from_numpy(p) for p in planes], torch.from_numpy(xyz),
                             SPEC, BOUND)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2.4e-7)


def test_plane_grads_match_pallas():
    planes, xyz, gout = inputs(1024, seed=1)

    def jloss(pl):
        return (jax_encode(pl, jnp.asarray(xyz)) * jnp.asarray(gout)).sum()

    ref = jax.grad(jloss)([jnp.asarray(p) for p in planes])
    tables = [torch.from_numpy(p).requires_grad_() for p in planes]
    enc = hl.triplane_encode(*tables, torch.from_numpy(xyz), SPEC, BOUND)
    (enc * torch.from_numpy(gout)).sum().backward()
    for t, r in zip(tables, ref):
        assert float(np.abs(np.asarray(r)).max()) > 1.0, "the gradient must not be trivial"
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=0, atol=1e-5)


def test_input_grad_through_weights_matches_pallas():
    planes, xyz, _ = inputs(256, seed=3)

    def jloss(x):
        return (jax_encode([jnp.asarray(p) for p in planes], x) ** 2).sum()

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(xyz)))
    x = torch.from_numpy(xyz).requires_grad_()
    tables = [torch.from_numpy(p) for p in planes]
    (hl.triplane_encode(*tables, x, SPEC, BOUND) ** 2).sum().backward()
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-5, atol=1e-6)


def _cpu_kernels(monkeypatch):
    """Stand-ins for the two CUDA launches on CPU tensors: the forward is the
    plain version, the backward its autograd table gradient. They let the
    CPU run ``Lookup``'s own forward and backward."""
    def fwd(tables, idx, w, spec):
        return hl.lookup_plain(tables, idx, w, spec)

    def bwd(idx, w, gout, spec, tables):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in tables]
            out = hl.lookup_plain(leaves, idx, w, spec)
            return list(torch.autograd.grad(out, leaves, gout))

    monkeypatch.setattr(hl, "lookup_fwd_cuda", fwd)
    monkeypatch.setattr(hl, "lookup_bwd_cuda", bwd)


@pytest.mark.parametrize("with_w_grad", [False, True], ids=["tables", "tables_and_w"])
def test_lookup_function_gradients(monkeypatch, with_w_grad):
    """Lookup.backward returns the table gradients in the tables' layout and
    the weights' gradient (the plain gather) only when asked for."""
    _cpu_kernels(monkeypatch)
    planes, xyz, gout = inputs(512, seed=4)
    idx, w = corners(torch.from_numpy(xyz))

    def run(fn):
        tables = [torch.from_numpy(p).requires_grad_() for p in planes]
        ws = w.clone().requires_grad_(with_w_grad)
        out = fn(tables, ws)
        (out * torch.from_numpy(gout)).sum().backward()
        return out, [t.grad for t in tables], ws.grad

    got = run(lambda t, ws: hl.Lookup.apply(SPEC, *t, idx, ws))
    ref = run(lambda t, ws: hl.lookup_plain(t, idx, ws, SPEC))
    np.testing.assert_array_equal(got[0].detach().numpy(), ref[0].detach().numpy())
    for g, r in zip(got[1], ref[1]):
        assert g.shape == (SPEC.total_params, 1)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-6)
    if with_w_grad:
        assert got[2].shape == w.shape
        np.testing.assert_allclose(got[2].numpy(), ref[2].numpy(), rtol=1e-6, atol=1e-6)
    else:
        assert got[2] is None and ref[2] is None


def test_cuda_path_refuses_cpu_operands():
    planes, xyz, _ = inputs(64, seed=5)
    idx, w = corners(torch.from_numpy(xyz))
    tables = [torch.from_numpy(p) for p in planes]
    with pytest.raises(ValueError, match="CUDA"):
        hl.lookup_fwd_cuda(tables, idx, w, SPEC)
    with pytest.raises(ValueError, match="grids"):
        hl.lookup_fwd_cuda(tables * 2, idx, w, SPEC)
    two = GridSpec(**dict(SPEC_KW, level_dim=2))
    with pytest.raises(ValueError, match="one channel"):
        hl.lookup_fwd_cuda([t.repeat(1, 2) for t in tables], idx, w, two)


def test_network_encode_x_impls(monkeypatch):
    cfg = pnetwork.NeRFNetConfig(num_levels=4, base_resolution=16, desired_resolution=64,
                                 log2_hashmap_size=10)
    net = pnetwork.init_ernerf_(pnetwork.NeRFNetwork(cfg), 0)
    xyz = torch.from_numpy(np.random.default_rng(6).uniform(-1, 1, (128, 3)).astype(np.float32))
    with torch.no_grad():
        auto = net.encode_x(xyz)
        monkeypatch.setattr(pnetwork, "ENCODE_IMPL", "plain")
        np.testing.assert_array_equal(net.encode_x(xyz).numpy(), auto.numpy())
        monkeypatch.setattr(pnetwork, "ENCODE_IMPL", "fused")
        with pytest.raises(ValueError, match="fused"):
            net.encode_x(xyz)
