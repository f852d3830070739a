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



# ---- the encode route: the corners hashed by the kernel ----------------------------
# Levels that move between dense and hashed with the table size: sides 17,
# 42, 102 and 257, so 2^12 rows keep levels 0 and 1 dense and 2^16 levels 0
# to 2 (a dense level's size is side², padded to a multiple of 8, not a
# power of two).
MOVING_KW = dict(input_dim=2, num_levels=4, level_dim=1, base_resolution=16,
                 desired_resolution=256)
ENCODE_CASES = {
    "outside_the_box": dict(kw=SPEC_KW, bound=1.0, spread=3.0),
    "bound_1.5": dict(kw=SPEC_KW, bound=1.5, spread=2.0),
    "hashmap_12": dict(kw=dict(MOVING_KW, log2_hashmap_size=12), bound=1.0, spread=1.2),
    "hashmap_16": dict(kw=dict(MOVING_KW, log2_hashmap_size=16), bound=1.0, spread=1.2),
}


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_matches_pallas(case, monkeypatch):
    """``triplane_encode`` on the CPU (the encode route's plain version)
    against the JAX package's Pallas encode. x01 = (x + bound) / (2·bound) is
    a true division on every device, as JAX computes it op by op; at a bound
    of 1.5 the product by the f32 reciprocal (PyTorch on CUDA for a Python
    scalar divisor; XLA under jit) moves x01 by an ulp on ~2/3 of the points,
    which the limit sees."""
    cfg = ENCODE_CASES[case]
    spec, jspec, bound = GridSpec(**cfg["kw"]), JGridSpec(**cfg["kw"]), cfg["bound"]
    planes, _, _ = inputs(1, seed=7, spec=spec)
    xyz = np.random.default_rng(8).uniform(-cfg["spread"], cfg["spread"], (1024, 3)) \
        .astype(np.float32)
    ref = np.asarray(hash_mxu.triplane_encode_mxu(*[jnp.asarray(p) for p in planes],
                                                  jnp.asarray(xyz), jspec, bound,
                                                  interpret=True))
    routes = _record_routes(monkeypatch)
    tables = [torch.from_numpy(p) for p in planes]
    got = hl.triplane_encode(*tables, torch.from_numpy(xyz), spec, bound)
    assert routes == ["encode"], "positions that need no gradient take the encode"
    assert got.shape == ref.shape == (1024, 3 * spec.num_levels)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2.4e-7)
    if case == "bound_1.5":
        idx, w = _kernel_corners(torch.from_numpy(xyz), spec, bound, reciprocal=True)
        assert np.abs(hl.lookup_plain(tables, idx, w, spec).numpy() - ref).max() > 2.4e-7


def _record_routes(monkeypatch) -> list:
    """Record, in order, which of ``encode`` and ``lookup`` triplane_encode
    calls (each still runs)."""
    routes = []
    for name in ("encode", "lookup"):
        fn = getattr(hl, name)
        monkeypatch.setattr(hl, name, lambda *a, _fn=fn, _name=name: (
            routes.append(_name), _fn(*a))[1])
    return routes


def test_xyz_requiring_grad_takes_the_corner_route(monkeypatch):
    """Positions that need a gradient take the plain corners and ``lookup``
    (the corner weights carry that gradient), which the JAX package's
    gradient matches; the same positions without one take ``encode``."""
    planes, xyz, _ = inputs(256, seed=9)

    def jloss(x):
        return (jax_encode([jnp.asarray(p) for p in planes], x) ** 2).sum()

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(xyz)))
    routes = _record_routes(monkeypatch)
    x = torch.from_numpy(xyz).requires_grad_()
    tables = [torch.from_numpy(p) for p in planes]
    (hl.triplane_encode(*tables, x, SPEC, BOUND) ** 2).sum().backward()
    assert routes == ["lookup"]
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-5, atol=1e-6)
    hl.triplane_encode(*tables, x.detach(), SPEC, BOUND)
    assert routes == ["lookup", "encode"]


def _kernel_corners(xyz: torch.Tensor, spec: GridSpec, bound: float, reciprocal=False):
    """csrc/hash_lookup.cu encode_fwd_kernel's corner arithmetic, from the
    per-level constants the wrapper hands it (``_levels``): float32 values
    rounded after every operation (numpy float32 scalars), uint32 rows (int64
    masked). Returns idx, w [3, N, L, 4] as the kernel saves them;
    ``reciprocal`` makes x01 a product by the f32 reciprocal (a control)."""
    scale, mul1, hsize, _, hashed = (list(a) for a in hl._levels(spec))
    coords = torch.stack((xyz[:, :2], xyz[:, 1:], xyz[:, ::2]))   # [3, N, 2]
    span = np.float32(2.0 * bound)
    x01 = (coords + np.float32(bound)) * (np.float32(1.0) / span) if reciprocal else \
        (coords + np.float32(bound)) / torch.tensor(span)
    shift = np.float32(0.0 if spec.align_corners else 0.5)
    idx, w = [], []
    for l in range(spec.num_levels):
        pos = x01 * np.float32(scale[l]) + shift
        cell = torch.floor(pos)
        frac = pos - cell
        cell = torch.clamp(cell.to(torch.int64), 0, 0xFFFFFFFF)   # the saturating cast
        rows, ws = [], []
        for k in range(4):
            ga = (cell[..., 0] + (k >> 1)) & 0xFFFFFFFF
            gb = (cell[..., 1] + (k & 1)) & 0xFFFFFFFF
            h = ga ^ ((gb * 2654435761) & 0xFFFFFFFF) if hashed[l] else \
                (ga + gb * mul1[l]) & 0xFFFFFFFF
            rows.append((h % hsize[l]).to(torch.int32))
            ws.append((frac[..., 0] if k >> 1 else 1 - frac[..., 0])
                      * (frac[..., 1] if k & 1 else 1 - frac[..., 1]))
        idx.append(torch.stack(rows, -1))
        w.append(torch.stack(ws, -1))
    return torch.stack(idx, -2), torch.stack(w, -2)


@pytest.mark.parametrize("kw,bound", [
    (SPEC_KW, 1.0), (SPEC_KW, 1.5), (dict(MOVING_KW, log2_hashmap_size=12), 1.0),
    (dict(MOVING_KW, log2_hashmap_size=16), 0.7), (dict(SPEC_KW, gridtype="tiled"), 1.0),
    (dict(SPEC_KW, align_corners=True), 1.0),
    (dict(MOVING_KW, base_resolution=64, desired_resolution=2048, log2_hashmap_size=12), 1.0),
], ids=["default", "bound_1.5", "hashmap_12", "hashmap_16", "tiled", "aligned", "wide"])
def test_encode_kernel_constants_give_the_plain_corners(kw, bound):
    """The encode kernel's per-level constants and arithmetic, emulated on
    the CPU, give ``triplane_corners``' rows and weights bit for bit (points
    inside and outside the box; dense, hashed and tiled levels; a side
    larger than the table, "wide", whose second coordinate a tiled grid
    drops)."""
    spec = GridSpec(**kw)
    xyz = torch.from_numpy(np.random.default_rng(10).uniform(-2 * bound, 2 * bound, (4096, 3))
                           .astype(np.float32))
    ki, kw_ = _kernel_corners(xyz, spec, bound)
    pi, pw = hl.triplane_corners(xyz, spec, bound)
    assert torch.equal(ki, pi) and torch.equal(kw_, pw)


@pytest.mark.parametrize("script", ["prof_k3", "prof_k3_encode"])
def test_profiling_probes_find_their_text(script):
    """Each probe of K3's profiling scripts is a text edit of
    csrc/hash_lookup.cu: its text must be there as often as the probe says,
    or the script refuses to build it on the card."""
    import importlib

    mod = importlib.import_module(f"mere_fusion_tpu_torch.scripts.{script}")
    with open(hl._SRC) as f:
        source = f.read()
    for probe, edits in mod.probes(source).items():
        for old, _new, *times in edits:
            assert source.count(old) == (times[0] if times else 1), (probe, old[:60])
