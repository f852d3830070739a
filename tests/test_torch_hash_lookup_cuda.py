"""K3's CUDA kernels (csrc/hash_lookup.cu) against their plain PyTorch
version, and the network's encode_x through them.

Needs an NVIDIA GPU (marker ``cuda``; skipped without one) and imports no
JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_hash_lookup_cuda.py

Tolerances (chip_smoke.py's, set from its readings on the card): the
forward sums the same four f32 products in the same order as the plain
version, 1e-6 absolute with tables U(−1, 1); the table gradient's atomics
add in an order that changes from run to run, 1e-5 of its largest entry;
the weights' gradient is a plain gather on both sides, 1e-6 relative. The
backward accumulates pieces of each plane's rows in the shared memory of a
cluster of blocks and writes every row of the gradient: it is held at table
sizes whose levels go in pairs, alone and in slices, with every point in one
cell (the most adds a row can take), at point counts that split unevenly over
a cluster, and into a buffer filled with NaN. The encode kernel (the corners
hashed in the kernel) equals the plain version bit for bit (points inside
and outside the box, dense and hashed levels, a bound of 1.5), and the rows
and weights it saves equal triplane_corners'.
"""
from __future__ import annotations

import pytest
import torch

from chip_smoke import (
    K3_BWD_RTOL,
    K3_FWD_ATOL,
    k3_fma_corners,
    k3_inputs,
    k3_operands,
    k3_plain_grad,
)
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork, init_ernerf_
from mere_fusion_tpu_torch.ops import hash_lookup
from mere_fusion_tpu_torch.ops.hashgrid import GridSpec


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


SHAPES = {
    "training": dict(n=65536, spec=None),
    "small": dict(n=1000, spec=GridSpec(input_dim=2, num_levels=4, level_dim=1,
                                        base_resolution=16, log2_hashmap_size=10,
                                        desired_resolution=64)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernels_match_plain_on_gpu(cuda_device, shape):
    spec, tables, idx, w, gout = k3_operands(cuda_device, **SHAPES[shape])
    before = (hash_lookup.fwd_launches, hash_lookup.bwd_launches)
    out = hash_lookup.lookup(tables, idx, w, spec)
    dtables = hash_lookup.lookup_bwd_cuda(idx, w, gout, spec, tables)
    torch.cuda.synchronize()
    assert (hash_lookup.fwd_launches, hash_lookup.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = hash_lookup.lookup_plain(tables, idx, w, spec)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert (out - ref).abs().max().item() <= K3_FWD_ATOL
    dref = k3_plain_grad(spec, tables, idx, w, gout)
    scale = max(d.abs().max().item() for d in dref)
    for d, r in zip(dtables, dref):
        assert d.shape == r.shape == (spec.total_params, spec.level_dim)
        assert (d - r).abs().max().item() <= K3_BWD_RTOL * scale


@pytest.mark.cuda
def test_autograd_function_on_gpu(cuda_device):
    """Lookup under autograd: table gradients through the backward kernel,
    the weights' gradient through the plain gather, against plain autograd."""
    spec, tables, idx, w, gout = k3_operands(cuda_device, **SHAPES["small"])

    def grads(fn):
        t = [x.clone().requires_grad_() for x in tables]
        ws = w.clone().requires_grad_()
        (fn(t, ws) * gout).sum().backward()
        return [x.grad for x in t], ws.grad

    got = grads(lambda t, ws: hash_lookup.lookup(t, idx, ws, spec))
    ref = grads(lambda t, ws: hash_lookup.lookup_plain(t, idx, ws, spec))
    scale = max(r.abs().max().item() for r in ref[0])
    for g, r in zip(got[0], ref[0]):
        assert (g - r).abs().max().item() <= K3_BWD_RTOL * scale
    assert (got[1] - ref[1]).abs().max().item() <= 1e-6 * ref[1].abs().max().item()


@pytest.mark.cuda
def test_bad_operands_raise_on_gpu(cuda_device):
    spec, tables, idx, w, gout = k3_operands(cuda_device, **SHAPES["small"])
    with pytest.raises(TypeError, match="float32"):
        hash_lookup.lookup(tables, idx, w.double(), spec)
    with pytest.raises(TypeError, match="int32"):
        hash_lookup.lookup(tables, idx.long(), w, spec)
    with pytest.raises(ValueError, match="shape"):
        hash_lookup.lookup(tables, idx[:, :-1].contiguous(), w, spec)
    with pytest.raises(ValueError, match="contiguous"):
        hash_lookup.lookup(tables, idx.transpose(1, 2).contiguous().transpose(1, 2), w, spec)
    with pytest.raises(ValueError, match="CUDA"):
        hash_lookup.lookup(tables, idx, w.cpu(), spec)
    with pytest.raises(ValueError, match="gout"):
        hash_lookup.lookup_bwd_cuda(idx, w, gout[:, :-1], spec, tables)


@pytest.mark.cuda
def test_encode_x_launches_the_kernel_at_any_size(cuda_device):
    cfg = NeRFNetConfig(num_levels=4, base_resolution=16, desired_resolution=64,
                        log2_hashmap_size=10)
    net = init_ernerf_(NeRFNetwork(cfg).to(cuda_device), 0)
    for n in (1, 100, 5000):
        xyz = torch.rand(n, 3, device=cuda_device) * 2 - 1
        before = hash_lookup.encode_launches
        enc = net.encode_x(xyz)
        assert hash_lookup.encode_launches == before + 1
        ref = hash_lookup.triplane_encode(net.plane_xy, net.plane_yz, net.plane_xz, xyz,
                                          cfg.plane_spec, cfg.bound, impl="plain")
        assert (enc - ref).abs().max().item() <= K3_FWD_ATOL


def bwd_case(dev, n, spec=None, same_cell=False, seed=0):
    """K3 backward's operands and the plain version's table gradients: n
    seeded points (all at one point when same_cell) through the spec's
    corner rows and weights."""
    spec, tables, idx, w, gout = k3_operands(dev, n=n, spec=spec, seed=seed)
    if same_cell:
        from mere_fusion_tpu_torch.ops.hash_lookup import triplane_corners

        xyz = torch.full((n, 3), 0.3141, device=dev)
        idx, w = triplane_corners(xyz, spec, 1.0)
    dref = k3_plain_grad(spec, tables, idx, w, gout)
    return spec, tables, idx, w, gout, dref


def assert_grads_close(dtables, dref):
    scale = max(d.abs().max().item() for d in dref)
    for d, r in zip(dtables, dref):
        assert bool(torch.isfinite(d).all())
        assert (d - r).abs().max().item() <= K3_BWD_RTOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("log2_hashmap_size", [14, 15, 16, 17, 19])
def test_backward_table_sizes(cuda_device, log2_hashmap_size):
    """Any --log2_hashmap_size: at 14 (the default) levels go in pairs, at 15
    a pair no longer fits a block's shared memory, from 16 on the finest
    levels (58,568 to 263,176 rows) are cut into slices. 65,536 points into a
    buffer filled with NaN: every row written, each within the limit."""
    spec = NeRFNetConfig(log2_hashmap_size=log2_hashmap_size).plane_spec
    spec, tables, idx, w, gout, dref = bwd_case(cuda_device, 65536, spec=spec)
    out = torch.full((3, spec.total_params, 1), float("nan"), device=cuda_device)
    got = hash_lookup.lookup_bwd_cuda(idx, w, gout, spec, tables, out=out)
    torch.cuda.synchronize()
    assert_grads_close(got, dref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,same_cell", [(1, False), (1001, False), (65537, False),
                                         (1001, True), (16384, True)])
def test_backward_collisions_and_ragged_counts(cuda_device, n, same_cell):
    """Every point in one cell puts all of a level's adds on four rows (at
    16,384 points an f32 sum of that many random-sign terms moves by ~4.5e-6
    of its size between two orders of addition, inside the limit); 1, 1001
    and 65537 points leave a cluster's blocks unequal shares (some none)."""
    spec, tables, idx, w, gout, dref = bwd_case(cuda_device, n, same_cell=same_cell)
    got = hash_lookup.lookup_bwd_cuda(idx, w, gout, spec, tables)
    torch.cuda.synchronize()
    assert_grads_close(got, dref)
    if same_cell:   # four rows a level take every add; the rest stay 0
        assert int((got[0] != 0).sum()) <= 4 * spec.num_levels


@pytest.mark.cuda
def test_backward_writes_every_row(cuda_device):
    """No zero-fill: a gradient buffer filled with NaN comes back fully
    written, equal to a fresh one."""
    spec, tables, idx, w, gout, dref = bwd_case(cuda_device, 4096)
    out = torch.full((3, spec.total_params, 1), float("nan"), device=cuda_device)
    got = hash_lookup.lookup_bwd_cuda(idx, w, gout, spec, tables, out=out)
    torch.cuda.synchronize()
    assert got[0].data_ptr() == out.data_ptr()
    assert not bool(torch.isnan(out).any())
    assert_grads_close(got, dref)
    with pytest.raises(ValueError, match="out"):
        hash_lookup.lookup_bwd_cuda(idx, w, gout, spec, tables, out=out[:2])


def plain_encode(tables, xyz, spec, bound=1.0):
    idx, w = hash_lookup.triplane_corners(xyz, spec, bound)
    return hash_lookup.lookup_plain(tables, idx, w, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("log2_hashmap_size", list(range(12, 20)))
@pytest.mark.parametrize("n", [1, 255, 4096, 65536])
def test_encode_matches_plain_bit_for_bit(cuda_device, n, log2_hashmap_size):
    """Every table size from 2^12 (every level hashed) to 2^19 (the coarse
    levels dense, their sizes not powers of two), points up to 1.2 outside
    the box; with and without the saved rows and weights, which equal
    triplane_corners'."""
    spec = NeRFNetConfig(log2_hashmap_size=log2_hashmap_size).plane_spec
    spec, tables, xyz, _ = k3_inputs(cuda_device, n, spec, seed=n, spread=1.2)
    ref = plain_encode(tables, xyz, spec)
    pidx, pw = hash_lookup.triplane_corners(xyz, spec, 1.0)
    for save in (False, True):
        out, idx, w = hash_lookup.encode_cuda(tables, xyz, spec, save=save)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        if save:
            assert torch.equal(idx, pidx) and torch.equal(w, pw)


@pytest.mark.cuda
def test_encode_bound_and_controls(cuda_device):
    """At a bound of 1.5 the kernel divides as the plain version does (a true
    division, which PyTorch on CUDA takes only from a tensor divisor); an
    FMA-contracted pos and a dropped corner are off the limit."""
    spec, tables, xyz, _ = k3_inputs(cuda_device, 65536, seed=3, spread=1.6)
    ref = plain_encode(tables, xyz, spec, 1.5)
    assert torch.equal(hash_lookup.encode_cuda(tables, xyz, spec, 1.5)[0], ref)
    ref1 = plain_encode(tables, xyz, spec)
    fi, fw = k3_fma_corners(xyz, spec)
    assert (hash_lookup.lookup_plain(tables, fi, fw, spec) - ref1).abs().max().item() > K3_FWD_ATOL
    idx, w = hash_lookup.triplane_corners(xyz, spec, 1.0)
    w[..., 3] = 0
    assert (hash_lookup.lookup_plain(tables, idx, w, spec) - ref1).abs().max().item() > K3_FWD_ATOL


@pytest.mark.cuda
def test_encode_autograd_and_routes(cuda_device):
    """triplane_encode's routes and their launches: tables that need a
    gradient take Encode (rows and weights saved, the backward kernel);
    positions that need a gradient, the corner route; both give the plain
    version's output and the plain version's table gradients; no gradient,
    the encode alone."""
    spec, tables, xyz, gout = k3_inputs(cuda_device, 4096, seed=4, spread=1.1)
    idx, w = hash_lookup.triplane_corners(xyz, spec, 1.0)
    ref = hash_lookup.lookup_plain(tables, idx, w, spec)
    ref_grads = k3_plain_grad(spec, tables, idx, w, gout)

    def run(x):
        t = [p.clone().requires_grad_() for p in tables]
        before = (hash_lookup.encode_launches, hash_lookup.fwd_launches,
                  hash_lookup.bwd_launches)
        out = hash_lookup.triplane_encode(*t, x, spec)
        (out * gout).sum().backward()
        torch.cuda.synchronize()
        after = (hash_lookup.encode_launches, hash_lookup.fwd_launches, hash_lookup.bwd_launches)
        assert torch.equal(out, ref)
        for g, c in zip((p.grad for p in t), ref_grads):
            scale = c.abs().max().item()
            assert scale > 0 and (g - c).abs().max().item() <= K3_BWD_RTOL * scale
        return out, tuple(a - b for a, b in zip(after, before))

    out, launches = run(xyz)
    assert launches == (1, 0, 1)
    x = xyz.clone().requires_grad_()
    _, xlaunches = run(x)
    assert xlaunches == (0, 1, 1) and x.grad is not None
    with torch.no_grad():
        before = hash_lookup.encode_launches
        assert torch.equal(hash_lookup.triplane_encode(*tables, xyz, spec), out.detach())
        assert hash_lookup.encode_launches == before + 1
    with pytest.raises(TypeError, match="float32"):
        hash_lookup.encode_cuda(tables, xyz.double(), spec)
    with pytest.raises(ValueError, match="CUDA"):
        hash_lookup.encode_cuda(tables, xyz.cpu(), spec)
