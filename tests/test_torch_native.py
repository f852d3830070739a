"""The port's ctypes binding of native/mfhost.cpp (built into the port's own
build directory) against its numpy fallbacks and the JAX package's binding."""
from __future__ import annotations

import numpy as np
import pytest

from mere_fusion_tpu import native as jax_native
from mere_fusion_tpu_torch import native
from mere_fusion_tpu_torch.runtime.build import BUILD_DIR


@pytest.fixture()
def fallback(monkeypatch):
    """The numpy paths: no library loaded, no build attempted."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


def test_builds_into_the_ports_build_directory():
    if not native.available():
        pytest.skip("no g++: the numpy fallbacks serve")
    assert native._lib._name.startswith(BUILD_DIR)


@pytest.mark.parametrize("use_lib", [True, False])
def test_pcm_and_blend_match_jax_binding(request, use_lib):
    if not use_lib:
        request.getfixturevalue("fallback")
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.2, 1.2, 4096).astype(np.float32)
    np.testing.assert_allclose(native.f32_to_pcm16(x).astype(int),
                               jax_native.f32_to_pcm16(x).astype(int), atol=1)
    pcm = jax_native.f32_to_pcm16(x)
    np.testing.assert_allclose(native.pcm16_to_f32(pcm), jax_native.pcm16_to_f32(pcm),
                               atol=1e-4)
    fg = rng.integers(0, 255, (32, 40, 3), dtype=np.uint8)
    bg = rng.integers(0, 255, (32, 40, 3), dtype=np.uint8)
    w = rng.uniform(0, 1, (32, 40)).astype(np.float32)
    got = native.blend_linear_u8(fg, bg, w).astype(int)
    assert np.abs(got - jax_native.blend_linear_u8(fg, bg, w).astype(int)).max() <= 1


@pytest.mark.parametrize("use_lib", [True, False])
def test_paste_clips_at_the_border(request, use_lib):
    if not use_lib:
        request.getfixturevalue("fallback")
    dst = np.zeros((10, 10, 3), np.uint8)
    native.paste_u8(np.full((4, 4, 3), 7, np.uint8), dst, 8, 8)
    assert dst[8, 8, 0] == 7 and dst[9, 9, 0] == 7 and dst[7, 7, 0] == 0
