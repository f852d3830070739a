"""The PyTorch port's DeepSpeech featurizer (mere_fusion_tpu_torch/audio/
deepspeech.py) against the JAX package's, on the CPU:

- the host pipeline (MFCC, ``input_vector``, ``interpolate_features``,
  ``conv_audio_to_deepspeech`` with a resample) within 1e-6;
- the GraphDef reader and ``params_from_graph`` equal to JAX's, on graphs
  written by ``chip_smoke.write_graphdef`` and by the JAX test's own writer;
- the network at hidden width 64 (PARAM_SHAPES patched in both packages):
  float32 within 2e-5, bf16 products against JAX's bf16 within 2e-2 of the
  largest logit; the LSTM scan in both directions within 2e-5;
- one full-width float32 ``deepspeech_logits_fn`` within 1e-4 of the largest
  logit.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import deepspeech_graph_names, speech_pcm, write_graphdef
from mere_fusion_tpu.audio import deepspeech as jds
from mere_fusion_tpu_torch.audio import deepspeech as pds
from tests.test_deepspeech import _const_node, _len_delim
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
TOY_SHAPES = {
    "h1": (494, 64), "b1": (64,), "h2": (64, 64), "b2": (64,), "h3": (64, 128), "b3": (128,),
    "lstm_fw_kernel": (192, 256), "lstm_fw_bias": (256,),
    "lstm_bw_kernel": (192, 256), "lstm_bw_bias": (256,),
    "h5": (128, 64), "b5": (64,), "h6": (64, 29), "b6": (29,),
}


@pytest.fixture()
def toy(monkeypatch):
    """Both packages' networks at hidden width 64."""
    monkeypatch.setattr(jds, "PARAM_SHAPES", TOY_SHAPES)
    monkeypatch.setattr(pds, "PARAM_SHAPES", TOY_SHAPES)


def tensors(params: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in params.items()}


def assert_close(got, want, tol: float, name: str = ""):
    """Within tol of the reference's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("n", [300, 8960, 16000])
def test_mfcc_and_input_vector_match_jax(n):
    audio = (np.random.default_rng(n).uniform(-0.3, 0.3, n) * 32768).astype(np.int16)
    np.testing.assert_allclose(pds.mfcc_psf(audio), jds.mfcc_psf(audio), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pds.input_vector(audio), jds.input_vector(audio),
                               rtol=0, atol=1e-6)


def test_interpolate_features_matches_jax():
    feats = np.random.default_rng(0).standard_normal((50, 29))
    for out_rate, out_len in ((25.0, 25), (30.0, 31)):
        np.testing.assert_allclose(pds.interpolate_features(feats, 50.0, out_rate, out_len),
                                   jds.interpolate_features(feats, 50.0, out_rate, out_len),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("rate", [16000, 22050])
def test_conv_audio_to_deepspeech_matches_jax(rate):
    """The per-file pipeline, with a fixed linear map as the network; 22,050
    Hz int16 audio goes through each package's resampler."""
    w = np.random.default_rng(1).standard_normal((494, 29)) * 0.05
    net = lambda vec: vec @ w
    audio = (speech_pcm(rate) * 32767).astype(np.int16)
    got = pds.conv_audio_to_deepspeech(audio, rate, net, num_frames=25)
    want = jds.conv_audio_to_deepspeech(audio, rate, net, num_frames=25)
    assert got.shape == want.shape and got.shape[1:] == (16, 29)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_graph_reader_matches_jax(tmp_path, toy):
    params = pds.init_params(np.random.default_rng(2))
    path = str(tmp_path / "ds.pb")
    size = write_graphdef(path, deepspeech_graph_names(params))
    assert size == (tmp_path / "ds.pb").stat().st_size
    got, want = pds.read_graph_constants(path), jds.read_graph_constants(path)
    assert list(got) == list(want) == list(deepspeech_graph_names(params))
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].flags.writeable
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    got_p, want_p = pds.params_from_graph(got), jds.params_from_graph(want)
    assert list(got_p) == list(want_p) and set(got_p) == set(TOY_SHAPES)
    for key in want_p:
        np.testing.assert_array_equal(got_p[key], want_p[key], err_msg=key)
        np.testing.assert_array_equal(got_p[key], params[key], err_msg=key)
    # each array is a view of the file's one buffer, not a copy
    assert got_p["h1"].base is not None


def test_graph_reader_matches_jax_on_hand_built_nodes(tmp_path):
    """The JAX test's own writer: a Placeholder (no tensor), Const nodes."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    pb = (_const_node("h1", a) + _const_node("bidirectional_rnn/fw/basic_lstm_cell/kernel", b)
          + _len_delim(1, _len_delim(1, b"x") + _len_delim(2, b"Placeholder")))
    path = tmp_path / "g.pb"
    path.write_bytes(pb)
    got, want = pds.read_graph_constants(str(path)), jds.read_graph_constants(str(path))
    assert set(got) == set(want) == {"h1", "bidirectional_rnn/fw/basic_lstm_cell/kernel"}
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_params_from_graph_raises_as_jax(toy):
    params = deepspeech_graph_names(pds.init_params(np.random.default_rng(2)))
    del params["h5"]
    with pytest.raises(KeyError, match="h5"):
        pds.params_from_graph(params)
    params = deepspeech_graph_names(pds.init_params(np.random.default_rng(2)))
    params["b1"] = params["b1"][:10]
    with pytest.raises(ValueError, match="b1"):
        pds.params_from_graph(params)


def test_init_params_draw_as_jax(toy):
    got = pds.init_params(np.random.default_rng(7), scale=0.05)
    want = jds.init_params(np.random.default_rng(7), scale=0.05)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_jax(reverse):
    rng = np.random.default_rng(3)
    kernel = (rng.standard_normal((12 + 8, 32)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    xs = rng.standard_normal((9, 12)).astype(np.float32)
    want = jds._lstm_scan(jnp.asarray(kernel), jnp.asarray(bias), jnp.asarray(xs),
                          reverse=reverse)
    got = pds.lstm_scan(torch.from_numpy(kernel), torch.from_numpy(bias),
                        torch.from_numpy(xs), reverse=reverse)
    assert got.dtype == torch.float32 and got.shape == (9, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepspeech_apply_matches_jax(toy, dtype):
    """Hidden width 64, weights at trained magnitude (scale 0.1): float32
    within 2e-5; bf16 products (f32 sums, bf16-rounded activations) against
    JAX's within 2e-2 of the largest logit (a clipped activation rounded
    the other way moves a logit by a bf16 step)."""
    params = pds.init_params(np.random.default_rng(11), scale=0.1)
    x = np.random.default_rng(8).standard_normal((27, 494)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jds.deepspeech_apply({k: jnp.asarray(v) for k, v in params.items()},
                                           jnp.asarray(x), compute_dtype=jdt))
    pdt = None if dtype == "float32" else torch.bfloat16
    got = pds.deepspeech_apply(tensors(params), torch.from_numpy(x), pdt)
    assert got.dtype == torch.float32 and got.shape == (27, 29)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    else:
        assert_close(got.numpy(), want, 2e-2)
        f32 = jds.deepspeech_apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
        assert np.abs(np.asarray(f32) - want).max() > 1e-4, "bf16 must round"


def test_logits_fn_forms(toy):
    """The numpy form, the tensor form (return_device: bf16 by default) and
    the graph path agree with JAX's forms on the CPU; with no device given
    and no GPU the function raises."""
    params = pds.init_params(np.random.default_rng(9), scale=0.05)
    pcm = speech_pcm()
    f32 = pds.deepspeech_logits_fn(params=params, device="cpu")(pcm)
    assert isinstance(f32, np.ndarray) and f32.shape == (28, 29)
    want = jds.deepspeech_logits_fn(params=params)(pcm)
    np.testing.assert_allclose(f32, want, rtol=0, atol=2e-5)
    fn = pds.deepspeech_logits_fn(params=params, device=CPU, return_device=True)
    assert fn.width == 29
    dev = fn(pcm)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    want_bf16 = jds.deepspeech_logits_fn(params=params, compute_dtype="bfloat16")(pcm)
    assert_close(dev.numpy(), want_bf16, 2e-2)
    with pytest.raises(ValueError, match="pb_path or params"):
        pds.deepspeech_logits_fn(device="cpu")


def test_logits_fn_needs_cuda_or_an_explicit_cpu(monkeypatch, toy):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pds.deepspeech_logits_fn(params=pds.init_params())


def test_full_width_logits_fn_matches_jax(tmp_path):
    """The full-width network (BiLSTM 2048) from a written graph, float32,
    on one 8,960-sample window: within 1e-4 of the largest logit."""
    params = pds.init_params(np.random.default_rng(11), scale=0.1)
    path = str(tmp_path / "ds.pb")
    write_graphdef(path, deepspeech_graph_names(params))
    pcm = speech_pcm()
    got = pds.deepspeech_logits_fn(pb_path=path, device="cpu")(pcm)
    want = jds.deepspeech_logits_fn(params=params)(pcm)
    assert got.shape == want.shape == (28, 29)
    assert_close(got, want, 1e-4)
    assert float(np.abs(want).max()) > 1.0, "logits at trained magnitude"
