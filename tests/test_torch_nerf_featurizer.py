"""The PyTorch port's ER-NeRF live featurizers against the JAX package's, on
the CPU at toy sizes (a DeepSpeech graph at hidden width 64, 64² frames, 4
hash levels):

- ``NerfASR``'s windows with att=0 and att=2 equal to JAX's (the fake
  featurizer), and the device flush (``device_logits_fn``) equal to the host
  path, after which ``get_next_feat`` raises as JAX's does;
- ``make_nerf_featurizer`` on a written ``.pb``: both bf16 forms, within
  2e-2 of the largest logit of JAX's forms (bf16 activations rounded the
  other way), and the ``nerf.audio_in_dim`` check;
- a ``make_engine`` session with ``nerf.asr_model`` set to the ``.pb``:
  uint8 frames within 1 LSB of JAX's ``NeRFReal`` fed the same speech (the
  K2 step on JAX's baked textures, the Pallas kernel in interpret mode), the
  device rings within 2e-2;
- wav2vec: a tiny random ``Wav2Vec2ForCTC`` and a 44-token processor
  saved to a directory; the port within 1e-4 of the largest logit of the
  JAX package's torch branch, and the ImportError without transformers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import deepspeech_graph_names, speech_pcm, write_graphdef
from mere_fusion_tpu.audio import deepspeech as jds
from mere_fusion_tpu.config import Config as JConfig
from mere_fusion_tpu.data.provider import NeRFTestDataset as JDataset
from mere_fusion_tpu.engines import make_engine as j_make_engine
from mere_fusion_tpu.engines import make_nerf_featurizer as j_featurizer
from mere_fusion_tpu.engines.nerf import NerfASR as JNerfASR
from mere_fusion_tpu.engines.nerf import fake_logits_fn as j_fake
from mere_fusion_tpu.models.ernerf.network import NeRFNetConfig as JNetConfig
from mere_fusion_tpu.models.ernerf.network import NeRFNetwork as JNetwork
from mere_fusion_tpu.ops.triplane_bake import bake_triplanes as j_bake
from mere_fusion_tpu_torch.audio import deepspeech as pds
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.convert import ernerf_from_flax
from mere_fusion_tpu_torch.data.provider import NeRFTestDataset, synthesize_nerf_dataset
from mere_fusion_tpu_torch.engines import make_engine, make_nerf_featurizer
from mere_fusion_tpu_torch.engines.nerf import NeRFReal, NerfASR, fake_logits_fn
from mere_fusion_tpu_torch.engines.nerf_step import make_render_step
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig
from mere_fusion_tpu_torch.runtime.metrics import metrics
from tests.test_torch_deepspeech import TOY_SHAPES, assert_close

CPU = torch.device("cpu")
NET = dict(num_levels=4, base_resolution=16, desired_resolution=64, log2_hashmap_size=10,
           audio_in_dim=29)
OVERRIDES = {
    "tts.backend": "procedural", "avatar.kind": "ernerf", "nerf.grid_size": 16,
    "nerf.num_levels": 4, "nerf.base_resolution": 16, "nerf.desired_resolution": 64,
    "nerf.log2_hashmap_size": 10, "nerf.max_steps": 8, "nerf.tile_budget": 8,
    "nerf.audio_in_dim": 29,
}


@pytest.fixture()
def toy_pb(tmp_path, monkeypatch):
    """A DeepSpeech graph at hidden width 64 (both packages' PARAM_SHAPES
    patched), weights at trained magnitude."""
    monkeypatch.setattr(jds, "PARAM_SHAPES", TOY_SHAPES)
    monkeypatch.setattr(pds, "PARAM_SHAPES", TOY_SHAPES)
    path = str(tmp_path / "ds.pb")
    write_graphdef(path, deepspeech_graph_names(pds.init_params(np.random.default_rng(11),
                                                                scale=0.1)))
    return path


def drive(asrs, chunks):
    """Two run_steps a video frame on each ASR, the same chunk into each."""
    for chunk in chunks:
        for a in asrs:
            a.put_audio_frame(chunk)
            a.run_step()


@pytest.mark.parametrize("att", [0, 2])
def test_nerf_asr_windows_match_jax(att):
    cfg, jcfg = Config(), JConfig()
    port = NerfASR(cfg, None, fake_logits_fn(44), att=att)
    ref = JNerfASR(jcfg, None, j_fake(44), att=att)
    for a in (port, ref):
        a.warm_up()
    pcm = speech_pcm(16000)
    for f in range(25):
        drive((port, ref), (pcm[(2 * f + k) * 320:(2 * f + k + 1) * 320] for k in range(2)))
        got, want = port.get_next_feat(), ref.get_next_feat()
        assert got.shape == want.shape == ((8 if att else 1), 44, 16)
        np.testing.assert_array_equal(got, want)
    assert np.abs(got).sum() > 0, "speech features must reach the window"


def test_device_flush_equals_the_host_path():
    """With device_logits_fn the flushes after the device ring goes live
    write the logits' rows there: the windows equal the host path's, and
    the host ring is stale."""
    fake = fake_logits_fn(44)
    flushes = []
    host = NerfASR(Config(), None, fake)
    dev = NerfASR(Config(), None, fake,
                  device_logits_fn=lambda a: flushes.append(1) or torch.from_numpy(fake(a)))
    for a in (host, dev):
        a.warm_up()
    assert not flushes, "the device ring is not live before the first device window"
    pcm = speech_pcm(16000)
    for f in range(20):
        drive((host, dev), (pcm[(2 * f + k) * 320:(2 * f + k + 1) * 320] for k in range(2)))
        np.testing.assert_array_equal(dev.get_next_feat_device().numpy(), host.get_next_feat())
    assert len(flushes) == 40 // 8          # a window every context (8) steps
    np.testing.assert_array_equal(dev._ring_dev.numpy(), host.feat_ring)
    with pytest.raises(RuntimeError, match="stale"):
        dev.get_next_feat()


def test_make_nerf_featurizer_on_a_graph(toy_pb):
    logits_fn, device_fn = make_nerf_featurizer(toy_pb, CPU, audio_in_dim=29)
    j_logits_fn, j_device_fn = j_featurizer(toy_pb)
    pcm = speech_pcm()
    host, dev = logits_fn(pcm), device_fn(pcm)
    assert isinstance(host, np.ndarray) and host.shape == (28, 29)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), host)     # both forms run bf16
    assert_close(host, j_logits_fn(pcm), 2e-2)
    assert_close(dev.numpy(), np.asarray(j_device_fn(pcm)), 2e-2)
    # one copy of the graph's weights a device, its matrices in bf16
    again, _ = make_nerf_featurizer(toy_pb, CPU)
    np.testing.assert_array_equal(again(pcm), host)
    with pytest.raises(ValueError, match="nerf.audio_in_dim"):
        make_nerf_featurizer(toy_pb, CPU, audio_in_dim=44)


def test_audio_in_dim_mismatch_and_missing_featurizer_raise(toy_pb, tmp_path):
    d = synthesize_nerf_dataset(str(tmp_path / "data"), hw=64)
    cfg = Config().override(**{
        **OVERRIDES, "nerf.pose_path": f"{d}/transforms.json", "nerf.au_path": f"{d}/au.csv",
        "nerf.scale": 1.0, "nerf.asr_model": toy_pb, "nerf.audio_in_dim": 44})
    with pytest.raises(ValueError, match="nerf.audio_in_dim"):
        make_engine(cfg, device=CPU)
    ds = NeRFTestDataset.load(f"{d}/transforms.json", f"{d}/au.csv", scale=1.0)
    with pytest.raises(ValueError, match="make_nerf_featurizer"):
        NeRFReal(cfg, ds, device=CPU)


def test_speech_session_matches_jax(toy_pb, tmp_path):
    d = synthesize_nerf_dataset(str(tmp_path / "data"), hw=64)
    kw = dict(scale=1.0, smooth_path=True, smooth_path_window=3, smooth_eye=True)
    jds_, pds_ = (cls.load(f"{d}/transforms.json", f"{d}/au.csv", **kw)
                  for cls in (JDataset, NeRFTestDataset))
    jnet = JNetwork(JNetConfig(**NET))
    variables = jax.jit(jnet.init, static_argnames="method")(
        jax.random.key(0), jnp.zeros((8, 29, 16)), jnp.zeros((4, 3)),
        jnp.ones((4, 3)) / np.sqrt(3.0), jnp.zeros((1, 4)), jnp.zeros((1, 1)),
        method=JNetwork.full_init)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(5)
    for name in ("plane_xy", "plane_yz", "plane_xz"):
        params[name] = rng.uniform(-1, 1, params[name].shape).astype(np.float32)
    variables = {"params": params}
    over = {**OVERRIDES, "nerf.asr_model": toy_pb}
    jeng = j_make_engine(JConfig().override(**over), network=jnet, variables=variables,
                         dataset=jds_)
    cfg = Config().override(**over)
    builds = metrics.latency("nerf.build.featurizer").count
    peng = make_engine(cfg, device=CPU, dataset=pds_,
                       state=ernerf_from_flax(variables, NeRFNetConfig(**NET)))
    assert metrics.latency("nerf.build.featurizer").count == builds + 1
    assert peng.asr.device_logits_fn is not None
    # the port's step on the JAX engine's baked textures
    baked = j_bake(params, JNetConfig(**NET).plane_spec, 1.0, resolution=128,
                   dtype=jnp.bfloat16)
    peng._render_step = make_render_step(peng.network, pds_, cfg, {
        k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
        for k, v in baked.items()})
    pcm = speech_pcm(16000)
    for e in (jeng, peng):
        for c in range(50):                      # one TTS burst: 1 s of speech
            e.asr.put_audio_frame(pcm[c * 320:(c + 1) * 320])
    rendered = 0
    for _ in range(40):
        for e in (jeng, peng):
            e.asr.run_step()
            e.asr.run_step()
        # the warm-up's queued silence is dropped for speech, in step
        shown = jeng.test_step()
        assert peng.test_step() == shown
        if shown:
            rendered += 1
            diff = np.abs(jeng.latest_frame.image.astype(int)
                          - peng.latest_frame.image.astype(int))
            assert diff.max() <= 1, f"frame {rendered} differs by {diff.max()} LSB"
        if rendered == 6:
            break
    assert rendered == 6 and peng.latest_frame.image.std() > 2
    assert_close(peng.asr._ring_dev.numpy(), np.asarray(jeng.asr._ring_dev), 2e-2)
    assert np.abs(peng.asr._ring_dev.numpy()).max() > 0.1
    with pytest.raises(RuntimeError, match="stale"):
        peng.asr.get_next_feat()


def test_wav2vec_matches_jax(tmp_path):
    """A tiny random Wav2Vec2ForCTC and a 44-token processor saved to a
    directory. The reference is the JAX package's torch branch: its flax
    branch raises under transformers 4.57 (the flax module's apply returns
    a tuple, not an output with .logits)."""
    transformers = pytest.importorskip("transformers")
    import json

    from mere_fusion_tpu.engines.nerf import wav2vec_logits_fn as j_wav2vec
    from mere_fusion_tpu_torch.engines.nerf import wav2vec_logits_fn

    vocab_file = tmp_path / "vocab.json"
    vocab_file.write_text(json.dumps({f"<{i}>": i for i in range(44)}))
    model_dir = str(tmp_path / "w2v")
    tokenizer = transformers.Wav2Vec2CTCTokenizer(str(vocab_file), unk_token="<1>",
                                                  pad_token="<0>", word_delimiter_token="<2>")
    extractor = transformers.Wav2Vec2FeatureExtractor(
        feature_size=1, sampling_rate=16000, padding_value=0.0, do_normalize=True,
        return_attention_mask=False)
    transformers.Wav2Vec2Processor(feature_extractor=extractor,
                                   tokenizer=tokenizer).save_pretrained(model_dir)
    torch.manual_seed(0)
    config = transformers.Wav2Vec2Config(
        vocab_size=44, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=2, pad_token_id=0)
    transformers.Wav2Vec2ForCTC(config).eval().save_pretrained(model_dir)

    fn = wav2vec_logits_fn(model_dir, CPU)
    assert fn.width == 44
    pcm = speech_pcm(8960)
    got, want = fn(pcm), j_wav2vec(model_dir, backend="torch")(pcm)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (27, 44)
    assert_close(got, want, 1e-4)
    # make_engine's featurizer: host logits, no device form
    logits_fn, device_fn = make_nerf_featurizer(model_dir, CPU, audio_in_dim=44)
    assert device_fn is None
    np.testing.assert_array_equal(logits_fn(pcm), got)
    with pytest.raises((OSError, ValueError)):     # local files only, no download
        wav2vec_logits_fn(str(tmp_path / "not-a-model"), CPU)


def test_wav2vec_without_transformers_raises(monkeypatch):
    from mere_fusion_tpu_torch.engines.nerf import wav2vec_logits_fn

    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        wav2vec_logits_fn("some/model", CPU)


def test_server_cli_maps_the_featurizer_and_fullbody_flags():
    from mere_fusion_tpu_torch.cli import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_args([
        "--model", "ernerf", "--asr_model", "ds.pb", "--audio_in_dim", "29",
        "--fullbody_img", "body", "--fullbody_offset_x", "12", "--fullbody_offset_y", "34"]))
    nc = cfg.nerf
    assert (nc.asr_model, nc.audio_in_dim, nc.fullbody_imgs) == ("ds.pb", 29, "body")
    assert tuple(nc.fullbody_offset) == (12, 34)
    nc = config_from_args(build_parser().parse_args(["--model", "ernerf"])).nerf
    assert (nc.asr_model, nc.audio_in_dim, nc.fullbody_imgs) == ("", 44, "")
    # the JAX package's fullbody command line (tests/test_config.py) maps as it does
    argv = ["--model", "ernerf", "--pose", "/d/t.json", "--au", "/d/au.csv",
            "--fix_eye", "0.3", "--fullbody", "--fullbody_img", "/d/full",
            "--fullbody_offset_x", "40", "--fullbody_offset_y", "60"]
    from mere_fusion_tpu import cli as jax_cli

    nc = config_from_args(build_parser().parse_args(argv)).nerf
    ref = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv)).nerf
    assert (nc.pose_path, nc.au_path, nc.fix_eye, nc.fullbody_imgs) == (
        ref.pose_path, ref.au_path, ref.fix_eye, ref.fullbody_imgs) == (
        "/d/t.json", "/d/au.csv", 0.3, "/d/full")
    assert tuple(nc.fullbody_offset) == tuple(ref.fullbody_offset) == (40, 60)
    with pytest.raises(SystemExit, match="--fullbody needs --fullbody_img <dir>"):
        config_from_args(build_parser().parse_args(["--model", "ernerf", "--fullbody"]))
