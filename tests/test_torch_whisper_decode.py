"""The port's Whisper decoder and decode loops (mere_fusion_tpu_torch/
models/whisper.py) against the JAX package's, on the same weights.

Narrow widths (d 64, 2 + 2 layers, 32 audio frames) with the full
51,865-token vocabulary, so that every special token (SOT 50258, EOT 50257,
<|nospeech|>, the language tokens) is a real row of the embedding. Weights
come from the JAX init through ``convert.whisper_from_flax``; inputs from
numpy seeds. Logits and cross-attention within 2e-5, decoded tokens
identical, avg logprob and no-speech probability within 1e-5.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.models import whisper as jw
from mere_fusion_tpu_torch.convert import load_whisper_checkpoint, whisper_from_flax
from mere_fusion_tpu_torch.models import whisper as tw

DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2)
JDIMS, TDIMS = jw.WhisperDims(**DIMS), tw.WhisperDims(**DIMS)
LOGIT_ATOL = 2e-5
SCORE_ATOL = 1e-5
MAX_NEW = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The decode loops run many small operations: one intra-op thread, so
    that this file does not oversubscribe the cores other test workers share."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables as numpy, the port's model on the CPU,
    the JAX and port encodings of one seeded mel)."""
    model = jw.Whisper(JDIMS)
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 80, 64)),
                                    jnp.zeros((1, 4), jnp.int32))
    variables = jax.tree_util.tree_map(np.array, variables)   # writable copies
    port = tw.Whisper(TDIMS)
    port.load_state_dict(whisper_from_flax(variables, TDIMS), strict=True)
    port.eval()
    mel = np.random.default_rng(0).standard_normal((1, 80, 64)).astype(np.float32)
    xa_j = jax.jit(lambda v, m: model.apply(v, m, method=jw.Whisper.encode))(
        variables, jnp.asarray(mel))
    with torch.no_grad():
        xa_t = port.encode(torch.from_numpy(mel))
    np.testing.assert_allclose(xa_t.numpy(), np.asarray(xa_j), atol=1e-5)
    return model, variables, port, xa_j, xa_t


def _prompt(prompted: bool) -> list[int]:
    """The backend's prompts: the SOT sequence alone, or <|startofprev|>,
    previous-text tokens and the SOT sequence."""
    sot = jw.sot_sequence(0)
    if not prompted:
        return sot
    prev = np.random.default_rng(1).integers(0, 50000, 12).tolist()
    return [jw.SOT_PREV] + prev + sot


def test_decoder_full_pass_and_cached_steps_match_jax(pair):
    model, variables, port, xa_j, xa_t = pair
    tokens = np.random.default_rng(2).integers(0, 51865, (2, 10))
    xa2_j, xa2_t = jnp.concatenate([xa_j, xa_j * 0.5]), torch.cat([xa_t, xa_t * 0.5])
    full_j = np.asarray(jax.jit(lambda v, t, x: model.apply(v, t, x, method=jw.Whisper.logits))(
        variables, jnp.asarray(tokens, jnp.int32), xa2_j))
    with torch.no_grad():
        full_t = port.logits(torch.from_numpy(tokens), xa2_t).numpy()
    assert full_t.shape == (2, 10, 51865) and full_t.dtype == np.float32
    np.testing.assert_allclose(full_t, full_j, atol=LOGIT_ATOL)

    def dec(method, *args):
        return model.apply(variables, *args,
                           method=lambda m, *a: getattr(m.decoder, method)(*a))

    step = jax.jit(lambda *a: dec("step", *a))
    ck_j, cv_j = dec("cross_kv", xa2_j)
    kc_j, vc_j = dec("init_cache", 2, 10)
    with torch.no_grad():
        ck_t, cv_t = port.decoder.cross_kv(xa2_t)
        kc_t, vc_t = port.decoder.init_cache(2, 10)
        for i in range(10):
            step_j, kc_j, vc_j = step(jnp.asarray(tokens[:, i:i + 1], jnp.int32),
                                      jnp.asarray(i, jnp.int32), kc_j, vc_j, ck_j, cv_j)
            step_t = port.decoder.step(torch.from_numpy(tokens[:, i:i + 1]), i,
                                       kc_t, vc_t, ck_t, cv_t)
            np.testing.assert_allclose(step_t.numpy(), np.asarray(step_j), atol=LOGIT_ATOL)
            # the step's logits are the full pass's at its position
            np.testing.assert_allclose(step_t.numpy(), full_t[:, i], atol=LOGIT_ATOL)
    # the port keeps its keys scaled in the heads' layout [L, B, h, dh, ctx]
    keys = kc_t.permute(0, 1, 4, 2, 3).reshape(np.asarray(kc_j).shape) / (64 // 2) ** -0.25
    np.testing.assert_allclose(keys.numpy(), np.asarray(kc_j), atol=1e-5)
    np.testing.assert_allclose(vc_t.transpose(2, 3).reshape(np.asarray(vc_j).shape).numpy(),
                               np.asarray(vc_j), atol=1e-5)


def test_cross_attentions_match_jax(pair):
    model, variables, port, xa_j, xa_t = pair
    tokens = np.asarray([_prompt(True)])
    w_j = np.asarray(jax.jit(lambda v, t, x: model.apply(
        v, t, x, method=jw.Whisper.cross_attentions))(variables, jnp.asarray(tokens, jnp.int32),
                                                      xa_j))
    with torch.no_grad():
        w_t = port.cross_attentions(torch.from_numpy(tokens), xa_t).numpy()
    assert w_t.shape == (2, 1, 2, tokens.shape[1], 32)
    np.testing.assert_allclose(w_t, w_j, atol=LOGIT_ATOL)
    np.testing.assert_allclose(w_t.sum(-1), 1.0, atol=1e-5)


_JAX_DECODERS: dict = {}


def _decoders(kind: str, pair):
    """(JAX decoder, port decoder) of ``kind``, the JAX one jitted once."""
    model, variables, port, _, _ = pair
    if kind not in _JAX_DECODERS:
        _JAX_DECODERS[kind] = {
            "greedy": lambda: jw.make_greedy_decoder(model, variables, MAX_NEW),
            "cached": lambda: jw.make_cached_greedy_decoder(
                model, variables, MAX_NEW, return_scores=True),
            "beam3": lambda: jw.make_cached_beam_decoder(
                model, variables, beam_size=3, max_new_tokens=MAX_NEW, return_scores=True),
        }[kind]()
    ported = {
        "greedy": lambda: tw.make_greedy_decoder(port, MAX_NEW),
        "cached": lambda: tw.make_cached_greedy_decoder(port, MAX_NEW, return_scores=True),
        "beam3": lambda: tw.make_cached_beam_decoder(
            port, beam_size=3, max_new_tokens=MAX_NEW, return_scores=True),
    }[kind]()
    return _JAX_DECODERS[kind], ported


@pytest.mark.parametrize("prompted", [False, True], ids=["unprompted", "prompted"])
@pytest.mark.parametrize("kind", ["greedy", "cached", "beam3"])
def test_decoders_match_jax(pair, kind, prompted):
    _, _, _, xa_j, xa_t = pair
    decode_j, decode_t = _decoders(kind, pair)
    prompt = _prompt(prompted)
    plen = len(prompt)
    out_j = decode_j(xa_j, jnp.asarray([prompt], jnp.int32), plen)
    out_t = decode_t(xa_t, torch.tensor([prompt]), plen)
    if kind == "greedy":
        out_j, out_t = (out_j,), (out_t,)
    tokens_j, tokens_t = np.asarray(out_j[0]), out_t[0].numpy()
    assert tokens_t.shape == (1, plen + MAX_NEW)
    np.testing.assert_array_equal(tokens_t, tokens_j)
    assert (tokens_t[0, :plen] == prompt).all()
    if kind != "greedy":
        np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), atol=SCORE_ATOL)
        np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]), atol=SCORE_ATOL)
        assert decode_t.stats["steps"] <= plen + MAX_NEW - 1


def test_cached_greedy_equals_plain_rescoring(pair):
    _, _, port, _, xa_t = pair
    prompt = torch.tensor([_prompt(True)])
    plain = tw.make_greedy_decoder(port, MAX_NEW)(xa_t, prompt, prompt.shape[1])
    cached = tw.make_cached_greedy_decoder(port, MAX_NEW)(xa_t, prompt, prompt.shape[1])
    torch.testing.assert_close(cached, plain, rtol=0, atol=0)


def test_language_detector_matches_jax(pair):
    model, variables, port, xa_j, xa_t = pair
    xa2_j, xa2_t = jnp.concatenate([xa_j, -xa_j]), torch.cat([xa_t, -xa_t])
    idx_j, probs_j = jw.make_language_detector(model, variables)(xa2_j)
    idx_t, probs_t = tw.make_language_detector(port)(xa2_t)
    assert probs_t.shape == (2, 99)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), atol=SCORE_ATOL)
    np.testing.assert_allclose(probs_t.sum(-1).numpy(), 1.0, atol=1e-6)


def test_sampling_decoder_at_zero_is_greedy_and_matches_jax(pair):
    model, variables, port, xa_j, xa_t = pair
    prompt = _prompt(True)
    plen = len(prompt)
    sample_t = tw.make_cached_sampling_decoder(port, best_of=3, max_new_tokens=MAX_NEW)
    sample_j = jw.make_cached_sampling_decoder(model, variables, best_of=3,
                                               max_new_tokens=MAX_NEW)
    toks, avg, ns = sample_t(xa_t, torch.tensor([prompt]), plen, 0.0, 7)
    toks_j, avg_j, ns_j = sample_j(xa_j, jnp.asarray([prompt], jnp.int32), plen, 0.0, 7)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(toks_j))
    np.testing.assert_allclose(avg.numpy(), np.asarray(avg_j), atol=SCORE_ATOL)
    np.testing.assert_allclose(ns.numpy(), np.asarray(ns_j), atol=SCORE_ATOL)
    g_toks, g_avg, g_ns = tw.make_cached_greedy_decoder(
        port, MAX_NEW, return_scores=True)(xa_t, torch.tensor([prompt]), plen)
    for row in range(3):   # batch 3 against batch 1: sums in another order
        torch.testing.assert_close(toks[row], g_toks[0], rtol=0, atol=0)
        torch.testing.assert_close(avg[row], g_avg[0], rtol=0, atol=SCORE_ATOL)
        torch.testing.assert_close(ns[row], g_ns[0], rtol=0, atol=SCORE_ATOL)


def test_sampling_decoder_above_zero_is_seeded_and_well_formed(pair):
    _, _, port, _, xa_t = pair
    prompt = _prompt(False)
    plen = len(prompt)
    sample = tw.make_cached_sampling_decoder(port, best_of=5, max_new_tokens=MAX_NEW)
    a = sample(xa_t, torch.tensor([prompt]), plen, 1.0, 3)
    b = sample(xa_t, torch.tensor([prompt]), plen, 1.0, 3)
    c = sample(xa_t, torch.tensor([prompt]), plen, 1.0, 4)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0])
    toks, avg, ns = (t.numpy() for t in a)
    assert toks.shape == (5, plen + MAX_NEW)
    assert len({tuple(r) for r in toks}) > 1          # the candidates differ
    for row, score, probe in zip(toks, avg, ns):
        assert (row[:plen] == prompt).all()
        assert ((row >= 0) & (row < 51865)).all()
        gen = row[plen:]
        eot = np.flatnonzero(gen == tw.EOT)
        if eot.size:
            assert (gen[eot[0]:] == tw.EOT).all()
        assert np.isfinite(score) and score <= 0.0
        assert 0.0 <= probe <= 1.0


def test_suppressed_tokens_never_decoded(pair):
    _, _, port, _, xa_t = pair
    prompt = torch.tensor([_prompt(False)])
    free = tw.make_cached_beam_decoder(port, beam_size=3, max_new_tokens=8)(xa_t, prompt, 4)
    banned = tuple(sorted(set(free[0, 4:].tolist()) - {tw.EOT}))
    held = tw.make_cached_beam_decoder(port, beam_size=3, max_new_tokens=8,
                                       suppress_tokens=banned)(xa_t, prompt, 4)
    assert banned and not set(held[0, 4:].tolist()) & set(banned)


def test_openai_checkpoint_loads_strict_and_jax_reads_it_to_the_same_tokens(pair, tmp_path):
    from mere_fusion_tpu.asr.backends import JaxWhisperBackend
    from mere_fusion_tpu_torch.asr.backends import TorchWhisperBackend

    _, _, port, _, _ = pair
    path = str(tmp_path / "tiny-narrow.pt")
    torch.save({"dims": dataclasses.asdict(TDIMS), "model_state_dict": port.state_dict()},
               path)
    loaded = load_whisper_checkpoint(path)
    assert loaded.dims == TDIMS
    for k, v in port.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)
    audio = (0.2 * np.sin(np.linspace(0, 900, 10240))).astype(np.float32)
    kw = dict(tokenizer=None, beam_size=3, temperatures=(0.0,))
    res_j = JaxWhisperBackend.from_checkpoint(path, **kw).transcribe(audio)
    res_t = TorchWhisperBackend.from_checkpoint(path, device="cpu", **kw).transcribe(audio)
    assert res_t["tokens"] == res_j["tokens"] and len(res_t["tokens"]) > 0
    assert res_t["avg_logprob"] == pytest.approx(res_j["avg_logprob"], abs=SCORE_ATOL)
