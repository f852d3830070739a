"""Whisper in PyTorch (OpenAI whisper key names): the encoder, the text
decoder and their eager decode loops.

Port of mere_fusion_tpu/models/whisper.py. Module and parameter names follow
OpenAI's whisper state dict (``encoder.conv1``, ``encoder.blocks.{i}.attn.query``,
``decoder.token_embedding``, ``decoder.positional_embedding``,
``decoder.blocks.{i}.cross_attn``, ``decoder.blocks.{i}.mlp.0``,
``decoder.ln``), so a whisper ``.pt``'s ``model_state_dict`` loads into
``Whisper`` with ``load_state_dict(strict=True)`` and its ``encoder.*``
entries into ``AudioEncoder``. Properties carried over exactly:

- the encoder can return per-layer embeddings (pre-block input + each block
  output, stacked) — MuseTalk conditions on these;
- attention scales q and k by (d/h)^-0.25 each and softmaxes in float32;
  ``key`` has no bias;
- the logits are the final hidden state against the tied token embedding.
  The product runs in float64 against a float64 copy of the embedding, so no
  TF32 setting of the process reaches it and the result is at least true
  float32 (the JAX twin asks for Precision.HIGHEST; ops/mel.py does the same).

The decoders are eager loops over a static ``[B, P + max_new]`` token
buffer with KV caches written in place: one incremental decoder step a
token, the loop counter on the host, one readback a generated step for the
stop test. In-prompt steps run the blocks only (they keep the prompt's
token) and the logits product only where the no-speech probe reads it.
Ties break as in JAX: ``argmax`` takes the first maximum, and the beam's
top-k and sorts take the lower index among equal values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class WhisperDims:
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4


TINY = WhisperDims()
TINY_EN = WhisperDims(n_vocab=51864)
# published OpenAI checkpoint dims; WhisperDims(**ckpt["dims"]) loads any of
# these from a .pt, the presets are for weightless construction and tests
BASE = WhisperDims(n_audio_state=512, n_audio_head=8, n_audio_layer=6,
                   n_text_state=512, n_text_head=8, n_text_layer=6)
SMALL = WhisperDims(n_audio_state=768, n_audio_head=12, n_audio_layer=12,
                    n_text_state=768, n_text_head=12, n_text_layer=12)
MEDIUM = WhisperDims(n_audio_state=1024, n_audio_head=16, n_audio_layer=24,
                     n_text_state=1024, n_text_head=16, n_text_layer=24)
LARGE_V2 = WhisperDims(n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                       n_text_state=1280, n_text_head=20, n_text_layer=32)
LARGE_V3 = WhisperDims(n_mels=128, n_vocab=51866,
                       n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                       n_text_state=1280, n_text_head=20, n_text_layer=32)
SIZE_DIMS = {"tiny": TINY, "tiny.en": TINY_EN, "base": BASE, "small": SMALL,
             "medium": MEDIUM, "large-v2": LARGE_V2, "large-v3": LARGE_V3}


def sinusoids(length: int, channels: int, max_timescale: float = 10000) -> np.ndarray:
    """Sinusoidal position embedding [length, channels] (float32)."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x: torch.Tensor, xa: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        src = x if xa is None else xa
        wv, _ = self._attend(self.query(x), self.key(src), self.value(src), mask)
        return self.out(wv)

    def attention_weights(self, x: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
        """Cross-attention probabilities [B, h, Lq, Lk] (the DTW word
        aligner's input)."""
        return self._attend(self.query(x), self.key(xa), self.value(xa), None)[1]

    def _scale(self) -> float:
        return (self.query.out_features // self.n_head) ** -0.25

    def _heads_k(self, k: torch.Tensor) -> torch.Tensor:
        """Keys [B, L, D] → scaled, as the products read them: [B, h, dh, L]."""
        b, lk, _ = k.shape
        return (k * self._scale()).reshape(b, lk, self.n_head, -1).permute(0, 2, 3, 1)

    def _heads_v(self, v: torch.Tensor) -> torch.Tensor:
        b, lk, _ = v.shape
        return v.reshape(b, lk, self.n_head, -1).transpose(1, 2)

    def cross_kv(self, xa: torch.Tensor):
        """The cross-attention keys and values of the encoded audio, made
        once a decode in the layout the steps read: keys scaled by
        (d/h)^-0.25 as [B, h, dh, T'], values as [B, h, T', dh]."""
        return (self._heads_k(self.key(xa)).contiguous(),
                self._heads_v(self.value(xa)).contiguous())

    def step_self(self, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  pos: int) -> torch.Tensor:
        """Incremental self-attention of x [B, 1, D] at position ``pos``:
        its key (scaled, into k_cache [B, h, dh, ctx]) and value (into
        v_cache [B, h, ctx, dh]) are written in place, and it attends over
        positions 0..pos."""
        k_cache[..., pos] = self._heads_k(self.key(x))[..., 0]
        v_cache[:, :, pos] = self._heads_v(self.value(x))[:, :, 0]
        return self.out(self._attend_heads(self.query(x), k_cache[..., :pos + 1],
                                           v_cache[:, :, :pos + 1]))

    def step_cross(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Cross-attention of x [B, 1, D] over ``cross_kv``'s keys and
        values; a key set serves B / Bk consecutive rows of x (the beams and
        the sampled candidates of one window share its audio)."""
        return self.out(self._attend_heads(self.query(x), k, v))

    def _attend_heads(self, q, k, v):
        """softmax(q k) v for q [B, Lq, D] against keys [Bk, h, dh, Lk] and
        values [Bk, h, Lk, dh] in the heads' layout. With Bk < B, key set j
        serves rows j·r … j·r + r − 1 (r = B / Bk) with one read of its k
        and v."""
        b, lq, d = q.shape
        bk, h = k.shape[0], self.n_head
        q = (q * self._scale()).reshape(b, lq, h, -1)
        if bk < b:     # shared keys: a key set's rows ride the query axis
            r = b // bk
            q = q.reshape(bk, r, lq, h, -1).permute(0, 3, 1, 2, 4).reshape(bk, h, r * lq, -1)
            w = torch.softmax((q @ k).float(), dim=-1).to(v.dtype)
            return (w @ v).reshape(bk, h, r, lq, -1).permute(0, 2, 3, 1, 4).reshape(b, lq, d)
        w = torch.softmax((q.transpose(1, 2) @ k).float(), dim=-1).to(v.dtype)
        return (w @ v).transpose(1, 2).reshape(b, lq, d)

    def _attend(self, q, k, v, mask):
        b, lq, d = q.shape
        lk = k.shape[1]
        h = self.n_head
        scale = (d // h) ** -0.25
        q = (q * scale).reshape(b, lq, h, -1).transpose(1, 2)
        k = (k * scale).reshape(b, lk, h, -1).permute(0, 2, 3, 1)
        v = v.reshape(b, lk, h, -1).transpose(1, 2)
        qk = q @ k
        if mask is not None:
            qk = qk + mask[:lq, :lk]
        w = torch.softmax(qk.float(), dim=-1).to(v.dtype)
        return (w @ v).transpose(1, 2).reshape(b, lq, d), w


class ResidualAttentionBlock(nn.Module):
    """Self-attention (+ cross-attention in the decoder) + MLP."""

    def __init__(self, n_state: int, n_head: int, cross_attention: bool = False):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state, eps=1e-5)
        if cross_attention:
            self.cross_attn = MultiHeadAttention(n_state, n_head)
            self.cross_attn_ln = nn.LayerNorm(n_state, eps=1e-5)
        else:
            self.cross_attn = self.cross_attn_ln = None
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state),
                                 nn.GELU(approximate="none"),
                                 nn.Linear(4 * n_state, n_state))
        self.mlp_ln = nn.LayerNorm(n_state, eps=1e-5)

    def forward(self, x: torch.Tensor, xa: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.attn_ln(x), mask=mask)
        if self.cross_attn is not None:
            x = x + self.cross_attn(self.cross_attn_ln(x), xa=xa)
        return x + self.mlp(self.mlp_ln(x))

    def step(self, x, k_cache, v_cache, pos: int, cross_k, cross_v) -> torch.Tensor:
        x = x + self.attn.step_self(self.attn_ln(x), k_cache, v_cache, pos)
        if self.cross_attn is not None:
            x = x + self.cross_attn.step_cross(self.cross_attn_ln(x), cross_k, cross_v)
        return x + self.mlp(self.mlp_ln(x))


class AudioEncoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims
        self.dims = dims
        self.conv1 = nn.Conv1d(d.n_mels, d.n_audio_state, 3, padding=1)
        self.conv2 = nn.Conv1d(d.n_audio_state, d.n_audio_state, 3, stride=2, padding=1)
        self.register_buffer(
            "positional_embedding",
            torch.from_numpy(sinusoids(d.n_audio_ctx, d.n_audio_state)))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d.n_audio_state, d.n_audio_head)
            for _ in range(d.n_audio_layer))
        self.ln_post = nn.LayerNorm(d.n_audio_state, eps=1e-5)

    def forward(self, mel: torch.Tensor, include_embeddings: bool = False):
        """mel [B, n_mels, T] with T = 2·n_audio_ctx. Returns the encoded
        audio [B, T/2, D] and, with include_embeddings, the per-layer
        embeddings [B, L+1, T/2, D]."""
        x = F.gelu(self.conv1(mel))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.positional_embedding.to(x.dtype)
        embeddings = [x]
        for block in self.blocks:
            x = block(x)
            embeddings.append(x)
        out = self.ln_post(x)
        if include_embeddings:
            return out, torch.stack(embeddings, dim=1)
        return out


class TextDecoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims
        self.dims = dims
        self.token_embedding = nn.Embedding(d.n_vocab, d.n_text_state)
        self.positional_embedding = nn.Parameter(torch.zeros(d.n_text_ctx, d.n_text_state))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d.n_text_state, d.n_text_head, cross_attention=True)
            for _ in range(d.n_text_layer))
        self.ln = nn.LayerNorm(d.n_text_state, eps=1e-5)
        self.register_buffer(
            "mask", torch.full((d.n_text_ctx, d.n_text_ctx), -np.inf).triu_(1),
            persistent=False)
        self._emb64 = None
        self._emb64_key = None

    def _embedding_f64(self) -> torch.Tensor:
        """The tied embedding in float64, made again when the weight was
        replaced or written (load_state_dict, .to())."""
        w = self.token_embedding.weight
        key = (w.data_ptr(), w.device, w._version)
        if self._emb64_key != key:
            self._emb64 = w.detach().double()
            self._emb64_key = key
        return self._emb64

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """Logits (float32) of hidden states [..., D] against the tied
        embedding, the product in float64."""
        return (x.double() @ self._embedding_f64().T).float()

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.token_embedding(tokens) + self.positional_embedding[:tokens.shape[-1]]

    def forward(self, tokens: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
        """tokens [B, L] int; xa the encoded audio [B, T', D]. Returns the
        logits [B, L, n_vocab] (float32)."""
        x = self._embed(tokens)
        for block in self.blocks:
            x = block(x, xa=xa, mask=self.mask)
        return self.project(self.ln(x))

    def cross_attentions(self, tokens: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
        """Cross-attention weights for a fixed token sequence:
        [n_layers, B, h, L, T'] from one full causal pass (the DTW word
        aligner's input)."""
        x = self._embed(tokens)
        weights = []
        for block in self.blocks:
            h = x + block.attn(block.attn_ln(x), mask=self.mask)
            weights.append(block.cross_attn.attention_weights(block.cross_attn_ln(h), xa))
            x = block(x, xa=xa, mask=self.mask)
        return torch.stack(weights)

    def init_cache(self, batch: int, max_len: int):
        """Zeroed self-attention caches in the heads' layout: scaled keys
        [n_layers, B, h, dh, max_len] and values [n_layers, B, h, max_len, dh]."""
        d = self.dims
        w = self.token_embedding.weight
        dh = d.n_text_state // d.n_text_head
        kw = dict(dtype=w.dtype, device=w.device)
        return (torch.zeros((d.n_text_layer, batch, d.n_text_head, dh, max_len), **kw),
                torch.zeros((d.n_text_layer, batch, d.n_text_head, max_len, dh), **kw))

    def cross_kv(self, xa: torch.Tensor):
        """Per-layer cross-attention keys and values of the encoded audio in
        the steps' layout (``MultiHeadAttention.cross_kv``), stacked:
        [n_layers, B, h, dh, T'] and [n_layers, B, h, T', dh]."""
        ks, vs = zip(*(blk.cross_attn.cross_kv(xa) for blk in self.blocks))
        return torch.stack(ks), torch.stack(vs)

    def step(self, token: torch.Tensor, pos: int, k_cache, v_cache, cross_k, cross_v,
             logits: bool = True) -> Optional[torch.Tensor]:
        """One incremental decode step: token [B, 1] at position ``pos``,
        the ``init_cache`` caches written in place at ``pos``, the
        ``cross_kv`` keys and values (a batch of Bk serves B / Bk
        consecutive rows each).
        Returns the logits [B, n_vocab], or None with logits=False (the
        blocks only)."""
        x = self.token_embedding(token) + self.positional_embedding[pos]
        for i, blk in enumerate(self.blocks):
            x = blk.step(x, k_cache[i], v_cache[i], pos, cross_k[i], cross_v[i])
        if not logits:
            return None
        return self.project(self.ln(x)[:, 0])


class Whisper(nn.Module):
    def __init__(self, dims: WhisperDims = TINY):
        super().__init__()
        self.dims = dims
        self.encoder = AudioEncoder(dims)
        self.decoder = TextDecoder(dims)

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return self.decoder(tokens, self.encoder(mel))

    def encode(self, mel: torch.Tensor, include_embeddings: bool = False):
        return self.encoder(mel, include_embeddings)

    def logits(self, tokens: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
        return self.decoder(tokens, xa)

    def cross_attentions(self, tokens: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
        return self.decoder.cross_attentions(tokens, xa)


def init_whisper(dims: WhisperDims = TINY, seed: int = 0, device=None) -> Whisper:
    """A Whisper with seeded random weights (``device.random_init_`` on the
    CPU, so every device gets the same weights), in eval mode on ``device``
    (the CPU when None)."""
    from mere_fusion_tpu_torch.device import random_init_

    model = random_init_(Whisper(dims), seed).eval()
    return model if device is None else model.to(device)


# ---- special tokens (multilingual vocab; tokenizer-independent) -------------
SOT = 50258           # <|startoftranscript|>
EOT = 50257           # <|endoftext|>
SOT_PREV = 50361      # <|startofprev|>: prefixes the previous-text prompt
TRANSCRIBE = 50359
TRANSLATE = 50358
NO_TIMESTAMPS = 50363
TIMESTAMP_BEGIN = 50364  # <|0.00|>; id t ↔ (t − TIMESTAMP_BEGIN)·0.02 s
NO_SPEECH = 50362
LANG_BASE = 50259     # <|en|> = 50259; language id = LANG_BASE + lang_index

# Whisper language codes in token-id order (<|en|>=50259 first), openai-whisper
# tokenizer.py LANGUAGES; large-v3 (n_vocab 51866) appends "yue" as the 100th.
LANGUAGE_CODES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)


def n_language_tokens(n_vocab: int) -> int:
    """99 language tokens for the classic multilingual vocab, 100 (adds yue)
    for large-v3's 51866-token vocab."""
    return 100 if n_vocab >= 51866 else 99


def language_index(code: str, n_vocab: int = 51865) -> int:
    idx = LANGUAGE_CODES.index(code)
    if idx >= n_language_tokens(n_vocab):
        raise ValueError(f"language {code!r} not in this model's vocab")
    return idx


def sot_sequence(language_index: int = 0, task: int = TRANSCRIBE) -> list[int]:
    return [SOT, LANG_BASE + language_index, task, NO_TIMESTAMPS]


def non_speech_token_ids(tokenizer) -> tuple:
    """Token ids to suppress during transcription (the published whisper
    rule: symbols and bracket/music tokens never start speech), derived from
    the tokenizer so that it works for any vocab."""
    symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + [
        "<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", '("', "((",
        "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪",
    ]
    ids = {SOT, SOT_PREV, NO_SPEECH}
    for sym in symbols + [" " + s for s in symbols]:
        try:
            toks = tokenizer.encode(sym)
        except KeyError:
            continue
        if len(toks) == 1:
            ids.add(toks[0])
    return tuple(sorted(ids))


# ---- decoders -----------------------------------------------------------------
def _topk_low_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row of a float32 tensor [..., N],
    descending, equal values by the lower index first (lax.top_k's order;
    torch.topk promises no order among ties). Each entry gets a distinct
    int64 key: its float's order-preserving bits above its reversed index."""
    bits = (x + 0.0).view(torch.int32)          # + 0.0: -0.0 sorts as 0.0
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    idx = torch.arange(x.shape[-1], device=x.device)
    top = torch.topk((key << 32) + (0x7FFFFFFF - idx), k).values
    pos = 0x7FFFFFFF - (top & 0xFFFFFFFF)
    return x.gather(-1, pos), pos


def _suppress_index(suppress_tokens, device) -> Optional[torch.Tensor]:
    if not suppress_tokens:
        return None
    return torch.as_tensor(list(suppress_tokens), dtype=torch.long, device=device)


def _decode_inputs(model: Whisper, xa, prompt):
    """xa and the prompt on the model's device, and that device."""
    dev = next(model.parameters()).device
    return xa.to(dev), torch.as_tensor(prompt, dtype=torch.long).to(dev), dev


def _scalar(value: float, dev) -> torch.Tensor:
    """A 0-dim float32 tensor: a division by it is a true division on every
    device (CUDA divides by a Python scalar as a product with its reciprocal)."""
    return torch.full((), value, dtype=torch.float32, device=dev)


def make_greedy_decoder(model: Whisper, max_new_tokens: int = 128,
                        suppress_tokens: Optional[tuple] = None):
    """The plain yardstick: decode(xa, prompt, prompt_len) → tokens
    [B, P+max_new], re-scoring the full causal sequence each step. prompt is
    a [B, P] buffer whose positions ≥ prompt_len are padding."""

    @torch.no_grad()
    def decode(xa, prompt, prompt_len: int):
        xa, prompt, dev = _decode_inputs(model, xa, prompt)
        sup = _suppress_index(suppress_tokens, dev)
        b, p = prompt.shape
        total = p + max_new_tokens
        # pad with 0: the causal mask makes the value irrelevant
        tokens = torch.cat([prompt, torch.zeros((b, max_new_tokens), dtype=torch.long,
                                                device=dev)], 1)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        i = prompt_len
        while i < total and not bool(done.all()):
            prev = model.logits(tokens, xa)[:, i - 1]
            if sup is not None:
                prev[:, sup] = -torch.inf
            nxt = prev.argmax(-1)
            newly_done = done | (nxt == EOT)
            tokens[:, i] = torch.where(done, EOT, nxt)
            done = newly_done
            i += 1
        return tokens

    return decode


def _scored_loop(model: Whisper, xa, prompt, prompt_len: int, max_new_tokens: int,
                 sup, pick, stats: dict):
    """The cached greedy/sampling loop over B rows of one buffer: xa is
    one window for all rows, or one window a row. ``pick`` maps a step's
    (suppressed) logits and its index to the next tokens. A row stops at
    its EOT; the loop, when every row has. Returns (tokens, avg_logprob,
    no_speech_prob)."""
    dec = model.decoder
    b, p = prompt.shape
    total = p + max_new_tokens
    dev = xa.device
    cross_k, cross_v = dec.cross_kv(xa)     # a batch-1 xa serves all b rows
    k_cache, v_cache = dec.init_cache(b, total)
    tokens = torch.cat([prompt, torch.full((b, max_new_tokens), EOT, dtype=torch.long,
                                           device=dev)], 1)
    sot_step = prompt_len - 4        # sot_sequence is the prompt's 4-token tail
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    sum_lp = torch.zeros(b, dtype=torch.float32, device=dev)
    n_gen = torch.zeros(b, dtype=torch.int32, device=dev)
    ns = torch.zeros(b, dtype=torch.float32, device=dev)
    i = 0
    while i < total - 1:
        if i >= prompt_len and bool(done.all()):    # the step's one readback
            break
        in_prompt = i + 1 < prompt_len
        logits = dec.step(tokens[:, i:i + 1], i, k_cache, v_cache, cross_k, cross_v,
                          logits=not in_prompt or i == sot_step)
        if i == sot_step:
            ns = torch.softmax(logits, -1)[:, NO_SPEECH]
        if not in_prompt:            # in the prompt the prompt's token is kept
            if sup is not None:
                logits[:, sup] = -torch.inf
            nxt = pick(logits, i)
            tok_lp = torch.log_softmax(logits, -1).gather(1, nxt[:, None])[:, 0]
            gen_now = ~done
            sum_lp = sum_lp + torch.where(gen_now, tok_lp, 0.0)
            n_gen = n_gen + (gen_now & (nxt != EOT)).int()
            nxt = torch.where(done, EOT, nxt)
            done = done | (nxt == EOT)
            tokens[:, i + 1] = nxt
        i += 1
    stats["steps"] = i
    return tokens, sum_lp / (n_gen + 1).float(), ns


def make_cached_greedy_decoder(model: Whisper, max_new_tokens: int = 128,
                               suppress_tokens: Optional[tuple] = None,
                               return_scores: bool = False):
    """KV-cached greedy decode: one incremental decoder step a token.

    Returns decode(xa [1 or B, T', D], prompt [B, P], prompt_len) → tokens
    [B, P+max_new], a window for all B rows or one a row; with
    return_scores → (tokens, avg_logprob [B], no_speech_prob [B]), where
    avg_logprob = Σ logprob(chosen) / (n_generated + 1), the EOT step
    included, and no_speech_prob is the <|nospeech|> probability at the
    <|startoftranscript|> step. ``decode.stats["steps"]`` is the last call's
    step count."""
    stats: dict = {}

    @torch.no_grad()
    def decode(xa, prompt, prompt_len: int):
        xa, prompt, dev = _decode_inputs(model, xa, prompt)
        tokens, avg, ns = _scored_loop(
            model, xa, prompt, prompt_len, max_new_tokens,
            _suppress_index(suppress_tokens, dev), lambda logits, i: logits.argmax(-1), stats)
        return (tokens, avg, ns) if return_scores else tokens

    decode.stats = stats
    return decode


def make_cached_sampling_decoder(model: Whisper, best_of: int = 5,
                                 max_new_tokens: int = 128,
                                 suppress_tokens: Optional[tuple] = None):
    """KV-cached temperature sampling with ``best_of`` candidates on the
    batch axis: the t > 0 rungs of the decode-fallback ladder.

    Sampling is the Gumbel-argmax identity, argmax(logits / T + g), with g
    drawn from a torch.Generator seeded with ``seed`` on the model's device
    (JAX's PRNG stream is not reproduced); at T = 0 no noise is drawn and the
    pick is argmax(logits / 1e-6), JAX's own. Log-probabilities use the
    unscaled distribution.

    Returns decode(xa [1, T', D], prompt [1, P], prompt_len, temperature,
    seed) → (tokens [best_of, P+max_new], avg_logprob [best_of],
    no_speech_prob [best_of])."""
    n = best_of
    stats: dict = {}

    @torch.no_grad()
    def decode(xa, prompt, prompt_len: int, temperature: float, seed: int):
        xa, prompt, dev = _decode_inputs(model, xa, prompt)
        t = _scalar(max(float(temperature), 1e-6), dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        tiny = torch.finfo(torch.float32).tiny

        def pick(logits, i):
            scaled = logits / t
            if temperature > 0:
                u = torch.rand(logits.shape, generator=gen, device=dev).clamp_(min=tiny)
                scaled = scaled - torch.log(-torch.log(u))
            return scaled.argmax(-1)

        return _scored_loop(model, xa, prompt.expand(n, -1), prompt_len, max_new_tokens,
                            _suppress_index(suppress_tokens, dev), pick, stats)

    decode.stats = stats
    return decode


def make_language_detector(model: Whisper):
    """Language identification: one decoder pass over [<|sot|>], softmax
    over the language tokens. Returns detect(xa [B, T', D]) →
    (lang_index [B], probs [B, n_langs])."""
    nl = n_language_tokens(model.dims.n_vocab)

    @torch.no_grad()
    def detect(xa):
        xa, sot, _ = _decode_inputs(model, xa, [[SOT]] * xa.shape[0])
        lang_logits = model.logits(sot, xa)[:, 0, LANG_BASE:LANG_BASE + nl]
        return lang_logits.argmax(-1), torch.softmax(lang_logits, -1)

    return detect


def make_cached_beam_decoder(model: Whisper, beam_size: int = 5,
                             max_new_tokens: int = 128,
                             suppress_tokens: Optional[tuple] = None,
                             return_scores: bool = False):
    """KV-cached beam search (whisper's BeamSearchDecoder, patience 1.0, with
    the maximum-likelihood ranker) over a batch of windows: B independent
    searches of ``beam_size`` beams on B·n rows, rows b·n … b·n + n − 1
    reading window b's cross-attention keys. Each window takes a top-2n
    expansion a step over its own n × vocab log-probs and keeps finished
    hypotheses in its own n-slot pool ranked by average log-prob over the
    generated region; the best live beam when none finished. A window whose
    pool is full leaves the batch (its rows, caches and keys are dropped),
    so that its tokens and scores stop changing: each window's result is
    the batch-1 search's on that window alone, as JAX's vmap over the
    batch-1 loop gives. The loop ends when every window has left, or at the
    buffer's end.

    Returns decode(xa [B, T', D], prompt [B or 1, P], prompt_len) → tokens
    [B, P+max_new]; with return_scores → (tokens, avg_logprob [B],
    no_speech_prob [B]). ``decode.stats["steps"]`` is the last call's step
    count."""
    n = beam_size
    stats: dict = {}

    @torch.no_grad()
    def decode(xa, prompt, prompt_len: int):
        xa, prompt, dev = _decode_inputs(model, xa, prompt)
        sup = _suppress_index(suppress_tokens, dev)
        dec = model.decoder
        nw = xa.shape[0]
        total = prompt.shape[1] + max_new_tokens
        cross_k, cross_v = dec.cross_kv(xa)      # a window's keys, read once for its beams
        k_cache, v_cache = dec.init_cache(nw * n, total)
        tokens = torch.cat([prompt.expand(nw, -1),
                            torch.full((nw, max_new_tokens), EOT, dtype=torch.long,
                                       device=dev)], 1).repeat_interleave(n, 0)
        # identical beams: only beam 0 of a window is alive at the first expansion
        sum_lp = torch.full((nw, n), -1e9, dtype=torch.float32, device=dev)
        sum_lp[:, 0] = 0.0
        fin_tokens = torch.full((nw, n, total), EOT, dtype=torch.long, device=dev)
        fin_scores = torch.full((nw, n), -torch.inf, dtype=torch.float32, device=dev)
        fin_count = torch.zeros(nw, dtype=torch.long, device=dev)
        ns = torch.zeros(nw, dtype=torch.float32, device=dev)
        out_tokens = torch.full((nw, total), EOT, dtype=torch.long, device=dev)
        out_avg = torch.zeros(nw, dtype=torch.float32, device=dev)
        live = torch.arange(nw, device=dev)      # the windows still searching
        sot_step = prompt_len - 4

        def settle(windows, mask):
            """The pool's best for the windows ``mask`` picks."""
            best = fin_scores[mask].argmax(1)
            out_tokens[windows] = fin_tokens[mask][torch.arange(best.numel(), device=dev),
                                                   best]
            out_avg[windows] = fin_scores[mask].amax(1)

        i = 0
        while i < total - 1:
            in_prompt = i + 1 < prompt_len
            logits = dec.step(tokens[:, i:i + 1], i, k_cache, v_cache, cross_k, cross_v,
                              logits=not in_prompt or i == sot_step)
            if i == sot_step:                    # every window is still live here
                ns = torch.softmax(logits[::n], -1)[:, NO_SPEECH]
            if in_prompt:    # tokens, scores, pools and caches stay as they are
                i += 1
                continue
            if sup is not None:
                logits[:, sup] = -torch.inf
            lp = torch.log_softmax(logits, -1)
            a, v = live.numel(), lp.shape[-1]
            top_lp, top_idx = _topk_low_index(
                (sum_lp[:, :, None] + lp.view(a, n, v)).view(a, n * v), 2 * n)
            src = top_idx // v + n * torch.arange(a, device=dev)[:, None]   # [a, 2n] rows
            tok_id = top_idx % v
            is_eot = tok_id == EOT
            # finished candidates → the pool, ranked by avg logprob over the
            # generated region (no length penalty)
            gen_len = _scalar(max(i + 1 - prompt_len, 1), dev)
            cand_avg = torch.where(is_eot, top_lp / gen_len, -torch.inf)
            cand_tokens = tokens[src]                                       # [a, 2n, total]
            cand_tokens[:, :, i + 1] = EOT
            all_scores = torch.cat([fin_scores, cand_avg], 1)
            keep = torch.sort(all_scores, dim=1, descending=True, stable=True).indices[:, :n]
            fin_scores = all_scores.gather(1, keep)
            fin_tokens = torch.cat([fin_tokens, cand_tokens], 1).gather(
                1, keep[:, :, None].expand(-1, -1, total))
            fin_count = torch.clamp(fin_count + is_eot.sum(1), max=n)
            # continue with the best n unfinished candidates of each window
            order = torch.sort(torch.where(is_eot, torch.inf, -top_lp), dim=1,
                               stable=True).indices[:, :n]
            src_l = src.gather(1, order).view(-1)
            tokens = tokens[src_l]
            tokens[:, i + 1] = tok_id.gather(1, order).view(-1)
            sum_lp = top_lp.gather(1, order)
            k_cache[..., :i + 1] = k_cache[:, src_l, ..., :i + 1]
            v_cache[:, :, :, :i + 1] = v_cache[:, src_l, :, :i + 1]
            i += 1
            going = fin_count < n
            going_host = going.tolist()           # the step's one readback
            if all(going_host):
                continue
            settle(live[~going], ~going)          # full pools: those windows leave
            rows = going.repeat_interleave(n)
            live, fin_scores, fin_tokens = live[going], fin_scores[going], fin_tokens[going]
            fin_count, sum_lp, tokens = fin_count[going], sum_lp[going], tokens[rows]
            k_cache, v_cache = k_cache[:, rows], v_cache[:, rows]
            cross_k, cross_v = cross_k[:, going], cross_v[:, going]
            if not any(going_host):
                break
        stats["steps"] = i
        if live.numel():
            # the buffer's end: the pool's best, or the best live beam when
            # nothing finished
            has = fin_count > 0
            has_host = has.tolist()
            if any(has_host):
                settle(live[has], has)
            if not all(has_host):
                none = ~has
                best = sum_lp[none].argmax(1)
                rows = n * torch.arange(live.numel(), device=dev)[none] + best
                out_tokens[live[none]] = tokens[rows]
                out_avg[live[none]] = (sum_lp[none].amax(1)
                                       / _scalar(max(i - prompt_len, 1), dev))
        if return_scores:
            return out_tokens, out_avg, ns
        return out_tokens

    decode.stats = stats
    return decode
