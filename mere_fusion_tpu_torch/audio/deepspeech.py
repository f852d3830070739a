"""DeepSpeech audio features for ER-NeRF (29-dim logits at 50 Hz).

Port of mere_fusion_tpu/audio/deepspeech.py, the twin of the reference's
TensorFlow-v1 pipeline (ernerf/data_utils/deepspeech_features/
deepspeech_features.py:16-275):
  1. resample to 16 kHz int16;
  2. python_speech_features-exact MFCC (26 cepstra, 25 ms / 10 ms frames,
     rectangular window, NFFT 512, lifter 22, log-energy c0), strided ::2
     down to 50 Hz;
  3. ±9-frame context windows flattened to 494-d, global mean/std norm;
  4. the DeepSpeech v0.1.0 acoustic net (3 clipped-ReLU dense, BiLSTM 2048,
     clipped-ReLU dense, 29-way logits) in PyTorch: the BiLSTM as an eager
     loop of TF ``BasicLSTMCell`` steps;
  5. linear interpolation 50 Hz → video fps and 16-frame windows.

Steps 1–3 and 5 are host numpy/scipy code. The frozen-graph weights load
without TensorFlow: ``read_graph_constants`` parses the GraphDef protobuf
wire format and ``params_from_graph`` maps its Const tensors onto the
parameter names.
"""
from __future__ import annotations

import math
import struct
from typing import Callable, Optional

import numpy as np
import torch

from mere_fusion_tpu_torch.device import parse_dtype, resolve_device

# ---------------------------------------------------------------------------
# python_speech_features-exact MFCC (psf 0.6 defaults as the reference calls
# it: numcep=26, nfilt=26, nfft=512, no window function)
# ---------------------------------------------------------------------------


def _round_half_up(number: float) -> int:
    import decimal

    return int(decimal.Decimal(number).quantize(
        decimal.Decimal("1"), rounding=decimal.ROUND_HALF_UP))


def _hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def _mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


def _filterbanks(nfilt: int, nfft: int, samplerate: int,
                 lowfreq: float = 0.0, highfreq: Optional[float] = None):
    highfreq = highfreq or samplerate / 2
    melpoints = np.linspace(_hz2mel(lowfreq), _hz2mel(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * _mel2hz(melpoints) / samplerate).astype(int)
    fbank = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fbank


def mfcc_psf(signal: np.ndarray, samplerate: int = 16000,
             winlen: float = 0.025, winstep: float = 0.01, numcep: int = 26,
             nfilt: int = 26, nfft: int = 512, preemph: float = 0.97,
             ceplifter: int = 22) -> np.ndarray:
    """MFCC matching python_speech_features.mfcc with the reference's
    arguments (deepspeech_features.py:206-209): rectangular window, power
    spectrum 1/NFFT·|rfft|², log mel filterbank, ortho DCT-II, sin lifter,
    c0 replaced by the log total frame energy."""
    from scipy.fftpack import dct

    signal = np.asarray(signal, np.float64)
    signal = np.append(signal[0], signal[1:] - preemph * signal[:-1])

    frame_len = _round_half_up(winlen * samplerate)
    frame_step = _round_half_up(winstep * samplerate)
    slen = len(signal)
    if slen <= frame_len:
        numframes = 1
    else:
        numframes = 1 + int(math.ceil((slen - frame_len) / frame_step))
    padlen = int((numframes - 1) * frame_step + frame_len)
    padded = np.concatenate([signal, np.zeros(padlen - slen)])
    idx = (np.tile(np.arange(frame_len), (numframes, 1))
           + np.tile(np.arange(numframes) * frame_step, (frame_len, 1)).T)
    frames = padded[idx]

    pspec = (np.abs(np.fft.rfft(frames, nfft)) ** 2) / nfft
    energy = pspec.sum(1)
    energy = np.where(energy == 0, np.finfo(np.float64).eps, energy)
    fb = _filterbanks(nfilt, nfft, samplerate)
    feat = pspec @ fb.T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    feat = dct(np.log(feat), type=2, axis=1, norm="ortho")[:, :numcep]
    n = np.arange(numcep)
    lift = 1 + (ceplifter / 2.0) * np.sin(np.pi * n / ceplifter)
    feat = feat * lift
    feat[:, 0] = np.log(energy)
    return feat


def input_vector(audio_int16: np.ndarray, sample_rate: int = 16000,
                 num_cepstrum: int = 26, num_context: int = 9) -> np.ndarray:
    """MFCC → ::2 stride → ±num_context windows flattened → global mean/std
    normalization (deepspeech_features.py:185-238)."""
    features = mfcc_psf(audio_int16, sample_rate, numcep=num_cepstrum)
    features = features[::2]
    num_strides = len(features)
    empty = np.zeros((num_context, num_cepstrum), features.dtype)
    features = np.concatenate([empty, features, empty])
    window_size = 2 * num_context + 1
    out = np.stack([features[i:i + window_size] for i in range(num_strides)])
    out = out.reshape(num_strides, -1)
    return (out - out.mean()) / out.std()


# ---------------------------------------------------------------------------
# DeepSpeech v0.1.0 acoustic network
# ---------------------------------------------------------------------------

N_HIDDEN = 2048
N_INPUT = 26 * (2 * 9 + 1)
N_OUTPUT = 29
RELU_CLIP = 20.0
FORGET_BIAS = 1.0  # TF BasicLSTMCell default, as DeepSpeech v0.1.0 uses it

PARAM_SHAPES = {
    "h1": (N_INPUT, N_HIDDEN), "b1": (N_HIDDEN,),
    "h2": (N_HIDDEN, N_HIDDEN), "b2": (N_HIDDEN,),
    "h3": (N_HIDDEN, 2 * N_HIDDEN), "b3": (2 * N_HIDDEN,),
    # TF BasicLSTMCell kernel [(input+units), 4*units], gate order i,j,f,o
    "lstm_fw_kernel": (2 * N_HIDDEN + N_HIDDEN, 4 * N_HIDDEN),
    "lstm_fw_bias": (4 * N_HIDDEN,),
    "lstm_bw_kernel": (2 * N_HIDDEN + N_HIDDEN, 4 * N_HIDDEN),
    "lstm_bw_bias": (4 * N_HIDDEN,),
    "h5": (2 * N_HIDDEN, N_HIDDEN), "b5": (N_HIDDEN,),
    "h6": (N_HIDDEN, N_OUTPUT), "b6": (N_OUTPUT,),
}


def init_params(rng: np.random.Generator | None = None,
                scale: float = 0.02) -> dict:
    """Random-weight parameters (numpy float32) for tests and smoke runs,
    drawn in PARAM_SHAPES order so that one seed gives the JAX package's
    weights; a frozen graph's real weights come from params_from_graph."""
    rng = rng or np.random.default_rng(0)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in PARAM_SHAPES.items()}


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in float32. bf16 operands on CUDA go to cuBLAS with a
    float32 output (``out_dtype``); the CPU build has no such GEMM, so
    there the bf16-rounded operands are multiplied in float32 (exact
    products, float32 sums: the same numbers in another summation order)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def lstm_scan(kernel: torch.Tensor, bias: torch.Tensor, xs: torch.Tensor,
              reverse: bool = False) -> torch.Tensor:
    """TF BasicLSTMCell over the rows of xs: gates i, j, f, o with the
    forget bias added to f. Returns the float32 hidden states [T, units].

    z = [x, h] @ kernel splits into the input block Wx and the recurrent
    block Wh: the input half is one [T, in] @ Wx product before the loop,
    and each step multiplies h by Wh alone. The cell state c and the gate
    math are float32; h is carried in xs's dtype (bf16 in the bf16 form)."""
    units = kernel.shape[1] // 4
    insz = kernel.shape[0] - units
    wh = kernel[insz:]
    xp = _mm(xs, kernel[:insz]) + bias.float()                 # [T, 4*units]
    c = torch.zeros(1, units, dtype=torch.float32, device=xs.device)
    h = torch.zeros(1, units, dtype=xs.dtype, device=xs.device)
    out = torch.empty(xs.shape[0], units, dtype=torch.float32, device=xs.device)
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    for t in steps:
        z = xp[t:t + 1] + _mm(h, wh)
        i, j, f, o = z.chunk(4, dim=-1)
        c = c * torch.sigmoid(f + FORGET_BIAS) + torch.sigmoid(i) * torch.tanh(j)
        new_h = torch.tanh(c) * torch.sigmoid(o)
        out[t] = new_h[0]
        h = new_h.to(xs.dtype)
    return out


def deepspeech_apply(params: dict, x: torch.Tensor,
                     compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x: [T, 494] context vectors → [T, 29] float32 logits (pre-softmax,
    the frozen graph's 'logits' node).

    compute_dtype: the products' operand dtype (torch.bfloat16 for live
    serving); the 2-D weights and x take it, biases, gate math and every
    product's sum stay float32, and the clipped activations are rounded to
    it, as the JAX package's ``deepspeech_apply``. None: float32 throughout.
    The cast of a weight already in compute_dtype is free, so callers that
    serve keep the weights cast (``deepspeech_logits_fn``)."""
    if compute_dtype is not None:
        params = {k: v.to(compute_dtype) if v.ndim == 2 else v for k, v in params.items()}
        x = x.to(compute_dtype)
    out_dtype = compute_dtype or torch.float32

    def clip(h):
        return torch.clamp(h, 0.0, RELU_CLIP).to(out_dtype)

    h = clip(_mm(x, params["h1"]) + params["b1"])
    h = clip(_mm(h, params["h2"]) + params["b2"])
    h = clip(_mm(h, params["h3"]) + params["b3"])
    fw = lstm_scan(params["lstm_fw_kernel"], params["lstm_fw_bias"], h)
    bw = lstm_scan(params["lstm_bw_kernel"], params["lstm_bw_bias"], h, reverse=True)
    h = torch.cat([fw, bw], -1).to(out_dtype)
    h = clip(_mm(h, params["h5"]) + params["b5"])
    return _mm(h, params["h6"]) + params["b6"]


def serving_weights(params: dict, device, compute_dtype: torch.dtype | None) -> dict:
    """params (numpy arrays or tensors) as float32 tensors on ``device``,
    the 2-D weights in compute_dtype when one is given."""
    out = {}
    for k, v in params.items():
        t = torch.as_tensor(v).to(device=device, dtype=torch.float32)
        out[k] = t.to(compute_dtype) if compute_dtype is not None and t.ndim == 2 else t
    return out


def deepspeech_logits_fn(pb_path: Optional[str] = None,
                         params: Optional[dict] = None,
                         device=None,
                         return_device: bool = False,
                         compute_dtype: Optional[str] = None) -> Callable:
    """fn(pcm_float32_16k) → [T50, 29] logits at 50 Hz.

    device: where the network runs; None is the current CUDA device (raises
    without one), "cpu" runs it on the host when the caller asks for that.
    return_device: return the float32 logits as a tensor on ``device``
    with no host readback (the live path: NerfASR writes them straight
    into its device feature ring); else a numpy array.
    compute_dtype: the products' operand dtype, e.g. "bfloat16", the
    default with return_device=True (live serving); else float32, as
    offline training features are."""
    if params is None:
        if pb_path is None:
            raise ValueError("deepspeech_logits_fn needs pb_path or params")
        params = params_from_graph(read_graph_constants(pb_path))
    dev = resolve_device(device)
    if compute_dtype is None and return_device:
        compute_dtype = "bfloat16"
    cdt = parse_dtype(compute_dtype) if compute_dtype is not None else None
    weights = serving_weights(params, dev, cdt)

    @torch.no_grad()
    def fn(pcm: np.ndarray):
        audio = np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16)
        vec = torch.from_numpy(input_vector(audio).astype(np.float32)).to(dev)
        out = deepspeech_apply(weights, vec, cdt)
        return out if return_device else out.cpu().numpy()

    fn.width = weights["h6"].shape[1]
    return fn


def interpolate_features(features: np.ndarray, input_rate: float,
                         output_rate: float, output_len: int) -> np.ndarray:
    """Per-channel np.interp resampling (deepspeech_features.py:241-275)."""
    input_len, num_features = features.shape
    it = np.arange(input_len) / float(input_rate)
    ot = np.arange(output_len) / float(output_rate)
    out = np.zeros((output_len, num_features))
    for c in range(num_features):
        out[:, c] = np.interp(ot, it, features[:, c])
    return out


def conv_audio_to_deepspeech(audio: np.ndarray, audio_sample_rate: int,
                             net_fn: Callable, num_frames: Optional[int] = None,
                             audio_window_size: int = 16,
                             audio_window_stride: int = 1) -> np.ndarray:
    """The per-file pipeline → [N, window, 29] feature windows
    (deepspeech_features.py:113-180). net_fn maps the [T50, 494] context
    vectors to [T50, 29] logits."""
    from mere_fusion_tpu_torch.tts import resample_pcm

    if audio_sample_rate != 16000:
        f = audio.astype(np.float32)
        if audio.dtype == np.int16:
            f = f / 32768.0
        audio16 = resample_pcm(f, audio_sample_rate, 16000)
        audio_i16 = np.clip(audio16 * 32768.0, -32768, 32767).astype(np.int16)
    else:
        audio_i16 = (audio if audio.dtype == np.int16 else
                     np.clip(audio * 32768.0, -32768, 32767).astype(np.int16))

    logits = np.asarray(net_fn(input_vector(audio_i16)))  # [T50, 29]

    deepspeech_fps = 50.0
    audio_len_s = float(audio.shape[0]) / audio_sample_rate
    if num_frames is None:
        video_fps = 50.0
        num_frames = int(round(audio_len_s * video_fps))
    else:
        video_fps = num_frames / audio_len_s
    logits = interpolate_features(logits, deepspeech_fps, video_fps, num_frames)

    half = int(audio_window_size / 2)
    zero_pad = np.zeros((half, logits.shape[1]))
    logits = np.concatenate([zero_pad, logits, zero_pad])
    windows = [logits[i:i + audio_window_size]
               for i in range(0, logits.shape[0] - audio_window_size,
                              audio_window_stride)]
    return np.array(windows)


# ---------------------------------------------------------------------------
# Frozen-graph (GraphDef .pb) constants: a minimal protobuf wire-format
# reader, no TensorFlow. The file is read once into a buffer and parsed
# through memoryviews, so a tensor's bytes are never copied again: each
# array is a view of that buffer.
# ---------------------------------------------------------------------------

_DT_FLOAT, _DT_INT32, _DT_INT64 = 1, 3, 9


def _read_varint(buf, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over one message's bytes;
    length-delimited and fixed-width values are views of ``buf``."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:  # 32-bit
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: memoryview) -> Optional[np.ndarray]:
    """TensorProto → ndarray (float/int tensors only)."""
    dtype = None
    shape: list[int] = []
    content = None
    float_vals: list[float] = []
    int_vals: list[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 0:  # dtype
            dtype = val
        elif field == 2 and wire == 2:  # TensorShapeProto
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 2 and w2 == 2:  # dim
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 1 and w3 == 0:
                            shape.append(v3)
        elif field == 4 and wire == 2:  # tensor_content
            content = val
        elif field == 5:  # float_val
            if wire == 5:
                float_vals.append(struct.unpack("<f", val)[0])
            elif wire == 2:  # packed
                float_vals.extend(np.frombuffer(val, "<f4").tolist())
        elif field in (6, 7, 9):  # double/int/int64 vals (rare here)
            if wire == 0:
                int_vals.append(val)
    np_dtype = {_DT_FLOAT: "<f4", _DT_INT32: "<i4", _DT_INT64: "<i8"}.get(dtype)
    if np_dtype is None:
        return None
    if content is not None and len(content):
        arr = np.frombuffer(content, np_dtype)
    elif float_vals:
        arr = np.array(float_vals, np_dtype)
    elif int_vals:
        arr = np.array(int_vals, np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    if shape and arr.size == int(np.prod(shape)):
        arr = arr.reshape(shape)
    elif shape and arr.size == 1:  # scalar fill
        arr = np.full(shape, arr.ravel()[0], np_dtype)
    return arr


def read_graph_constants(pb_path: str) -> dict[str, np.ndarray]:
    """Parse a frozen GraphDef .pb and return {node_name: array} for every
    Const node with a float/int tensor. The arrays are writable views of
    one buffer holding the file."""
    import os

    buf = bytearray(os.path.getsize(pb_path))
    with open(pb_path, "rb") as f:
        f.readinto(buf)
    consts: dict[str, np.ndarray] = {}
    for field, wire, node in _iter_fields(memoryview(buf)):
        if field != 1 or wire != 2:  # GraphDef.node
            continue
        name = op = None
        tensors = []
        for f2, w2, v2 in _iter_fields(node):
            if f2 == 1 and w2 == 2:
                name = bytes(v2).decode("utf-8", "replace")
            elif f2 == 2 and w2 == 2:
                op = bytes(v2).decode("utf-8", "replace")
            elif f2 == 5 and w2 == 2:  # attr map entry
                for f3, w3, v3 in _iter_fields(v2):
                    if f3 == 2 and w3 == 2:  # AttrValue
                        for f4, w4, v4 in _iter_fields(v3):
                            if f4 == 8 and w4 == 2:  # tensor
                                t = _parse_tensor(v4)
                                if t is not None:
                                    tensors.append(t)
        if op == "Const" and name and tensors:
            consts[name] = tensors[0]
    return consts


def params_from_graph(consts: dict[str, np.ndarray]) -> dict:
    """Map DeepSpeech v0.1.0 frozen-graph constants onto the parameter names.

    Dense layers are the Const nodes named h1/b1..h6/b6 (DeepSpeech.py
    variable names); LSTM kernels and biases are matched by 'fw'/'bw' +
    'kernel'/'bias' (bidirectional_rnn/{fw,bw}/basic_lstm_cell/*). float32
    arrays are kept as they are (no copy)."""
    params: dict = {}
    for key in ("h1", "b1", "h2", "b2", "h3", "b3", "h5", "b5", "h6", "b6"):
        matches = [v for k, v in consts.items() if k == key or k.endswith("/" + key)]
        if not matches:
            raise KeyError(f"frozen graph is missing dense param {key!r}")
        params[key] = np.asarray(matches[0], np.float32)
    for direction in ("fw", "bw"):
        for leaf in ("kernel", "bias"):
            matches = [v for k, v in consts.items()
                       if f"/{direction}/" in k and k.endswith(leaf)]
            if not matches:
                raise KeyError(f"missing lstm_{direction}_{leaf} in graph")
            params[f"lstm_{direction}_{leaf}"] = np.asarray(matches[0], np.float32)
    for key, shape in PARAM_SHAPES.items():
        if tuple(params[key].shape) != shape:
            raise ValueError(f"{key}: expected {shape}, got {params[key].shape}")
    return params
