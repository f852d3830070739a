"""Reference checkpoints → what the port's modules load.

Port of mere_fusion_tpu/utils/torch_convert.py. The Wav2Lip family's
modules (the generator, its discriminator, SyncNet) carry the reference's
names, so ``convert_wav2lip``, ``convert_wav2lip_disc`` and
``convert_syncnet`` only strip the ``module.`` prefix and check the key set
and shapes against the port's module.

ER-NeRF: a
trained reference checkpoint (``ngp_kf.pth``, the Trainer's
``ckpt['model']`` state dict, ernerf/nerf_triplane/network.py) maps onto the
nested numpy tree the JAX converter produces (flax names and layouts: Dense
kernels [in, out], Conv1d kernels [k, in, out]), so a test can hold the two
equal; ``convert.ernerf_from_flax`` then maps that tree onto the port's
names, the one mapping of the package. ``density_from_ernerf`` turns the
Morton-order density grid into the port's raster-order ``DensityGrid``.

EasyOCR's detector and recognizer (``craft_mlt_25k.pth``, ``english_g2.pth``):
``convert_craft`` and ``convert_crnn`` map their state dicts onto the port's
CRAFT and CRNN by order (weighted modules in state-dict order, classified as
conv, BatchNorm, LSTM or linear), as the JAX package's converters do, with
the counts checked.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def strip_prefix(state_dict: Mapping[str, Any], prefix: str = "module.") -> dict:
    return {
        (k[len(prefix):] if k.startswith(prefix) else k): v
        for k, v in state_dict.items()
    }


def _linear_nobias(sd: Mapping, key: str) -> dict:
    return {"kernel": _np(sd[key]).T}


def _mlp(sd: Mapping, base: str, num_layers: int) -> dict:
    """Reference MLP (network.py:70-91): bias-free Linear net.{l} → net_{l}."""
    return {f"net_{l}": _linear_nobias(sd, f"{base}.net.{l}.weight")
            for l in range(num_layers)}


def _conv1d(sd: Mapping, base: str) -> dict:
    # torch conv1d [out, in, k] → [k, in, out]
    return {"kernel": _np(sd[f"{base}.weight"]).transpose(2, 1, 0),
            "bias": _np(sd[f"{base}.bias"])}


def convert_ernerf(state_dict: Mapping[str, Any]) -> dict:
    """A trained reference ER-NeRF state dict → ``{"params": tree}``.

    Hash tables convert 1:1 (the level offsets and sizes are the CUDA
    gridencoder's layout, [total_params, level_dim]); MLP and audio-net
    weights transpose. Training-only modules (the reference's audio id
    embedding) are skipped; ``individual_codes*`` and the torso appear only
    when the checkpoint has them."""
    sd = strip_prefix(state_dict)
    params: dict = {}

    for plane in ("xy", "yz", "xz"):
        params[f"plane_{plane}"] = _np(sd[f"encoder_{plane}.embeddings"])

    an = {}
    for i, j in enumerate((0, 2, 4, 6)):
        an[f"conv_{i}"] = _conv1d(sd, f"audio_net.encoder_conv.{j}")
    an["fc_0"] = {"kernel": _np(sd["audio_net.encoder_fc1.0.weight"]).T,
                  "bias": _np(sd["audio_net.encoder_fc1.0.bias"])}
    an["fc_1"] = {"kernel": _np(sd["audio_net.encoder_fc1.2.weight"]).T,
                  "bias": _np(sd["audio_net.encoder_fc1.2.bias"])}
    params["audio_net"] = an

    if any(k.startswith("audio_att_net.") for k in sd):
        att = {}
        for i, j in enumerate((0, 2, 4, 6, 8)):
            att[f"conv_{i}"] = _conv1d(sd, f"audio_att_net.attentionConvNet.{j}")
        att["att"] = {
            "kernel": _np(sd["audio_att_net.attentionNet.0.weight"]).T,
            "bias": _np(sd["audio_att_net.attentionNet.0.bias"]),
        }
        params["audio_att_net"] = att

    params["eye_att_net"] = _mlp(sd, "eye_att_net", 2)
    params["sigma_net"] = _mlp(sd, "sigma_net", 3)
    params["color_net"] = _mlp(sd, "color_net", 2)
    params["unc_net"] = _mlp(sd, "unc_net", 2)
    params["aud_ch_att_net"] = _mlp(sd, "aud_ch_att_net", 2)

    if "individual_codes" in sd:
        params["individual_codes"] = _np(sd["individual_codes"])
    if "anchor_points" in sd:  # torso stage
        params["anchor_points"] = _np(sd["anchor_points"])
        params["torso_grid"] = _np(sd["torso_encoder.embeddings"])
        params["torso_deform_net"] = _mlp(sd, "torso_deform_net", 3)
        params["torso_net"] = _mlp(sd, "torso_net", 3)
        if "individual_codes_torso" in sd:
            params["individual_codes_torso"] = _np(sd["individual_codes_torso"])
    return {"params": params}


def _morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """CUDA __morton3D (raymarching.cu:56-71): interleave bits, x lowest."""

    def expand(v):
        v = v.astype(np.uint32)
        v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
        v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
        v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
        v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
        return v

    return expand(x) | (expand(y) << np.uint32(1)) | (expand(z) << np.uint32(2))


def density_from_ernerf(ckpt: Mapping[str, Any], grid_size: int = 128,
                        density_thresh: float = 10.0,
                        mean_density: float | None = None) -> DensityGrid:
    """The port's raster-order DensityGrid (on the CPU) from a reference
    model state dict: its density_grid is [CAS, H³] in Morton order
    (renderer.py:112, packed by morton3D indices); cascade 0 is the bound-1
    grid the renderer uses. The occupancy threshold is min(mean_density,
    density_thresh). Raises ValueError when the grid does not have
    grid_size³ cells."""
    dg = _np(ckpt["density_grid"])
    if dg.ndim == 2:
        dg = dg[0]
    g = grid_size
    if dg.size != g ** 3:
        raise ValueError(f"checkpoint density grid has {dg.size} cells but "
                         f"nerf.grid_size={g} expects {g ** 3}")
    idx = np.arange(g ** 3)
    x, y, z = idx // (g * g), (idx // g) % g, idx % g
    raster = dg[_morton3d(x, y, z)]
    if mean_density is None:
        # the Trainer stores mean_density at the checkpoint's top level, beside
        # 'model' (utils.py:1431): callers pass it; a bare state dict recomputes
        mean_density = float(ckpt.get("mean_density", np.maximum(raster, 0).mean()))
    mean_density = float(mean_density)
    thresh = min(mean_density, density_thresh)
    return DensityGrid(grid=torch.from_numpy(np.ascontiguousarray(raster, np.float32)),
                       occupancy=torch.from_numpy(raster > thresh),
                       mean_density=torch.tensor(mean_density, dtype=torch.float32))


def load_torch_checkpoint(path: str) -> dict:
    """A .pth file loaded on the CPU, its ``state_dict`` wrapper removed.

    Loaded with ``weights_only=False``, as the JAX package loads it: a
    reference Trainer checkpoint also pickles its training stats (numpy
    scalars among them), which the weights-only unpickler refuses. The file
    is one the user names as the avatar to serve; unpickling can run code,
    so name only checkpoints from a trusted source. The port's own
    checkpoints (``utils/checkpoint.py``) load weights-only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return ckpt


def reference_state(state_dict: Mapping[str, Any], build: Callable) -> dict:
    """A reference state dict (``module.`` prefix allowed) as the state dict
    of the module ``build()`` makes, float entries in float32. BatchNorm's
    ``num_batches_tracked``, which old checkpoints lack, defaults to 0; any
    other key missing or extra, or a shape that differs, raises KeyError."""
    sd = strip_prefix(state_dict)
    with torch.device("meta"):
        expected = build().state_dict()
    out, missing, bad = {}, [], []
    for key, ref in expected.items():
        if key not in sd:
            if key.endswith("num_batches_tracked"):
                out[key] = torch.zeros((), dtype=torch.int64)
            else:
                missing.append(key)
            continue
        v = torch.as_tensor(sd[key])
        if tuple(v.shape) != tuple(ref.shape):
            bad.append((key, tuple(v.shape), tuple(ref.shape)))
        out[key] = v.to(ref.dtype)
    extra = sorted(set(sd) - set(expected))
    if missing or extra or bad:
        raise KeyError(f"checkpoint does not match the module: missing {missing[:8]} "
                       f"extra {extra[:8]} shapes {bad[:4]}")
    return out


def convert_wav2lip(state_dict: Mapping[str, Any]) -> dict:
    """A reference ``wav2lip.pth`` state dict → the port's Wav2Lip state dict."""
    from mere_fusion_tpu_torch.models.wav2lip import Wav2Lip

    return reference_state(state_dict, Wav2Lip)


def convert_wav2lip_disc(state_dict: Mapping[str, Any]) -> dict:
    """A reference Wav2Lip_disc_qual state dict → the port's Wav2LipDisc's."""
    from mere_fusion_tpu_torch.models.wav2lip import Wav2LipDisc

    return reference_state(state_dict, Wav2LipDisc)


def convert_syncnet(state_dict: Mapping[str, Any]) -> dict:
    """A reference SyncNet_color state dict → the port's SyncNet's."""
    from mere_fusion_tpu_torch.models.syncnet import SyncNet

    return reference_state(state_dict, SyncNet)


def _grouped_layers(state_dict: Mapping[str, Any]) -> list[tuple[str, dict]]:
    """(module_path, {leaf: tensor}) per weighted module in state-dict order,
    ``module.`` stripped and ``num_batches_tracked`` dropped."""
    groups: dict = {}
    for k, v in strip_prefix(state_dict).items():
        if k.endswith("num_batches_tracked"):
            continue
        mod, leaf = k.rsplit(".", 1) if "." in k else ("", k)
        groups.setdefault(mod, {})[leaf] = torch.as_tensor(v).detach().float()
    return list(groups.items())


def _layer_kind(leaves: Mapping[str, torch.Tensor]) -> str:
    if "running_mean" in leaves:
        return "bn"
    if "weight_ih_l0" in leaves:
        return "lstm"
    w = leaves.get("weight")
    return {4: "conv", 2: "linear"}.get(None if w is None else w.ndim, "other")


def _put(out: dict, name: str, leaves: Mapping[str, torch.Tensor]) -> None:
    for leaf, v in leaves.items():
        out[f"{name}.{leaf}"] = v
    if "running_mean" in leaves:
        out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _by_kind(state_dict: Mapping[str, Any], want: dict, what: str) -> dict[str, list]:
    kinds: dict[str, list] = {k: [] for k in want}
    for _m, leaves in _grouped_layers(state_dict):
        kind = _layer_kind(leaves)
        if kind in kinds:
            kinds[kind].append(leaves)
    got = {k: len(v) for k, v in kinds.items()}
    if got != want:
        raise ValueError(f"{what} checkpoint shape: want {want}, got {got}")
    return kinds


def convert_craft(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """CRAFT detector state dict (EasyOCR craft_mlt_25k.pth; the reference's
    easyocr.Reader, yolo_opencv.py:189-199) → the port's CRAFT state dict:
    13 VGG conv+BN pairs, fc6/fc7, 4 double_conv blocks (conv+BN ×2 each),
    the 5-conv class head, in that order."""
    kinds = _by_kind(state_dict, {"conv": 28, "bn": 21}, "CRAFT")
    convs, bns = iter(kinds["conv"]), iter(kinds["bn"])
    out: dict = {}
    for stage, reps in (("s1", 2), ("s2", 2), ("s3", 3), ("s4", 3), ("s5", 3)):
        for j in range(reps):
            _put(out, f"{stage}_{j}.conv", next(convs))
            _put(out, f"{stage}_{j}.bn", next(bns))
    _put(out, "fc6", next(convs))
    _put(out, "fc7", next(convs))
    for k in range(4):
        for j in range(2):
            _put(out, f"up_{k}.conv_{j}", next(convs))
            _put(out, f"up_{k}.bn_{j}", next(bns))
    for j in range(5):
        _put(out, f"cls_{j}", next(convs))
    return out


def convert_crnn(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """CRNN recognizer state dict (EasyOCR english_g2, "None-VGG-BiLSTM-CTC")
    → the port's CRNN state dict: 7 extractor convs (BN after conv_4 and
    conv_5), two bidirectional LSTMs and their projections, the CTC head."""
    kinds = _by_kind(state_dict, {"conv": 7, "bn": 2, "lstm": 2, "linear": 3}, "CRNN")
    out: dict = {}
    for i, leaves in enumerate(kinds["conv"]):
        _put(out, f"conv_{i}", leaves)
    for i, leaves in zip((4, 5), kinds["bn"]):
        _put(out, f"bn_{i}", leaves)
    for i in range(2):
        _put(out, f"rnn_{i}.lstm", kinds["lstm"][i])
        _put(out, f"rnn_{i}.proj", kinds["linear"][i])
    _put(out, "head", kinds["linear"][2])
    return out


def convert_rtmpose(state_dict: Mapping[str, Any], deepen: float = 1.0,
                    widen: float = 1.0) -> dict:
    """DWPose/RTMPose wholebody .pth (mmpose ``dw-ll_ucoco_384.pth``,
    reference musetalk/utils/preprocessing.py:17-18) → the port's RTMPose
    state dict (models/rtmpose.py, which carries mmpose's names).

    Every tensor the port's module has is read, its shape checked; a
    missing key raises KeyError, as the JAX converter's walk of the same
    tree does. Keys the module does not have (mmpose's data preprocessor,
    an EMA copy) are not read; BatchNorm's ``num_batches_tracked`` defaults
    to 0."""
    from mere_fusion_tpu_torch.models.rtmpose import RTMPose

    sd = strip_prefix(state_dict)
    with torch.device("meta"):
        expected = RTMPose(deepen, widen).state_dict()
    out, missing, bad = {}, [], []
    for key, ref in expected.items():
        if key not in sd:
            if key.endswith("num_batches_tracked"):
                out[key] = torch.zeros((), dtype=torch.int64)
            else:
                missing.append(key)
            continue
        v = torch.as_tensor(sd[key])
        if tuple(v.shape) != tuple(ref.shape):
            bad.append((key, tuple(v.shape), tuple(ref.shape)))
        out[key] = v.to(ref.dtype)
    if missing or bad:
        raise KeyError(f"RTMPose checkpoint does not match deepen={deepen} widen={widen}: "
                       f"missing {missing[:8]} shapes {bad[:4]}")
    return out
