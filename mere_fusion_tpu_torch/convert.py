"""JAX param trees → the port's state dicts.

Inverse of the JAX package's ``utils/diffusers_convert.py::convert_vae`` /
``convert_musetalk_unet`` and ``utils/torch_convert.py::convert_whisper``,
plus the ER-NeRF head (``ernerf_from_flax``, whose names already match)
the Wav2Lip family (``wav2lip_from_flax``, ``wav2lip_disc_from_flax``,
``syncnet_from_flax``: ``{"params", "batch_stats"}`` onto the reference's
names, running statistics included) and the avatar preparation's face
models (``s3fd_from_flax``, ``fan_from_flax``, ``bisenet_from_flax``, onto
the reference's names with their running statistics) and the perception
nets (``yolo_from_flax`` onto ultralytics' names, ``face_attrs_from_flax``,
``craft_from_flax``, ``crnn_from_flax`` onto the flax names with dots)
and the LPIPS criterion (``lpips_from_flax`` onto torchvision's and the
lpips package's names) and the RTMPose wholebody landmarker
(``rtmpose_from_flax`` onto mmpose's names, running statistics included):
a flax tree, given as nested dicts of numpy arrays, becomes a state dict
under diffusers (VAE, UNet) or OpenAI whisper (encoder, or the full model:
``whisper_from_flax``) key names, which the port's modules load with
``load_state_dict(strict=True)``; ``load_whisper_checkpoint`` reads an
OpenAI whisper ``.pt`` itself. Layouts:

- Conv ``[kh, kw, in, out]`` → ``[out, in, kh, kw]`` (Conv1d ``[k, in, out]``
  → ``[out, in, k]``); Dense ``[in, out]`` → Linear ``[out, in]``; a
  Wav2Lip transposed conv keeps its ``(cin, cout, k, k)``;
- norm ``scale`` → ``weight``;
- ``down_{i}_res_{j}`` → ``down_blocks.i.resnets.j`` and the like,
  ``time_linear_k`` → ``time_embedding.linear_k``, ``geglu_proj`` →
  ``ff.net.0.proj``.

A key the port's module lacks, or one it has that the tree does not give,
raises KeyError. ``state_from_flax`` dispatches a family of the converter
CLI (``tools/convert_ckpt.py``) to its function, given the tree the JAX
package's orbax directory holds (``utils.checkpoint.restore_orbax_raw``).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping

import numpy as np
import torch

from mere_fusion_tpu_torch.models.bisenet import BiSeNet
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork
from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
from mere_fusion_tpu_torch.models.face_attrs import EmotionNet, VGGFaceAttr
from mere_fusion_tpu_torch.models.fan import FAN
from mere_fusion_tpu_torch.models.lpips import ALEX_CONVS, LPIPS
from mere_fusion_tpu_torch.models.musetalk.unet import UNet2DCondition, UNetConfig
from mere_fusion_tpu_torch.models.musetalk.vae import AutoencoderKL, VAEConfig
from mere_fusion_tpu_torch.models.ocr import CRAFT, CRNN, DEFAULT_CHARSET
from mere_fusion_tpu_torch.models.rtmpose import RTMPose
from mere_fusion_tpu_torch.models.s3fd import S3FD
from mere_fusion_tpu_torch.models.syncnet import SyncNet
from mere_fusion_tpu_torch.models.wav2lip import Wav2Lip, Wav2LipDisc
from mere_fusion_tpu_torch.models.yolo import YOLOV10_SPEC, YoloV10
from mere_fusion_tpu_torch.models.whisper import AudioEncoder, Whisper, WhisperDims, sinusoids

_BLOCK_RULES = [
    (r"(^|\.)down_(\d+)_res_(\d+)\.", r"\1down_blocks.\2.resnets.\3."),
    (r"(^|\.)down_(\d+)_attn_(\d+)\.", r"\1down_blocks.\2.attentions.\3."),
    (r"(^|\.)down_(\d+)_downsample\.", r"\1down_blocks.\2.downsamplers.0.conv."),
    (r"(^|\.)up_(\d+)_res_(\d+)\.", r"\1up_blocks.\2.resnets.\3."),
    (r"(^|\.)up_(\d+)_attn_(\d+)\.", r"\1up_blocks.\2.attentions.\3."),
    (r"(^|\.)up_(\d+)_upsample\.", r"\1up_blocks.\2.upsamplers.0.conv."),
    (r"(^|\.)mid_res_(\d+)\.", r"\1mid_block.resnets.\2."),
]

_VAE_RULES = _BLOCK_RULES + [
    (r"(^|\.)mid_attn\.proj_out\.", r"\1mid_block.attentions.0.to_out.0."),
    (r"(^|\.)mid_attn\.", r"\1mid_block.attentions.0."),
]

_UNET_RULES = _BLOCK_RULES + [
    (r"(^|\.)mid_attn\.", r"\1mid_block.attentions.0."),
    (r"^time_linear_(\d)\.", r"time_embedding.linear_\1."),
    (r"\.block_0\.", ".transformer_blocks.0."),
    (r"\.to_out\.", ".to_out.0."),
    (r"\.ff\.geglu_proj\.", ".ff.net.0.proj."),
    (r"\.ff\.proj_out\.", ".ff.net.2."),
]

_WHISPER_RULES = [
    (r"^blocks_(\d+)\.", r"blocks.\1."),
    (r"\.mlp_fc1\.", ".mlp.0."),
    (r"\.mlp_fc2\.", ".mlp.2."),
]


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for name, node in tree.items():
        path = f"{prefix}{name}"
        if isinstance(node, Mapping):
            out.update(_flatten(node, path + "."))
        else:
            out[path] = np.asarray(node, dtype=np.float32)
    return out


def _leaf(path: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    module, leaf = path.rsplit(".", 1)
    if leaf == "kernel":
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 3:
            value = value.transpose(2, 1, 0)
        elif value.ndim == 2:
            value = value.T
        return f"{module}.weight", value
    if leaf == "scale":
        return f"{module}.weight", value
    if leaf in ("bias", "weight"):   # "weight": S3FD's L2Norm scale vector
        return path, value
    raise KeyError(f"unexpected flax leaf {path!r}")


def _translate(tree: Mapping, rules, expected: set[str] | None) -> dict[str, torch.Tensor]:
    """The tree's leaves under the port's names; their set must be
    ``expected`` unless that is None."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    sd = {}
    for path, value in _flatten(tree).items():
        path = path + "."
        for pattern, repl in rules:
            path = re.sub(pattern, repl, path)
        key, value = _leaf(path[:-1], value)
        sd[key] = torch.from_numpy(np.ascontiguousarray(value))
    if expected is None:
        return sd
    missing = expected - set(sd)
    extra = set(sd) - expected
    if missing or extra:
        raise KeyError(f"tree does not match the module: missing "
                       f"{sorted(missing)[:8]} extra {sorted(extra)[:8]}")
    return sd


def _expected_keys(build) -> set[str]:
    with torch.device("meta"):
        return set(build().state_dict())


def _infer_vae_config(tree: Mapping) -> VAEConfig:
    p = tree.get("params", tree)
    enc = p["encoder"]
    n_down = len({k.split("_")[1] for k in enc if re.fullmatch(r"down_\d+_res_\d+", k)})
    layers = len([k for k in enc if re.fullmatch(r"down_0_res_\d+", k)])
    chans = tuple(int(np.shape(enc[f"down_{i}_res_0"]["conv1"]["kernel"])[-1])
                  for i in range(n_down))
    # the group count leaves no trace in the shapes: sd-vae's 32, or the
    # largest count that divides a narrower tree's channels
    groups = math.gcd(VAEConfig().norm_num_groups, *chans)
    return VAEConfig(
        in_channels=int(np.shape(enc["conv_in"]["kernel"])[2]),
        latent_channels=int(np.shape(p["post_quant_conv"]["kernel"])[-1]),
        block_out_channels=chans, layers_per_block=layers, norm_num_groups=groups)


def vae_from_flax(tree: Mapping, cfg: VAEConfig | None = None) -> dict[str, torch.Tensor]:
    """JAX AutoencoderKL variables → diffusers-named state dict. ``cfg``
    defaults to the one the tree's shapes imply."""
    cfg = cfg or _infer_vae_config(tree)
    return _translate(tree, _VAE_RULES, _expected_keys(lambda: AutoencoderKL(cfg)))


def unet_from_flax(tree: Mapping, cfg: UNetConfig) -> dict[str, torch.Tensor]:
    """JAX UNet2DCondition variables → diffusers-named state dict."""
    return _translate(tree, _UNET_RULES, _expected_keys(lambda: UNet2DCondition(cfg)))


def whisper_encoder_from_flax(tree: Mapping, dims: WhisperDims) -> dict[str, torch.Tensor]:
    """JAX Whisper variables (the encoder is read) → the port's AudioEncoder
    state dict, i.e. OpenAI's ``encoder.*`` entries without the prefix."""
    p = tree.get("params", tree)
    expected = _expected_keys(lambda: AudioEncoder(dims))
    sd = _translate(p["encoder"], _WHISPER_RULES, expected - {"positional_embedding"})
    sd["positional_embedding"] = torch.from_numpy(
        sinusoids(dims.n_audio_ctx, dims.n_audio_state))
    return sd


def whisper_from_flax(tree: Mapping, dims: WhisperDims) -> dict[str, torch.Tensor]:
    """JAX Whisper variables → the port's Whisper state dict: OpenAI's
    ``encoder.*`` and ``decoder.*`` names (``token_embedding.weight``, the
    ``positional_embedding`` parameter, ``blocks.{i}.cross_attn``, ``ln``)."""
    p = tree.get("params", tree)
    sd = {f"encoder.{k}": v for k, v in whisper_encoder_from_flax(p, dims).items()}
    dec = dict(p["decoder"])
    sd["decoder.token_embedding.weight"] = torch.from_numpy(
        np.asarray(dec.pop("token_embedding")["embedding"], dtype=np.float32).copy())
    sd["decoder.positional_embedding"] = torch.from_numpy(
        np.asarray(dec.pop("positional_embedding"), dtype=np.float32).copy())
    sd.update({f"decoder.{k}": v for k, v in _translate(dec, _WHISPER_RULES, None).items()})
    expected = _expected_keys(lambda: Whisper(dims))
    missing, extra = expected - set(sd), set(sd) - expected
    if missing or extra:
        raise KeyError(f"tree does not match the module: missing "
                       f"{sorted(missing)[:8]} extra {sorted(extra)[:8]}")
    return sd


def load_whisper_checkpoint(path: str) -> Whisper:
    """An OpenAI whisper ``.pt`` (``{"dims": {...}, "model_state_dict":
    {...}}``) as the port's Whisper on the CPU, loaded with strict=True, in
    eval mode; half-precision files load into float32."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model = Whisper(WhisperDims(**ckpt["dims"]))
    model.load_state_dict(ckpt["model_state_dict"], strict=True)
    return model.eval()


def ernerf_from_flax(tree: Mapping, cfg: NeRFNetConfig | None = None) -> dict[str, torch.Tensor]:
    """JAX NeRFNetwork variables → the port's NeRFNetwork state dict. The
    hash tables and individual codes are top-level leaves and keep their
    names; dense and conv kernels are transposed. ``cfg`` defaults to the
    one the tree's names imply."""
    p = tree.get("params", tree)
    cfg = cfg or _infer_ernerf_config(p)
    leaves = {k: v for k, v in p.items() if not isinstance(v, Mapping)}
    modules = {k: v for k, v in p.items() if isinstance(v, Mapping)}
    expected = _expected_keys(lambda: NeRFNetwork(cfg))
    sd = _translate(modules, [], expected - set(leaves))
    for name, value in leaves.items():
        if name not in expected:
            raise KeyError(f"tree does not match the module: extra {name!r}")
        sd[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return sd


def individual_code_sizes(params: Mapping) -> dict:
    """NeRFNetConfig's ``num_train_frames``, ``individual_dim`` and
    ``individual_dim_torso`` as the individual-code tables of ``params`` (a
    state dict or a JAX tree's top level) size them: none where absent."""
    head, torso = params.get("individual_codes"), params.get("individual_codes_torso")
    return {"num_train_frames": next((np.shape(t)[0] for t in (head, torso) if t is not None), 1),
            "individual_dim": np.shape(head)[1] if head is not None else 0,
            "individual_dim_torso": np.shape(torso)[1] if torso is not None else 0}


def _infer_ernerf_config(tree: Mapping) -> NeRFNetConfig:
    """The NeRFNetConfig whose parameter names the tree has: the torso when
    it holds ``anchor_points``, the individual codes as their tables size
    them. Widths the names do not show keep their defaults."""
    p = tree.get("params", tree)
    return NeRFNetConfig(torso="anchor_points" in p, **individual_code_sizes(p))


def density_from_flax(density, device=None) -> DensityGrid:
    """The JAX package's DensityGrid (any object with ``grid``, ``occupancy``
    and ``mean_density`` arrays, or a mapping of them, as an orbax
    directory restores it) → the port's."""
    field = density.__getitem__ if isinstance(density, Mapping) else density.__getattribute__
    return DensityGrid(
        grid=torch.from_numpy(np.array(field("grid"), dtype=np.float32)).to(device),
        occupancy=torch.from_numpy(np.array(field("occupancy"), dtype=bool)).to(device),
        mean_density=torch.tensor(float(np.asarray(field("mean_density"))), device=device))


def split_checkpoint_tree(raw) -> tuple[dict, DensityGrid | None]:
    """(parameter tree, DensityGrid or None) of a tree restored from the JAX
    package's orbax directory without a template: a training workspace
    (``NeRFTrainState``: its EMA parameters are served, as the reference's
    EMA-aware load does, utils.py:1479-1538) or a converted tree
    (tools/convert_ckpt: ``params`` and an optional ``density``)."""
    if isinstance(raw, dict) and "ema_params" in raw:
        return raw["ema_params"], density_from_flax(raw["density"])
    if isinstance(raw, dict) and "params" in raw:
        return raw["params"], density_from_flax(raw["density"]) if "density" in raw else None
    raise ValueError("unrecognized checkpoint layout: top-level "
                     f"{list(raw) if isinstance(raw, dict) else type(raw)}")


# flax module names of the Wav2Lip family → the reference's
_CONV_BN_NAMES = [
    (r"^ae_(\d+)$", r"audio_encoder.\1"),
    (r"^fe_(\d+)_(\d+)$", r"face_encoder_blocks.\1.\2"),
    (r"^fd_(\d+)_(\d+)$", r"face_decoder_blocks.\1.\2"),
    (r"^de_(\d+)_(\d+)$", r"face_encoder_blocks.\1.\2"),
    (r"^out_(\d)$", r"output_block.\1"),
    (r"^pred$", "binary_pred.0"),
]
_SYNCNET_NAMES = [(r"^ae_(\d+)$", r"audio_encoder.\1"), (r"^fe_(\d+)$", r"face_encoder.\1")]


def _conv_bn_from_flax(tree: Mapping, names, build) -> dict[str, torch.Tensor]:
    """A flax tree of ConvBNRelu / ConvTransposeBNRelu / ConvLeaky blocks
    and plain convs → the reference-named state dict of ``build()``. Inside
    a block: ``conv`` → ``conv_block.0`` (a transposed conv's own
    ``kernel``/``bias`` too, its ``(cin, cout, k, k)`` kept), ``bn`` →
    ``conv_block.1`` with ``mean``/``var`` → ``running_mean``/``running_var``;
    a plain conv (``out_1``, ``pred``) keeps its name. ``num_batches_tracked``
    is 0."""
    params, stats = tree["params"], tree.get("batch_stats", {})
    sd = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    for name, node in params.items():
        base = name
        for pattern, repl in names:
            base = re.sub(pattern, repl, base)
        if "bn" in node or "conv" in node:
            conv = node.get("conv", node)
            kernel = np.asarray(conv["kernel"], np.float32)
            put(f"{base}.conv_block.0.weight",
                kernel.transpose(3, 2, 0, 1) if "conv" in node else kernel)
            put(f"{base}.conv_block.0.bias", conv["bias"])
            if "bn" in node:
                bn = f"{base}.conv_block.1"
                put(f"{bn}.weight", node["bn"]["scale"])
                put(f"{bn}.bias", node["bn"]["bias"])
                put(f"{bn}.running_mean", stats[name]["bn"]["mean"])
                put(f"{bn}.running_var", stats[name]["bn"]["var"])
                sd[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
        else:
            put(f"{base}.weight", np.asarray(node["kernel"], np.float32).transpose(3, 2, 0, 1))
            put(f"{base}.bias", node["bias"])
    expected = _expected_keys(build)
    missing, extra = expected - set(sd), set(sd) - expected
    if missing or extra:
        raise KeyError(f"tree does not match the module: missing "
                       f"{sorted(missing)[:8]} extra {sorted(extra)[:8]}")
    return sd


def wav2lip_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX Wav2Lip variables ``{"params", "batch_stats"}`` → the port's
    Wav2Lip state dict (the reference's names)."""
    return _conv_bn_from_flax(tree, _CONV_BN_NAMES, Wav2Lip)


def wav2lip_disc_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX Wav2LipDisc variables → the port's Wav2LipDisc state dict."""
    return _conv_bn_from_flax(tree, _CONV_BN_NAMES, Wav2LipDisc)


def syncnet_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX SyncNet variables → the port's SyncNet state dict."""
    return _conv_bn_from_flax(tree, _SYNCNET_NAMES, SyncNet)


# flax submodule names → the reference's Sequential indices
_FAN_NAMES = [(r"\.downsample_bn\.", ".downsample.0."), (r"\.downsample_conv\.", ".downsample.2.")]
_BISENET_NAMES = [(r"(^|\.)(layer\d)_(\d)\.", r"\1\2.\3."),
                  (r"\.downsample_conv\.", ".downsample.0."),
                  (r"\.downsample_bn\.", ".downsample.1.")]


def _with_stats_from_flax(tree: Mapping, rules, build, extra=None) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` → the state dict of ``build()``: leaves
    as in ``_translate``, each BatchNorm's ``mean``/``var`` →
    ``running_mean``/``running_var`` and a ``num_batches_tracked`` of 0;
    ``extra`` entries, mapped by the caller, join them. With ``build``
    None the names are not checked here."""
    tree = dict(tree)
    stats = _flatten(tree.pop("batch_stats", {}))
    sd = _translate(tree, rules, None)
    sd.update(extra or {})

    def rename(module: str) -> str:
        module += "."
        for pattern, repl in rules:
            module = re.sub(pattern, repl, module)
        return module[:-1]

    for path, value in stats.items():
        module, leaf = path.rsplit(".", 1)
        module = rename(module)
        sd[f"{module}.running_{leaf}"] = torch.from_numpy(np.ascontiguousarray(value))
        sd[f"{module}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    if build is None:
        return sd
    expected = _expected_keys(build)
    missing, extra = expected - set(sd), set(sd) - expected
    if missing or extra:
        raise KeyError(f"tree does not match the module: missing "
                       f"{sorted(missing)[:8]} extra {sorted(extra)[:8]}")
    return sd


def s3fd_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX S3FD variables → the port's S3FD state dict (the reference's
    names, which the flax module shares)."""
    return _with_stats_from_flax(tree, [], S3FD)


def fan_from_flax(tree: Mapping, num_modules: int = 4) -> dict[str, torch.Tensor]:
    """JAX FAN variables ``{"params", "batch_stats"}`` → the port's FAN
    state dict (face_alignment's names)."""
    return _with_stats_from_flax(tree, _FAN_NAMES, lambda: FAN(num_modules))


def bisenet_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX BiSeNet variables ``{"params", "batch_stats"}`` → the port's
    BiSeNet state dict (the reference's names)."""
    return _with_stats_from_flax(tree, _BISENET_NAMES, BiSeNet)


# flax's merged names → torch paths: "model_23" → "model.23",
# "one2one_cv2_0_1" → "one2one_cv2.0.1", "m_0" → "m.0"
_INDEX_NAMES = [(r"_(\d+)(?=[._])", r".\1")]


def yolo_from_flax(tree: Mapping, scale: str = "x", nc: int = 80,
                   spec: tuple = YOLOV10_SPEC) -> dict[str, torch.Tensor]:
    """JAX YoloV10 variables ``{"params", "batch_stats"}`` → the port's
    YoloV10 state dict (ultralytics' names), BatchNorm statistics included."""
    return _with_stats_from_flax(tree, _INDEX_NAMES, lambda: YoloV10(scale, nc, spec=spec))


def face_attrs_from_flax(tree: Mapping, n_classes: int | None = None,
                         width: float = 1.0) -> dict[str, torch.Tensor]:
    """JAX VGGFaceAttr variables (``n_classes`` given) or EmotionNet
    variables (``n_classes`` None) → the port's state dict. EmotionNet
    flattens channels-last as the flax module does, so ``dense_0`` keeps its
    rows."""
    if n_classes is None:
        return _translate(tree, [], _expected_keys(lambda: EmotionNet(width=width)))
    return _translate(tree, [], _expected_keys(lambda: VGGFaceAttr(n_classes, width=width)))


def craft_from_flax(tree: Mapping, width: float = 1.0) -> dict[str, torch.Tensor]:
    """JAX CRAFT variables ``{"params", "batch_stats"}`` → the port's CRAFT
    state dict."""
    return _with_stats_from_flax(tree, [], lambda: CRAFT(width=width))


_LSTM_LEAVES = (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0"))


def crnn_from_flax(tree: Mapping, n_classes: int = 1 + len(DEFAULT_CHARSET),
                   output_channel: int = 256, hidden: int = 256) -> dict[str, torch.Tensor]:
    """JAX CRNN variables → the port's CRNN state dict: each BiLSTM's
    ``w_ih_fw`` … ``b_hh_bw`` → ``lstm.weight_ih_l0`` …
    ``lstm.bias_hh_l0_reverse`` (torch's gate order, as the flax cells
    use), its ``proj`` a Linear."""
    params = dict(tree["params"])
    extra = {}
    for i in range(2):
        rnn = dict(params.pop(f"rnn_{i}"))
        params[f"rnn_{i}"] = {"proj": rnn.pop("proj")}
        for ours, theirs in _LSTM_LEAVES:
            for d, suffix in (("fw", ""), ("bw", "_reverse")):
                extra[f"rnn_{i}.lstm.{theirs}{suffix}"] = torch.from_numpy(
                    np.array(rnn.pop(f"{ours}_{d}"), dtype=np.float32))
        if rnn:
            raise KeyError(f"tree does not match the module: extra rnn_{i} leaves {sorted(rnn)}")
    return _with_stats_from_flax(
        {"params": params, "batch_stats": tree.get("batch_stats", {})}, [],
        lambda: CRNN(n_classes, output_channel, hidden), extra)


def lpips_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX LPIPS variables → the port's LPIPS state dict: ``alex.conv{i}``
    → ``net.features.{0,3,6,8,10}``, the lin head ``lin{i}`` [C, 1] →
    ``lins.{i}.model.1.weight`` [1, C, 1, 1]."""
    p = dict(tree.get("params", tree))
    alex = p.pop("alex")
    rules = [(rf"^conv{i}\.", f"net.features.{j}.") for i, j in enumerate(ALEX_CONVS)]
    lins = {}
    for i in range(len(ALEX_CONVS)):
        w = np.array(p.pop(f"lin{i}"), dtype=np.float32)
        lins[f"lins.{i}.model.1.weight"] = torch.from_numpy(w.T.reshape(1, -1, 1, 1).copy())
    if p:
        raise KeyError(f"tree does not match the module: extra {sorted(p)}")
    expected = _expected_keys(LPIPS)
    sd = _translate(alex, rules, expected - set(lins))
    return {**sd, **lins}


# flax's RTMPose names → mmpose's: "stem_0" → "stem.0", "stage4_1" →
# "stage4.1", "blocks_2" → "blocks.2", "conv2_depthwise_conv" →
# "conv2.depthwise_conv", the head's Dense "mlp" → "mlp.1"
_RTMPOSE_NAMES = [(r"(^|\.)stem_(\d)\.", r"\1stem.\2."),
                  (r"(^|\.)(stage\d)_(\d)\.", r"\1\2.\3."),
                  (r"\.blocks_(\d+)\.", r".blocks.\1."),
                  (r"\.conv2_(depthwise_conv|pointwise_conv)\.", r".conv2.\1."),
                  (r"^head\.mlp\.", "head.mlp.1.")]


def rtmpose_from_flax(tree: Mapping, deepen: float = 1.0,
                      widen: float = 1.0) -> dict[str, torch.Tensor]:
    """JAX RTMPose variables ``{"params", "batch_stats"}`` → the port's
    RTMPose state dict (mmpose's names); the ScaleNorm gains, the GAU's
    gamma, beta and res_scale keep their shapes."""
    params = {k: dict(v) for k, v in tree["params"].items()}
    head = params["head"] = dict(params["head"])
    gau = head["gau"] = dict(head["gau"])
    as_t = lambda v: torch.from_numpy(np.array(v, dtype=np.float32))
    extra = {"head.mlp.0.g": as_t(head.pop("mlp_ln")["g"]),
             "head.gau.ln.g": as_t(gau.pop("ln")["g"]),
             "head.gau.res_scale.scale": as_t(gau.pop("res_scale"))}
    for name in ("gamma", "beta"):
        extra[f"head.gau.{name}"] = as_t(gau.pop(name))
    return _with_stats_from_flax({"params": params, "batch_stats": tree["batch_stats"]},
                                 _RTMPOSE_NAMES, lambda: RTMPose(deepen, widen), extra)


# legacy diffusers VAE attention names → the current ones the port uses
_LEGACY_VAE_ATTN = {".query.": ".to_q.", ".key.": ".to_k.", ".value.": ".to_v.",
                    ".proj_attn.": ".to_out.0."}


def native_state(family: str, raw) -> tuple[dict, dict]:
    """(state dict under the port's module names, metadata) from a loaded
    torch checkpoint of ``family`` (wav2lip, vae, musetalk-unet or whisper,
    whose modules carry the reference's names)."""
    if family == "whisper":
        # OpenAI whisper .pt: {"dims": ..., "model_state_dict": ...}; the
        # dims ride in the metadata (whisper-tiny's when the file has none)
        fields = WhisperDims.__dataclass_fields__
        dims = WhisperDims(**{k: v for k, v in (raw.get("dims") or {}).items() if k in fields})
        return dict(raw.get("model_state_dict", raw)), {"dims": dataclasses.asdict(dims)}
    sd = raw.get("state_dict", raw)
    if family == "wav2lip":
        from mere_fusion_tpu_torch.utils.torch_convert import convert_wav2lip

        return convert_wav2lip(sd), {}
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    if family == "vae":
        renamed = {}
        for k, v in sd.items():
            if ".mid_block.attentions." in k:
                for old, new in _LEGACY_VAE_ATTN.items():
                    k = k.replace(old, new)
            renamed[k] = v
        sd = renamed
    return sd, {}


# the face-attribute families' class counts (None: EmotionNet)
FACE_CLASSES = {"face-age": 101, "face-gender": 2, "face-race": 6, "face-emotion": None}


def _numpy_leaves(tree):
    """``tree`` with torch tensors (an orbax tree's bfloat16 leaves) as
    float32 numpy arrays, which every bfloat16 value is exactly."""
    if isinstance(tree, Mapping):
        return {k: _numpy_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_leaves(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def state_from_flax(family: str, tree: Mapping, meta: Mapping | None = None, *,
                    unet_config: UNetConfig | None = None) -> dict[str, torch.Tensor]:
    """A family of the converter CLI, its JAX tree (an orbax directory's, as
    ``restore_orbax_raw`` returns it) → the port's state dict, by the
    family's ``*_from_flax``. Each family's configuration comes from:

    - vae: the tree's shapes; musetalk-unet: ``unet_config`` (default
      UNetConfig()); whisper: ``meta["dims"]`` (family.json's; default
      whisper-tiny), the full model under OpenAI's names; yolo: none, its
      names are translated unchecked and ``build_yolo``'s strict load
      checks them against the model's scale; face-*: the class count the
      family names; the others' names do not depend on their widths;
    - ernerf: a converted tree (``params``, optionally ``density``) or a
      JAX training workspace (``NeRFTrainState``: its EMA parameters and
      density grid are served), through ``split_checkpoint_tree``;
      the density grid, when there is one, joins the state dict as
      ``density.grid``, ``density.occupancy`` and ``density.mean_density``.
    """
    tree = _numpy_leaves(tree)
    meta = meta or {}
    simple = {"wav2lip": wav2lip_from_flax, "wav2lip-disc": wav2lip_disc_from_flax,
              "syncnet": syncnet_from_flax, "vae": vae_from_flax, "s3fd": s3fd_from_flax,
              "bisenet": bisenet_from_flax, "fan": fan_from_flax, "craft": craft_from_flax,
              "crnn": crnn_from_flax, "rtmpose": rtmpose_from_flax}
    if family in simple:
        return simple[family](tree)
    if family == "musetalk-unet":
        return unet_from_flax(tree, unet_config or UNetConfig())
    if family == "whisper":
        fields = WhisperDims.__dataclass_fields__
        dims = WhisperDims(**{k: v for k, v in (meta.get("dims") or {}).items() if k in fields})
        return whisper_from_flax(tree, dims)
    if family == "yolo":
        return _with_stats_from_flax(tree, _INDEX_NAMES, None)
    if family in FACE_CLASSES:
        return face_attrs_from_flax(tree, FACE_CLASSES[family])
    if family == "ernerf":
        params, density = split_checkpoint_tree(tree)
        state = ernerf_from_flax(params)
        if density is not None:
            state.update(density_state(density))
        return state
    raise ValueError(f"unknown family {family!r}")


def density_state(density: DensityGrid) -> dict[str, torch.Tensor]:
    """A DensityGrid as the state dict entries ``density.<field>``."""
    return {f"density.{k}": getattr(density, k) for k in ("grid", "occupancy", "mean_density")}


def split_density(state: Mapping) -> tuple[dict, DensityGrid | None]:
    """(the network's entries, the DensityGrid of the ``density.*`` ones, or
    None when there are none) of an ernerf state dict."""
    net = {k: v for k, v in state.items() if not k.startswith("density.")}
    fields = {k[len("density."):]: v for k, v in state.items() if k.startswith("density.")}
    return net, DensityGrid(**fields) if fields else None
