"""JAX param trees → the port's state dicts.

Inverse of the JAX package's ``utils/diffusers_convert.py::convert_vae`` /
``convert_musetalk_unet`` and ``utils/torch_convert.py::convert_whisper``,
plus the ER-NeRF head (``ernerf_from_flax``, whose names already match)
the Wav2Lip family (``wav2lip_from_flax``, ``wav2lip_disc_from_flax``,
``syncnet_from_flax``: ``{"params", "batch_stats"}`` onto the reference's
names, running statistics included) and the avatar preparation's face
models (``s3fd_from_flax``, ``fan_from_flax``, ``bisenet_from_flax``, onto
the reference's names with their running statistics):
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
raises KeyError.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from mere_fusion_tpu_torch.models.bisenet import BiSeNet
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork
from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
from mere_fusion_tpu_torch.models.fan import FAN
from mere_fusion_tpu_torch.models.musetalk.unet import UNet2DCondition, UNetConfig
from mere_fusion_tpu_torch.models.musetalk.vae import AutoencoderKL, VAEConfig
from mere_fusion_tpu_torch.models.s3fd import S3FD
from mere_fusion_tpu_torch.models.syncnet import SyncNet
from mere_fusion_tpu_torch.models.wav2lip import Wav2Lip, Wav2LipDisc
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
    return VAEConfig(
        in_channels=int(np.shape(enc["conv_in"]["kernel"])[2]),
        latent_channels=int(np.shape(p["post_quant_conv"]["kernel"])[-1]),
        block_out_channels=chans, layers_per_block=layers)


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


def ernerf_from_flax(tree: Mapping, cfg: NeRFNetConfig) -> dict[str, torch.Tensor]:
    """JAX NeRFNetwork variables → the port's NeRFNetwork state dict. The
    hash tables and individual codes are top-level leaves and keep their
    names; dense and conv kernels are transposed."""
    p = tree.get("params", tree)
    leaves = {k: v for k, v in p.items() if not isinstance(v, Mapping)}
    modules = {k: v for k, v in p.items() if isinstance(v, Mapping)}
    expected = _expected_keys(lambda: NeRFNetwork(cfg))
    sd = _translate(modules, [], expected - set(leaves))
    for name, value in leaves.items():
        if name not in expected:
            raise KeyError(f"tree does not match the module: extra {name!r}")
        sd[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return sd


def density_from_flax(density, device=None) -> DensityGrid:
    """The JAX package's DensityGrid (any object with ``grid``, ``occupancy``
    and ``mean_density`` arrays) → the port's."""
    return DensityGrid(
        grid=torch.from_numpy(np.array(density.grid, dtype=np.float32)).to(device),
        occupancy=torch.from_numpy(np.array(density.occupancy, dtype=bool)).to(device),
        mean_density=torch.tensor(float(np.asarray(density.mean_density)), device=device))


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


def _with_stats_from_flax(tree: Mapping, rules, build) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` → the state dict of ``build()``: leaves
    as in ``_translate``, each BatchNorm's ``mean``/``var`` →
    ``running_mean``/``running_var`` and a ``num_batches_tracked`` of 0."""
    tree = dict(tree)
    stats = _flatten(tree.pop("batch_stats", {}))
    sd = _translate(tree, rules, None)

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
