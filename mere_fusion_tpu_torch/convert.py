"""JAX param trees → the port's state dicts.

Inverse of the JAX package's ``utils/diffusers_convert.py::convert_vae`` /
``convert_musetalk_unet`` and ``utils/torch_convert.py::convert_whisper``,
plus the ER-NeRF head (``ernerf_from_flax``, whose names already match):
a flax tree, given as nested dicts of numpy arrays, becomes a state dict
under diffusers (VAE, UNet) or OpenAI whisper (encoder) key names, which the
port's modules load with ``load_state_dict(strict=True)``. Layouts:

- Conv ``[kh, kw, in, out]`` → ``[out, in, kh, kw]`` (Conv1d ``[k, in, out]``
  → ``[out, in, k]``); Dense ``[in, out]`` → Linear ``[out, in]``;
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

from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork
from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
from mere_fusion_tpu_torch.models.musetalk.unet import UNet2DCondition, UNetConfig
from mere_fusion_tpu_torch.models.musetalk.vae import AutoencoderKL, VAEConfig
from mere_fusion_tpu_torch.models.whisper import AudioEncoder, WhisperDims, sinusoids

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
    if leaf == "bias":
        return path, value
    raise KeyError(f"unexpected flax leaf {path!r}")


def _translate(tree: Mapping, rules, expected: set[str]) -> dict[str, torch.Tensor]:
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    sd = {}
    for path, value in _flatten(tree).items():
        path = path + "."
        for pattern, repl in rules:
            path = re.sub(pattern, repl, path)
        key, value = _leaf(path[:-1], value)
        sd[key] = torch.from_numpy(np.ascontiguousarray(value))
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
