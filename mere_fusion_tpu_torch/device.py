"""Device selection and seeded random initialisation.

Entry points of the port run on CUDA unless the caller passes a CPU device
(the CPU tests do). With no device given and no GPU present they raise:
a serving stack that silently drops to the CPU is a different product.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the current CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=torch.device('cpu') "
            "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def device_scope(device):
    """Make ``device`` the calling thread's current CUDA device (a thread's
    current device defaults to 0); a no-op for the CPU or None."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def parse_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


@torch.no_grad()
def random_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from a seeded torch.Generator on the module's
    device: weights N(0, 1/fan_in) (flax's lecun_normal), biases 0, norm
    scales 1. Works on modules materialised with ``to_empty``."""
    params = list(module.parameters())
    if not params:
        return module
    gen = torch.Generator(device=params[0].device).manual_seed(seed)
    for name, p in module.named_parameters():
        if p.ndim == 1:
            p.fill_(1.0 if _is_norm_scale(module, name) else 0.0)
        else:
            fan_in = p[0].numel()
            p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
    return module


def _is_norm_scale(root: nn.Module, name: str) -> bool:
    owner = root.get_submodule(name.rsplit(".", 1)[0]) if "." in name else root
    return (name.endswith("weight")
            and isinstance(owner, (nn.GroupNorm, nn.LayerNorm)))
