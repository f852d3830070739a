"""Triplane audio-conditioned NeRF network.

Port of mere_fusion_tpu/models/ernerf/network.py, itself the twin of the
public ER-NeRF NeRFNetwork (Fictionarry/ER-NeRF nerf_triplane/network.py):
three 2-D hash-grid encoders over the xy/yz/xz planes, AudioNet (conv1d
pyramid over 16 CTC frames), AudioAttNet (attention over 8 windows),
channel-attention MLPs for audio and eye, an exp-activated sigma MLP, an
SH-direction colour MLP and an uncertainty head.

Parameter names follow the JAX tree (``plane_xy``, ``audio_net.conv_0``,
``sigma_net.net_1`` ...) so ``convert.ernerf_from_flax`` is a rename plus
layout transposes. Only the head is ported: the torso net (``torso=True``)
raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from mere_fusion_tpu_torch.ops import hash_lookup
from mere_fusion_tpu_torch.ops.encoders import sh_encode
from mere_fusion_tpu_torch.ops.hashgrid import GridSpec

# Hash-encode implementation of encode_x (mirrors the JAX package's switch to
# its Pallas lookup):
#   "auto"  — K3 (ops/hash_lookup.triplane_encode): the CUDA kernels on the
#             card at every size (the encode kernel, which hashes the corners
#             itself), the plain version on the CPU
#   "plain" — the plain version on any device (the comparison path)
ENCODE_IMPL = "auto"


@dataclass(frozen=True)
class NeRFNetConfig:
    bound: float = 1.0
    audio_in_dim: int = 44           # esperanto CTC logits (29 deepspeech, 1024 hubert)
    audio_dim: int = 32
    att_window: int = 8              # temporal attention window count
    exp_eye: bool = True
    individual_dim: int = 4
    num_train_frames: int = 1        # size of the individual-code table
    num_levels: int = 12
    level_dim: int = 1
    base_resolution: int = 64
    log2_hashmap_size: int = 14
    desired_resolution: int = 512    # × bound at runtime
    torso: bool = False
    individual_dim_torso: int = 8
    torso_shrink: float = 0.8

    @property
    def plane_spec(self) -> GridSpec:
        return GridSpec(
            input_dim=2,
            num_levels=self.num_levels,
            level_dim=self.level_dim,
            base_resolution=self.base_resolution,
            log2_hashmap_size=self.log2_hashmap_size,
            desired_resolution=int(self.desired_resolution * self.bound),
        )

    @property
    def in_dim(self) -> int:
        return 3 * self.num_levels * self.level_dim  # triplane concat


class MLP(nn.Module):
    """Bias-free ReLU MLP with layers ``net_0`` .. ``net_{L-1}``."""

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for l in range(num_layers):
            i = dim_in if l == 0 else dim_hidden
            o = dim_out if l == num_layers - 1 else dim_hidden
            setattr(self, f"net_{l}", nn.Linear(i, o, bias=False))

    def layer(self, l: int) -> nn.Linear:
        return getattr(self, f"net_{l}")

    def forward(self, x):
        for l in range(self.num_layers):
            x = self.layer(l)(x)
            if l != self.num_layers - 1:
                x = F.relu(x)
        return x


class AudioNet(nn.Module):
    """16-frame CTC window [B, dim_in, 16] → [B, dim_aud] code."""

    def __init__(self, dim_in: int = 44, dim_aud: int = 32, win_size: int = 16):
        super().__init__()
        self.win_size = win_size
        chans = (dim_in, 32, 32, 64, 64)
        for i in range(4):
            setattr(self, f"conv_{i}",
                    nn.Conv1d(chans[i], chans[i + 1], 3, stride=2, padding=1))
        self.fc_0 = nn.Linear(64, 64)
        self.fc_1 = nn.Linear(64, dim_aud)

    def forward(self, x):
        half = self.win_size // 2
        h = x[:, :, 8 - half: 8 + half]
        for i in range(4):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), 0.02)
        h = h[:, :, 0]                                     # [B, 64]
        h = F.leaky_relu(self.fc_0(h), 0.02)
        return self.fc_1(h)


class AudioAttNet(nn.Module):
    """Temporal attention over a window of audio codes: [1, S, A] → [1, A]."""

    def __init__(self, dim_aud: int = 32, seq_len: int = 8):
        super().__init__()
        self.seq_len = seq_len
        chans = (dim_aud, 16, 8, 4, 2, 1)
        for i in range(5):
            setattr(self, f"conv_{i}", nn.Conv1d(chans[i], chans[i + 1], 3, padding=1))
        self.att = nn.Linear(seq_len, seq_len)

    def forward(self, x):
        h = x.transpose(1, 2)                              # [1, A, S]
        for i in range(5):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), 0.02)
        w = self.att(h.reshape(1, self.seq_len))
        w = torch.softmax(w, dim=1).reshape(1, self.seq_len, 1)
        return torch.sum(w * x, dim=1)


class NeRFNetwork(nn.Module):
    def __init__(self, cfg: NeRFNetConfig = NeRFNetConfig()):
        super().__init__()
        if cfg.torso:
            raise NotImplementedError(
                "the ER-NeRF torso net is not ported to the PyTorch package "
                "yet (ROADMAP: 'ER-NeRF torso')")
        self.cfg = cfg
        n = cfg.plane_spec.total_params
        self.plane_xy = nn.Parameter(torch.zeros(n, cfg.level_dim))
        self.plane_yz = nn.Parameter(torch.zeros(n, cfg.level_dim))
        self.plane_xz = nn.Parameter(torch.zeros(n, cfg.level_dim))
        self.audio_net = AudioNet(cfg.audio_in_dim, cfg.audio_dim)
        self.audio_att_net = AudioAttNet(cfg.audio_dim, cfg.att_window)
        d = cfg.in_dim
        self.eye_att_net = MLP(d, 1, 16, 2)
        # the eye scalar always enters the sigma net (the serving path
        # passes an eye area every frame)
        self.sigma_net = MLP(d + cfg.audio_dim + 1, 1 + 64, 64, 3)
        self.color_net = MLP(16 + 64 + cfg.individual_dim, 3, 64, 2)
        self.unc_net = MLP(d, 1, 32, 2)
        self.aud_ch_att_net = MLP(d, cfg.audio_dim, 64, 2)
        if cfg.individual_dim > 0:
            self.individual_codes = nn.Parameter(
                torch.zeros(cfg.num_train_frames, cfg.individual_dim))

    # ---- encoders -------------------------------------------------------------
    def encode_x(self, xyz):
        """[N, 3] in [−bound, bound] → triplane features [N, 3·L·C], all
        three planes in one K3 lookup (training and the density refresh;
        inference samples baked textures instead)."""
        return hash_lookup.triplane_encode(self.plane_xy, self.plane_yz, self.plane_xz, xyz,
                                           self.cfg.plane_spec, self.cfg.bound,
                                           impl=ENCODE_IMPL)

    def encode_audio(self, a):
        """[W, audio_in_dim, 16] windows → [1, audio_dim] attended code."""
        return self.audio_att_net(self.audio_net(a)[None])

    def individual_code(self, index: int):
        return self.individual_codes[index][None]

    # ---- heads ----------------------------------------------------------------
    def density(self, x, enc_a, e=None, enc_x=None):
        if enc_x is None:
            enc_x = self.encode_x(x)
        n = enc_x.shape[0]
        enc_a = enc_a.expand(n, enc_a.shape[-1])
        aud_ch_att = self.aud_ch_att_net(enc_x)
        enc_w = enc_a * aud_ch_att
        if e is not None:
            eye_att = torch.sigmoid(self.eye_att_net(enc_x))
            e_feat = e.expand(n, 1) * eye_att
            h = torch.cat([enc_x, enc_w, e_feat], dim=-1)
        else:
            eye_att = torch.zeros(n, 1, dtype=enc_x.dtype, device=enc_x.device)
            h = torch.cat([enc_x, enc_w], dim=-1)
        h = self.sigma_net(h)
        return {
            "sigma": torch.exp(h[..., 0]),
            "geo_feat": h[..., 1:],
            "ambient_aud": torch.linalg.norm(aud_ch_att, dim=-1, keepdim=True),
            "ambient_eye": eye_att,
        }

    def forward(self, x, d, enc_a, c=None, e=None, training: bool = False):
        """x [N,3], d [N,3] unit, enc_a [1,audio_dim], c [1,ind_dim], e [1,1].

        Returns (sigma [N], color [N,3], ambient_aud [N,1], ambient_eye [N,1],
        uncertainty [N,1])."""
        return self.forward_with_enc(self.encode_x(x), d, enc_a, c, e, training)

    def forward_with_enc(self, enc_x, d, enc_a, c=None, e=None, training: bool = False):
        dens = self.density(None, enc_a, e, enc_x)
        parts = [sh_encode(d, 4), dens["geo_feat"]]
        if c is not None:
            parts.append(c.expand(enc_x.shape[0], c.shape[-1]))
        h = self.color_net(torch.cat(parts, dim=-1))
        color = torch.sigmoid(h) * (1 + 2 * 0.001) - 0.001
        if training:
            unc = self.unc_net(enc_x.detach())
        else:
            unc = torch.zeros_like(dens["ambient_aud"])
        unc = torch.log1p(torch.exp(unc))
        return dens["sigma"], color, dens["ambient_aud"], dens["ambient_eye"], unc


@torch.no_grad()
def init_ernerf_(net: NeRFNetwork, seed: int) -> NeRFNetwork:
    """Seeded random weights on the network's device, as the JAX init draws
    them: hash tables U(−1e-4, 1e-4), dense and conv kernels N(0, 1/fan_in),
    biases 0, individual codes N(0, 0.1)."""
    gen = torch.Generator(device=net.plane_xy.device).manual_seed(seed)
    for name, p in net.named_parameters():
        if name.startswith("plane_"):
            p.uniform_(-1e-4, 1e-4, generator=gen)
        elif name == "individual_codes":
            p.normal_(0.0, 0.1, generator=gen)
        elif p.ndim == 1:
            p.zero_()
        else:
            p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=gen)
    return net
