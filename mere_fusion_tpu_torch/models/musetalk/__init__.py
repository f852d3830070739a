"""MuseTalk model family: AutoencoderKL (sd-vae-ft-mse), the audio-
conditioned UNet, and the positional encoding on whisper features."""

from mere_fusion_tpu_torch.models.musetalk.vae import AutoencoderKL, VAEConfig  # noqa: F401
from mere_fusion_tpu_torch.models.musetalk.unet import (  # noqa: F401
    MUSETALK_UNET,
    UNet2DCondition,
    UNetConfig,
    positional_encoding,
)
