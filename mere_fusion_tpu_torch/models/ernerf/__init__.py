"""ER-NeRF: audio-driven triplane NeRF talking head (the head, for serving and training)."""

from mere_fusion_tpu_torch.models.ernerf.network import (  # noqa: F401
    NeRFNetConfig,
    NeRFNetwork,
    init_ernerf_,
)
from mere_fusion_tpu_torch.models.ernerf.renderer import (  # noqa: F401
    DensityGrid,
    get_rays,
    intersect_aabb,
)
