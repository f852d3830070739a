"""Multi-session placement over the host's CUDA devices."""

from mere_fusion_tpu_torch.parallel.placement import DevicePlacer, cuda_devices  # noqa: F401
