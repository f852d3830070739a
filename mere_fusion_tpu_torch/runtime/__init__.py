"""Runtime services: metrics registry."""

from mere_fusion_tpu_torch.runtime.metrics import metrics, MetricsRegistry  # noqa: F401
