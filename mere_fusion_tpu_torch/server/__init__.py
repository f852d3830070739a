"""Session manager + aiohttp API."""

from mere_fusion_tpu_torch.server.app import create_app  # noqa: F401
from mere_fusion_tpu_torch.server.sessions import Session, SessionManager  # noqa: F401
