"""Dependency-free ``.env`` loading + API-key defaults for LLM adapters.

A copy of mere_fusion_tpu/utils/env.py.

The reference pulls API keys from a ``.env`` file via python-dotenv
(reference app.py:10, stream_openai_video.py:41) and then reads
``os.environ``; python-dotenv is absent in this image, so a minimal parser
provides the same contract (KEY=VALUE lines, ``#`` comments, optional
``export`` prefix and single/double quotes, existing environment wins
unless ``override=True``).
"""
from __future__ import annotations

import os


def load_dotenv(path: str = ".env", override: bool = False) -> dict:
    """Load ``path`` into ``os.environ``; returns the parsed mapping.

    Missing file is not an error (same as python-dotenv's default).
    """
    loaded: dict[str, str] = {}
    try:
        f = open(path, encoding="utf-8")
    except OSError:
        return loaded
    with f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            if line.startswith("export "):
                line = line[len("export "):]
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip()
            if not key:
                continue
            if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
                value = value[1:-1]
            else:
                # python-dotenv strips ` # trailing comment` from unquoted
                # values; match it so `KEY=val # prod` loads just `val`.
                for i, ch in enumerate(value):
                    if ch == "#" and i > 0 and value[i - 1] in " \t":
                        value = value[:i].rstrip()
                        break
            loaded[key] = value
            if override or key not in os.environ:
                os.environ[key] = value
    return loaded


def env_api_key(*names: str) -> str:
    """First non-empty value among the named environment variables."""
    for name in names:
        value = os.environ.get(name, "")
        if value:
            return value
    return ""
