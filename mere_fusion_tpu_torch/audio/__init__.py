"""Audio feature extractors feeding the avatar models."""
