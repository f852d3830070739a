"""PyTorch model definitions (whisper encoder, MuseTalk)."""
