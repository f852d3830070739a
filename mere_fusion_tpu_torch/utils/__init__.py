"""Small utilities of the port: checkpointing."""
