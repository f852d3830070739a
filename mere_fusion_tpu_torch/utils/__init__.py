"""Small utilities of the port: checkpoints of its training state and the
reference ER-NeRF checkpoint converter."""
