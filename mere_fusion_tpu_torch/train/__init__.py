"""Training of the port's models (ER-NeRF head stage)."""
