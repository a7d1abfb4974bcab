"""Input pipelines of the port (``repro.data``'s point clouds)."""
