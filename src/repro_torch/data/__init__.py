"""Input pipelines of the port (``repro.data``): point clouds
(``pointclouds``) and the synthetic LM token stream (``tokens``)."""
