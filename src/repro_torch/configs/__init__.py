"""Run configurations of the port (``repro.configs``' GSON entry)."""
