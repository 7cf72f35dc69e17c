"""The LM stack of the port (``repro.models``): configs, blocks, models."""
