"""Graph datasets of the port (synthetic samples only, in this slice)."""
