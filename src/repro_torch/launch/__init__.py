"""``repro_torch.launch`` — the LM stack's step builders (``steps.py``)
and the device meshes over a ``torch.distributed`` group (``mesh.py``)."""
