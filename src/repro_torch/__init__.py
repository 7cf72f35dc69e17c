"""DIPPM on PyTorch and CUDA — the port of ``repro`` for the NVIDIA H100.

Each module mirrors the file of the same name under ``repro``. The port
imports ``torch`` and numpy only: nothing of JAX and nothing of the JAX
package, which stays the reference that the port's tests hold it
against. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``, where every kernel takes its plain
PyTorch version.
"""
