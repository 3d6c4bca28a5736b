"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Each module mirrors the reference module at the same path under
``src/repro/``. The port imports ``torch`` and never ``jax`` or anything
of ``repro``. Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
