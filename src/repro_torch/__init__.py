"""PyTorch + CUDA port of the ``repro`` serving stack for one NVIDIA H100.

Module names mirror ``src/repro/`` so each counterpart is easy to find.
The package imports ``torch`` and never ``jax`` or ``repro``.  Entry
points run on the card (``cuda``) unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version, because the tensors it is given lie on the CPU.
"""
