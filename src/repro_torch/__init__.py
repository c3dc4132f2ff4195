"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

The package mirrors ``repro``'s layout (``core/``, ``solvers/``,
``kernels/<name>/{ops,ref,…}.py``, ``runtime/``) so each module's JAX
counterpart sits at the same path.  It imports ``torch`` and numpy only —
never ``jax`` and nothing of ``repro``.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"`` (see ``_device.resolve_device``).
"""
