"""PyTorch/CUDA port of the SWIM membership simulator.

The JAX package ``scalecube_cluster_tpu`` is the reference; this package
runs the same protocol round with PyTorch tensors on an NVIDIA H100, with
the merge/timers step as a hand-written CUDA kernel
(``kernels/merge.py``, ``csrc/merge_timers.cu``).  Module names follow
the reference layout so each piece has an obvious counterpart.

The port imports ``torch``, numpy and the standard library only — never
``jax`` and never the reference package (``tests/test_torch_interop.py``
checks both).  Entry points run on ``device="cuda"`` unless the caller
asks for the CPU.

Slice covered: the focal and full-view shift-delivery round with the wide
carry and no optional planes (``models/swim.py`` docstring lists what
raises ``NotImplementedError``).
"""
