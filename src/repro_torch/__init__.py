"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The layout mirrors ``src/repro/``: ``models/`` holds the layers and the
decoder LM, ``kernels/`` the hand-written Hopper kernels with their plain
PyTorch versions, ``serving/`` the paged continuous-batching engine and
``launch/serve.py`` its command line.  The package imports ``torch`` and
nothing of ``jax``, ``repro`` or ``triton``: every kernel is CUDA C++ under
``csrc/``, built with ``nvcc`` at first use (``kernels/_build.py``).

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when it is not available: nothing falls back to the CPU unless the caller
asks for it (``repro_torch/device.py``).
"""
