"""repro_torch — the PyTorch/CUDA port of the ε-private PIR serving stack.

Same sub-package and module names as the JAX reference package so a
reader finds the counterpart of every module (``repro_torch/db/packing.py``
mirrors the reference's ``db/packing.py``), PyTorch's idiom inside: plain
functions on tensors, frozen dataclasses holding tensors, an explicit
``device`` argument, explicit ``torch.Generator`` objects for randomness.

Device rule: every entry point takes ``device=None`` meaning ``cuda`` and
raises when there is no card; only a caller that passes ``device="cpu"``
gets the CPU (see :mod:`repro_torch._device`).

The GF(2) answer kernels are CUDA C++ under ``kernels/csrc`` built with
``nvcc`` at first use (:mod:`repro_torch.kernels._build`).
"""

__version__ = "0.1.0"
