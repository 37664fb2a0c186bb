"""nextpolish_tpu_torch — the PyTorch/CUDA port of nextpolish_tpu.

The port mirrors the JAX package's module paths (``models/cns/device_dp.py``
here is the counterpart of ``nextpolish_tpu/models/cns/device_dp.py``) and
is held byte-equal to it by the ``tests/test_torch_*.py`` suite.  It imports
``torch`` and numpy, never ``jax`` and never ``nextpolish_tpu``: host code
that both packages need is kept here as its own copy.

Slice 1 covers long-read consensus (``worker2``, tasks 5/6).  Its device
hot loop, the engine-2 level scan, is two hand-written CUDA kernels, the
chain and the winners (``csrc/level_scan.cu``), beside their plain
PyTorch versions (``models/cns/level_scan.py``).  Entry points run on ``cuda`` unless the
caller asks for ``cpu`` (``device.resolve_device``).
"""

__version__ = "0.1.0"
