"""nextpolish_tpu_torch — the PyTorch/CUDA port of nextpolish_tpu.

The port mirrors the JAX package's module paths (``models/cns/device_dp.py``
here is the counterpart of ``nextpolish_tpu/models/cns/device_dp.py``) and
is held byte-equal to it by the ``tests/test_torch_*.py`` suite.  It imports
``torch`` and numpy, never ``jax`` and never ``nextpolish_tpu``: host code
that both packages need is kept here as its own copy.

The entry points are the run.cfg pipeline (``python -m
nextpolish_tpu_torch run.cfg``, ``pipeline.py``: the built-in mapper in
``align/`` and the polishing engines, round after round) and the two
workers (``worker2``, tasks 5/6; ``worker1 -t 1|2``).  Each device program
is a hand-written CUDA kernel beside its plain PyTorch version: the
engine-2 level scan (``csrc/level_scan.cu``), task 1's chain scans
(``csrc/chain_scan.cu``) and the aligner's banded DP and traceback
(``csrc/band_align.cu``).  Entry points run on ``cuda`` unless the caller
asks for ``cpu`` (``device.resolve_device``).
"""

__version__ = "0.1.0"
