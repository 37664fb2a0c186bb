"""Built-in read mapper: minimizer seeding + chaining + banded extension
(port of nextpolish_tpu/align/).

Replaces the reference's vendored bwa mem / minimap2 subprocesses
(SURVEY.md §1 L1): host-side minimizer index and seed voting, batched
banded affine-gap alignment and its traceback on the device (extend.py,
two CUDA kernels), CIGAR assembly on the host.
"""
