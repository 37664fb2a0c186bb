"""Shared by the readers of the program's trace buckets
(nextpolish_tpu_torch/runtime/trace.py): a bucket's total over the
window, or None where the program added nothing to it."""


def total(ctx, name):
    b = ctx["buckets"].get(name)
    return None if b is None or not b["n"] else b["s"]


def per_mb(ctx, name):
    """A bucket's seconds per polished megabase."""
    v = total(ctx, name)
    return None if v is None else v / (ctx["bases"] / 1e6)
