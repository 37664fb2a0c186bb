"""Mean seconds a window waits in engine 2's batcher between its submit
and the dispatch that puts it in a launch group (the program's
`cns.queue` spans)."""
from npbench.metrics import _spans


def read(ctx):
    return _spans.mean_s("cns.queue")
