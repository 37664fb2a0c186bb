"""chain_forward's share of its roofline: the least time the H100 could
take for the forward scans of every task-1 launch in the window
(npbench/roofline.py, from the cells and launches the program counted)
over the device time of the scan's kernels (base names beginning `fwd_`:
`fwd_scan`, or an earlier build's `fwd_chunks`/`fwd_up`/`fwd_down`/
`fwd_replay`).  The scan's one memset a launch (about 3 us of 1.6 ms)
cannot be told from other memsets by name and is left out."""
from npbench import roofline
from npbench.metrics import _buckets


def read(ctx):
    tr = ctx.get("trace")
    cells = _buckets.total(ctx, "task1.chain_cells")
    launches = _buckets.total(ctx, "task1.chain_launches")
    if tr is None or not cells or not launches:
        return None
    t = tr.kernel_seconds(lambda n: n.startswith("fwd_"))
    if t <= 0:
        return None
    least, _ = roofline.least_seconds(*roofline.chain_forward_work(
        int(launches), int(cells)))
    return 100.0 * least / t
