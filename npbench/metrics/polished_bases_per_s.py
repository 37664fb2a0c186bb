"""Draft bases of every job completed in the window over the time from
the window's start to the end of its last job (all the work over all the
time, so a stall shows)."""


def read(ctx):
    return ctx["bases"] / ctx["window_s"]
