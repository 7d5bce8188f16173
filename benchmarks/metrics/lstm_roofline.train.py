"""Kernels #1-#4 (the LSTM recurrence) against their roofline over the
profiled cycle: the least time their launches could take over the time the
profiler saw them run, in percent."""


def read(r):
    c = r.cycle
    return None if c is None or c["missed"] else r.roofline("lstm")
