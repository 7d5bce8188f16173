"""Kernels #5/#6 (the discriminative term) against their roofline over the
profiled cycle, in percent."""


def read(r):
    c = r.cycle
    return None if c is None or c["missed"] else r.roofline("disc")
