"""Segments trained a second over the window: every real segment of its
epochs over its wall time, dev passes and checkpoints inside."""


def read(r):
    return r.segments_per_s
