"""Segments trained a second over a hierarchical window: every real
segment of its rounds over its wall time, turnovers, dev passes and
checkpoints inside."""


def read(r):
    return r.segments_per_s
