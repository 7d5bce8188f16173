"""Segments trained a second over a streamed window: every real segment of
its epochs over its wall time, chunk switches, dev passes and checkpoints
inside."""


def read(r):
    return r.segments_per_s
