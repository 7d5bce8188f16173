"""Milliseconds a train step: the program's own epoch clock (its
``train_seconds``, the steps with their device work) over the window's
steps."""


def read(r):
    return 1e3 * r.train_seconds / r.steps if r.steps else None
