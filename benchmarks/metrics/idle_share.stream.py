"""Share of the profiled epoch cycle in which no kernel or copy ran on
the card, in percent; nothing where the profiler's launches did not square
with the program's counters, or where no device operation was seen."""


def read(r):
    c = r.cycle
    if c is None or c["missed"] or c["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - c["busy_s"] / c["window_s"])
