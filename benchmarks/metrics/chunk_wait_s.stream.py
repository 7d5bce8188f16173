"""Seconds an epoch's chunk switches waited on the streamed tier: the host
for the filler thread's fill of the next chunk, plus the device for the
slot's copy before the chunk's first step, summed over the epoch's
switches and averaged over the window's epochs."""


def read(r):
    waits = getattr(r, "chunk_waits", None)
    if not waits:
        return None
    return sum(waits) / len(waits)
