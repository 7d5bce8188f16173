"""Seconds a round's turnover takes (draw, materialise, stage, MAP init,
as the loop prints them), averaged over the window's rounds."""


def read(r):
    if not r.turnovers:
        return None
    return sum(sum(t.values()) for t in r.turnovers) / len(r.turnovers)
