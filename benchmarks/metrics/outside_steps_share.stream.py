"""Share of the window outside the epochs' steps (dev passes, checkpoints,
the loop's own work, each call's staging and capture; in rounds the
turnovers): one less the program's epoch clocks over the window's wall
time, in percent."""


def read(r):
    return 100.0 * (1.0 - r.train_seconds / r.window_s)
