"""Set-up seconds: from the process start to the window's start (imports,
the corpus, the weights, the kernels' build on a checkout's first run, the
first steps and the warm-up epoch)."""


def read(r):
    return r.setup_s
