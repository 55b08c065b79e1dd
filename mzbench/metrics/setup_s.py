"""setup_s: seconds from the process's start to the window's (imports,
the card, the kernels' load or build, the inputs, warm-up)."""


def read(run):
    return run.setup_s
