"""Seconds from the process's start to the window: imports, the card,
the inputs, the containers the traffic reads, the warm-up passes."""


def read(run):
    return run.setup_s
