"""Seconds from process start to the window: import, weights, kernel load, warm-up."""


def read(run):
    return run.setup_s
