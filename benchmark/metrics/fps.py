"""Frames rendered in the window over the window, host clock (less the
time the harness takes to copy the sampled answers to host memory)."""

UNIT = "frames/s"


def read(run):
    return run.frames / run.window_s
