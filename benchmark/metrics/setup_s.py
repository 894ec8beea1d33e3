"""Set-up: the process's start to the first timed request (imports,
weights, build, kernel load or build, warm-up of the cell's shapes)."""

UNIT = "s"


def read(run):
    return run.setup_s
