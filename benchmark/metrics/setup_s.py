"""setup_s: seconds from the process's start to the first timed request:
imports, the kernel library's load (its build on a checkout's first run),
the weights, the Scorer's set-up, the traffic, and the warm-up of every
shape the cell's traffic uses."""


def read(run):
    return run.setup_s
