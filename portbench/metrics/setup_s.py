"""setup_s: process start to the first timed step, in seconds."""


def read(run):
    return run.setup_s
