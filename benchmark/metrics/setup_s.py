"""Seconds from the harness's start to the first timed step: weights,
corpus, the program's state, the checked steps and the warm-up."""


def read(run):
    return run["setup_s"]
