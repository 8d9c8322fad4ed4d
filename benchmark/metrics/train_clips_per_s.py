"""Clips trained in the window over the window's whole time (host clock;
the time holds every step's scalar fetch)."""


def read(run):
    return run["items"] / run["window_s"]
