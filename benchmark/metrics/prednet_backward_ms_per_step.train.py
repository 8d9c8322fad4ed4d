"""Device time of the backward pass a traced step: the span of the
gradients' call, through all the time steps (read as
benchmark/metrics/_prednet_spans.py says)."""

from benchmark.metrics._prednet_spans import ms_per_step


def read(run):
    return ms_per_step(run, "prednet.backward")
