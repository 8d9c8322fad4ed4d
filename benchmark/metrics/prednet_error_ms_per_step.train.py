"""Device time of the error units of the forward pass a traced step: the
spans of one level's A_hat, split error and pooled next target at one
time step (read as benchmark/metrics/_prednet_spans.py says)."""

from benchmark.metrics._prednet_spans import ms_per_step


def read(run):
    return ms_per_step(run, "prednet.error")
