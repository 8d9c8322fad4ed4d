"""Device time of the convLSTM updates of the forward pass a traced step:
the spans of one level's R update at one time step, from the
concatenation and upsample to the new R (read as
benchmark/metrics/_prednet_spans.py says)."""

from benchmark.metrics._prednet_spans import ms_per_step


def read(run):
    return ms_per_step(run, "prednet.lstm")
