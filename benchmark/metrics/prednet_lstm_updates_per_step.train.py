"""convLSTM updates a traced step: the count of the program's
`prednet.lstm` spans, one a level a time step (read as
benchmark/metrics/_prednet_spans.py says). An invariant of the published
recurrence, not a number to lower: 4 levels x 10 steps read 40, and
fewer would mean part of the recurrence was skipped."""

from benchmark.metrics._prednet_spans import count_per_step


def read(run):
    return count_per_step(run, "prednet.lstm")
