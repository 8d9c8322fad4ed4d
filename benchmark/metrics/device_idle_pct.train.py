"""Share of the traced window in which no device row ran."""


def read(run):
    tr = run.get("trace")
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr else None
