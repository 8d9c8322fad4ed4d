"""Device kernel rows in the traced window over its steps."""


def read(run):
    tr = run.get("trace")
    return tr["kernel_rows"] / tr["steps"] if tr else None
