"""Device time of the convolution category (benchmark/trace.py) a traced
step."""


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    return 1e3 * tr["by_category_s"].get("convolution", 0.0) / tr["steps"]
