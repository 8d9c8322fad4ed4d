"""Device time of the elementwise and copy categories (benchmark/trace.py)
a traced step."""


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    cats = tr["by_category_s"]
    s = cats.get("elementwise", 0.0) + cats.get("copy", 0.0)
    return 1e3 * s / tr["steps"]
