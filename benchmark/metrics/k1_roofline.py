"""K1's share of its roofline: the least time its traced launches could
take, their bytes (benchmark/peaks.py k1_bytes) at the HBM's bandwidth,
over their device time. Nothing when the capture ran no K1."""

from benchmark.peaks import H100

K1 = "gather_rows_scaled"


def read(run):
    tr = run.get("trace")
    if not tr or not tr["kernel_s"].get(K1) or K1 not in tr["work"]:
        return None
    bound_s = tr["work"][K1]["bytes"] / H100["hbm_bytes_per_s"]
    return 100.0 * bound_s / tr["kernel_s"][K1]
