"""The whole step's share of the chip's peak: the model FLOPs of the
window's steps (benchmark/flops/<config>.py window_flops) over the
window's time times the configuration's peak FLOP/s."""


def read(run):
    return 100.0 * run["flops"] / (run["window_s"] * run["peak_flops_per_s"])
