"""Mean host-clock time of the call into the program's step, before the
scalar fetch: what the host needs to enqueue a step (it includes any
wait for the device that the call itself makes)."""


def read(run):
    spans = run["dispatch_s"]
    return 1e3 * sum(spans) / len(spans)
