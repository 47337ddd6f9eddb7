"""host_us_per_batch: the host's time to issue one batch (the wire's H2D,
the step's launches, the results' D2H), by the host's clock, mean over
the window's batches issued once the profiler had stopped."""


def read(run):
    return run.issue_us
