"""Share of the profiled stretch's wall time in which no operation ran on the card, in %
(the union of the device operations' intervals against the stretch's host wall time)."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s() / run.window_s)
