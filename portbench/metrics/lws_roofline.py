"""lws_roofline.<cells>: the least time the card needs for the LWS work of
the traced calls (every stage, portbench/roofline), as a share of the
device's busy time over the traced window (every kernel, copy and set).
The suffix names the cells whose end-to-end metric it moves."""


def read(run):
    if run.trace is None or run.least_s is None:
        return None
    return 100.0 * run.least_s / run.trace.busy_s
