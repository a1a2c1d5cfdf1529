"""device_idle_pct.<cells>: the share of the traced window in which no
kernel, copy or set ran on the card. The suffix names the cells whose
end-to-end metric it moves; the reading is the same in each."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
