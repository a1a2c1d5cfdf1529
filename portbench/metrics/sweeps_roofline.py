"""sweeps_roofline.<cells>: the least time of the LWS sweeps of the traced
calls (portbench/roofline, the work of the program span `lws_torch.run_lws`)
as a share of the device time of the operations launched from that span
(portbench/program_trace.py): the sweep kernel's share of its roofline,
whatever the kernels that do the work are named or however they are split.
Nothing to read without the program's span."""


def read(run):
    least = getattr(run.least_s, "by_span", {}).get("lws_torch.run_lws")
    launched = getattr(run.trace, "launched_s", lambda name: None)("lws_torch.run_lws")
    if least is None or not launched:
        return None
    return 100.0 * least / launched
