"""mel_front_pct.<cells>: the wall time of the program's mel front end (its
span `lws_torch.mel_to_linear`: the pseudo-inverse's projection and clamp,
launched from the host) as a share of the traced window. Nothing to read
without the program's span."""


def read(run):
    span = getattr(run.trace, "span_s", lambda name: None)("lws_torch.mel_to_linear")
    if span is None:
        return None
    return 100.0 * span / run.trace.window_s
