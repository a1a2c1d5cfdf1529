"""audio_s_per_s: seconds of audio resynthesised per wall second, all the
audio of every call completed over the time from the window's start to the
last completion (host clock)."""


def read(run):
    if not run.ends:
        return None
    return run.audio_s / (run.ends[-1] - run.t0)
