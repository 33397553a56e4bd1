"""Set-up: from the harness's start to the last warm-up line (the stream
made, the CLI spawned and warmed up on the traffic's first frames)."""


def read(run):
    return run.t0 - run.t_start
