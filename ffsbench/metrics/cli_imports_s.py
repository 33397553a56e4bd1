"""From the CLI's spawn to the end of its imports (Python, torch, the
spotfinder), by the CLI process's own wall-clock stamp: the part of every
collection's start, and of the set-up, that only the program can shorten.
The profiler of a traced run starts after it, so it reads alike traced or
not."""


def read(run):
    return run.cli_imported_unix - run.unix_spawn if run.cli_imported_unix else None
