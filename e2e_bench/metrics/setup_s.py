"""setup_s: seconds from the start of the process to the first measured
step (imports, card and kernel load, the recording, the program's set-up
and warm-up), by the host clock."""


def read(run):
    return run.setup_s
