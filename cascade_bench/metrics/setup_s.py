"""setup_s (s): host-clock time from the process's start to the window's
opening: imports, the weights drawn and loaded, the tokens and streams
made, every bucket of the cell warmed, and any kernel build."""


def read(run):
    return run.setup_s
