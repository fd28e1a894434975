"""From the process's start to the window's: loading the program, making
the inputs, building or loading the kernels and warming up."""


def read(run):
    return run.setup_s
