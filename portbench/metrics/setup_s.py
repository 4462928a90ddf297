"""Set-up: the program's loading, the cell's draw and layout, and warming
every shape the window uses, on the host's clock."""


def read(run):
    return run.setup_s
