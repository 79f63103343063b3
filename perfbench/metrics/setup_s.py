"""Set-up seconds: from the harness's first line to the window's start
(imports, the kernels' build on a checkout's first run, the weights drawn,
the checked and warm-up steps)."""


def read(run):
    return run.setup_seconds
