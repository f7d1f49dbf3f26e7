"""Process start to the window's start: imports, the CUDA context, the
merge kernel's build or load, and the warm-up cluster."""

UNIT = "s"


def read(win):
    return win.setup_s
