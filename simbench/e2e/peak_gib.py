"""The card's peak allocated memory over the window, after a reset at
its start: what bounds the cluster one card holds."""

UNIT = "GiB"


def read(win):
    return win.peak_bytes / 2 ** 30
