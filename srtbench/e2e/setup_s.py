"""Set-up: process start (the runner's first line) to the window's
start, in seconds (host clock)."""


def read(window):
    return window.setup_s
