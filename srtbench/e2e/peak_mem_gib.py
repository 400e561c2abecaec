"""Peak device memory over the window, reset at its start
(``torch.cuda.max_memory_allocated``; the largest rank's on four
cards), in GiB."""


def read(window):
    return window.peak_bytes / 2 ** 30
