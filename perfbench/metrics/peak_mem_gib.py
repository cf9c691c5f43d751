"""Peak device memory of the window, GiB: ``torch.cuda.max_memory_allocated``
after ``reset_peak_memory_stats`` at the window's start."""


def read(ctx):
    return None if ctx.peak_window_bytes is None else ctx.peak_window_bytes / 2 ** 30
