"""Peak device memory of the run in GiB (torch.cuda.max_memory_allocated,
read before the reference runs)."""


def read(ctx):
    b = ctx["memory_peak_bytes"]
    return b / 2 ** 30 if b > 0 else None
