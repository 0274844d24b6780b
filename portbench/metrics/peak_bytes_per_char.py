"""peak_bytes_per_char: ``torch.cuda.max_memory_allocated()`` over the
whole run (set-up and window) over the text's n characters."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / run.facts["n"]
