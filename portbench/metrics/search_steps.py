"""search_steps: the DESA's blind-search steps a batch (the TLDT sample
search and K7: each search's longest walk, summed), the program's
``DESA.last_stats["steps"]`` after each batch, as a mean."""


def read(run):
    steps = run.counters.get("search_steps")
    return sum(steps) / len(steps) if steps else None
