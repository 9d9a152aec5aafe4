"""batch_fill_pct (%), engine: the mean samples a batch completed inside
the window, over the server profile's largest batch."""


def read(run):
    if not run.batches:
        return None
    mean = sum(len(b.keys) for b in run.batches) / len(run.batches)
    return 100.0 * mean / run.max_batch
