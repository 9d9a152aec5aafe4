"""bvsb_roofline_pct (%), kernels: over the traced slice, the least time
its BvSB calls could take (``counts.bvsb_work``: one call a batch over the
last position's logits, (batch, vocabulary) float32), over the device time
of the program's BvSB kernels in the trace."""
KERNELS = ("bvsb_chunk_kernel", "bvsb_merge_kernel")


def read(run):
    if not run.trace or not run.slice_batches:
        return None
    device_s = sum(dur for name, _, dur in run.trace["ops"]
                   if any(k in name for k in KERNELS)) * 1e-6
    if device_s <= 0:
        return None
    bound = sum(run.counts.bvsb_work(len(b.keys), run.config["vocab_size"])
                .bound_s() for b in run.slice_batches)
    return 100.0 * bound / device_s
