"""flash_roofline_pct (%), kernels: over the traced slice, the least time
its flash attention calls could take (``counts.flash_work``: one call a
layer a batch at (batch, L, L, heads, KV heads, head dim), float32), over
the device time of the program's flash kernels in the trace."""
KERNELS = ("flash_tc_kernel", "flash_fma_kernel")


def read(run):
    if not run.trace or not run.slice_batches:
        return None
    device_s = sum(dur for name, _, dur in run.trace["ops"]
                   if any(k in name for k in KERNELS)) * 1e-6
    if device_s <= 0:
        return None
    cfg, c, n = run.config, run.counts, run.length
    bound = sum(cfg["num_layers"] * c.flash_work(
        len(b.keys), n, n, cfg["num_heads"], cfg["num_kv_heads"],
        cfg["head_dim"]).bound_s() for b in run.slice_batches)
    return 100.0 * bound / device_s
