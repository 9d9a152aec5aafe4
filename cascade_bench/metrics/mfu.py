"""mfu (%), model step: the FLOPs classification needs for the batches
completed inside the window (``counts.classify_flops``: the trunk over
every token, the head at each sample's last position), over the window's
host-clock seconds times the H100's FP32 peak (67 TFLOP/s, data sheet)."""


def read(run):
    if not run.batches:
        return None
    c = run.counts
    flops = sum(c.classify_flops(run.config, len(b.keys), run.length)
                for b in run.batches)
    return 100.0 * flops / ((run.t_end - run.t_start) * c.FP32_FLOPS)
