"""HD001 corpus: host data copied to the device inside a host loop — one
host-to-device copy an iteration (non-blocking, so no sync: HD001 alone)."""
import torch


def upload(rows, dev):
    out = []
    for row in rows:
        # BUG: stack the rows on the host and copy once
        out.append(torch.from_numpy(row).to(dev, non_blocking=True))
    return out
