"""HD002 corpus: a tensor read back to the host in host code — the host
waits for the card."""
import torch


def read_threshold(values, device_id):
    arr = torch.as_tensor(values)
    # BUG: keep the value on the device, or read the whole vector once
    return float(arr[device_id])
