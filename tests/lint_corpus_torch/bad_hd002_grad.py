"""HD002 corpus: a sync inside the arguments of ``torch.autograd.grad`` —
a call into autograd is host code like any other, not a traced context."""
import torch


def grads(params, x):
    loss = torch.sum(params["w"] * x)
    # BUG: .item() reads the loss back to the host before the backward
    return torch.autograd.grad(loss / loss.item(), list(params.values()))
