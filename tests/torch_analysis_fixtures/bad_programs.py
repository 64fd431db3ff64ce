"""Known-bad fixture programs of the graph audit, one per rule: importable
and traced by tests/test_torch_analysis.py (on zeros and under fake
tensors).  Each takes the tensors ``inputs(bucket)`` makes."""

import torch

_calls = [0]


def inputs(bucket: int, device: str = "cpu"):
    return [torch.zeros((bucket, 50), device=device), torch.zeros((bucket, 2, 50), device=device)]


def host_read(a, b):
    """Reads a value on the host: a graph capture refuses it."""
    top = a.max().item()  # VIOLATION: torch-host-sync
    return a + top


def host_list(a, b):
    """Reads a row's digits on the host as a list."""
    digits = a[0].tolist()  # VIOLATION: torch-host-sync
    return a + digits[0]


def host_array(a, b):
    """Reads the digits on the host as an array."""
    top = b.numpy().max()  # VIOLATION: torch-host-sync
    return a + float(top)


def data_branch(a, b):
    """Branches on a tensor's value."""
    if a.sum() > 0:  # VIOLATION: torch-host-sync
        return a + 1
    return a


def wide_digits(a, b):
    """Digits widened past float32 and int32."""
    w = a.double()  # VIOLATION: torch-wide-dtype
    i = a.to(torch.int64)  # VIOLATION: torch-wide-dtype
    return w.float() + i.float()


def digit_matmul(a, b):
    """A matrix product of digit rows."""
    return a @ a.T  # VIOLATION: torch-matmul-in-program


def unstable(a, b):
    """A constant that changes from one trace to the next (torch-unstable-program)."""
    _calls[0] += 1
    return a + torch.full((_calls[0], 50), 1.0, device=a.device).sum(0)


def clean(a, b):
    """The glue of a program: adds, selects, a reshape, no sync."""
    s = a + b.sum(-2)
    return torch.where(s > 0, s, a).reshape(a.shape)


def local_body_reading_another_shard(s, mine, other):
    """A shard's local body that reads the other shard's input."""
    return mine[0] + other[0]  # VIOLATION: torch-sharded-entry


def local_body(s, mine, other):
    return mine[0] * 2
