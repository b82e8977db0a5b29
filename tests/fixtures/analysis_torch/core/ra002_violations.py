"""RA002 fixture (torch; estimator-plane scope: lives under a ``core/`` path).

Literal float32 casts in a policy module — the blr.predict class.
"""
import numpy as np
import torch


def bad_cast(x):
    return torch.as_tensor(x, torch.float32)    # line 10: RA002


def bad_to(x):
    return x.to(torch.float32)                  # line 14: RA002


def bad_method(x):
    return x.float()                            # line 18: RA002


def bad_kw(x):
    return torch.zeros((3,), dtype=torch.float32)   # line 22: RA002


def ok_policy(x, dt):
    return torch.as_tensor(x, dtype=dt)         # dtype from policy: clean


def ok_serialise(x):
    return torch.as_tensor(x, dtype=torch.float64)  # full width: clean


def bad_half(x):
    return x.half()                             # line 34: RA002


def bad_like(x):
    return torch.ones_like(x, dtype=torch.bfloat16)  # line 38: RA002


def bad_to_kw(x):
    return x.to(device=x.device, dtype=torch.half)   # line 42: RA002


def ok_double(x):
    return x.double()                           # float64: clean


def bad_numpy(x):
    return np.asarray(x, np.float32)            # line 50: RA002
