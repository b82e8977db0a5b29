"""RA001 fixture (torch): host syncs and host-side effects on traced paths.

Line numbers are asserted exactly in tests/test_torch_lint.py —
append new cases at the end or renumber the expectations.
"""
import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import checkpoint

HISTORY = []


@torch.compile
def bad_print(x):
    print("tracing", x)            # line 15: RA001 print under trace
    return x * 2


@torch.compile(dynamic=False)
def bad_sync(x, n):
    y = x.sum()
    return float(y) + n            # not flagged: y is a local, not a param


@torch.compile
def bad_param_sync(x):
    return float(x) + 1.0          # line 27: RA001 float() on traced param


@torch.compile
def bad_item(x):
    return x.sum().item()          # line 32: RA001 .item() sync


@torch.compile
def bad_capture(x):
    HISTORY.append(x)              # line 37: RA001 captured-container mutation
    return x + 1


class Model(torch.nn.Module):
    @torch.compile
    def bad_attach(self, x):
        self.last = x              # line 44: RA001 attribute store on self
        return x


def outer(xs):
    def body(carry, x):
        print(carry)               # line 50: RA001 print in a checkpointed body
        return carry + x
    total = checkpoint(body, xs[0], xs, use_reentrant=False)
    return total


def fine_shapes(x):
    pass


@torch.compile
def ok_static_shape(x):
    return x.reshape(int(x.shape[0]), -1)   # shape read: NOT flagged


class Engine:
    def capture(self, graph, x, out):
        with torch.cuda.graph(graph):
            y = _core(x)
            self._pack(y, out)

    def _pack(self, y, out):
        out[:] = y                 # store into a tensor in a graph: NOT flagged
        return y.cpu()             # line 73: RA001 .cpu() in a captured method


def _core(x):
    n = x.nonzero()                # line 77: RA001 .nonzero() sizes from data
    return x.tolist() + [n]        # line 78: RA001 .tolist()


class Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.scale = 2.0            # attribute store on a parameter: NOT flagged
        torch.cuda.synchronize()   # line 85: RA001 synchronize
        return x * ctx.scale

    @staticmethod
    def backward(ctx, g):
        idx = torch.where(g > 0)   # line 90: RA001 one-argument torch.where
        ctx.stream.synchronize()   # line 91: RA001 .synchronize() on a stream
        return g.numpy()[idx]      # line 92: RA001 .numpy()


def batched(xs):
    return torch.vmap(_row)(xs)


def _row(x):
    return torch.where(x > 0, x, 0.0)       # three-argument where: NOT flagged


def remat(x):
    return torch.utils.checkpoint.checkpoint(_remat_body, x, use_reentrant=False)


def _remat_body(x):
    return x * x.max().item()      # line 108: RA001 .item() in a checkpointed def
