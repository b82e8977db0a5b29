"""A file none of the port's passes should flag."""
import torch


@torch.compile
def pure(x):
    return torch.tanh(x) * 2.0


def host_side(model, xs):
    results = []
    for x in xs:                 # host loop, mutation of a local: fine
        results.append(pure(x).cpu())
    print("done")                # print outside any traced region: fine
    return results
