"""RA000 fixture (torch): justified vs bare vs unknown-rule suppressions."""
import torch


@torch.compile
def justified(x):
    print(x)  # repro_torch: ignore[RA001] -- trace-time debug aid, fires once by design
    return x


@torch.compile
def bare(x):
    print(x)  # repro_torch: ignore[RA001]
    return x                           # line 13 comment: RA000 (no why)


@torch.compile
def unknown_rule(x):
    print(x)  # repro_torch: ignore[RA999] -- this rule id does not exist anywhere
    return x                           # RA000 unknown rule + RA001 unsuppressed


@torch.compile
def line_above(x):
    # repro_torch: ignore[RA001] -- suppression on the preceding line also binds here
    print(x)
    return x


@torch.compile
def other_marker(x):
    print(x)  # repro: ignore[RA001] -- the JAX package's marker binds nothing here
    return x
