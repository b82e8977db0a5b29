"""RA001 fixture (torch): the fused-tick seed list (`_SEED_TRACED`).

These defs carry NO visible capture or autograd plumbing — they are
traced purely by the seed-list contract (the real tick is captured into
a CUDA graph behind an engine object).  Line numbers are asserted
exactly in tests/test_torch_lint.py — append new cases at the end or
renumber the expectations.
"""
import torch

TICK_LOG = []
CACHE = {}


def _tick_core(state, obs):
    print("ticking", obs)          # line 16: RA001 print in seeded kernel
    return state


def tick_step(state, obs):
    TICK_LOG.append(obs)           # line 21: RA001 captured mutation
    return _helper(state, obs)


def _helper(state, obs):
    # transitively traced: called by name from seeded `tick_step`
    return float(obs) + 1.0        # line 27: RA001 float() on traced param


def fleet_tick_step(fleet, obs):
    CACHE.update(last=obs)         # line 31: RA001 captured-dict mutation
    return fleet


def plain_host_helper(obs):
    # negative control: NOT seeded, NOT called from a traced def —
    # host-side prints here are fine and must stay unflagged
    print("host summary", obs)
    return torch.as_tensor(obs)


def _stacked_tick_core(state, obs, slot):
    ws = torch.zeros((3, slot + 1), dtype=state.dtype)
    ws[:, :slot] = state           # store into a tensor: NOT flagged
    return _host_obs(obs), ws


def _host_obs(obs):
    return obs.detach().cpu()      # line 49: RA001 .cpu(), by the closure
