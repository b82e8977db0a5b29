"""RA002 fixture (torch; models/ scope): products of mixed operand casts."""
import torch


def bad_mixed(h, w):
    return torch.einsum("btd,dv->btv", h.float(),
                        w.to(torch.bfloat16))   # line 6: RA002 fp32 x bf16


def bad_half_cast(h, w):
    return torch.einsum("btd,dv->btv",
                        h.float(), w)           # line 11: RA002 one uncast


def ok_consistent(h, w):
    return torch.einsum("btd,dv->btv", h.float(),
                        w.to(torch.float32))


def ok_variable_cast(h, w, dt):
    return torch.einsum("btd,dv->btv", h.to(dt), w.to(dt))


def bad_matmul(h, w):
    return torch.matmul(h.half(), w.float())    # line 25: RA002 fp16 x fp32


def bad_bmm(h, w):
    return torch.bmm(h.bfloat16(), w)           # line 29: RA002 one uncast


def ok_bmm(h, w):
    return torch.bmm(h.bfloat16(), w.to(dtype=torch.bfloat16))
