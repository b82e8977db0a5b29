"""The port's training step counted by ``repro_torch.analysis.step_stats``
against ``repro.analysis.hlo_stats.analyze_hlo`` of the reference's
compiled step (train step with AdamW, smoke configs, B 2 x T 64, float32
activations), under remat "none" and "full".  This file stands apart
from ``tests/test_torch_dryrun.py`` so that its twenty reference compiles
run beside the rest of the suite.

Eight configs count exactly the same FLOPs.  mamba2-1.3b and zamba2-1.2b
differ by two named terms a Mamba-2 layer, worked out below, and by
nothing else:

* the depthwise conv's gradient.  XLA's CPU HLO computes the weight
  gradient as a dense (k, C, C) convolution over a window of T, which
  ``hlo_stats`` prices 2 T k C^2, and the input gradient over the
  padded T + k - 1 positions; the port counts what each gradient needs,
  2 B T k C (as the forward);
* the SSD scan's gradient.  The reference's ``lax.scan`` transposes every
  chunk alike; autograd through the port's plain version skips chunk
  0's state gradient (its state is zeros) and the last chunk's state
  update (the final state does not reach the loss): three products of
  2 B L H P N fewer.
"""
import pytest
import torch

from repro_torch.configs import smoke_config
from test_torch_dryrun import ARCHS, B, T, port_stats, ref_flops


def named_terms(arch: str) -> int:
    """What the reference counts beyond the port at B x T."""
    cfg = smoke_config(arch)
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    s = cfg.ssm
    k = s.d_conv
    C = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    conv = (2 * T * k * C * C + 2 * k * B * (T + k - 1) * C
            - 2 * (2 * k * B * T * C))
    L = min(s.chunk, T)
    scan = 3 * 2 * B * L * s.n_ssm_heads(cfg.d_model) * s.head_dim \
        * s.d_state
    return cfg.n_layers * (conv + scan)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_flops_equal_analyze_hlo(arch, remat):
    got = port_stats(arch, "train", "cpu", remat)
    assert got.flops == ref_flops(arch, "train", remat) - named_terms(arch)
    # each of the conv's two gradients costs one forward pass
    passes = 2 if remat == "full" else 1        # the forward recomputed
    assert (passes * got.flops_by_op.get("aten.convolution_backward", 0)
            == 2 * got.flops_by_op.get("aten.convolution", 0))


def test_the_terms_are_what_they_say():
    """mamba2-1.3b's terms at B 2 x T 64: the conv's 3,198,720 and the
    scan's 98,304 a layer, 2 layers."""
    assert named_terms("mamba2-1.3b") == 2 * (3_198_720 + 98_304)
    assert named_terms("stablelm-1.6b") == 0


def test_ssd_backward_formulations_at_mamba2s_training_shape():
    """The SSD gradient's products per call at 13h's microbatch (B 4, T
    4,096, H 64, P 64, N 128, chunks of 128), counted on meta tensors:
    autograd through the plain version (the dry run's count, 1.7019e11);
    the reference's scan transposed whole (3 products of 2 B L H P N
    more, 1.7180e11); the explicit formulas of ``ssd_chunked_bwd``, which
    ``ssd_bwd.cu`` computes (3 C B^T-sized, 2 intra-sized and 4 state-sized
    products a chunk, 2.0616e11), besides a forward pass over the chunk
    states that the card takes from its forward instead."""
    from repro_torch.analysis import step_stats
    from repro_torch.kernels.ssd.ref import (ssd_chunked_bwd,
                                             ssd_chunked_flops)
    Bb, T_, H, P, G, N, L = 4, 4096, 64, 64, 1, 128, 128
    n = T_ // L
    u, s, w = (2 * Bb * L * H * P * N, 2 * Bb * L * L * H * N,
               2 * Bb * L * L * H * P)

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    bf = torch.bfloat16
    with step_stats() as stats:
        ssd_chunked_bwd(meta(Bb, T_, H, P, dtype=bf), meta(Bb, T_, H),
                        meta(H), meta(Bb, T_, G, N, dtype=bf),
                        meta(Bb, T_, G, N, dtype=bf), L, None,
                        meta(Bb, T_, H, P), None)
    autograd = ssd_chunked_flops(Bb, T_, H, P, N, L,
                                 grads=(True,) * 5 + (False,))
    assert autograd == n * (2 * s + 2 * w) + (4 * n - 3) * u \
        == 170_188_079_104
    assert autograd + 3 * u == 171_798_691_840
    assert stats.flops == n * (3 * s + 2 * w + 4 * u) + n * u \
        == 206_158_430_208 + 17_179_869_184
