"""Model factory: ModelConfig -> {init, init_caches, loss, prefill, decode}.

Counterpart of ``repro.models.model``: the decoder-only families
(``transformer.py``: dense, vlm, moe, ssm, hybrid) and the encoder-decoder
(``encdec.py``).  ``prefill``/``decode`` update the caches they are given
in place and return them.

Serving on a mesh: ``prefill``/``decode`` with ``rules`` and ``mesh`` (the
JAX package's ``rules`` argument) take a rank's serving copies of the
weights (``serving_layouts``), its rows of the batch
(``launch.sharding.serve_rows``) and its cache slices (``init_caches``
with ``rules`` and ``mesh``), and return its rows' logits over its vocab
slice.  Rules with ``kv_seq`` over "model" split the KV caches by
sequence (context-parallel decode, ``layers.split_cache_attention``);
the calls then take the caches' ``max_len``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from .. import resolve_device
from . import encdec as _encdec
from . import transformer as _tf
from .common import (AxisRules, ModelConfig, ServingLayout, axes_of, is_def,
                     mesh_axis_sizes, rules_for_mesh,
                     serving_spec, ssm_head_columns, tree_defs_init,
                     tree_defs_to_abstract, tree_defs_to_specs)
from .moe import is_expert_leaf


def _map_paths(fn, defs, path=()):
    """``fn(path, leaf)`` over a def tree, in sorted key order."""
    if is_def(defs):
        return fn(path, defs)
    return {k: _map_paths(fn, defs[k], path + (k,)) for k in sorted(defs)}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_defs: Any

    def init(self, seed: int = 0, *, device=None) -> dict:
        """Random parameters from a ``torch.Generator`` seeded with
        ``seed``, on ``device`` (default: the CUDA card)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tree_defs_init(self.param_defs, gen, dev)

    def param_specs(self, rules: AxisRules):
        """The spec of each parameter (a tuple per leaf, one entry per
        dim), as the JAX package's ``PartitionSpec`` tree."""
        return tree_defs_to_specs(self.param_defs, rules)

    def abstract_params(self, mesh, rules: AxisRules):
        """Each parameter as ``common.Abstract``: a ``meta`` tensor of the
        global shape with its spec and one rank's local shape on
        ``mesh``."""
        return tree_defs_to_abstract(self.param_defs, mesh, rules)

    def cache_defs(self, batch: int, max_len: int, cross_len: int = 0,
                   cache_dtype=torch.bfloat16):
        if self.cfg.family == "encdec":
            return _encdec.encdec_cache_def(self.cfg, batch, max_len,
                                            cross_len or max_len, cache_dtype)
        return _tf.cache_def(self.cfg, batch, max_len, cache_dtype)

    def _model_rank(self, rules: AxisRules, mesh) -> tuple[int, int, bool]:
        """(tp, this rank's index along "model", whether the SSM heads
        are split over it)."""
        tp = mesh.shape.get("model", 1)
        index = mesh.index("model") if tp > 1 else 0
        ssm = self.cfg.ssm
        split = ssm is not None and tp > 1 and "model" in axes_of(
            rules.resolve("ssm_heads",
                          dims=(ssm.n_ssm_heads(self.cfg.d_model),))[0])
        return tp, index, split

    def serving_layouts(self, rules: AxisRules, mesh):
        """What a serving rank holds of each parameter
        (``common.ServingLayout``): the leaf's ``serving_spec`` (whole
        over the fsdp axes, its slice over "model"), but the MoE router
        and shared expert whole (only the expert leaves are split), and
        the Mamba-2 leaves by heads: the in_proj and conv columns
        ``ssm_head_columns``, the rest by their specs, or every one whole
        where the SSM heads do not split over "model"."""
        tp, index, ssm_split = self._model_rank(rules, mesh)

        def layout(path, d):
            whole = (None,) * len(d.shape)
            if "moe" in path and not is_expert_leaf(d):
                return ServingLayout(whole)
            if "mamba" in path:
                if not ssm_split:
                    return ServingLayout(whole)
                if path[-1] in ("in_proj", "conv_w", "conv_b"):
                    leaf = "in_proj" if path[-1] == "in_proj" else "conv"
                    return ServingLayout(
                        whole, ssm_head_columns(self.cfg, leaf, tp, index))
            return ServingLayout(serving_spec(d, rules))
        return _map_paths(layout, self.param_defs)

    def serving_cache_layouts(self, rules: AxisRules, mesh, batch: int,
                              max_len: int, cross_len: int = 0,
                              cache_dtype=torch.bfloat16):
        """What a serving rank holds of each cache leaf: its slice of
        ``cache_specs`` (rows over the dp axes where they divide, KV and
        SSM heads over "model"), but the conv window its columns [x_r | B
        | C] where the SSM heads are split (``ssm_head_columns``), whole
        along its channels where they are not."""
        tp, index, ssm_split = self._model_rank(rules, mesh)
        defs = self.cache_defs(batch, max_len, cross_len, cache_dtype)

        def layout(path, d):
            spec = d.spec(rules)
            if path[-1] != "conv":
                return ServingLayout(spec)
            cols = (ssm_head_columns(self.cfg, "conv", tp, index)
                    if ssm_split else None)
            return ServingLayout(spec[:-1] + (None,), cols)
        return _map_paths(layout, defs)

    def init_caches(self, batch: int, max_len: int, cross_len: int = 0, *,
                    cache_dtype=torch.bfloat16, device=None, rules=None,
                    mesh=None) -> dict:
        """Zeroed caches, updated in place by ``prefill`` and ``decode``.

        dense and vlm: {"blocks": {"k", "v": (L, B, Tmax, Hkv, hd)}} in
        ``cache_dtype``; ssm: {"blocks": {"conv": (L, B, k-1, conv_ch),
        "state": (L, B, H, P, N)}}, the window in ``cache_dtype`` and the
        state in float32, neither growing with ``max_len``; hybrid:
        {"blocks": {"ssm": {"conv", "state"} as (U, every, B, ...),
        "attn": {"k", "v": (U, B, Tmax, Hkv, hd)}}, "tail": {"conv",
        "state"} as (tail, B, ...)}: U super-units of ``every`` Mamba-2
        layers, each with its own KV cache for its application of the one
        shared attention block, and the tail's Mamba-2 layers (no "tail"
        where ``n_layers`` divides by ``every``); moe: {"blocks":
        {"moe_layer", "dense_{j}": {"k", "v"}}}, one cache per layer of a
        unit; encdec: {"self": {"k", "v": (dec_layers, B, Tmax, Hkv, hd)},
        "cross": the same at ``cross_len`` positions (0: ``max_len``, as
        the JAX package)}.

        With ``mesh`` (and ``rules``, default ``rules_for_mesh``): this
        rank's serving slices of them (``serving_cache_layouts``) for a
        batch of ``batch`` rows."""
        dev = resolve_device(device)
        defs = self.cache_defs(batch, max_len, cross_len, cache_dtype)
        if mesh is None:
            return tree_defs_init(defs, None, dev)
        layouts = self.serving_cache_layouts(
            rules or rules_for_mesh(mesh), mesh, batch, max_len, cross_len,
            cache_dtype)
        sizes = mesh_axis_sizes(mesh)

        def zeros(path, d):
            lay = _index_path(layouts, path)
            return torch.zeros(lay.local_shape(d.shape, sizes),
                               dtype=d.dtype, device=dev)
        return _map_paths(zeros, defs)

    def cache_specs(self, rules: AxisRules, batch: int, max_len: int,
                    cross_len: int = 0, cache_dtype=torch.bfloat16):
        defs = self.cache_defs(batch, max_len, cross_len, cache_dtype)
        return tree_defs_to_specs(defs, rules)

    def abstract_caches(self, mesh, rules: AxisRules, batch: int,
                        max_len: int, cross_len: int = 0,
                        cache_dtype=torch.bfloat16):
        defs = self.cache_defs(batch, max_len, cross_len, cache_dtype)
        return tree_defs_to_abstract(defs, mesh, rules)

    def loss(self, params, batch: dict, *, count=None, rules=None,
             mesh=None):
        """(loss, {"xent", "aux"}): ``encdec_loss`` or ``lm_loss``.
        ``count``: the token count the summed xent is divided by (default:
        this batch's ``sum(mask)``); a sharded step passes the count of
        the global batch and its ``rules`` and ``mesh`` (the MoE layers'
        groups and experts, ``moe.apply_moe``), so that the ranks' losses,
        xents and aux losses sum to the batch's over the dp axes.  On a
        mesh the leaves are a training rank's (``serving_layouts``): the
        layers split over "model" where a leaf holds its slice."""
        from repro_torch.launch.sharding import train_axis
        tp = None if mesh is None else train_axis(mesh)
        if self.cfg.family == "encdec":
            return _encdec.encdec_loss(params, self.cfg, batch, count=count,
                                       tp=tp)
        return _tf.lm_loss(params, self.cfg, batch, count=count, rules=rules,
                           mesh=mesh, tp=tp)

    def serving_axis(self, rules, mesh, max_len: int | None = None):
        """A serving rank's "model" axis (``launch.sharding.model_axis``:
        with ``seq``, whether caches of ``max_len`` positions are split by
        sequence).  The encoder-decoder refuses rules that put the KV
        cache's sequence over "model"."""
        from repro_torch.launch.sharding import model_axis
        tp = model_axis(mesh, rules, max_len)
        if self.cfg.family == "encdec" and tp.seq is not False:
            raise NotImplementedError(
                f"{self.cfg.arch}: its self and cross caches under kv_seq "
                "over \"model\" (ROADMAP.md, \"Configurations the port "
                "does not yet run\": context-parallel decode of the "
                "encoder-decoder); its KV heads divide over \"model\", so "
                "serve it with the default kv_seq rule")
        return tp

    def _serving(self, rules, mesh, rows, max_len=None) -> dict:
        """The keywords of a serving rank's forward: its "model" axis
        (``serving_axis``) and, for the MoE layers, the rules with the dp
        axes its rows are split over (``rows``, a
        ``launch.sharding.Rows``; default: the mesh's dp axes) and the
        mesh."""
        from repro_torch.launch.sharding import dp_axes
        rules = rules or rules_for_mesh(mesh)
        kw = {"tp": self.serving_axis(rules, mesh, max_len)}
        if self.cfg.moe is not None:
            axes = dp_axes(mesh, rules) if rows is None else rows.axes
            kw.update(rules=dataclasses.replace(rules, dp_axes=axes),
                      mesh=mesh)
        return kw

    def prefill(self, params, batch: dict, caches, rules=None, mesh=None,
                rows=None, max_len=None):
        """Last-position logits and the filled caches.  With ``mesh``: a
        serving rank's (module docstring; ``rows`` the batch's
        ``launch.sharding.Rows``, ``max_len`` the positions the caches
        were made for, which says whether rules with ``kv_seq`` over
        "model" split them)."""
        kw = {} if mesh is None else self._serving(rules, mesh, rows,
                                                   max_len)
        if self.cfg.family == "encdec":
            return _encdec.encdec_prefill(params, self.cfg, batch, caches,
                                          tp=kw.get("tp"))
        return _tf.lm_prefill(params, self.cfg, batch, caches, **kw)

    def decode(self, params, batch: dict, caches, cache_index: int,
               rules=None, mesh=None, rows=None, max_len=None):
        kw = {} if mesh is None else self._serving(rules, mesh, rows,
                                                   max_len)
        if self.cfg.family == "encdec":
            return _encdec.encdec_decode(params, self.cfg, batch, caches,
                                         cache_index, tp=kw.get("tp"))
        return _tf.lm_decode(params, self.cfg, batch, caches, cache_index,
                             **kw)


def _index_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def build_model(cfg: ModelConfig) -> Model:
    defs = (_encdec.encdec_def(cfg) if cfg.family == "encdec"
            else _tf.lm_def(cfg))
    return Model(cfg=cfg, param_defs=defs)
