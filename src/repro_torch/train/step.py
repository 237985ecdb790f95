"""LM train and serve steps (port of ``repro/train/step.py``).

The reference wires its steps with ``pjit`` shardings resolved from the
logical-axis rules. Here the steps are plain functions. The serving builders
(:func:`make_prefill`, :func:`make_decode_step`) take an optional mesh: with
one they run under ``use_rules(rules, mesh)`` and an ``spmd_region`` on the
rank's shards and also return the placements (``model.param_shardings``,
:func:`batch_shardings`). :func:`state_sharding_for_leaf` and
:func:`decode_state_shardings` place the decode state.

:func:`make_train_step` with a mesh is the reference's ``pjit`` step under
``TRAIN_RULES`` made explicit on each rank. The trainable leaves and their
AdamW moments are stored at ``specs_to_shardings`` (ZeRO-3: ``fsdp`` over
``data``, the tensor-parallel dims over ``model``); each leaf is all-gathered
into the placement the forward reads (``model.param_shardings``), the
gather's backward being the reduce-scatter that sums the ``data`` ranks'
gradients; a leaf not split over a batch axis has its gradient summed over
it (``collectives.sum_grad``). The batch is global on every rank and the
loss the vocab-parallel cross-entropy (``model.train_loss`` on a mesh). The
update runs on the rank's shards (``optimizer.apply_updates`` with the
placements). With ``ocfg.grad_compress`` and a ``pod`` axis larger than 1 the
gradients cross the pods as int8 with error feedback
(``train.grad_compress``), ``ef`` carried in the optimizer state.

The train step takes the trainable half's gradients with autograd. The Phi
state (``phi_*``: int8 patterns, PWP banks, usage histograms) is frozen: it
is split off before the loss, never requires grad, gets no optimizer state
and is merged back uncopied. Under autograd every Phi GEMM resolves the
differentiable ``coo`` lowering (``autodiff_or_vmap``), the rate coding
takes the LIF loop, and attention at S > 1024 records
``autodiff_keeps_flash``: the reference's ``autodiff_region`` reads here as
the operands' ``requires_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.kernels import dispatch
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (and the entries at the same
    keys of ``rest``), keeping every (also empty) dict."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


# ----------------------------------------------------------- opt state specs
def opt_state_specs(param_specs: Any, ocfg: opt.OptConfig) -> dict:
    """ParamSpec tree for the optimizer state (so it shards like params)."""

    def m_spec(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, s.axes, torch.float32, init="zeros")

    def v_spec(s: ParamSpec):
        if ocfg.factored and len(s.shape) >= 2:
            return {
                "vr": ParamSpec(s.shape[:-1], s.axes[:-1], torch.float32, init="zeros"),
                "vc": ParamSpec(s.shape[:-2] + s.shape[-1:], s.axes[:-2] + s.axes[-1:],
                                torch.float32, init="zeros"),
            }
        return m_spec(s)

    out = {
        "step": ParamSpec((), (), torch.int32, init="zeros"),
        "m": _tree_map(m_spec, param_specs),
        "v": _tree_map(v_spec, param_specs),
    }
    if ocfg.grad_compress:  # error-feedback residual, replicated across pods
        out["ef"] = _tree_map(m_spec, param_specs)
    return out


# ------------------------------------------------------------------- steps
@dataclasses.dataclass
class StepBundle:
    """``fn(params, opt_state, batch) -> (params, opt_state, loss)``: one
    optimizer step, functional (the inputs are not written). ``grads(params,
    batch) -> (loss, grads)`` is its first half: the loss and the gradients
    of the trainable half, a tree shaped like it. On a mesh, ``params`` and
    ``opt_state`` are the rank's shards at ``in_shardings`` (params, optimizer
    state, batch by key), the batch is global, and the grads are the rank's
    shards of the global gradient; ``compressed(params, batch, ef) -> (loss,
    grads, new_ef)`` is the cross-pod half of a ``grad_compress`` step
    (None elsewhere)."""

    fn: Callable
    grads: Callable
    in_shardings: Any = None
    compressed: Callable | None = None


def value_and_grad(loss_fn: Callable, params: dict, batch: Any
                   ) -> tuple[torch.Tensor, dict]:
    """(loss, gradients) of ``loss_fn(params, batch)`` at ``params`` (nested
    dicts of tensors; not written), by autograd."""
    flat: list[torch.Tensor] = []

    def leaf(w: torch.Tensor) -> torch.Tensor:
        flat.append(w.detach().requires_grad_())
        return flat[-1]

    leaves = _tree_map(leaf, params)
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))

    def grad(w: torch.Tensor) -> torch.Tensor:
        # a leaf off the forward (the token embedding of a frame
        # frontend) gets zeros, as jax.grad gives it
        g = next(gs)
        return torch.zeros_like(w) if g is None else g

    return loss.detach(), _tree_map(grad, leaves)


def _padded(placement: tuple, ndim: int) -> tuple:
    return tuple(placement) + (None,) * (ndim - len(placement))


def gather_to_body(trainable: dict, stored: dict, body: dict, mesh) -> dict:
    """The trainable leaves as the forward reads them: each of this rank's
    shards (placed ``stored``) all-gathered along every dim whose stored axes
    the ``body`` placement lacks; and where a batch axis of the current
    rules is neither gathered nor in the body placement, the leaf's gradient
    summed over it (each rank of it runs other rows)."""
    bd = (shd.resolve_spec(("batch",)) or (None,))[0]
    batch_axes = shd.axis_names_of(bd)

    def one(w: torch.Tensor, s: tuple, b: tuple) -> torch.Tensor:
        reduced: set[str] = set()
        for dim, (sa, ba) in enumerate(zip(_padded(s, w.ndim), _padded(b, w.ndim))):
            if sa == ba:
                reduced.update(shd.axis_names_of(sa))
                continue
            if ba is not None:
                raise ValueError(f"stored placement {s} does not gather into {b}")
            w = coll.all_gather(w, mesh, sa, dim)
            reduced.update(shd.axis_names_of(sa))
        rest = tuple(a for a in batch_axes if a not in reduced)
        return coll.sum_grad(w, mesh, rest or None)

    return _tree_map(one, trainable, stored, body)


def make_train_step(cfg: ModelConfig, ocfg: opt.OptConfig, mesh=None,
                    rules: dict | None = None) -> tuple:
    """The train step. Returns (bundle, param specs, optimizer state specs)
    on one device; with a ``mesh`` (rules default ``TRAIN_RULES``), also the
    batch's placement by key, as the reference's (bundle, p_specs, o_specs,
    bspec), and the bundle's ``in_shardings``: the params' (trainable leaves
    at ``specs_to_shardings``, the Phi state at ``model.param_shardings``),
    the optimizer state's, the batch's. The optimizer state mirrors only the
    TRAINABLE half."""
    param_specs = model.lm_specs(cfg)
    ostate_specs = opt_state_specs(model.split_phi_state(param_specs)[0], ocfg)

    if mesh is None:
        def loss_and_grads(params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
            trainable, phi_state = model.split_phi_state(params)
            return value_and_grad(
                lambda t, b: model.train_loss(cfg, model.merge_phi_state(t, phi_state), b),
                trainable, batch)

        def train_step(params: dict, opt_state: dict, batch: dict):
            loss, grads = loss_and_grads(params, batch)
            trainable, phi_state = model.split_phi_state(params)
            new_t, new_opt = opt.apply_updates(trainable, grads, opt_state, ocfg)
            return model.merge_phi_state(new_t, phi_state), new_opt, loss

        return StepBundle(fn=train_step, grads=loss_and_grads), param_specs, ostate_specs

    rules = rules or shd.TRAIN_RULES
    body_t, body_phi = model.split_phi_state(model.param_shardings(cfg, mesh, rules))
    stored_t = shd.specs_to_shardings(model.split_phi_state(param_specs)[0], mesh, rules)
    p_sh = model.merge_phi_state(stored_t, body_phi)
    o_sh = shd.specs_to_shardings(ostate_specs, mesh, rules)
    bspec = batch_shardings(cfg, mesh, rules)
    cross_pod = "pod" in mesh.axis_names and mesh.shape["pod"] > 1 and ocfg.grad_compress

    def loss_fn(phi_state: dict):
        def fn(trainable: dict, batch: dict) -> torch.Tensor:
            rows = next(iter(batch.values())).shape[0]
            bd = (shd.resolve_spec(("batch",)) or (None,))[0]
            if rows % mesh.extent(bd):
                raise ValueError(f"a global batch of {rows} rows does not split over the "
                                 f"{mesh.extent(bd)} ranks of {bd}")
            full = gather_to_body(trainable, stored_t, body_t, mesh)
            return model.train_loss(cfg, model.merge_phi_state(full, phi_state), batch)
        return fn

    def loss_and_grads(params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        trainable, phi_state = model.split_phi_state(params)
        # in an spmd region every Phi GEMM under autograd resolves coo at its
        # lm.{name}.spmd site, as in the reference's partitioned trace
        with _on_mesh(mesh, rules):
            return value_and_grad(loss_fn(phi_state), trainable, batch)

    def compressed(params: dict, batch: dict, ef: dict, stats: dict | None = None):
        from repro_torch.train.grad_compress import pod_compressed_grads

        trainable, phi_state = model.split_phi_state(params)
        with _on_mesh(mesh, rules):
            return pod_compressed_grads(loss_fn(phi_state), trainable, batch, ef, mesh,
                                        placements=stored_t, stats=stats)

    def train_step(params: dict, opt_state: dict, batch: dict):
        trainable, phi_state = model.split_phi_state(params)
        if cross_pod:
            loss, grads, new_ef = compressed(params, batch, opt_state["ef"])
            opt_state = dict(opt_state, ef=new_ef)
        else:
            loss, grads = loss_and_grads(params, batch)
        new_t, new_opt = opt.apply_updates(trainable, grads, opt_state, ocfg, mesh=mesh,
                                           placements=stored_t)
        return model.merge_phi_state(new_t, phi_state), new_opt, loss

    bundle = StepBundle(fn=train_step, grads=loss_and_grads, in_shardings=(p_sh, o_sh, bspec),
                        compressed=compressed if cross_pod else None)
    return bundle, param_specs, ostate_specs, bspec


# ------------------------------------------------------------- batch specs
def batch_shardings(cfg: ModelConfig, mesh, rules: dict) -> Callable:
    """The placement of an input batch leaf by its key: rows over the
    ``batch`` axes (as a tuple, the reference's ``PartitionSpec``)."""
    bd = (shd.resolve_spec(("batch",), rules, mesh) or (None,))[0]

    def spec(k: str) -> tuple:
        if k in ("patch_embeds", "frame_embeds"):
            return (bd, None, None)
        return (bd, None)

    return spec


# -------------------------------------------------------- decode state specs
def state_sharding_for_leaf(cfg: ModelConfig, shape: tuple, mesh, rules: dict, batch: int,
                            batch_dim: int | None = None) -> tuple:
    """Pattern-match a decode-state leaf to its placement (one entry a dim).

    KV caches (..., B, S, H, hd): batch → the ``batch`` axes, heads →
    'model'. SSM states (..., B, H, P, N): heads → 'model'. Conv states
    (..., B, k-1, C=d_inner): channels → 'model'. Then the divisibility
    fallback. The batch dim is the first of size ``batch``, as the
    reference finds it, unless ``batch_dim`` names it: with as many stacked
    layers as batch rows the first match is the layer axis."""
    bd = (shd.resolve_spec(("batch",), rules, mesh) or (None,))[0]
    tp = (shd.resolve_spec(("heads",), rules, mesh) or (None,))[0]
    axes: list = [None] * len(shape)
    b_i = batch_dim if batch_dim is not None else next(
        (i for i, s in enumerate(shape) if s == batch), None)
    if b_i is not None:
        axes[b_i] = bd
        if len(shape) >= b_i + 4 and shape[b_i + 3] == cfg.hd and \
                shape[b_i + 2] == cfg.kv_heads_padded:
            axes[b_i + 2] = tp                      # kv cache heads
        elif cfg.ssm_state and len(shape) == b_i + 4 and \
                shape[b_i + 1] == cfg.ssm_heads and shape[b_i + 3] == cfg.ssm_state:
            axes[b_i + 1] = tp                      # ssm state heads
        elif cfg.ssm_state and len(shape) == b_i + 3 and shape[b_i + 2] == cfg.d_inner:
            axes[b_i + 2] = tp                      # conv_x channels
    # divisibility fallback (batch 1, odd head counts, ...)
    for i, ax in enumerate(axes):
        if ax is not None and shape[i] % shd.axis_size(mesh, ax) != 0:
            axes[i] = None
    return tuple(axes)


def _leaf_shardings(cfg: ModelConfig, state_specs: Any, mesh, rules: dict,
                    batch: int) -> list[tuple]:
    """The placement of each leaf of a decode-state tree, in
    ``model.state_leaves`` order, each leaf's batch dim taken from
    ``model.state_batch_axes``."""
    dims = model.state_leaves(model.state_batch_axes(cfg, state_specs))
    return [state_sharding_for_leaf(cfg, tuple(s.shape), mesh, rules, batch, batch_dim=d)
            for s, d in zip(model.state_leaves(state_specs), dims)]


def decode_state_shardings(cfg: ModelConfig, state_specs: Any, mesh, rules: dict,
                           batch: int) -> Any:
    """:func:`state_sharding_for_leaf` over a decode-state tree (specs or
    tensors; same structure, a placement at each leaf), each leaf's batch
    dim taken from ``model.state_batch_axes``."""
    it = iter(_leaf_shardings(cfg, state_specs, mesh, rules, batch))
    return model.map_state(lambda _: next(it), state_specs)


def init_decode_state(cfg: ModelConfig, batch: int, context: int, mesh=None,
                      rules: dict | None = None,
                      device: str | torch.device | None = None) -> tuple[Any, list | None]:
    """Zero decode state of ``batch`` slots: on a mesh, this rank's shards of
    it. Returns (state, the leaves' placements in ``model.state_leaves``
    order), the placements None off a mesh."""
    specs = model.decode_state_specs(cfg, batch, context)
    if mesh is None:
        return model.init_decode_state(cfg, batch, context, device), None
    placements = _leaf_shardings(cfg, specs, mesh, rules or shd.SERVE_RULES, batch)
    it = iter(placements)
    local = model.map_state(
        lambda s: model.TensorSpec(shd.local_shape(s.shape, next(it), mesh), s.dtype), specs)
    return model._zeros(local, mesh.device if device is None else device), placements


# ----------------------------------------------------------------- serving
def _on_mesh(mesh, rules):
    """The context a step runs in: the mesh's rules and an SPMD region, or
    nothing off a mesh."""
    import contextlib

    if mesh is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(shd.use_rules(rules, mesh))
    stack.enter_context(dispatch.spmd_region())
    return stack


def make_prefill(cfg: ModelConfig, mesh=None, rules: dict | None = None) -> tuple:
    """(prefill_fn(params, batch) -> (last logits, decode state), param specs)
    on one device; with a ``mesh`` (rules default ``SERVE_RULES``), also the
    params' placements and the batch's: (fn, specs, param placements, batch
    placement by key). On a mesh ``params`` are the rank's shards, the batch
    is global and the state the rank's."""
    param_specs = model.lm_specs(cfg)
    rules = rules or shd.SERVE_RULES

    @torch.no_grad()
    def prefill_fn(params, batch):
        with _on_mesh(mesh, rules):
            return model.prefill(cfg, params, batch)

    if mesh is None:
        return prefill_fn, param_specs
    return (prefill_fn, param_specs, model.param_shardings(cfg, mesh, rules),
            batch_shardings(cfg, mesh, rules))


def make_decode_step(cfg: ModelConfig, mesh=None, rules: dict | None = None) -> tuple:
    """(decode_fn(params, token, pos, caches, embeds=None) -> (logits,
    caches), param specs) on one device; the caches are written in place.
    With a ``mesh``, also the params' placements and the tokens' and
    embeddings': (fn, specs, param placements, token placement, embeds
    placement)."""
    param_specs = model.lm_specs(cfg)
    rules = rules or shd.SERVE_RULES

    @torch.no_grad()
    def decode_fn(params, token, pos, caches, embeds=None):
        with _on_mesh(mesh, rules):
            return model.decode_step(cfg, params, token, pos, caches, embeds=embeds)

    if mesh is None:
        return decode_fn, param_specs
    bd = (shd.resolve_spec(("batch",), rules, mesh) or (None,))[0]
    return (decode_fn, param_specs, model.param_shardings(cfg, mesh, rules), (bd,),
            (bd, None))
