"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake tensors.

Port of ``repro/launch/dryrun.py``. The reference builds its production mesh
from 512 placeholder host devices and lowers and compiles each step on
``ShapeDtypeStruct`` inputs. The port has no compiler; it runs one rank's
step on fake tensors (``torch._subclasses.fake_tensor``: shapes, dtypes and
devices, no data) in a fake world of the production mesh's size
(``torch.distributed``'s ``fake`` backend: 256 or 512 ranks, this process
rank 0), so

* the mesh, its groups and every placement are built at full scale, and the
  port's own collectives run on that world and count what they move;
* every parameter, optimizer state, batch and decode state is a fake tensor
  of the rank's local shape (Phi banks from the specs, never a calibration);
* the kernel wrappers take the card's path, gates and checks included, and
  skip only the launch (``kernels.costs``): the record's ``launches`` is the
  step's kernel plan on the H100, and ``distributed.cost_analysis`` counts
  FLOPs, bytes, live memory and collectives, and gives the roofline on the
  card's data-sheet rates.

The device is ``cuda`` (fake) by default: no card is needed, and on a build
of PyTorch without CUDA a function mode (:class:`_NoDeviceGuard`) sends the
few Python entry points that set a CUDA device guard (indexing, ``copy_``,
``contiguous``, device moves) straight to their aten ops. Results go to
``results/dryrun_torch/``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b --shape decode_32k --phi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both [--phi]
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, phi_variant
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.cost_analysis import StepCost
from repro_torch.kernels import ATTN_IMPLS, dispatch, ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib
from repro_torch.utils import dump_json, human_count, load_json, log, tree_bytes

RESULTS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                       "results", "dryrun_torch"))

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def input_specs(cfg, shape_id: str):
    """``model.TensorSpec`` stand-ins for every model input of this cell."""
    sh = SHAPES[shape_id]
    return model.input_batch_specs(cfg, sh["batch"], sh["seq"],
                                   with_labels=(sh["kind"] == "train"))


def _model_flops(cfg, shape_id: str) -> float:
    sh = SHAPES[shape_id]
    tot, act = cfg.param_count()
    tokens = sh["batch"] * sh["seq"]
    if sh["kind"] == "train":
        return 6.0 * act * tokens
    if sh["kind"] == "prefill":
        mult = cfg.phi.timesteps if cfg.spiking and cfg.phi else 1
        return 2.0 * act * tokens * mult
    return 2.0 * act * sh["batch"]  # decode: one token per row


def _batch_shardings(cfg, batch_specs, mesh, rules):
    """The placement of each batch leaf: its rows over the ``batch`` axes. The
    port's steps take the global batch on every rank and cut their rows
    themselves; the placements are recorded."""
    return {k: shd.shape_aware_spec(v.shape, ("batch",) + (None,) * (len(v.shape) - 1), mesh,
                                    rules)
            for k, v in batch_specs.items()}


# ------------------------------------------------------------- tracing ---
_AT = torch.ops.aten


def _split_index(x: torch.Tensor, idx):
    """``x[idx]`` as aten ops: (the view after the basic part of ``idx``,
    the advanced part for ``aten.index`` or None), as PyTorch's indexing
    applies them (ints select, slices slice, None unsqueezes, tensors and
    lists index)."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    idx = tuple(torch.as_tensor(i, device=x.device) if isinstance(i, list) else i for i in idx)
    consumed = sum(1 for i in idx if i is not None and i is not Ellipsis)
    out, dim, adv = x, 0, []
    for i in idx:
        if i is None:
            out = _AT.unsqueeze.default(out, dim)
            adv.append(None)
            dim += 1
        elif i is Ellipsis:
            adv += [None] * (x.ndim - consumed)
            dim += x.ndim - consumed
        elif isinstance(i, slice):
            if not (i.start is None and i.stop is None and i.step in (None, 1)):
                out = _AT.slice.Tensor(out, dim, i.start, i.stop,
                                       1 if i.step is None else i.step)
            adv.append(None)
            dim += 1
        elif isinstance(i, torch.Tensor):
            adv.append(i)
            dim += 1
        elif isinstance(i, int) and not isinstance(i, bool):
            out = _AT.select.int(out, dim, i)
        else:
            raise TypeError(f"dry run: index {i!r} of type {type(i).__name__}")
    if all(a is None for a in adv):
        return out, None
    while adv[-1] is None:
        adv.pop()
    return out, adv


class _NoDeviceGuard(torch.overrides.TorchFunctionMode):
    """Sends the Python entry points that set a device guard to their aten
    ops: a build of PyTorch without CUDA has no CUDA guard, and a fake
    ``cuda`` tensor's indexing, ``copy_``, ``contiguous`` and device moves
    raise there. The aten ops are the ones those entry points run."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            out, adv = _split_index(args[0], args[1])
            return out if adv is None else _AT.index.Tensor(out, adv)
        if func is torch.Tensor.__setitem__:
            x, idx, v = args
            out, adv = _split_index(x, idx)
            if adv is not None:
                if not isinstance(v, torch.Tensor):
                    v = torch.scalar_tensor(v, dtype=x.dtype, device=x.device)
                _AT.index_put_.default(out, adv, v)
            elif isinstance(v, torch.Tensor):
                _AT.copy_.default(out, v)
            else:
                _AT.fill_.Scalar(out, v)
            return None
        if func is torch.Tensor.copy_:
            return _AT.copy_.default(args[0], args[1])
        if func is torch.Tensor.contiguous:
            x = args[0]
            fmt = kwargs.get("memory_format", args[1] if len(args) > 1 else
                             torch.contiguous_format)
            return x if x.is_contiguous(memory_format=fmt) else _AT.clone.default(
                x, memory_format=fmt)
        if func is torch.Tensor.to:
            x = args[0]
            dev, dt, _, _ = torch._C._nn._parse_to(*args[1:], **kwargs)
            if dev is not None and torch.device(dev) != x.device:
                return _AT._to_copy.default(x, dtype=dt or x.dtype, device=torch.device(dev))
        return func(*args, **kwargs)


@contextlib.contextmanager
def fake_world(size: int):
    """A fake world of ``size`` ranks with this process as rank 0 (the
    ``fake`` backend: collectives run and move nothing), left on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dry run: this process is already in a world")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def tracing(device):
    """Fake tensors on ``device`` (no data, no allocation); on a PyTorch
    without CUDA, through aten where a CUDA device guard would be needed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    no_guard = torch.device(device).type == "cuda" and torch.version.cuda is None
    with FakeTensorMode(), (_NoDeviceGuard() if no_guard else contextlib.nullcontext()):
        yield


def fake_tree(specs, placements, mesh, device):
    """Fake tensors of every leaf's local shape under ``placements`` (a
    spec tree of ``ParamSpec``/``TensorSpec``; call inside :func:`tracing`)."""
    if isinstance(specs, dict):
        return {k: fake_tree(specs[k], None if placements is None else placements[k], mesh,
                             device) for k in specs}
    shape = tuple(specs.shape) if mesh is None else shd.local_shape(specs.shape, placements,
                                                                     mesh)
    return torch.empty(shape, dtype=specs.dtype, device=device)


def policy_usage(policy: dispatch.PhiExecutionPolicy) -> dict:
    """The calibration usage histograms registered with ``policy``, by site:
    a dry run registers them with its own policy to resolve as ``policy``."""
    with policy._lock:
        return {site: u.copy() for site, u in policy._usage.items()}


def launch_plan(cost: StepCost, policy: dispatch.PhiExecutionPolicy) -> dict:
    """The step's kernel plan: each hand-written kernel's launches, and at
    each Phi and attention site the policy's decisions (impl, reason,
    calls) with the last call's local shape, ranks and, for a matmul site,
    the Hopper gate's kernel for that shape (``ops.fused_shape_viable``)."""
    sites: dict = {}
    for (site, impl, reason), n in sorted(policy.decisions().items()):
        d = policy.last_decision(site)
        row = sites.setdefault(site, {"decisions": [], "shape": list(d.shape),
                                      "shards": d.shards})
        row["decisions"].append({"impl": impl, "reason": reason, "calls": n})
        if d.impl not in ATTN_IMPLS:
            row["gate"] = ops.fused_shape_viable(*d.shape, p_active=d.p_active)
    return {"kernels": cost.launch_counts(), "sites": sites}


def trace_step(cfg, kind: str, batch: int, seq: int, mesh, rules=None, *, device="cuda",
               ocfg_overrides: dict | None = None, usage: dict | None = None,
               model_flops: float = 0.0) -> dict:
    """Trace one rank's ``kind`` step (``train``, ``prefill`` or ``decode``)
    of ``cfg`` at a global ``batch`` × ``seq`` on ``mesh`` (None: one device)
    with fake inputs on ``device``, under a fresh policy (telemetry off; the
    ``usage`` histograms registered by site); a train step's optimizer is the
    reference's ``OptConfig`` (factored for bf16 params) with
    ``ocfg_overrides``. Returns the record's
    ``memory``, ``cost``, ``collectives``, ``collective_calls``, ``roofline``,
    ``launches`` and ``trace_s``."""
    t0 = time.time()
    dev = torch.device(device)
    rules = rules or (shd.TRAIN_RULES if kind == "train" else shd.SERVE_RULES)
    policy = dispatch.PhiExecutionPolicy(telemetry=False)
    for site, u in (usage or {}).items():
        policy.register_usage(site, u)
    prev = dispatch.set_policy(policy)
    try:
        with tracing(dev):
            specs = model.input_batch_specs(cfg, batch, seq, with_labels=(kind == "train"))
            inputs = {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                      for k, s in specs.items()}
            if kind == "train":
                ocfg = opt.OptConfig(factored=cfg.param_dtype == torch.bfloat16,
                                     **(ocfg_overrides or {}))
                if mesh is None:
                    bundle, p_specs, o_specs = step_lib.make_train_step(cfg, ocfg)
                    p_sh = o_sh = None
                else:
                    bundle, p_specs, o_specs, _ = step_lib.make_train_step(cfg, ocfg, mesh,
                                                                           rules)
                    p_sh, o_sh, _ = bundle.in_shardings
                args = (fake_tree(p_specs, p_sh, mesh, dev), fake_tree(o_specs, o_sh, mesh, dev),
                        inputs)
                run = bundle.fn
            elif kind == "prefill":
                built = step_lib.make_prefill(cfg, mesh, rules)
                p_sh = built[2] if mesh is not None else None
                args = (fake_tree(built[1], p_sh, mesh, dev), inputs)
                run = built[0]
            else:
                built = step_lib.make_decode_step(cfg, mesh, rules)
                p_sh = built[2] if mesh is not None else None
                state, _ = step_lib.init_decode_state(cfg, batch, seq, mesh, rules, device=dev)
                tok = torch.zeros((batch,), dtype=torch.int32, device=dev)
                emb = inputs.get("frame_embeds")
                args = (fake_tree(built[1], p_sh, mesh, dev), tok, tok.clone(), state,
                        None if emb is None else emb[:, 0].contiguous())
                run = built[0]
            cost = StepCost(mesh, args)
            with cost:
                out = run(*args)
            out_bytes = tree_bytes(out)
    finally:
        dispatch.set_policy(prev)
    return {
        "memory": {"argument_bytes": cost.argument_bytes, "output_bytes": out_bytes,
                   "temp_bytes": cost.peak_live_bytes - cost.live_at_start,
                   "generated_code_bytes": None},
        "cost": {"flops": float(cost.flops), "flops_aten": float(cost.flops_aten),
                 "ops_kernels": float(cost.ops_kernels), "bytes": float(cost.bytes),
                 "bytes accessed": float(cost.bytes_raw_total),
                 "bytes_kernels": float(cost.bytes_kernels), "aten_ops": cost.ops},
        "collectives": dict(cost.collectives),
        "collective_calls": dict(cost.collective_calls),
        "roofline": cost.roofline(1 if mesh is None else mesh.size, model_flops,
                                  cfg.compute_dtype).as_dict(),
        "launches": launch_plan(cost, policy),
        "trace_s": round(time.time() - t0, 1),
    }


def run_cell(arch: str, shape_id: str, multi_pod: bool, phi: bool = False,
             rules_override: dict | None = None, tag: str = "",
             cfg_overrides: dict | None = None, ocfg_overrides: dict | None = None) -> dict:
    """One cell's record: rank 0's step traced on fake ``cuda`` tensors in
    a fake world of the production mesh's size. A train cell needs a PyTorch
    built with CUDA: autograd asks a fake ``cuda`` leaf's device guard for
    its stream, and a build without CUDA aborts there."""
    t0 = time.time()
    sh = SHAPES[shape_id]
    cfg = get_config(arch)
    if phi:
        cfg = phi_variant(cfg)
    if cfg_overrides:
        cfg = cfg.with_(**cfg_overrides)
    shape, _ = mesh_lib.PRODUCTION_SHAPES[multi_pod]
    rec: dict = {"arch": arch, "shape": shape_id, "mesh": "x".join(map(str, shape)),
                 "phi": phi, "tag": tag}

    if shape_id == "long_500k" and not cfg.sub_quadratic:
        rec["skipped"] = ("pure full-attention arch: long_500k requires "
                          "sub-quadratic attention (per assignment)")
        return rec
    if phi and sh["kind"] == "train":
        rec["skipped"] = ("Phi spiking mode is the serving path (paper: "
                          "inference technique; training uses PAFT on the "
                          "dense path, Sec. 3.3/3.4)")
        return rec

    kind = sh["kind"]
    rules = rules_override or (shd.TRAIN_RULES if kind == "train" else shd.SERVE_RULES)
    if kind == "train" and torch.version.cuda is None:
        raise RuntimeError("a train cell traces on fake cuda tensors, whose autograd needs "
                           "a PyTorch built with CUDA: run it where torch.version.cuda is set")
    with fake_world(math.prod(shape)):
        t_mesh = time.time()
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cuda")
        rec["mesh_s"] = round(time.time() - t_mesh, 2)
        rec["batch_shardings"] = _batch_shardings(cfg, input_specs(cfg, shape_id), mesh, rules)
        rec.update(trace_step(cfg, kind, sh["batch"], sh["seq"], mesh, rules,
                              ocfg_overrides=ocfg_overrides,
                              model_flops=_model_flops(cfg, shape_id)))
    log.info("memory: %s", rec["memory"])
    log.info("cost: %s", {k: human_count(v) for k, v in rec["cost"].items()})
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def cell_path(arch, shape_id, multi_pod, phi, tag="") -> str:
    mesh = "2x16x16" if multi_pod else "16x16"
    suffix = ("_phi" if phi else "") + (f"_{tag}" if tag else "")
    return os.path.join(RESULTS, f"{arch}__{shape_id}__{mesh}{suffix}.json")


def run_and_save(arch, shape_id, multi_pod, phi=False, force=False,
                 rules_override=None, tag="", cfg_overrides=None,
                 ocfg_overrides=None) -> dict:
    path = cell_path(arch, shape_id, multi_pod, phi, tag)
    if not force and os.path.exists(path):
        rec = load_json(path)
        if "error" not in rec:
            log.info("cached: %s", os.path.basename(path))
            return rec
    try:
        rec = run_cell(arch, shape_id, multi_pod, phi, rules_override, tag,
                       cfg_overrides, ocfg_overrides)
    except Exception as e:  # noqa: BLE001 — record failures for triage
        rec = {"arch": arch, "shape": shape_id,
               "mesh": "2x16x16" if multi_pod else "16x16", "phi": phi,
               "tag": tag, "error": str(e),
               "traceback": traceback.format_exc()[-4000:]}
    dump_json(path, rec)
    status = "SKIP" if "skipped" in rec else ("FAIL" if "error" in rec else "ok")
    log.info("%s %s [%s]", os.path.basename(path), status,
             rec.get("total_s", "-"))
    if "roofline" in rec:
        r = rec["roofline"]
        log.info("  compute %.3fs memory %.3fs collective %.3fs -> %s (useful %.2f)",
                 r["compute_s"], r["memory_s"], r["collective_s"], r["bottleneck"],
                 r["useful_ratio"])
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--phi", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]

    failures = 0
    for mp in meshes:
        for arch in archs:
            for shape_id in shapes:
                rec = run_and_save(arch, shape_id, mp, args.phi, args.force)
                failures += 1 if "error" in rec else 0
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
