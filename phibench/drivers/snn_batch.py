"""Closed-loop batch classification through the port's ``phi_apply``.

Set-up: the weights (on the device, onto the 2^-10 grid) and a calibration
batch from the configuration's ``weights_seed``, a pool of
``distinct_batches`` batches of images from the run's seed, Phi calibration
(``calibrate_model``), and warm-up calls
(the first call of a prefetching site runs its pre-pass, the second its
runtime sets). The window: the pool's batches back to back, each call
followed by a synchronisation, until ``seconds`` have passed. Check: every
batch's logits against the reference's for its images; the number compared
is the mean of each answer's largest absolute logit difference (see
``check``).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from phibench import spec
from phibench import traffic as tr
from phibench import work as wk

GRID = 1024.0


def program_config(config: dict):
    from repro_torch.core.patterns import PhiConfig
    from repro_torch.snn.lif import LIFConfig
    from repro_torch.snn.models import SNNConfig

    s, prog = config["sizes"], config["program"]
    cfg = SNNConfig(kind="spikformer", input_size=s["input_size"],
                    input_channels=s["input_channels"], num_classes=s["num_classes"],
                    timesteps=s["timesteps"], dim=s["dim"], heads=s["heads"],
                    blocks=s["blocks"], attn=prog["attn"], phi=PhiConfig(**prog["phi"]))
    if cfg.lif != LIFConfig(decay=s["lif_decay"], threshold=s["lif_threshold"]):
        raise ValueError(f"the program's LIF {cfg.lif} is not the file's")
    return cfg


def make_weights(sizes: dict, seed: int, device) -> dict:
    """Normal, sqrt(2 / fan_in), times ``gain`` but for the stem, rounded
    onto the 2^-10 grid."""
    D, C = sizes["dim"], sizes["input_channels"]
    gen = torch.Generator(device=device).manual_seed(tr.sub_seed(seed, 2))

    def normal(k, n, gain=sizes["gain"]):
        x = torch.randn((k, n), generator=gen, device=device)
        return (x * ((2.0 / k) ** 0.5 * gain * GRID)).round_() / GRID

    w = {"embed": normal(16 * C, D, 1.0)}
    for b in range(sizes["blocks"]):
        w[f"b{b}_qkv"] = normal(D, 3 * D)
        w[f"b{b}_proj"] = normal(D, D)
        w[f"b{b}_fc1"] = normal(D, 4 * D)
        w[f"b{b}_fc2"] = normal(4 * D, D)
    w["head"] = normal(D, sizes["num_classes"])
    return w


@dataclasses.dataclass
class State:
    cfg: object
    params: dict
    phi: object
    pool: torch.Tensor
    outs: list = dataclasses.field(default_factory=list)
    batches: list = dataclasses.field(default_factory=list)


def setup(run) -> State:
    from repro_torch.kernels import dispatch
    from repro_torch.snn import models as M

    conf, traffic, dev = run.cell.config, run.cell.traffic, run.device
    sizes = conf["sizes"]
    cfg = program_config(conf)
    dispatch.set_policy(dispatch.PhiExecutionPolicy())
    params = {n: {"w": w} for n, w in make_weights(sizes, conf["weights_seed"], dev).items()}
    B, P = traffic["batch"], traffic["distinct_batches"]
    pool = tr.images(sizes, B * P, run.seed, 1, dev).reshape(P, B, *(
        [sizes["input_size"]] * 2), sizes["input_channels"])
    calib = tr.images(sizes, conf["calibration_batch"], conf["weights_seed"], 2, dev)
    with torch.no_grad():
        phi, _ = M.calibrate_model(params, cfg, calib)
    st = State(cfg, params, phi, pool)
    for i in range(traffic["warmup_batches"]):
        M.phi_apply(params, cfg, phi, pool[i % P])
    return st


def window(st: State, run, seconds: float) -> None:
    from repro_torch.snn import models as M

    P = st.pool.shape[0]
    sync = torch.cuda.synchronize if run.device.type == "cuda" else (lambda: None)
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        st.outs.append(M.phi_apply(st.params, st.cfg, st.phi, st.pool[i % P]))
        sync()
        t1 = time.perf_counter()
        st.batches.append((t0, t1))
        i += 1
        if t1 - t_start >= seconds:
            break
    run.window_s = t1 - t_start


def account(st: State, run) -> None:
    B = run.cell.traffic["batch"]
    n = len(st.batches)
    run.work = wk.Work()
    run.work.add(wk.snn_batch(run.cell.config["sizes"], B), n)
    run.attempted = n * B
    run.failed = sum(int((~torch.isfinite(o).all(-1)).sum()) for o in st.outs)
    run.records.update(images=n * B, batch_ms=[(t1 - t0) * 1e3 for t0, t1 in st.batches])


def release(st: State) -> dict:
    """Free the program's state; returns every answer with its pool index."""
    from repro_torch.kernels import dispatch

    P = st.pool.shape[0]
    sample = {"pool": st.pool, "outs": [(i % P, o) for i, o in enumerate(st.outs)]}
    st.params = st.phi = None
    dispatch.set_policy(dispatch.PhiExecutionPolicy())
    return sample


def check(run, sample: dict, control: bool):
    """(checks, ok, readings). Each answer's error is its largest absolute
    logit difference from the reference in float64; the number compared is
    the mean error over every answer of the window, the largest beside it.
    With ``control``, each control of the configuration is read on the
    pool's images."""
    conf = run.cell.config
    sizes = conf["sizes"]
    limit = run.cell.traffic["check"]["logit_mean_err"]
    weights = make_weights(sizes, conf["weights_seed"], run.device)
    reference = spec.reference(conf)
    used = sorted({i for i, _ in sample["outs"]})
    ref = {i: reference.logits(weights, sizes, sample["pool"][i], "float64") for i in used}
    errs = torch.cat([(o.double() - ref[i]).abs().amax(-1) for i, o in sample["outs"]])
    mean = float(errs.mean()) if len(errs) else float("inf")
    readings = {"logit_max_err": float(errs.max()) if len(errs) else None}
    for c in conf["controls"] if control else ():
        low = torch.cat([(reference.logits(weights, sizes, sample["pool"][i], gemm=c["gemm"])
                          .double() - ref[i]).abs().amax(-1) for i in used])
        readings[c["name"]] = {"mean_err": float(low.mean()), "max_err": float(low.max())}
    checks = {"logit_mean_err": {"value": mean, "limit": limit}}
    return checks, mean <= limit, readings
