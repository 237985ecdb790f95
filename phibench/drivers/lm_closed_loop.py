"""Closed-loop serving of a decoder language model through the port's engine.

Set-up: the weights (the configuration's reference makes them from its
``weights_seed``, on the device) and the calibration batch, the program's
params tree around them, Phi calibration (``calibrate_lm_phi``, the L2
budget set as the port's serve launcher sets it), an ``Engine`` of
``concurrency`` slots that keeps each served token's logit row, and one
warm-up request per prefill bucket the traffic uses. The window:
``concurrency`` requests in flight, a new one submitted as each retires; the
harness calls ``Engine.submit`` and ``Engine.tick`` itself and never
``Engine.run``. Every tick ends in the logits' copy to the host, which waits
for the card. A request is due when submitted, has its first token when the
tick that admitted it returns, and is done when the tick that retired it
returns. The window closes at the first tick that returns ``seconds`` after
it opened. End-of-sequence is off (``eos_id`` -1): every request runs to its
own output length.

Check: a sample of the finished requests drawn from the seed, the one with
the most tokens in it, until ``check.served_tokens`` tokens are covered.
The reference runs once over each prompt and its served tokens; the numbers
compared are the program's logit rows against the reference's and the
served tokens' logits against the reference's best (see ``check``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from phibench import spec
from phibench import traffic as tr
from phibench import work as wk

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(config: dict):
    """The port's config of the configuration file, checked by its reference."""
    from repro_torch.configs import get_config, phi_variant

    prog = config["program"]
    over = {k: DTYPES.get(v, v) for k, v in prog.get("overrides", {}).items()}
    cfg = phi_variant(get_config(prog["arch"], smoke=prog.get("smoke", False), **over),
                      **prog["phi_variant"])
    spec.reference(config).check_program(cfg, config["sizes"])
    return cfg


def make_weights(config: dict, device) -> dict:
    """The configuration's weights, as its reference makes them."""
    return spec.reference(config).make_weights(
        config["sizes"], tr.sub_seed(config["weights_seed"], 2), device)


def program_params(cfg, weights: dict, device) -> dict:
    """The program's params tree: the benchmark's weights where its specs
    name them, zeros or ones (as the spec says) for the Phi state and the
    rest."""
    from repro_torch.distributed.sharding import is_spec
    from repro_torch.models import model

    def build(node, key):
        if not is_spec(node):
            return {k: build(node[k], k) for k in sorted(node)}
        if node.init in ("zeros", "ones"):
            fill = torch.zeros if node.init == "zeros" else torch.ones
            return fill(node.shape, dtype=node.dtype, device=device)
        w = weights.get(key)
        if w is None or tuple(w.shape) != tuple(node.shape):
            raise ValueError(f"no weight of shape {node.shape} for {key!r}")
        return w.to(node.dtype)

    return build(model.lm_specs(cfg), None)


@dataclasses.dataclass
class State:
    run: object
    sizes: dict
    engine: object = None
    stream: object = None
    reqs: dict = dataclasses.field(default_factory=dict)
    ticks: list = dataclasses.field(default_factory=list)
    prefill_ms: list = dataclasses.field(default_factory=list)
    generated: dict = dataclasses.field(default_factory=dict)
    decode_rows: list = dataclasses.field(default_factory=list)
    t_start: float = 0.0
    t_end: float = 0.0


def setup(run) -> State:
    from repro_torch.kernels import dispatch
    from repro_torch.models import model
    from repro_torch.serve.engine import Engine, Request

    conf, traffic, dev = run.cell.config, run.cell.traffic, run.device
    st = State(run=run, sizes=conf["sizes"])
    cfg = program_config(conf)
    dispatch.set_policy(dispatch.PhiExecutionPolicy())
    with torch.no_grad():
        params = program_params(cfg, make_weights(conf, dev), dev)
        n, s = conf["calibration_batch"]
        gen = torch.Generator().manual_seed(tr.sub_seed(conf["weights_seed"], 3))
        calib = {"tokens": torch.randint(3, cfg.vocab, (n, s), generator=gen,
                                         dtype=torch.int32).to(dev)}
        params, stats = model.calibrate_lm_phi(cfg, params, calib)
    maxd = max(x.l2_density for x in stats.values())
    cfg = cfg.with_(phi=dataclasses.replace(cfg.phi, nnz_budget=min(0.9, 2 * maxd + 0.05)))
    st.engine = Engine(cfg, params, batch_slots=traffic["concurrency"],
                       max_context=traffic["max_context"], eos_id=-1, seed=0,
                       record_logits=True)
    rng = np.random.default_rng(tr.sub_seed(run.seed, 4))
    for i, b in enumerate(tr.buckets(traffic)):
        plen = min(b, traffic["max_context"] - 1)
        st.engine.submit(Request(rid=-1 - i, tokens=rng.integers(3, cfg.vocab, plen),
                                 max_new_tokens=2))
    while st.engine.queue or st.engine.active.any():
        st.engine.tick()
    st.engine.results.clear()
    st.engine.logit_trace.clear()
    st.stream = tr.lm_stream(traffic, cfg.vocab, run.seed)
    return st


def _generated(eng) -> dict:
    out = {r.rid: len(r.tokens) for r in eng.results}
    for s in range(eng.B):
        if eng.active[s]:
            out[eng.slot_req[s].rid] = len(eng.out_tokens[s])
    return out


def window(st: State, run, seconds: float) -> None:
    from repro_torch.serve.engine import Request

    eng = st.engine
    timer = None
    if run.trace:
        timer = _PrefillTimer(st.prefill_ms, run.device)
        timer.install()
    try:
        with torch.no_grad():
            st.t_start = time.perf_counter()
            for _ in range(run.cell.traffic["concurrency"]):
                _submit(st, Request, st.t_start)
            while True:
                queued = {r.rid for r in eng.queue}
                n_res = len(eng.results)
                t0 = time.perf_counter()
                eng.tick()
                t1 = time.perf_counter()
                admitted = queued - {r.rid for r in eng.queue}
                # rows of this tick's decode step: the slots active after
                # admission, i.e. active now or retired by this tick
                st.decode_rows.append(int(eng.active.sum()) + len(eng.results) - n_res)
                for rid in admitted:
                    st.reqs[rid]["t_first"] = t1
                st.ticks.append((t0, t1, len(admitted)))
                open_ = t1 - st.t_start < seconds
                for res in eng.results[n_res:]:
                    st.reqs[res.rid]["t_done"] = t1
                    if open_:
                        _submit(st, Request, t1)
                if not open_:
                    break
            st.t_end = t1
    finally:
        if timer is not None:
            timer.remove()
    st.generated = _generated(eng)


def _submit(st: State, Request, t: float) -> None:
    r = next(st.stream)
    st.reqs[r["rid"]] = {"plen": len(r["tokens"]), "max_new": r["max_new"], "t_submit": t,
                         "tokens": r["tokens"]}
    st.engine.submit(Request(rid=r["rid"], tokens=r["tokens"], max_new_tokens=r["max_new"]))


class _PrefillTimer:
    """Times each ``model.prefill_padded`` call between two synchronisations
    (the traced run only)."""

    def __init__(self, out: list, device):
        self.out, self.device = out, device

    def install(self) -> None:
        from repro_torch.models import model

        self.orig = model.prefill_padded

        def timed(*a, **k):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            res = self.orig(*a, **k)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.out.append((time.perf_counter() - t0) * 1e3)
            return res

        model.prefill_padded = timed

    def remove(self) -> None:
        from repro_torch.models import model

        model.prefill_padded = self.orig


def account(st: State, run) -> None:
    """The window's work, counts and records for the metric readers."""
    sizes = st.sizes
    w = wk.Work()
    for rows in st.decode_rows:          # one decode step a tick: its GEMMs and head
        if rows:
            w.add(wk.lm_decode_step(sizes, rows))
    prompt_tokens = 0
    for rid, r in st.reqs.items():
        n = st.generated.get(rid, 0)
        if "t_first" in r:
            w.add(wk.lm_prefill(sizes, r["plen"]))
            prompt_tokens += r["plen"]
        # attention of its decoded tokens k = 1..n-1 over plen + k keys
        w.flops += sum(wk.lm_decode_attention(sizes, r["plen"] + k) for k in range(1, n))
        r["served"] = n
    run.window_s = st.t_end - st.t_start
    run.work = w
    run.attempted = len(st.reqs)
    done = [r for r in st.reqs.values() if "t_done" in r]
    run.failed = sum(r["served"] != r["max_new"] for r in done)
    run.records.update(
        prompt_tokens=prompt_tokens, output_tokens=sum(st.generated.values()),
        ticks=st.ticks, prefill_ms=st.prefill_ms,
        ttft_ms=[(r["t_first"] - r["t_submit"]) * 1e3 for r in st.reqs.values()
                 if "t_first" in r])


def release(st: State) -> list[dict]:
    """Free the program's state; returns the sample the check reads."""
    from repro_torch.kernels import dispatch

    eng = st.engine
    results = {r.rid: r.tokens for r in eng.results}
    done = sorted(rid for rid, r in st.reqs.items() if "t_done" in r and rid in results)
    rng = np.random.default_rng(tr.sub_seed(st.run.seed, 5))
    want = st.run.cell.traffic["check"]["served_tokens"]
    order = []
    if done:
        longest = max(done, key=lambda rid: (len(results[rid]), -rid))
        order = [longest] + [int(r) for r in rng.permutation([x for x in done if x != longest])]
    sample, covered = [], 0
    for rid in order:
        if covered >= want:
            break
        sample.append({"prompt": np.asarray(st.reqs[rid]["tokens"]),
                       "served": list(results[rid]),
                       "logits": np.stack(eng.logit_trace.get(rid, [])
                                          or [np.zeros(0, np.float32)])})
        covered += len(results[rid])
    st.engine = None
    dispatch.set_policy(dispatch.PhiExecutionPolicy())
    return sample


def _gaps(ref: torch.Tensor, picks: torch.Tensor) -> torch.Tensor:
    return ref.max(-1).values - ref.gather(-1, picks[:, None])[:, 0]


def check(run, sample: list[dict], control: bool):
    """(checks, ok, readings). Two numbers are compared over the sample's
    served tokens. ``logit_err_mean``: the mean absolute difference between
    the program's logit row, from which the engine drew a served token, and
    the reference's at its position, rounded to the activation dtype in
    which the program states its logits, averaged over the vocabulary and
    then over the positions. ``served_logit_gap_mean``: the mean gap by
    which a served token's logit lies below the reference's best, which
    catches a token altered after its logits. With ``control``, each control
    of the configuration is read on the same prompts and tokens: its logit
    rows against the reference's, and the gap of the token it puts first."""
    conf, dev = run.cell.config, run.device
    sizes = conf["sizes"]
    lim = run.cell.traffic["check"]
    out = DTYPES[sizes["activation_dtype"]]
    weights = make_weights(conf, dev)
    reference = spec.reference(conf)
    errs, gaps = [], []
    ctrl = {c["name"]: ([], []) for c in conf["controls"]} if control else {}
    for s in sample:
        served = torch.as_tensor(s["served"], device=dev)
        seq = torch.cat([torch.as_tensor(s["prompt"], device=dev), served[:-1]])
        first = len(s["prompt"]) - 1
        ref = reference.logits(weights, sizes, seq, first)
        stated = ref.to(out).to(torch.float32)
        rows = torch.as_tensor(s["logits"], device=dev)
        if rows.shape == stated.shape:
            errs.append((rows - stated).abs().mean(-1))
        else:                       # a row missing or extra: no number
            errs.append(torch.full((len(served),), float("inf"), device=dev))
        gaps.append(_gaps(ref, served))
        for c in conf["controls"] if control else ():
            low = reference.logits(weights, sizes, seq, first, gemm=c.get("gemm", "float32"),
                                   act=c.get("activations"))
            ctrl[c["name"]][0].append((low.to(out).to(torch.float32) - stated).abs().mean(-1))
            ctrl[c["name"]][1].append(_gaps(ref, low.argmax(-1)))
    err = torch.cat(errs) if errs else torch.zeros(0)
    gap = torch.cat(gaps) if gaps else torch.zeros(0)
    err_mean = float(err.mean()) if len(err) else float("inf")
    gap_mean = float(gap.mean()) if len(gap) else float("inf")
    checks = {"logit_err_mean": {"value": err_mean, "limit": lim["logit_err_mean"]},
              "served_logit_gap_mean": {"value": gap_mean, "limit": lim["served_logit_gap_mean"]},
              "checked_tokens": {"value": len(gap), "limit": lim["served_tokens"]}}
    readings = {"logit_err_max": float(err.max()) if len(err) else None,
                "logit_rows_equal": int((err == 0).sum()),
                "served_logit_gap_max": float(gap.max()) if len(gap) else None,
                "served_tokens_off_best": int((gap > 0).sum())}
    for name, (e, g) in ctrl.items():
        e, g = torch.cat(e), torch.cat(g)
        readings[name] = {"logit_err_mean": float(e.mean()), "logit_err_max": float(e.max()),
                          "gap_mean": float(g.mean()), "gap_max": float(g.max()),
                          "tokens_off_best": int((g > 0).sum())}
    ok = (err_mean <= lim["logit_err_mean"] and gap_mean <= lim["served_logit_gap_mean"]
          and len(gap) >= lim["served_tokens"])
    return checks, ok, readings
