"""The plain references against the port's plain path at smoke sizes."""
import copy
import json
from pathlib import Path

import pytest
import torch

from phibench import traffic as tr
from phibench.drivers import lm_closed_loop as lm
from phibench.drivers import snn_batch as sb
from phibench.reference import olmo, spikformer
from phibench.reference.spiking import matmul, to_tf32

CONFIGS = Path(__file__).resolve().parent / "configs"
CPU = torch.device("cpu")


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def olmo_smoke():
    c = config("olmo-1b-phi")
    c["program"] = {"arch": "olmo_1b", "smoke": True, "overrides": {"compute_dtype": "bfloat16"},
                    "phi_variant": {"timesteps": 4, "q": 16, "k": 16}}
    c["sizes"].update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128)
    return c


@pytest.mark.parametrize("seed", [1, 2**40 + 3])
def test_olmo_reference_is_the_ports_phi_forward_rounded(seed):
    from repro_torch.models import model

    c = olmo_smoke()
    cfg = lm.program_config(c)
    w = olmo.make_weights(c["sizes"], seed, CPU)
    params = lm.program_params(cfg, w, CPU)
    tok = torch.randint(3, 128, (40,), generator=torch.Generator().manual_seed(seed))
    batch = {"tokens": tok[None].to(torch.int32)}
    with torch.no_grad():
        params, _ = model.calibrate_lm_phi(cfg, params, batch)
        got = model.train_logits(cfg, params, batch)[0]
    ref = olmo.logits(w, c["sizes"], tok, 0)
    # the port's head returns bfloat16 logits; the reference keeps float32
    assert torch.equal(got, ref.to(torch.bfloat16).to(torch.float32))
    assert torch.equal(olmo.logits(w, c["sizes"], tok, 30), ref[30:])


@pytest.mark.parametrize("seed", [1, 2**40 + 3])
def test_spikformer_reference_is_the_ports_forward(seed):
    from repro_torch.snn import models as M

    c = config("spikformer-4-384")
    c["sizes"].update(dim=64, heads=2, blocks=2)
    cfg = sb.program_config(c)
    w = sb.make_weights(c["sizes"], seed, CPU)
    x = tr.images(c["sizes"], 8, seed, 1, CPU)

    def softmax_attention(q, k, v, name):
        return torch.softmax((q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5, -1) @ v

    got = M.apply({n: {"w": t} for n, t in w.items()}, cfg, x, attention=softmax_attention)
    assert torch.equal(got, spikformer.logits(w, c["sizes"], x))
    margin = torch.full((8,), float("inf"), dtype=torch.float64)
    ref64 = spikformer.logits(w, c["sizes"], x, "float64", margin)
    assert ref64.dtype == torch.float64 and bool((margin < float("inf")).all())


def test_control_precisions():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, -3.0 - 2**-12])
    assert to_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2**-9, 1.0, -3.0]
    a, w = torch.tensor([[1.0 + 2**-12]]), torch.tensor([[1.0]])
    assert matmul(a, w).item() == 1.0 + 2**-12
    assert matmul(a, w, "tf32").item() == 1.0
    assert matmul(a, w, "bfloat16").item() == 1.0
    with pytest.raises(ValueError):
        matmul(a, w, "int3")
