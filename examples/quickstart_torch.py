"""Quickstart for the PyTorch port: the full Phi workflow on a small SNN.

    PYTHONPATH=src python examples/quickstart_torch.py                # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # plain versions

Steps (paper Sec. 3.4 workflow), as ``examples/quickstart.py`` runs them in
the JAX package:
  1. train a small spiking CNN with surrogate gradients (synthetic data);
  2. Phi calibration: k-means patterns per K-partition + offline PWPs;
  3. lossless Phi inference (L1 PWP retrieval + L2 ±1 correction), checked
     against dense spiking inference;
  4. PAFT fine-tuning (on the card the matcher kernel assigns the patterns
     each step): L2 density drops, accuracy holds;
  5. report Table-4-style densities and theoretical speedups.
"""
import argparse
import sys

import numpy as np
import torch

sys.path.insert(0, "src")

from repro_torch.core import paft  # noqa: E402
from repro_torch.core.assign import phi_stats  # noqa: E402
from repro_torch.core.patterns import PhiConfig  # noqa: E402
from repro_torch.snn import data, models, train  # noqa: E402
from repro_torch.snn.models import SNNConfig  # noqa: E402
from repro_torch.utils import resolve_device  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args().device)
    torch.backends.cuda.matmul.allow_tf32 = False

    print(f"=== 1. train a spiking VGG on synthetic images ({dev}) ===")
    x, y = data.synthetic_images(768, 10, size=16, seed=0)
    cfg = SNNConfig(kind="vgg", widths=(32, 64), timesteps=4, input_size=16,
                    phi=PhiConfig(k=16, q=64, iters=10))
    params, _ = train.train(cfg, x, y, steps=120, batch=64, log_every=40, device=dev)
    acc = train.evaluate(params, cfg, x[:512], y[:512])
    print(f"accuracy: {acc:.3f}")

    print("=== 2. Phi calibration (patterns + PWPs) ===")
    calib = torch.from_numpy(x[:96]).to(dev)
    phi, acts = models.calibrate_model(params, cfg, calib)
    for name, act in acts.items():
        st = phi_stats(act, phi.patterns[name])
        print(f"  {name}: bit={st.bit_density:.3f} L1={st.l1_density:.3f} "
              f"L2={st.l2_density:.4f} spB={st.speedup_over_bit:.1f}x "
              f"spD={st.speedup_over_dense:.0f}x")

    print("=== 3. lossless Phi inference ===")
    xb = torch.from_numpy(x[:64]).to(dev)
    with torch.no_grad():
        logits_dense = models.apply(params, cfg, xb)
    logits_phi = models.phi_apply(params, cfg, phi, xb)
    err = float((logits_dense - logits_phi).abs().max())
    print(f"max |dense − phi| = {err:.2e}  (paper: Phi w/o PAFT is lossless)")
    assert err < 1e-3

    print("=== 4. PAFT fine-tuning ===")
    p2, _ = paft.paft_finetune(params, cfg, phi, x, y, lam=0.5, lr=3e-4, steps=80, device=dev)
    acc2 = train.evaluate(p2, cfg, x[:512], y[:512])
    phi2, acts2 = models.calibrate_model(p2, cfg, calib)
    d0 = np.mean([phi_stats(acts[n], phi.patterns[n]).l2_density for n in acts])
    d1 = np.mean([phi_stats(acts2[n], phi2.patterns[n]).l2_density for n in acts2])
    print(f"L2 density {d0:.4f} -> {d1:.4f} ({d0 / max(d1, 1e-9):.2f}x denser-sparse), "
          f"accuracy {acc:.3f} -> {acc2:.3f}")
    print("done.")


if __name__ == "__main__":
    main()
