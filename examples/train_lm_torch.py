"""End-to-end LM training with the PyTorch port: data pipeline + AdamW +
checkpointing + watchdog + crash-resume, on a reduced assigned-architecture
config (as ``examples/train_lm.py`` runs it in the JAX package).

    PYTHONPATH=src python examples/train_lm_torch.py --arch olmo_1b --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

Defaults train a ~20M-param olmo-family model for a few hundred steps on the
synthetic corpus; loss should fall from ~ln(vocab) toward the corpus's
template structure. Use --params-100m for the ~100M variant. Kill it mid-run
and re-run with the same --ckpt-dir: it resumes from the newest checkpoint.
Runs on the card unless --device names another.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.utils import log  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_lm_ckpt"))
    ap.add_argument("--params-100m", action="store_true",
                    help="~100M-param variant (d_model 512, 8 layers)")
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda; cpu runs the plain versions)")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=True)
    if args.params_100m:
        cfg = cfg.with_(d_model=512, n_layers=8, n_heads=8, n_kv_heads=8,
                        d_ff=2048, vocab=32000)
    else:
        cfg = cfg.with_(d_model=256, n_layers=4, n_heads=8, n_kv_heads=8,
                        d_ff=1024, vocab=8192)
    tot, _ = cfg.param_count()
    log.info("training %s variant: %.1fM params on %s", cfg.name, tot / 1e6, args.device)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=20, decay_steps=args.steps)
    _, losses = train_loop(cfg, ocfg, steps=args.steps, global_batch=args.batch,
                           seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                           device=args.device)
    if losses:
        log.info("loss: first=%.3f last10=%.3f", losses[0],
                 sum(losses[-10:]) / len(losses[-10:]))
    else:
        log.info("nothing to do: %s already holds step %d", args.ckpt_dir, args.steps)


if __name__ == "__main__":
    main()
