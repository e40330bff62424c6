"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --smoke --device cpu --steps 20 --ckpt-dir /tmp/ck --fail-at-step 8

Port of ``repro/launch/train.py``, with ``--device``: the card (``cuda``)
unless given ``cpu``. ``--smoke`` uses the reduced same-family config
(CPU-runnable); without it the full config trains at its published widths
and depth, which on the card is gemma-2b's 2.51 B parameters in bf16 with
fp32 AdamW moments. A config with the ``embeddings`` frontend (frame
embeddings and labels, no token ids) is refused, as the reference refuses
it: the synthetic and memmap sources yield tokens only.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import get_arch, smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.train import LoopConfig, TrainLoop, run_with_restarts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a failure (demonstrates restart)")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed)
    if cfg.frontend == "embeddings":
        raise SystemExit(f"{cfg.name} takes frontend embeddings; the data "
                         "pipeline yields token ids only")

    def make_loop(attempt: int) -> TrainLoop:
        lc = LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir, seed=args.seed,
                        fail_at_step=args.fail_at_step if attempt == 0 else None,
                        peak_lr=args.peak_lr)
        return TrainLoop(cfg, data_cfg, lc, device=args.device)

    metrics = run_with_restarts(make_loop, max_restarts=args.max_restarts)
    print(f"[train] done: {len(metrics.losses)} steps this process, "
          f"final loss {metrics.losses[-1]:.4f}, "
          f"stragglers {metrics.straggler_events}, "
          f"restored_from={metrics.restored_from}")
    return metrics


if __name__ == "__main__":
    main()
