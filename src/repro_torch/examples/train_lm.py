"""End-to-end training driver: train a (reduced) qwen3-family LM with the
full production stack — GeoFF-prefetched data pipeline, pre-warmed step,
async checkpointing, straggler detection, and a mid-run
checkpoint/restart drill.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \
        [--arch qwen3-1.7b] [--device cpu]

Port of ``examples/train_lm.py``: the same flags plus ``--device`` (the
card by default), the same reduced config. ``--ckpt-dir`` defaults to a
directory under the temporary directory; a directory that already holds
checkpoints is resumed from, as in the reference. The resumed step printed
is the first step the restarted trainer ran.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs.registry import smoke_config
from repro_torch.models.params import check_device
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def reduced_config(arch: str):
    return smoke_config(arch).replace(d_model=128, num_heads=4, head_dim=32,
                                      d_ff=512)


def trainer_config(steps: int, seq_len: int, batch: int, ckpt_dir: str):
    return TrainerConfig(
        seq_len=seq_len, global_batch=batch, total_steps=steps,
        checkpoint_every=50, checkpoint_dir=ckpt_dir,
        adamw=AdamWConfig(peak_lr=1e-3, warmup_steps=20, total_steps=steps))


def drill(cfg, tcfg, device="cuda"):
    """Half the steps, then a fresh trainer on the same checkpoint directory
    (the live one dropped, as after a crash) runs the rest. Returns (first
    trainer, restarted trainer)."""
    half = tcfg.total_steps // 2
    tr = Trainer(cfg, tcfg, device=device)
    tr.run(half)
    tr2 = Trainer(cfg, tcfg, device=device)
    tr2.run(tcfg.total_steps - half)
    return tr, tr2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda", help="'cpu' to run on the host")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    cfg = reduced_config(args.arch)
    tcfg = trainer_config(args.steps, args.seq_len, args.batch, args.ckpt_dir)
    print(f"training {args.arch} (reduced) for {args.steps // 2} steps, then "
          "simulating failure: dropping the live trainer, restarting from "
          "the latest checkpoint...")
    tr, tr2 = drill(cfg, tcfg, device)
    print(f"  step {tr.step}: loss={tr.metrics_log[-1]['loss']:.4f}")
    log = tr2.metrics_log

    first = np.mean([m["loss"] for m in log[:10]])
    last = np.mean([m["loss"] for m in log[-10:]])
    print(f"resumed at step {log[0]['step']}; finished at step {tr2.step}")
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'DECREASED' if last < first else 'did not decrease'})")
    print(f"stragglers detected: {len(tr2.stragglers)}")
    print(f"checkpoint stats: {tr2.ckpt.stats}")
    assert last < first, "loss should fall on the synthetic corpus"
    return {"first_losses": [m["loss"] for m in tr.metrics_log],
            "losses": [m["loss"] for m in log], "resumed_at": log[0]["step"],
            "finished_at": tr2.step, "first": float(first), "last": float(last),
            "stragglers": len(tr2.stragglers), "checkpoint": dict(tr2.ckpt.stats)}


if __name__ == "__main__":
    main()
