"""Training launcher of the PyTorch port.

Twin of ``repro/launch/train.py``: the synthetic data pipeline, AdamW on
the cosine schedule, checkpoint/restart and the straggler watchdog, on
one device (``--device``, ``cuda`` unless named; without a card the
default fails, nothing falls back). The step updates the state in place,
the counterpart of the reference's ``donate_argnums=0``.

  python -m repro_torch.launch.train --arch granite-8b --smoke --steps 200 \\
      --device cpu
  python -m repro_torch.launch.train --arch granite-8b --smoke --steps 200 \\
      --preempt-at 97 --ckpt-dir DIR && python -m repro_torch.launch.train \\
      ...   # resumes
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.train.fault import StepWatchdog, run_training
from repro_torch.train.loop import init_state, make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="training launcher of the PyTorch port: synthetic "
                    "data, AdamW, checkpoint/restart, straggler watchdog")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced per-arch config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the "
                         "host)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--preempt-at", type=int, default=None,
                    help="simulate preemption at this step (testing)")
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def _state(cfg, opt, device, compress: bool):
    """The initial state: the port's ``init_state`` from a generator
    seeded 0 on ``device``. Tests replace it to hand the launcher the
    reference's state."""
    return init_state(cfg, opt, torch.Generator(device=device).manual_seed(0),
                      device, compress=compress)


def main(argv=None):
    args = build_parser().parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if cfg.frontend is not None:
        raise SystemExit("train.py drives LM archs; frontends use the "
                         "examples/ drivers")
    device = resolve_device(args.device)
    opt = AdamWConfig(lr=args.lr)
    lr_fn = cosine_schedule(args.lr, warmup=max(1, args.steps // 20),
                            total=args.steps)
    state = _state(cfg, opt, device, args.compress_grads)
    nparams = sum(p.numel() for p in state.params.parameters())
    ndev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"arch={cfg.name} params={nparams:,} devices={ndev}")

    step_fn = make_train_step(
        cfg, opt, lr_fn=lr_fn, microbatches=args.microbatches,
        compress_grads=args.compress_grads, in_place=True)

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=1)

    def data_fn(s):
        b = data.batch(s)
        return {k: torch.from_numpy(b[k]).to(device)
                for k in ("tokens", "labels")}

    wd = StepWatchdog()
    t_start = time.time()
    tokens_per_step = args.batch * args.seq

    def log(s, m):
        if (s + 1) % args.log_every == 0:
            rate = tokens_per_step / max(wd.last_duration, 1e-9)
            print(f"step {s+1:5d} loss={float(m['loss']):.4f} "
                  f"ce={float(m['ce']):.4f} gnorm={float(m['grad_norm']):.3f} "
                  f"tok/s={rate:,.0f} stragglers={wd.stragglers}")

    state, metrics = run_training(
        state, step_fn, data_fn, num_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        preempt_at=args.preempt_at, watchdog=wd, on_metrics=log)
    dt = time.time() - t_start
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps * tokens_per_step / dt:,.0f} tok/s) "
          f"final_loss={float(metrics['loss']):.4f}")
    return state, metrics


if __name__ == "__main__":
    main()
