"""End-to-end training run, on the PyTorch port. The twin of
``examples/quickstart.py``.

Default: a ~10M-param dense LM trained a few hundred steps on the
synthetic bigram corpus, loss dropping well below ln(V). ``--preset
100m`` selects the ~100M-parameter config. The model trains on
``--device`` (``cuda`` unless named), the state updated in place. Exits
non-zero unless the last ce is below 0.8x the first.

  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
  PYTHONPATH=src python examples/torch_quickstart.py --preset 100m --steps 300
"""

import argparse
import dataclasses
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import configs, resolve_device  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.optim import AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.train.fault import StepWatchdog, run_training  # noqa: E402
from repro_torch.train.loop import init_state, make_train_step  # noqa: E402

PRESETS = {
    # ~10M params: runs a few hundred steps in minutes on CPU
    "10m": dict(num_layers=4, d_model=256, d_ff=1024, vocab_size=2048,
                num_heads=8, num_kv_heads=4, head_dim=32),
    # ~100M params
    "100m": dict(num_layers=12, d_model=768, d_ff=3072, vocab_size=8192,
                 num_heads=12, num_kv_heads=4, head_dim=64),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    base = configs.get_config("granite-8b")   # llama-style block layout
    cfg = dataclasses.replace(base, dtype="float32", param_dtype="float32",
                              **PRESETS[args.preset])
    opt = AdamWConfig(lr=args.lr)
    state = init_state(cfg, opt, torch.Generator(device=device).manual_seed(0),
                       device)
    n = sum(p.numel() for p in state.params.parameters())
    print(f"preset={args.preset}: {n/1e6:.1f}M params, "
          f"{args.steps} steps × {args.batch}×{args.seq} tokens")

    lr_fn = cosine_schedule(args.lr, warmup=args.steps // 10,
                            total=args.steps)
    step = make_train_step(cfg, opt, lr_fn=lr_fn, in_place=True)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=1)

    def data_fn(s):
        b = data.batch(s)
        return {k: torch.from_numpy(b[k]).to(device)
                for k in ("tokens", "labels")}

    wd = StepWatchdog()
    hist = []

    def log(s, m):
        hist.append(float(m["ce"]))
        if (s + 1) % 20 == 0:
            print(f"  step {s+1:4d}  ce={hist[-1]:.4f}  "
                  f"({args.batch*args.seq/max(wd.last_duration,1e-9):,.0f} tok/s)")

    t0 = time.time()
    run_training(state, step, data_fn, num_steps=args.steps, watchdog=wd,
                 on_metrics=log)
    print(f"done in {time.time()-t0:.0f}s: ce {hist[0]:.3f} -> {hist[-1]:.3f} "
          f"(uniform would be {math.log(cfg.vocab_size):.3f})")
    assert hist[-1] < hist[0] * 0.8, "loss should drop"
    return hist


if __name__ == "__main__":
    main()
