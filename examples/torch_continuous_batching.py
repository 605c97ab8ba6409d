"""Continuous-batching serving on the PyTorch port: 8 mixed-length
requests through 3 cache slots. Slots recycle as requests finish, and
every decode tick is batched. The twin of
``examples/continuous_batching.py``; the model runs on ``--device``
(``cuda`` unless named).

  PYTHONPATH=src python examples/torch_continuous_batching.py --device cpu
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs, resolve_device  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device for the model (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get_smoke_config("granite-8b")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    engine = ServeEngine(cfg, params, max_slots=3, max_len=64)

    rng = np.random.default_rng(0)
    for uid in range(8):
        plen = int(rng.integers(4, 20))
        n_new = int(rng.integers(3, 12))
        engine.submit(Request(
            uid, rng.integers(cfg.vocab_size, size=plen).astype(np.int32),
            n_new))
    print(f"8 requests queued into {engine.max_slots} slots "
          f"(prompt 4-19, gen 3-11 tokens)")

    t0 = time.time()
    finished = engine.run_to_completion()
    dt = time.time() - t0
    s = engine.stats()
    print(f"finished {s['finished']} requests in {s['steps']} engine ticks "
          f"({dt:.1f}s): {s['decoded_tokens']} tokens, "
          f"slot occupancy {s['avg_batch_occupancy']:.0%}")
    for r in finished[:3]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.generated}")
    assert len(finished) == 8


if __name__ == "__main__":
    main()
