"""Heterogeneous serving fleet with streamed tokens, on the PyTorch port.
The twin of ``examples/fleet_serve.py``.

Two paged replicas, one priced by the committed tpu_v5e profile and one
by the measured TeslaV100 profile, behind the cost-model router, with
per-token streaming callbacks from the deterministic front end. The
replicas derive different page lengths from their own profiles. The
model runs on ``--device`` (``cuda`` unless named); both replicas share
one copy of the weights.

  PYTHONPATH=src python examples/torch_fleet_serve.py            # granite smoke
  PYTHONPATH=src python examples/torch_fleet_serve.py --quick    # micro
  PYTHONPATH=src python examples/torch_fleet_serve.py --quick --device cpu
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
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve.fleet import FleetEngine  # noqa: E402
from repro_torch.serve.frontend import FleetFrontend  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="micro model + tiny workload")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the model (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.quick:
        cfg = ModelConfig(name="micro", family="dense", num_layers=2,
                          d_model=32, d_ff=64, vocab_size=64, num_heads=2,
                          num_kv_heads=2, dtype="float32",
                          param_dtype="float32")
        n_req, slots, max_len = args.requests or 5, 2, 24
    else:
        cfg = configs.get_smoke_config("granite-8b")
        n_req, slots, max_len = args.requests or 8, 3, 48
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)

    fleet = FleetEngine(cfg, params, max_slots=slots, max_len=max_len,
                        profiles=["tpu_v5e", "TeslaV100"])
    for r in fleet.replicas:
        print(f"replica {r.name}: page_len={r.engine.page_len} "
              f"(derived from its own profile), "
              f"pool={r.engine.alloc.num_pages} pages, "
              f"Little's-law inflight bound={r.inflight_bound}")

    front = FleetFrontend(fleet)
    streams: dict[int, list[int]] = {}

    def on_token(uid, tok):
        streams.setdefault(uid, []).append(tok)
        if len(streams[uid]) <= 3:      # show the stream coming alive
            print(f"    uid {uid} token #{len(streams[uid])}: {tok}")

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for uid in range(n_req):
        plen = int(rng.integers(3, max_len // 3))
        n_new = int(rng.integers(3, max_len // 3))
        prompt = rng.integers(cfg.vocab_size, size=plen).astype(np.int32)
        # submit_blocking rides out Backpressure by ticking the loop
        front.submit_blocking(prompt, n_new, uid=uid, on_token=on_token)
    handles = front.run()
    dt = time.perf_counter() - t0

    fleet.check_invariants()
    s = fleet.stats()
    toks = sum(len(h.tokens) for h in handles)
    print(f"\nstreamed {toks} tokens from {s['finished']} requests in "
          f"{s['ticks']} fleet ticks ({dt:.1f}s)")
    print(f"router: {s['decisions']} decisions, {s['migrations']} "
          f"migrations, {s['preemptions']} preemptions; "
          f"pages leaked: {s['pages_leaked']}")
    for p in s["per_replica"]:
        print(f"  {p['replica']}: finished={p['finished']} "
              f"peak_pages={p['peak_pages']}")
    assert len(handles) == n_req and all(h.done for h in handles)
    assert s["pages_leaked"] == 0
    assert not fleet.margin_violations()
    assert {uid: h.tokens for uid, h in enumerate(handles)} == streams
    print("ok: all streams complete, router honored its margin, "
          "zero leaks")


if __name__ == "__main__":
    main()
