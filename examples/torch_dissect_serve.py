"""Dissect-on-start on the PyTorch port: blind-profile a GPU, then serve
priced by it. The twin of ``examples/dissect_serve.py``.

The port's batched torch engine recovers the target GPU's cache
structures from scratch (no published numbers, no committed artifact:
the trace cache is bypassed), the fresh in-memory profile binds a fleet
replica through the ``resolve_spec()`` seam, and the replica derives its
page length from the structures it just measured. The model runs on
``--device`` (``cuda`` unless named), and so does the engine's scan.

  PYTHONPATH=src python examples/torch_dissect_serve.py            # granite smoke
  PYTHONPATH=src python examples/torch_dissect_serve.py --quick    # micro
  PYTHONPATH=src python examples/torch_dissect_serve.py --quick --device cpu
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs, resolve_device  # noqa: E402
from repro_torch.core import tracecache  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.profile.pipeline import dissect_device  # noqa: E402
from repro_torch.serve.fleet import FleetEngine  # noqa: E402
from repro_torch.serve.frontend import FleetFrontend  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="micro model + tiny workload")
    ap.add_argument("--target", default="GTX980",
                    help="the registered GPU to dissect")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the model and the engine's scan "
                         "(default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    with tracecache.disabled():      # force real simulation, not replay
        prof = dissect_device(args.target, engine="torch", device=dev)
    dt = time.perf_counter() - t0
    measured = sorted(n for n, c in prof.caches.items()
                      if c.provenance == "measured")
    print(f"dissected {prof.device} in {dt:.2f}s wall "
          f"(engine={prof.engine}, stage total "
          f"{prof.timings['total']:.3f}s)")
    for name in measured:
        c = prof.caches[name]
        print(f"  {name}: C={c.size_bytes}B b={c.line_bytes}B "
              f"sets={c.num_sets} assoc={c.assoc:g} "
              f"[{prof.timings.get(name, 0.0):.3f}s]")
    assert measured, "blind search recovered no structures"

    if args.quick:
        cfg = ModelConfig(name="micro", family="dense", num_layers=2,
                          d_model=32, d_ff=64, vocab_size=64, num_heads=2,
                          num_kv_heads=2, dtype="float32",
                          param_dtype="float32")
        n_req, slots, max_len = 4, 2, 24
    else:
        cfg = configs.get_smoke_config("granite-8b")
        n_req, slots, max_len = 6, 3, 48
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)

    # the DeviceProfile object itself binds the replica: no artifact on
    # disk, no registry lookup
    fleet = FleetEngine(cfg, params, max_slots=slots, max_len=max_len,
                        profiles=[prof])
    r = fleet.replicas[0]
    print(f"replica {r.name}: page_len={r.engine.page_len} "
          f"(derived from the fresh profile), "
          f"pool={r.engine.alloc.num_pages} pages")

    front = FleetFrontend(fleet)
    rng = np.random.default_rng(0)
    for uid in range(n_req):
        plen = int(rng.integers(3, max_len // 3))
        n_new = int(rng.integers(3, max_len // 3))
        prompt = rng.integers(cfg.vocab_size, size=plen).astype(np.int32)
        front.submit_blocking(prompt, n_new, uid=uid)
    handles = front.run()

    fleet.check_invariants()
    s = fleet.stats()
    toks = sum(len(h.tokens) for h in handles)
    print(f"served {toks} tokens from {s['finished']} requests on the "
          f"freshly-dissected replica; pages leaked: {s['pages_leaked']}")
    assert len(handles) == n_req and all(h.done for h in handles)
    assert s["pages_leaked"] == 0
    print("ok: dissect-on-start bound the fleet to measured structures")


if __name__ == "__main__":
    main()
