"""Mesh-sharded paged serving on the PyTorch port: one replica = one
device slice. The twin of ``examples/sharded_serve.py``.

Runs the SAME workload through an unsharded paged engine and a
mesh-sharded one, then proves the tokens and the tick schedule are
bit-identical: the width-invariance oracle, live. The paged KV pool's
heads axis is laid out over the mesh's "model" axis (``DTensor`` leaves,
each rank writing its own heads slice in place); the allocator and page
tables never leave the host.

The mesh takes every rank there is, one per device: run alone it is a
1-device mesh; under ``torchrun --nproc-per-node N`` (``--device cpu``
for gloo ranks on the host) it is N-way, and rank 0 prints.

  PYTHONPATH=src python examples/torch_sharded_serve.py --quick --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 2 examples/torch_sharded_serve.py \\
      --quick --device cpu
  PYTHONPATH=src python examples/torch_sharded_serve.py      # on the card
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.launch.mesh import (make_serve_mesh,  # noqa: E402
                                     release_world)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve import paging  # noqa: E402
from repro_torch.serve.engine import PagedServeEngine, Request  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="tiny workload (the CI smoke)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the model and the mesh "
                         "(default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # KV heads sized to divide any small mesh width
    cfg = ModelConfig(name="micro4", family="dense", num_layers=2,
                      d_model=32, d_ff=64, vocab_size=64, num_heads=4,
                      num_kv_heads=4, dtype="float32",
                      param_dtype="float32")
    n_req = args.requests or (4 if args.quick else 6)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)

    mesh = make_serve_mesh(device_type=dev.type)   # every rank on "model"
    width = mesh.size()
    say = print if not any(mesh.get_coordinate()) else (
        lambda *a, **k: None)
    say(f"serve mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
        f"({width} visible devices)")

    def drive(m):
        rng = np.random.default_rng(3)
        eng = PagedServeEngine(cfg, params, max_slots=3, max_len=32,
                               page_len=8, mesh=m)
        for uid in range(n_req):
            plen = int(rng.integers(3, 12))
            n_new = int(rng.integers(3, 9))
            eng.submit(Request(uid, rng.integers(cfg.vocab_size, size=plen)
                               .astype(np.int32), n_new))
        t0 = time.time()
        fin = eng.run_to_completion()
        dt = time.time() - t0
        eng.check_invariants()
        assert eng.alloc.allocated_pages == 0
        return {r.uid: tuple(r.generated) for r in fin}, eng, dt

    base, eng_u, dt_u = drive(None)
    got, eng_m, dt_m = drive(mesh)

    shards = eng_m.shards
    say(f"gather shards: {shards} "
        f"({'pool heads sharded over model' if shards > 1 else 'replicated'})"
        f"; page_len priced per shard -> "
        f"{paging.choose_page_len(cfg, expected_tokens=32, shards=shards)}")
    toks = sum(len(v) for v in base.values())
    say(f"unsharded: {toks} tokens, {eng_u.steps} ticks ({dt_u:.1f}s)")
    say(f"{width}-way mesh: {sum(len(v) for v in got.values())} tokens, "
        f"{eng_m.steps} ticks ({dt_m:.1f}s)")

    assert got == base, "sharded tokens diverged from unsharded"
    assert eng_m.steps == eng_u.steps, "tick schedule changed"
    say(f"ok: {width}-way mesh bit-identical to unsharded "
        f"({toks} tokens, {eng_u.steps} ticks), zero leaks")
    release_world()


if __name__ == "__main__":
    main()
