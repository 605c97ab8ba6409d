"""Serving launcher of the port: the fixed-batch prefill+decode loop, or
the dense or paged continuous-batching engine over a synthetic workload.

  # fixed-batch loop
  python -m repro_torch.launch.serve --arch granite-8b --smoke --batch 4 \
      --prompt-len 64 --gen 32

  # dense-slot continuous batching on a mixed workload
  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --engine dense --requests 16 --slots 4 --max-len 96

  # paged KV cache (page_len derived from the cost model when --page-len
  # is omitted; --num-pages sizes the pool)
  python -m repro_torch.launch.serve --arch granite-8b --smoke \
      --engine paged --requests 16 --slots 4 --max-len 96 \
      [--page-len 8] [--num-pages 32] [--prefill-chunk 16]

Twin of ``repro/launch/serve.py`` for ``--engine loop|dense|paged`` and
``--profile``. It runs on the card unless ``--device cpu`` is given; with
no card the default fails. The fleet, the planner and serving meshes are
not ported yet and exit with a message.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models import transformer as T
from repro_torch.profile import install_profile
from repro_torch.serve import paging
from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine
from repro_torch.train.loop import make_serve_step

_NOT_PORTED = ("is not ported to PyTorch yet (ROADMAP.md, queue 1 items 6 "
               "and 10)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _batch_loop(cfg, params, args) -> dict:
    """Prefill a seeded batch of prompts, then greedy-decode ``gen - 1``
    steps. Returns the timings and the generated tokens (B, gen)."""
    device = params.embed.device
    max_len = args.prompt_len + args.gen
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)
                            ).to(device)
    t0 = time.perf_counter()
    logits, cache = T.prefill(params, cfg, {"tokens": prompts},
                              max_len=max_len)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    serve_step = make_serve_step(cfg)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = serve_step(params, cache, tok, args.prompt_len + i)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    gen = torch.cat(out, dim=1).cpu()
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={device}")
    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({args.batch*args.prompt_len/t_prefill:,.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.1f} ms "
          f"({args.batch*(args.gen-1)/max(t_decode,1e-9):,.0f} tok/s)")
    print("sample tokens:", gen[0, :16].tolist())
    return {"prefill_s": t_prefill, "decode_s": t_decode, "tokens": gen}


def _workload(cfg, args) -> list[Request]:
    rng = np.random.default_rng(args.seed)
    reqs = []
    for uid in range(args.requests):
        plen = int(rng.integers(4, max(5, args.max_len // 3)))
        n_new = int(rng.integers(4, max(5, args.max_len // 3)))
        reqs.append(Request(uid, rng.integers(cfg.vocab_size, size=plen)
                            .astype(np.int32), n_new))
    return reqs


def _paged_engine(cfg, params, args) -> PagedServeEngine:
    """The paged engine of ``args``, with the page-length rationale
    printed as the JAX launcher prints it."""
    eng = PagedServeEngine(cfg, params, max_slots=args.slots,
                           max_len=args.max_len, page_len=args.page_len,
                           num_pages=args.num_pages,
                           prefill_chunk=args.prefill_chunk)
    print(f"page_len={eng.page_len} "
          f"({'given' if args.page_len else 'cost-model derived'}), "
          f"pool={eng.alloc.num_pages} pages")
    for t in paging.page_len_rationale(cfg, expected_tokens=args.max_len,
                                       shards=eng.shards):
        marker = " <-- chosen" if t.page_len == eng.page_len else ""
        print(f"  candidate {t.page_len:4d}: score={t.score:.4f} "
              f"gather={t.gather_frac:.3f} frag={t.frag_frac:.3f} "
              f"conflict_degree={t.conflict_degree}{marker}")
    return eng


def _engine_run(cfg, params, args, engine=None) -> dict:
    """Drive the dense or paged engine over :func:`_workload` to
    completion. ``engine`` (built by the caller) replaces the one ``args``
    names. Returns the engine, the finished requests and the wall
    seconds."""
    if engine is not None:
        eng = engine
    elif args.engine == "paged":
        eng = _paged_engine(cfg, params, args)
    else:
        eng = ServeEngine(cfg, params, max_slots=args.slots,
                          max_len=args.max_len)
    reqs = _workload(cfg, args)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    finished = eng.run_to_completion()
    _sync(eng.device)
    dt = time.perf_counter() - t0
    s = eng.stats()
    toks = sum(len(r.generated) for r in finished)
    print(f"arch={cfg.name} engine={args.engine} requests={len(finished)} "
          f"slots={args.slots} max_len={args.max_len} device={eng.device}")
    print(f"generated {toks} tokens in {s['steps']} ticks, {dt*1e3:.1f} ms "
          f"({toks/max(dt,1e-9):,.0f} tok/s wall)")
    print(f"occupancy={s['avg_batch_occupancy']:.2f}")
    if isinstance(eng, PagedServeEngine):
        print(f"peak pages={s['peak_pages']} "
              f"(dense would reserve {args.slots * args.max_len} tokens; "
              f"peak paged ~= {s['peak_pages'] * eng.page_len}), "
              f"preemptions={s['preemptions']}, "
              f"max slack={s['max_slack_tokens']} tok "
              f"(<= 1 page of {eng.page_len})")
    if finished:
        print("sample tokens:", finished[0].generated[:16])
    return {"engine": eng, "finished": finished, "wall_s": dt}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="serving launcher of the PyTorch port: fixed-batch "
                    "loop or the dense/paged continuous-batching engines")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", choices=("loop", "dense", "paged", "fleet"),
                    default="loop",
                    help="loop: fixed-batch prefill+decode; dense/paged: "
                         "continuous-batching engines on a mixed workload; "
                         "fleet is not ported yet")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    # fixed-batch loop knobs
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    # engine knobs
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--page-len", type=int, default=None,
                    help="KV page length; omit to derive it from the cost "
                         "model (littles_law + bankconflict)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size; omit for dense-equivalent capacity")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens admitted per tick (multiple of "
                         "page_len; default one page)")
    ap.add_argument("--profile", metavar="PATH_OR_DEVICE", default=None,
                    help="dissected DeviceProfile artifact (repro.profile/v1 "
                         "JSON, or a device name under experiments/profiles/) "
                         "that page sizing consumes instead of the built-in "
                         "TPU_V5E constants; tpu-family profiles only, as "
                         "in the JAX package")
    ap.add_argument("--seed", type=int, default=0)
    # the JAX launcher's options that the port does not have yet
    ap.add_argument("--plan", action="store_true", help="not ported yet")
    ap.add_argument("--mesh-shape", default=None, help="not ported yet")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag, given in (("--engine fleet", args.engine == "fleet"),
                        ("--plan", args.plan),
                        ("--mesh-shape", args.mesh_shape)):
        if given:
            raise SystemExit(f"{flag} {_NOT_PORTED}")
    if args.profile:
        prof = install_profile(args.profile)
        print(f"profile: {prof.summary()}")
    device = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    if args.engine == "loop":
        return _batch_loop(cfg, params, args)
    return _engine_run(cfg, params, args)


if __name__ == "__main__":
    main()
