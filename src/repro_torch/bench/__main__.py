"""CLI for the port's dissection harness.

  python -m repro_torch.bench list   [--device D] [--tag T] [--section S]
  python -m repro_torch.bench run    [filters] [--quick] [--strict] [--out F]
                                     [--report F] [--no-csv]
                                     [--torch-device T]
  python -m repro_torch.bench report [ARTIFACT] [-o F]
  python -m repro_torch.bench profile dissect DEVICE [--quick] [--engine E]
                                     [--out F] [--torch-device T]
  python -m repro_torch.bench profile show     DEVICE|PATH
  python -m repro_torch.bench profile diff     DEVICE|PATH [--fresh]
  python -m repro_torch.bench profile validate [PATH] [--root DIR]
  python -m repro_torch.bench docs   [--check] [--only TARGET] [-o FILE]

A copy of ``python -m repro.bench`` for the port. ``--device`` keeps the
reference's meaning, a registered device to filter by; ``--torch-device``
names where tensors live and kernels launch: ``cuda`` unless named, and
with no card ``run`` fails instead of falling back to the CPU. Artifacts
go under ``build/repro_torch/`` (``bench/latest.json``,
``profiles/<DEVICE>.json``, ``traces/``); the port writes nothing under
``experiments/`` or ``docs/``, and reads the committed profiles from
``experiments/profiles/``. ``docs`` (re)generates the port's generated
documents — ``experiments.md`` from the registry, ``serving.md``,
``profiles.md`` and ``cli.md`` from ``bench/docsgen.py`` — under
``build/repro_torch/docs/``, and ``--check`` exits 1 if any is stale.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch import resolve_device
from repro_torch.bench import registry, report, result, runner
from repro_torch.core import tracecache

DEFAULT_ARTIFACT = runner.HINT_ARTIFACT
#: where ``docs`` writes the generated documents
DOCS_ROOT = str(runner.ARTIFACT_DIR.parent / "docs")
#: where ``profile dissect`` writes without ``--out``
PROFILE_ROOT = str(runner.ARTIFACT_DIR.parent / "profiles")
DEFAULT_JOBS = max(1, min(os.cpu_count() or 1, 8))


def _add_filters(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", help="only this registered device")
    p.add_argument("--tag", help="only experiments carrying this tag")
    p.add_argument("--section", help="substring of the paper section, e.g. 4.4")
    p.add_argument("--only", action="append", default=[],
                   metavar="NAME", help="experiment name (repeatable)")


def _add_torch_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--torch-device", default="cuda", metavar="T",
                   help="torch device of the tensors and kernels (default "
                        "cuda; cpu runs the plain versions)")


def cmd_list(args: argparse.Namespace) -> int:
    exps = registry.select(device=args.device, tag=args.tag,
                           section=args.section, names=args.only or None)
    print(f"{len(exps)} experiments "
          f"({len(registry.REGISTRY)} registered):")
    for e in exps:
        print(f"  {e.name:28s} {e.artifact:12s} {e.section:10s} "
              f"devices={','.join(e.devices)} tags={','.join(e.tags) or '-'}")
    return 0


def cmd_run(args: argparse.Namespace) -> int:
    resolve_device(args.torch_device)   # no card: fail before any record
    cache_root = None if args.no_trace_cache else args.trace_cache
    tracecache.configure(cache_root)
    opts = runner.RunOptions(device=args.device, tag=args.tag,
                             section=args.section, names=tuple(args.only),
                             quick=args.quick, seed=args.seed,
                             jobs=max(1, args.jobs),
                             trace_cache_root=cache_root,
                             torch_device=args.torch_device)
    launches: dict[str, int] = {}
    records = runner.run_experiments(
        opts, progress=lambda s: print(f"# running {s}", file=sys.stderr),
        launches=launches)
    if not records:
        print("no experiments matched the filters", file=sys.stderr)
        return 2
    if not args.no_csv:
        print("name,us_per_call,derived")
        for name, us, derived in runner.records_to_rows(records):
            print(f"{name},{us:.1f},{derived}")
    payload = result.write_artifact(
        records, args.out,
        extra={"quick": args.quick, "filters": {
            "device": args.device, "tag": args.tag,
            "section": args.section, "only": args.only},
            "torch_device": args.torch_device,
            "kernel_launches": launches})
    if args.report:
        with open(args.report, "w") as fh:
            fh.write(report.render_report(records))
        print(f"# report -> {args.report}", file=sys.stderr)
    s = payload["summary"]
    print(f"# artifact -> {args.out}: {s['PASS']} PASS, "
          f"{s['DEVIATION']} DEVIATION, {s['ERROR']} ERROR, "
          f"{s['INFO']} info-only; kernel launches {launches}",
          file=sys.stderr)
    bad = s["DEVIATION"] + s["ERROR"]
    if bad and args.strict:
        for r in records:
            if r.verdict in (result.DEVIATION, result.ERROR):
                why = (r.error.strip().splitlines()[-1] if r.error else
                       "; ".join(f"{m.name}={m.measured} vs {m.expected}"
                                 for m in r.deviations))
                print(f"# {r.verdict}: {r.experiment} × {r.device}: {why}",
                      file=sys.stderr)
        return 1
    return 0


def cmd_report(args: argparse.Namespace) -> int:
    records = result.load_artifact(args.artifact)
    text = report.render_report(records)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text)
        print(f"wrote {args.output}", file=sys.stderr)
    else:
        print(text, end="")
    return 0


def _load_or_dissect(target: str, fresh: bool, quick: bool, seed: int,
                     torch_device: str):
    """Resolve a device name / artifact path into a DeviceProfile."""
    from repro_torch.profile import dissect_device, load_profile, path_for
    if target.endswith(".json"):
        if not fresh:
            return load_profile(target)
        # --fresh on a path: re-dissect the device the artifact names
        target = load_profile(target).device
    if not fresh and os.path.exists(path_for(target)):
        return load_profile(target)
    return dissect_device(target, quick=quick, seed=seed,
                          device=torch_device)


def cmd_profile(args: argparse.Namespace) -> int:
    from repro_torch import profile as P
    if args.action != "validate" and not args.target:
        raise ValueError(f"profile {args.action} requires a DEVICE or PATH")
    if args.action == "dissect":
        tracecache.configure(tracecache.DEFAULT_ROOT)
        prof = P.dissect_device(args.target, quick=args.quick,
                                seed=args.seed, engine=args.engine,
                                device=args.torch_device)
        path = P.save_profile(prof, args.out, root=PROFILE_ROOT)
        print(f"# profile -> {path}", file=sys.stderr)
        print(prof.summary())
        return 0
    if args.action == "show":
        tracecache.configure(tracecache.DEFAULT_ROOT)
        prof = _load_or_dissect(args.target, False, args.quick, args.seed,
                                args.torch_device)
        print(prof.summary())
        for name in sorted(prof.caches):
            print(f"  {name:22s} {prof.caches[name].summary()}")
        for cls in sorted(prof.latency):
            prov = prof.latency_provenance.get(cls, "?")
            print(f"  latency/{cls:14s} {prof.latency[cls]:8.0f} cyc "
                  f"[{prov}]")
        for k in sorted(prof.bandwidth):
            prov = prof.bandwidth_provenance.get(k, "?")
            print(f"  bandwidth/{k:12s} {prof.bandwidth[k]:8.2f} GB/s "
                  f"[{prov}]")
        if prof.bank_conflict:
            bc = prof.bank_conflict
            print(f"  bank_conflict         base={bc.get('base_cycles')} "
                  f"slope={bc.get('slope_cycles_per_way')} cyc/way "
                  f"[{bc.get('provenance', '?')}]")
        for k in sorted(prof.spec):
            print(f"  spec/{k:17s} {prof.spec[k]:.6g} "
                  f"[{prof.spec_provenance.get(k, '?')}]")
        stale = prof.is_stale()
        if stale:
            print(f"  STALE: {'; '.join(stale)}")
        return 0
    if args.action == "diff":
        tracecache.configure(tracecache.DEFAULT_ROOT)
        prof = _load_or_dissect(args.target, args.fresh, args.quick,
                                args.seed, args.torch_device)
        stale = prof.is_stale()
        if stale:
            # a stale artifact's measured numbers cannot be reproduced, so
            # a verdict against the CURRENT published tables is meaningless
            print(f"STALE profile {args.target}:", file=sys.stderr)
            for s in stale:
                print(f"  - {s}", file=sys.stderr)
            print("re-dissect (profile dissect DEVICE, or diff --fresh)",
                  file=sys.stderr)
            return 1
        pub = P.published_profile(prof.device)
        rows = P.diff_profiles(prof, pub)
        print(P.render_diff(rows, title=f"Profile diff: {prof.device}"),
              end="")
        bad = [r for r in rows if not r.ok]
        return 1 if bad else 0
    if args.action == "validate":
        if args.target:
            problems = {args.target: P.validate_file(args.target)}
        else:
            problems = P.validate_all(args.root)
        if not problems:
            # an empty root means the gate would verify NOTHING — that
            # is a failure, not a pass (a rename/typo must not go green)
            print(f"no profile artifacts under "
                  f"{args.root or P.DEFAULT_ROOT}", file=sys.stderr)
            return 1
        bad = 0
        for path, probs in problems.items():
            if probs:
                bad += 1
                print(f"INVALID {path}:")
                for p in probs:
                    print(f"  - {p}")
            else:
                print(f"ok      {path}")
        return 1 if bad else 0
    raise ValueError(f"unknown profile action {args.action!r}")


def _doc_targets() -> dict[str, tuple[str, "callable"]]:
    """Every generated doc: name -> (default path, renderer). Renderers
    import lazily: ``cli`` pulls the launchers."""
    from repro_torch.bench import docsgen
    return {
        name: (os.path.join(DOCS_ROOT, f"{name}.md"), render)
        for name, render in (("experiments", report.experiments_doc),
                             ("serving", docsgen.serving_doc),
                             ("profiles", docsgen.profiles_doc),
                             ("cli", docsgen.cli_doc))
    }


def cmd_docs(args: argparse.Namespace) -> int:
    targets = _doc_targets()
    if args.output and not args.only:
        # historical single-file form: -o PATH acts on experiments.md
        args.only = "experiments"
    names = [args.only] if args.only else list(targets)
    stale = []
    for name in names:
        default_path, render = targets[name]
        path = args.output if (args.only and args.output) else default_path
        text = render()
        if args.check:
            try:
                with open(path) as fh:
                    on_disk = fh.read()
            except FileNotFoundError:
                on_disk = ""
            if on_disk != text:
                stale.append(path)
            else:
                print(f"{path} is up to date", file=sys.stderr)
            continue
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            fh.write(text)
        print(f"wrote {path}", file=sys.stderr)
    if stale:
        for path in stale:
            print(f"{path} is stale; regenerate with "
                  "`python -m repro_torch.bench docs`", file=sys.stderr)
        return 1
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="list registered experiments")
    _add_filters(p)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("run", help="run experiments, write JSON artifact")
    _add_filters(p)
    _add_torch_device(p)
    p.add_argument("--quick", action="store_true",
                   help="cheap CI subset of each experiment")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on any DEVIATION/ERROR verdict")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=DEFAULT_ARTIFACT,
                   help=f"JSON artifact path (default {DEFAULT_ARTIFACT})")
    p.add_argument("--report", metavar="FILE",
                   help="also write the Markdown verdict report")
    p.add_argument("--no-csv", action="store_true",
                   help="suppress the legacy CSV rows on stdout")
    p.add_argument("--jobs", type=int, default=DEFAULT_JOBS, metavar="N",
                   help="experiment×device records run across N spawned "
                        "processes (default min(cores, 8); 1 = serial)")
    p.add_argument("--trace-cache", default=tracecache.DEFAULT_ROOT,
                   metavar="DIR",
                   help="simulated-trace cache root (default "
                        f"{tracecache.DEFAULT_ROOT})")
    p.add_argument("--no-trace-cache", action="store_true",
                   help="always re-simulate; neither read nor write traces")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("report", help="render Markdown from a JSON artifact")
    p.add_argument("artifact", nargs="?", default=DEFAULT_ARTIFACT)
    p.add_argument("-o", "--output", help="write to file instead of stdout")
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("profile",
                       help="dissect/show/diff/validate device profiles")
    p.add_argument("action",
                   choices=("dissect", "show", "diff", "validate"))
    p.add_argument("target", nargs="?", default=None,
                   help="device name or artifact path (validate: optional "
                        "single artifact instead of the whole root)")
    p.add_argument("--quick", action="store_true",
                   help="dissect: record the quick-mode contract in the "
                        "artifact (the batched engine measures every "
                        "structure either way)")
    p.add_argument("--engine", choices=("auto", "torch", "vector",
                                        "reference"), default="auto",
                   help="dissect: trace-simulation core (auto is the "
                        "batched torch engine on --torch-device)")
    _add_torch_device(p)
    p.add_argument("--fresh", action="store_true",
                   help="diff: re-dissect even if an artifact exists")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="dissect: artifact path (default "
                        f"{PROFILE_ROOT}/<device>.json)")
    p.add_argument("--root", default=None,
                   help="validate: profile root (default "
                        "experiments/profiles)")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("docs",
                       help="(re)generate every generated doc: "
                            "experiments, serving, profiles, cli")
    p.add_argument("-o", "--output", default=None,
                   help="write a single target to this path (with "
                        "--only; bare -o keeps the historical "
                        "experiments.md behavior)")
    p.add_argument("--only", choices=("experiments", "serving",
                                      "profiles", "cli"),
                   help="restrict to one generated doc")
    p.add_argument("--check", action="store_true",
                   help="exit 1 if any file on disk is stale")
    p.set_defaults(fn=cmd_docs)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        registry.discover()
        return args.fn(args)
    except (KeyError, FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
