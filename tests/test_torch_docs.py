"""The port's generated documents, its TPU roofline record, the legacy CSV
wrapper and the autotune example, against the reference's.

* ``python -m repro_torch.bench docs`` renders the four documents under
  its root (here a temporary one); each equals the reference's render
  line for line, but for the lines listed in ``EXCEPTIONS``: those that
  name the package, the regenerate command, or a CLI surface only one
  package has (the port's ``--torch-device`` and ``--device``, its own
  defaults and help strings). ``docs --check`` is 0 after ``docs`` and 1
  after an edit; nothing under ``docs/`` or ``experiments/`` changes.
  The reference renders in a subprocess: its launchers set ``XLA_FLAGS``
  for the process that imports them.
* ``tpu_roofline`` reads the port's dry-run records from its root (the
  analytic fallback everywhere else, the reference's record there, which
  ``tests/test_torch_bench.py`` compares field for field).
* ``python -m repro_torch.benchmarks.run table8`` prints the reference
  wrapper's header and row names.
* ``examples/torch_autotune_attention.py --device cpu`` prints the
  reference example's plan table and meets its 1e-4 check.
"""

import difflib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.bench import __main__ as cli
from repro_torch.benchmarks import tpu_roofline

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
DOCS = ("experiments", "serving", "profiles", "cli")

#: per document, the substrings that mark a line allowed to differ
EXCEPTIONS = {
    "experiments": ("Regenerate with", "Rendered by repro_torch",
                    "registers itself with", "`@experiment` decorator in",
                    "rendered from that registry metadata",
                    "module; this table is rendered", "drift from the code",
                    "python -m repro", "cannot drift"),
    "serving": ("Regenerate with", "python -m repro", "examples/",
                "--requests 8 --slots 3", "--faults 1",
                "--workload-replay", "capacity planner:", "mesh-sharded",
                "XLA_FLAGS", "torchrun", "--mesh-shape 2"),
    "profiles": ("Regenerate with", "One section per committed",
                 "experiments/profiles/"),
    "cli": ("Regenerate with", "repro.bench", "repro_torch.bench",
            "repro.launch", "repro_torch.launch", "CLI for the",
            "| `--torch-device", "| `--device ", "| `--out ",
            "| `--out-dir", "| `--jobs", "| `--trace-cache", "| `artifact`",
            "| `--engine", "| `--temperature", "| `--profile",
            "| `--mesh-shape", "| `--fleet-profiles", "| `--dissect-on-start",
            "| `--fleet-tiers", "| `--workload ", "| `--plan",
            "serving launcher", "training launcher", "multi-pod dry-run"),
}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


@pytest.fixture(scope="module")
def reference_docs(tmp_path_factory) -> dict[str, list[str]]:
    out = tmp_path_factory.mktemp("ref_docs")
    code = ("import sys\n"
            "from repro.bench import docsgen, registry, report\n"
            "registry.discover()\n"
            "r = {'experiments': report.experiments_doc,\n"
            "     'serving': docsgen.serving_doc,\n"
            "     'profiles': docsgen.profiles_doc, 'cli': docsgen.cli_doc}\n"
            "for n, f in r.items():\n"
            "    open(sys.argv[1] + '/' + n + '.md', 'w').write(f())\n")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code, str(out)], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return {n: (out / f"{n}.md").read_text().splitlines() for n in DOCS}


@pytest.fixture(scope="module")
def port_docs(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("port_docs")
    before = SMOKE.tree_state("experiments", "docs")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "DOCS_ROOT", str(root))
        assert cli.main(["docs"]) == 0
    assert SMOKE.tree_state("experiments", "docs") == before
    return root


@pytest.mark.parametrize("doc", DOCS)
def test_doc_equals_the_references_line_for_line(doc, reference_docs,
                                                 port_docs):
    ref = reference_docs[doc]
    port = (port_docs / f"{doc}.md").read_text().splitlines()
    sm = difflib.SequenceMatcher(a=ref, b=port, autojunk=False)
    differing, equal = [], 0
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            equal += i2 - i1
        else:
            differing += ref[i1:i2] + port[j1:j2]
    bad = [ln for ln in differing
           if not any(m in ln for m in EXCEPTIONS[doc])]
    assert not bad, "\n".join(bad[:10])
    # the exceptions are few: most of each page is the reference's
    assert equal >= 0.8 * len(ref) and len(port) >= 0.8 * len(ref)


def test_port_docs_name_no_host_path(port_docs):
    for doc in DOCS:
        text = (port_docs / f"{doc}.md").read_text()
        assert str(ROOT) not in text, doc


def test_docs_check_passes_after_docs_and_fails_after_an_edit(
        tmp_path, monkeypatch, capsys):
    before = SMOKE.tree_state("experiments", "docs")
    monkeypatch.setattr(cli, "DOCS_ROOT", str(tmp_path))
    assert cli.main(["docs", "--check"]) == 1          # nothing written yet
    assert cli.main(["docs"]) == 0
    assert cli.main(["docs", "--check"]) == 0
    page = tmp_path / "serving.md"
    page.write_text(page.read_text() + "edited by hand\n")
    capsys.readouterr()
    assert cli.main(["docs", "--check"]) == 1
    assert f"{page} is stale" in capsys.readouterr().err
    assert cli.main(["docs", "--only", "serving"]) == 0
    assert cli.main(["docs", "--check"]) == 0
    one = tmp_path / "one.md"
    assert cli.main(["docs", "-o", str(one)]) == 0      # experiments.md
    assert one.read_text() == (tmp_path / "experiments.md").read_text()
    assert cli.build_parser().parse_args(["docs"]).fn is cli.cmd_docs
    assert SMOKE.tree_state("experiments", "docs") == before


def test_docs_root_is_under_build():
    assert Path(cli.DOCS_ROOT) == ROOT / "build" / "repro_torch" / "docs"


# -- tpu_roofline ---------------------------------------------------------------


def test_tpu_roofline_reads_the_ports_dry_run_records(tmp_path):
    from repro_torch import configs
    arch = configs.list_archs()[0]          # a cell quick mode prices
    rec = {"arch": arch, "shape": "train_4k", "tag": "baseline",
           "roofline": {"dominant": "compute", "compute_s": 0.5,
                        "memory_s": 0.25, "collective_s": 0.125,
                        "roofline_fraction": 0.5, "useful_ratio": 0.75}}
    (tmp_path / "single").mkdir()
    (tmp_path / "single" / f"{arch}__train_4k.json").write_text(
        json.dumps(rec))
    (tmp_path / "single" / f"{arch}__train_4k__pure_dp.json").write_text(
        json.dumps(dict(rec, tag="pure_dp")))
    cells = tpu_roofline._cells(quick=True, root=str(tmp_path))
    analytic = tpu_roofline._cells(quick=True, root=str(tmp_path / "none"))
    assert cells[0] == (f"{arch}/train_4k", rec["roofline"], False)
    assert len(cells) == len(analytic)          # one cell read, not added
    assert all(a for _, _, a in cells[1:])
    assert tpu_roofline.DRYRUN_ROOT == "build/repro_torch/dryrun"


# -- the legacy wrapper and the example -------------------------------------------


def _run(argv):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable] + argv, cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.splitlines()


def test_csv_wrapper_prints_the_references_rows():
    port = _run(["-m", "repro_torch.benchmarks.run", "table8",
                 "--torch-device", "cpu"])
    ref = _run(["benchmarks/run.py", "table8"])
    assert port[0] == ref[0] == "name,us_per_call,derived"
    names = lambda rows: [r.split(",", 1)[0] for r in rows[1:]]
    assert names(port) == names(ref) and len(names(port)) >= 4


def _example(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_autotune_example_prints_the_references_plan_table(capsys):
    port = _example(ROOT / "examples" / "torch_autotune_attention.py")
    err = port.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert 0 <= err < port.TOL
    _example(ROOT / "examples" / "autotune_attention.py").main()
    want = capsys.readouterr().out.splitlines()
    assert got[:8] == want[:8] and len(want[:8]) == 8
    assert got[9].startswith("tuned kernel vs oracle (bq=256, bk=256) "
                             "on cpu: max|err|=")
