"""Batched serving demo on the PyTorch port, over
``python -m repro_torch.launch.serve --smoke``: prefill a request batch,
decode with a KV cache, report prefill/decode throughput (or any engine
the launcher's flags name). The twin of ``examples/serve_batch.py``; the
model runs on ``--device`` (``cuda`` unless named).

  PYTHONPATH=src python examples/torch_serve_batch.py --arch granite-8b --device cpu
  PYTHONPATH=src python examples/torch_serve_batch.py --arch mamba2-1.3b --gen 64
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import serve  # noqa: E402


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv = ["--arch", "granite-8b"] + argv
    if "--smoke" not in argv:
        argv.append("--smoke")
    return serve.main(argv)


if __name__ == "__main__":
    main()
