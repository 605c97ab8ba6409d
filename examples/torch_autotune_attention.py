"""Memory-model-driven flash-attention tuning on the PyTorch port: the
paper's thesis (measure the hierarchy, then optimize against the model)
applied to our own kernel. The twin of ``examples/autotune_attention.py``.

Picks (block_q, block_k) from the calibrated model and prints the
predicted traffic per choice. Those plans are priced for ``tpu_v5e``'s
VMEM and HBM by ``core/autotune.py``, as the reference prices them; they
are not the H100's. Then it runs the port's ``flash_attention`` with the
tuned blocks at the reference's shape, q (4, 512, 64) float32, and holds
it to the plain version within 1e-4. The CUDA kernels tile by their own
64 rows and only validate the blocks (``kernels/flash_attention.py``), so
on the card this checks the kernel's output, not the tiling. On
``--device cpu`` the wrapper runs its plain version.

  PYTHONPATH=src python examples/torch_autotune_attention.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core.autotune import flash_attention_blocks  # noqa: E402
from repro_torch.core.devices import TPU_V5E  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-4


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where flash runs (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)

    print(f"target: {TPU_V5E.name}  VMEM={TPU_V5E.vmem_bytes >> 20}MiB  "
          f"HBM={TPU_V5E.hbm_bytes_per_s / 1e9:.0f}GB/s")
    print(f"{'seq':>8} {'d':>5} {'bq':>6} {'bk':>6} {'VMEM':>10} "
          f"{'HBM traffic':>14} note")
    for seq in (4096, 32768, 131072):
        for d in (64, 128):
            p = flash_attention_blocks(seq, seq, d)
            print(f"{seq:>8} {d:>5} {p.block_q:>6} {p.block_k:>6} "
                  f"{p.vmem_bytes >> 10:>9}K {p.hbm_bytes / 1e6:>12.1f}MB "
                  f"{p.note}")

    # verify the tuned configuration numerically at the reference's
    # scaled-down shape
    plan = flash_attention_blocks(32768, 32768, 64)
    bq = min(plan.block_q, 256)
    bk = min(plan.block_k, 256)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((4, 512, 64), generator=g).to(dev)
    with torch.no_grad():
        out = ops.flash_attention(q, q, q, num_q_heads=4, num_kv_heads=4,
                                  block_q=bq, block_k=bk)
        exp = ref.attention_ref(q, q, q, num_q_heads=4, num_kv_heads=4)
    err = float((out - exp).abs().max())
    print(f"\ntuned kernel vs oracle (bq={bq}, bk={bk}) on {dev}: "
          f"max|err|={err:.2e}")
    assert err < TOL, f"max|err| {err:.2e} >= {TOL:g}"
    return err


if __name__ == "__main__":
    main()
