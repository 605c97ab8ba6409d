"""The paper, end to end, on the PyTorch port: dissect three GPU memory
hierarchies with fine-grained P-chase and print the recovered structures
vs published truth. The twin of ``examples/dissect_memory.py``; the
traces come from the port's batched torch engine, whose scan runs on the
card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_dissect_memory.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import devices, inference, spectrum  # noqa: E402
from repro_torch.core.pchase import cache_backend  # noqa: E402

MB = 1 << 20


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the torch engine's scan runs (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)

    def backend(mk):
        return cache_backend(mk, engine="torch", device=dev)

    print("=" * 72)
    print("Fine-grained P-chase dissection (paper Table 5, Figs 7-11, 14)")
    print(f"torch engine on {dev}")
    print("=" * 72)

    cases = [
        ("Fermi GTX560Ti L1 data cache", devices.fermi_l1_data, 64 << 10),
        ("Kepler GTX780 texture L1", devices.kepler_texture_l1, 64 << 10),
        ("Kepler GTX780 read-only cache", devices.kepler_readonly, 64 << 10),
        ("Maxwell GTX980 unified L1", devices.maxwell_unified_l1, 128 << 10),
    ]
    for name, mk, nmax in cases:
        p = inference.dissect(backend(mk), n_max=nmax, max_line=4096)
        print(f"\n{name}\n  -> {p.summary()}")

    print("\nL2 TLB (unequal sets, Fig 9):")
    be = backend(devices.l2_tlb)
    c = inference.find_cache_size(be, n_max=512 * MB, n_min=8 * MB,
                                  stride_bytes=2 * MB, granularity=2 * MB)
    page = inference.find_line_size(be, c, stride_bytes=2 * MB,
                                    granularity=256 << 10, max_line=8 * MB)
    st = inference.recover_set_structure(be, c, 2 * MB, max_steps=80)
    print(f"  reach={c // MB}MB page={page // MB}MB ways={st.way_counts}")

    print("\nFermi L1 replacement probabilities (Fig 11):")
    rep = inference.detect_replacement(backend(devices.fermi_l1_data),
                                       16 << 10, 128, passes=800)
    print(f"  LRU={rep.is_lru} probs(sorted)="
          f"{sorted(round(p, 3) for p in rep.way_probs)}"
          f"  (paper: 1/6, 1/2, 1/6, 1/6)")

    print("\nGlobal-memory latency spectrum (Fig 14):")
    for gpu in ("GTX560Ti", "GTX780", "GTX980"):
        sp = spectrum.measure_spectrum(lambda d=gpu: devices.make_hierarchy(d))
        line = "  ".join(f"{k}={sp[k]:.0f}" for k in sorted(sp))
        print(f"  {gpu:9s} {line}")
    print("\n(GTX980 P1=P2=P3: Maxwell's virtually-addressed L1 bypasses "
          "the TLB — paper §5.2 finding 2)")


if __name__ == "__main__":
    main()
