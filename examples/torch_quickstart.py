"""Quickstart on the PyTorch port: the paper's pipeline end to end
(``examples/quickstart.py``'s run).

  1. fit the exponential weight prior (paper eq. 3) on a real model,
  2. evaluate the distortion-rate bounds (Props 4.1/4.2),
  3. jointly pick (b̂, f, f̃) under a QoS target (Algorithm 1),
  4. serve a batch through the quantized agent/server split and compare the
     realized output distortion across bit-widths.

Weights come from the port's ``init`` under a seeded ``torch.Generator``,
so the numbers differ from the JAX example's; the lines do not.  Runs on
the CUDA card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import torch

from repro_torch.configs import get_smoke
from repro_torch.core import codesign as cd
from repro_torch.core.cost_model import SystemParams
from repro_torch.core.rate_distortion import (distortion_lower_bound,
                                              distortion_upper_bound,
                                              exponential_mle)
from repro_torch.device import resolve_device, set_float32_numerics
from repro_torch.models.lm import tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.runtime import CoInferenceEngine, QosClass


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_float32_numerics()

    # -- a real (reduced) model -------------------------------------------
    cfg = get_smoke("stablelm-3b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    print(f"model: {cfg.name}  layers={cfg.n_layers}  "
          f"split at {cfg.split_layer} (agent|server)")

    # -- 1. weight statistics (paper eq. 3 / Fig. 2) ----------------------
    mags = torch.cat([torch.abs(leaf).reshape(-1)
                      for leaf in tree_leaves(params) if leaf.ndim >= 2])
    lam = float(exponential_mle(mags))
    print(f"\n[1] exponential fit: lambda_hat = {lam:.1f}")

    # -- 2. rate-distortion interval (Props 4.1 / 4.2) --------------------
    print("\n[2] distortion-rate interval per bit-width (rate = b-1):")
    for b in (2, 4, 6, 8):
        dl = float(distortion_lower_bound(b - 1, lam))
        du = float(distortion_upper_bound(b - 1, lam))
        print(f"    b={b}:  D in [{dl:.2e}, {du:.2e}]")

    # -- 3. joint co-design (Algorithm 1) ---------------------------------
    sysp = SystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)
    sol = cd.solve_sca(lam, sysp, t0=1.3, e0=1.5)
    print(f"\n[3] Algorithm 1 under (T0=1.3s, E0=1.5J): b_hat={sol.b_hat}, "
          f"f={sol.f / 1e9:.2f} GHz, f~={sol.f_server / 1e9:.2f} GHz")
    print(f"    realized T={sol.delay:.3f}s E={sol.energy:.3f}J "
          f"({sol.iterations} SCA iterations)")

    # -- 4. quantized co-inference serving --------------------------------
    eng = CoInferenceEngine(model, params, sysp, lam=lam, device=device)
    eng.b_emb = 16
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1)).to(
                             device)
    with torch.no_grad():
        clean, _ = model.forward(params, {"tokens": toks})
    print("\n[4] measured output distortion through the split:")
    for b in (16, 8, 4, 2):
        eng.configure(b)
        logits, stats = eng.serve_batch({"tokens": toks})
        d = float(torch.sum(torch.abs(logits - clean)) / toks.shape[0])
        print(f"    b_hat={b:2d}: ||f - f_hat||_1 = {d:9.2f}   "
              f"T={stats.total_delay_s * 1e3:7.2f} ms  "
              f"E={stats.energy_j:6.3f} J")
    eng.auto_configure(QosClass("interactive", t0=1.3, e0=1.5))
    print(f"\n    auto-configured to b_hat={eng.b_hat} for the QoS class")


if __name__ == "__main__":
    main()
