"""The float32 Bernoulli CVI ELBO against float64 over data seeds, on the
kernel path and the plain path, on one CUDA card:

    python3 chip_cvi_f32.py

Bench config 4's kernel and uniform grid (Matern32(0.5, 1), T = 1e6 points
of linspace(0, 1000, T)) with the Bernoulli likelihood of chip_smoke.py
phase 4g, observations from each seed of SEEDS, chip_smoke.CVI_UPDATES
site updates from the initial sites: in float64 on the kernel path (the
reference), and in float32 on the kernel path and on the plain path.  For
each seed and float32 path it prints the ELBO's error against float64 and
the part of it that the path's float32 sites account for (the float64
ELBO at those sites), both over max(|ELBO|, T); and the ratio of the
kernel path's error to the plain path's.  The last line is one JSON object
of all of it.
"""
from __future__ import annotations

import json
import statistics
import sys

import torch

import chip_smoke

SEEDS = (1, 2, 3, 4, 5, 6, 7, 8)
T = chip_smoke.T_FULL


def updated(dtype, seed):
    """The Bernoulli CVI at ``seed`` after CVI_UPDATES site updates."""
    model = chip_smoke.build_cvi(T, dtype, "Bernoulli", seed=seed)
    with torch.no_grad():
        for _ in range(chip_smoke.CVI_UPDATES):
            model.update_sites()
    return model


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_cvi_f32: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs, adj, kf, _ = chip_smoke.modules()
    card = chip_smoke.card_line()
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}", flush=True)
    cs.build_kernels()
    out = {}
    for seed in SEEDS:
        ref = updated(torch.float64, seed)
        with torch.no_grad():
            e64 = float(ref.elbo())
        row = {}
        for tag in ("kernel", "plain"):
            if tag == "plain":
                with chip_smoke.plain_path(cs, adj, kf):
                    model = updated(torch.float32, seed)
            else:
                model = updated(torch.float32, seed)
            with torch.no_grad():
                e32 = float(model.elbo())
                with chip_smoke.plain_path(cs, adj, kf):
                    at = float(chip_smoke.sites_of(
                        chip_smoke.build_cvi(T, torch.float64, "Bernoulli", seed=seed),
                        *model.sites.natural_parameters).elbo())
            row[tag] = {"error": chip_smoke.rel_list([e32], [e64], T),
                        "sites_part": chip_smoke.rel_list([at], [e64], T)}
        row["ratio"] = row["kernel"]["error"] / row["plain"]["error"]
        out[seed] = row
        print(f"  seed {seed}: float32 ELBO vs float64, kernel path "
              f"{row['kernel']['error']:.3e} (its sites {row['kernel']['sites_part']:.3e}), "
              f"plain path {row['plain']['error']:.3e} (its sites "
              f"{row['plain']['sites_part']:.3e}); kernel / plain {row['ratio']:.3f}",
              flush=True)
    ratios = [row["ratio"] for row in out.values()]
    print(f"  kernel / plain over {len(SEEDS)} seeds: min {min(ratios):.3f}, median "
          f"{statistics.median(ratios):.3f}, max {max(ratios):.3f}  [{card}]", flush=True)
    print(json.dumps({"card": card, "T": T, "updates": chip_smoke.CVI_UPDATES,
                      "seeds": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
