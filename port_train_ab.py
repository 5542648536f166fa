"""Times the PyTorch port's one-device trainers on the card, importing
``pio_tpu_torch`` from a given tree, so that two trees (a commit and its
parent, unpacked with ``git archive`` into a directory .gitignore lists)
can be compared in one run on one card:

    python3 port_train_ab.py --tree DIR [--label NAME] [--reps N]

(``--device cpu`` makes a dry run of the script on the CPU, K8 through
its plain version; its times are not the card's.)

It trains the sequence template with attention "flash" (K8) at
examples/sequence/engine.json's widths and the two-tower at
examples/twotower/engine.json's, on chip_smoke.py's train_mesh data and
steps, each after a warm run of 3 steps, and prints one JSON line: the
tree's label, each trainer's ms a step (every rep, and the least), its
last loss and a SHA-256 of its final params. Run it as
parent, change, change, parent to see the spread between processes.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import replace


def _sha(params: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True,
                    help="the directory whose pio_tpu_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    # the tree's package first; chip_smoke.py beside this file (not the
    # tree's) gives the data and widths, and imports the package lazily
    sys.path.insert(0, tree)
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("port_train_ab: CUDA is not available")
    import pio_tpu_torch
    from pio_tpu_torch.models import sequence as seq
    from pio_tpu_torch.models import twotower as tt

    if not pio_tpu_torch.__file__.startswith(tree + os.sep):
        raise SystemExit(f"port_train_ab: imported {pio_tpu_torch.__file__}"
                         f", not {tree}'s package")
    cs.cuda_settings()
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    data, inter = cs.mesh_seq_data(), cs.mesh_tt_data()
    sp = seq.SequenceParams(**{**cs.MESH_SEQ, "attention": "flash"})
    tp = tt.TwoTowerParams(**cs.MESH_TT)

    def run_seq(p):
        params, _, loss = seq.train_sequence_model(data, p, device=dev)
        return params, loss

    def run_tt(p):
        params, _, _, losses = tt.train_two_tower(inter, p, device=dev)
        return params, float(losses[-1])

    out = {"label": args.label or tree, "device": args.device,
           "card": cs.card_line() if dev.type == "cuda" else None,
           "torch": torch.__version__}
    for name, fn, p in (("sequence_flash", run_seq, sp),
                        ("twotower", run_tt, tp)):
        fn(replace(p, steps=3))                              # warm
        ms = []
        for _ in range(args.reps):
            sync()
            t0 = time.perf_counter()
            params, loss = fn(p)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0) / p.steps)
        out[name] = {"steps": p.steps, "step_ms": ms,
                     "best_step_ms": min(ms), "loss": loss,
                     "sha256": _sha(params)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
