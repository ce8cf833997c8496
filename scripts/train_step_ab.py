"""Phase L1 of ``chip_smoke.py`` on its own, for one checkout of the port:
xlstm-1.3b at full width through ``chip_smoke.train_run``, the function
phase L1 runs (6 steps of 8 x 2,048 tokens, the same step timers, checks
and launch counts), with ``repro_torch`` loaded from ``--root``'s ``src``
(default: this checkout).  Prints the card's name and power limit, then
one JSON line: ``train_run``'s result and B8ᵀ's paths where the checkout
records them.  Needs a card.

Two commits compare on the same card in one run, in turns, e.g. with the
parent unpacked by ``git archive`` into ``build/parent``:

    python3 scripts/train_step_ab.py --root build/parent
    python3 scripts/train_step_ab.py
    python3 scripts/train_step_ab.py
    python3 scripts/train_step_ab.py --root build/parent
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose src/repro_torch is measured")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_step_ab: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import slstm

    print(cs.card_line(), flush=True)
    paths = getattr(slstm, "backward_path_launches", None)
    before = dict(paths) if paths is not None else None
    res, out = cs.train_run(torch, get_config(cs.XLSTM), f"L1 {cs.XLSTM}",
                            cs.Counters(), lambda obj: None)
    del out
    res = {"root": root, **res}
    if paths is not None:
        res["slstm_backward_paths"] = {k: v - before[k]
                                       for k, v in paths.items()}
    print(json.dumps(res, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
