"""The serving prefill's peak device memory, as phases F and J of
``chip_smoke.py`` take it: xlstm-1.3b and qwen2-1.5b at full size with
seeded random weights, a warm-up forward of 8 x 256 tokens, then the peak
of one 8 x 2,048 prefill under ``torch.no_grad()``
(``torch.cuda.max_memory_allocated()`` after a reset, in GiB).

    python3 scripts/serve_peak.py [--root DIR]

``--root`` loads ``repro_torch`` from another checkout's ``src`` (default:
this one), so two commits compare in one run on the same card, e.g. the
parent unpacked with ``git archive`` into ``build/parent``:

    python3 scripts/serve_peak.py --root build/parent
    python3 scripts/serve_peak.py

Prints the card's name and power limit, then one JSON line.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = (("F", "xlstm-1.3b"), ("J", "qwen2-1.5b"))
BATCH, SEQ, WARMUP = 8, 2048, 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose src/repro_torch is measured")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_peak: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import zipf_tokens
    from repro_torch.models import forward, init_params

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = {"root": root}
    for phase, arch in PHASES:
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        with torch.no_grad():
            model = init_params(cfg, generator=gen, device="cuda")
            toks = torch.as_tensor(zipf_tokens(np.random.RandomState(0), (
                BATCH, SEQ), cfg.vocab_size), device="cuda")
            forward(model, {"tokens": toks[:, :WARMUP]}, cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            logits, _ = forward(model, {"tokens": toks}, cfg)
            torch.cuda.synchronize()
        out[phase] = {"arch": arch, "batch": BATCH, "seq": SEQ,
                      "prefill_peak_gib":
                          torch.cuda.max_memory_allocated() / 2**30,
                      "finite": bool(torch.isfinite(logits).all())}
        del model, logits, toks
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0 if all(out[p]["finite"] for p, _ in PHASES) else 1


if __name__ == "__main__":
    sys.exit(main())
