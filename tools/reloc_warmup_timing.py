"""The first relocalizing frame's time with `cfg.vocab.warmup_reloc` on and
off, each session in a fresh process, on the card.

    python tools/reloc_warmup_timing.py            # off, on, on, off
    python tools/reloc_warmup_timing.py on|off     # one session, this process

A session is `chip_smoke.py`'s relocalization session at bench.py's
configuration (640x480, 1000 features, the loop closer's correction
warm-up on): 34 frames of the forward dolly, 3 black frames, then frame 10
again until it relocalizes. In a fresh process nothing of the
relocalization chain has run before that frame, so its time holds every
first use the warm-up is there to move. Each session prints one JSON
line: the card, the flag, the warm-up's seconds (run at the first keyframe
that makes the loop closer), the revisit frames' ms, the frame that
relocalized and its translation error. Without arguments the four
sessions run in turn in child processes, and the last line gathers them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from orbslam2_tpu_torch import drive  # noqa: E402


def one_session(flag: str) -> dict:
    from orbslam2_tpu_torch.pipeline import tracking

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    device = torch.device("cuda")
    cfg = chip_smoke.bench_config()
    cfg = dataclasses.replace(cfg, vocab=dataclasses.replace(cfg.vocab,
                                                             warmup_reloc=flag == "on"))
    warmup_s = []
    warm_fn = tracking.Tracker.warmup_reloc

    def timed_warmup(self, db):
        t0 = time.perf_counter()
        try:
            return warm_fn(self, db)
        finally:
            warmup_s.append(time.perf_counter() - t0)

    tracking.Tracker.warmup_reloc = timed_warmup
    chip_smoke.start_render_pool()
    try:
        slam, seq, secs, ok_before, lost, tries, _ = chip_smoke.run_reloc_session(cfg, device)
    finally:
        chip_smoke.stop_render_pool()
        tracking.Tracker.warmup_reloc = warm_fn
    first = chip_smoke.RELOC_MAP_FRAMES + chip_smoke.RELOC_BLACK
    return dict(card=drive.card_line(), warmup_reloc=flag == "on", warmup_s=warmup_s,
                ok_before=ok_before, lost=lost, relocalized_at_try=tries,
                revisit_ms=[1000 * s for s in secs[first:]],
                t_err_m=chip_smoke.reloc_error(slam, seq) if tries is not None else None)


def main():
    if len(sys.argv) > 1:
        print(json.dumps(one_session(sys.argv[1])), flush=True)
        return
    runs = []
    for flag in ("off", "on", "on", "off"):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), flag], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"the {flag} session failed")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    first = {flag: [r["revisit_ms"][0] for r in runs if r["warmup_reloc"] == (flag == "on")]
             for flag in ("off", "on")}
    print(json.dumps({"first_revisit_ms": first,
                      "warmup_s": [r["warmup_s"] for r in runs if r["warmup_reloc"]],
                      "card": runs[0]["card"]}), flush=True)


if __name__ == "__main__":
    main()
