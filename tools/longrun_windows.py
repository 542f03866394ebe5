"""Where a long run's time goes, window by window, from the records of
`python -m orbslam2_tpu_torch.longrun --out RUN.json --events EVENTS.jsonl`.

    python tools/longrun_windows.py RUN.json EVENTS.jsonl

Prints, for each 100-frame window, its frames/s, keyframes and points (from
the run's `fps_decay`), the keyframes inserted in it and the frames that
verified a loop candidate the Sim3 check rejected (`loop_sim3_fail`
events); then a least-squares fit of each window's seconds to those counts
(a constant, seconds per verification frame, seconds per keyframe), once
as is and once with the window's position added, over the windows after
the first and without those that hold a loop correction; and the
rejections before frames 800 and 1300, the prefixes the reference's own
runs cover (`tools/loop_reference_targets.py longrun 800|1300`).
"""

from __future__ import annotations

import collections
import json
import sys

import numpy as np


def window_counts(events: list[dict], window: int = 100) -> tuple[dict, dict, list[int]]:
    """Per window index: the frames that held a rejected verification, the
    keyframes inserted; and the frame of every rejection."""
    n, verify, kfs, rejected = 0, collections.defaultdict(set), collections.Counter(), []
    for e in events:
        if e["event"] == "frame":
            n += 1
        elif e["event"] == "loop_sim3_fail":
            verify[(n - 1) // window].add(n - 1)
            rejected.append(n - 1)
        elif e["event"] == "keyframe":
            kfs[n // window] += 1
    return verify, kfs, rejected


def main(run_path: str, events_path: str) -> None:
    run = json.load(open(run_path))
    events = [json.loads(line) for line in open(events_path)]
    verify, kfs, rejected = window_counts(events)
    corrections = {c["frame"] // 100 for c in run["loop_corrections"]}
    rows = []
    for w in run["fps_decay"]:
        i = w["frame"] // 100 - 1
        secs = 100 / w["fps"]
        rows.append((i, secs))
        print(f"frames {100 * i}-{w['frame']}: {w['fps']:.2f} frames/s, {w['keyframes']} keyframes, "
              f"{w['points']} points; {kfs[i]} inserted, {len(verify[i])} verification frames"
              f"{' (a correction)' if i in corrections else ''}", flush=True)
    fit = [(i, s) for i, s in rows[1:] if i not in corrections]
    y = np.array([s for _, s in fit])
    base = np.array([[1.0, len(verify[i]), kfs[i]] for i, _ in fit])
    coef, *_ = np.linalg.lstsq(base, y, rcond=None)
    print(f"fit over {len(fit)} windows: {coef[0]:.3f} s a window, {coef[1]:.3f} s a verification "
          f"frame, {coef[2]:.3f} s a keyframe; largest miss {np.abs(base @ coef - y).max():.2f} s",
          flush=True)
    posed = np.c_[base, [i for i, _ in fit]]
    coef, *_ = np.linalg.lstsq(posed, y, rcond=None)
    print(f"with the window's position: {coef[1]:.3f} s a verification frame, {coef[3]:.3f} s a "
          f"window", flush=True)
    print(f"rejected verifications: {len(rejected)} in {sum(len(v) for v in verify.values())} "
          f"frames; {sum(f < 800 for f in rejected)} before frame 800, "
          f"{sum(f < 1300 for f in rejected)} before frame 1300", flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
