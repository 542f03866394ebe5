"""A cell as data: its entry in `BENCHMARK.json`, its configuration file
(`slambench/configs/<config>.yaml`), its traffic mix
(`slambench/traffic/<mix>.json`) and its limits
(`slambench/limits/<cell>.json`), all found by name under the checkout's
root.

A configuration file mirrors one of ORB-SLAM2's settings files: the
upstream `Key: value` lines as published, then the capacities the port
needs (`Port.*`), and the lists `assumed` and `reduced`. It is read here
by a small parser of that flat subset, not by the program's own loader,
so a change to the program cannot change what the benchmark runs.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from slambench import render

# the port's capacities a configuration file sets (`Port.<key>`), by the
# program's config group that holds each
PORT_KEYS = {
    "feature_slots": "orb", "max_keyframes": "map", "max_points": "map",
    "max_local_keyframes": "map", "max_local_points": "map",
    "ba_max_local_kfs": "solver", "ba_max_fixed_kfs": "solver", "ba_max_points": "solver",
}


def parse_settings(text: str) -> dict:
    """The flat subset of an OpenCV YAML settings file: `Key: value`
    lines (numbers, or strings with or without quotes), `%` and `#` lines
    skipped, and `key:` followed by `  - item` lines as a list. Nested
    OpenCV matrices are not read."""
    out: dict = {}
    list_key = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip() or line.lstrip().startswith("%"):
            continue
        stripped = line.strip()
        if stripped.startswith("- ") and list_key is not None:
            out[list_key].append(_scalar(stripped[2:].strip()))
            continue
        list_key = None
        if raw[:1] in (" ", "\t") or ":" not in stripped:
            continue
        key, _, value = stripped.partition(":")
        key, value = key.strip(), value.strip()
        if not value:
            out[key] = []
            list_key = key
        elif not value.startswith("!!"):
            out[key] = _scalar(value)
    return out


def _scalar(value: str):
    if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
        return value[1:-1]
    try:
        return int(value)
    except ValueError:
        try:
            return float(value)
        except ValueError:
            return value


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    settings: dict
    mix: dict
    limits: dict
    chips: int

    @property
    def stereo(self) -> bool:
        return self.settings["Benchmark.sensor"] == "STEREO"

    @property
    def camera(self) -> render.Camera:
        s = self.settings
        return render.Camera(fx=float(s["Camera.fx"]), fy=float(s["Camera.fy"]),
                             cx=float(s["Camera.cx"]), cy=float(s["Camera.cy"]),
                             width=int(s["Camera.width"]), height=int(s["Camera.height"]),
                             bf=float(s["Camera.bf"]))

    @property
    def fps(self) -> float:
        return float(self.settings.get("Camera.fps", 30.0))

    def slam_config(self):
        """The program's configuration for this cell: the settings file's
        values, its `Port.*` capacities and the mix's `pipeline_depth`;
        RGB-D depth arrives decoded to metres (factor 1), as the program's
        runner hands it over."""
        from orbslam2_tpu_torch import config as c

        s = self.settings
        groups: dict = {"orb": {}, "map": {}, "solver": {}}
        for key, group in PORT_KEYS.items():
            if f"Port.{key}" in s:
                groups[group][key] = int(s[f"Port.{key}"])
        cam = c.CameraConfig(
            fx=float(s["Camera.fx"]), fy=float(s["Camera.fy"]), cx=float(s["Camera.cx"]),
            cy=float(s["Camera.cy"]), k1=float(s.get("Camera.k1", 0.0)),
            k2=float(s.get("Camera.k2", 0.0)), p1=float(s.get("Camera.p1", 0.0)),
            p2=float(s.get("Camera.p2", 0.0)), k3=float(s.get("Camera.k3", 0.0)),
            bf=float(s["Camera.bf"]), fps=self.fps, width=int(s["Camera.width"]),
            height=int(s["Camera.height"]), rgb=bool(int(s.get("Camera.RGB", 1))))
        orb = c.OrbConfig(
            num_features=int(s["ORBextractor.nFeatures"]),
            scale_factor=float(s["ORBextractor.scaleFactor"]),
            num_levels=int(s["ORBextractor.nLevels"]),
            ini_th_fast=int(s["ORBextractor.iniThFAST"]),
            min_th_fast=int(s["ORBextractor.minThFAST"]), **groups["orb"])
        tracking = c.TrackingConfig(th_depth=float(s["ThDepth"]), depth_map_factor=1.0,
                                    pipeline_depth=int(self.mix.get("pipeline_depth", 0)))
        return c.SlamConfig(sensor=c.Sensor[s["Benchmark.sensor"]], camera=cam, orb=orb,
                            map=c.MapConfig(**groups["map"]), tracking=tracking,
                            solver=c.SolverConfig(**groups["solver"]))


def load_benchmark(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path}: no BENCHMARK.json in the working directory")
    return json.loads(path.read_text())


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of `root/BENCHMARK.json` with its files."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    settings = parse_settings((root / conf["file"]).read_text())
    mix = json.loads((root / "slambench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = root / "slambench" / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    return Cell(name=workload, config_name=w["config"], traffic_name=w["traffic"],
                settings=settings, mix=mix, limits=limits, chips=int(w.get("chips", 1)))


def frame_order(segments) -> list[int]:
    """The frame indices of a list of segments, each an inclusive
    [first, last] walked by +1 or -1."""
    out = []
    for first, last in segments:
        step = 1 if last >= first else -1
        out.extend(range(first, last + step, step))
    return out
