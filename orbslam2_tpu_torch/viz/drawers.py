"""Offline visualization: frame overlays and map renders (the port of
`orbslam2_tpu.viz.drawers`: the drawers take numpy arrays, as there, and
the viewer reads the session's map tensors back to the host first).

Replaces the Pangolin/OpenGL Viewer stack (reference src/Viewer.cc,
src/FrameDrawer.cc, src/MapDrawer.cc) with headless renderers writing PNGs
— behavioral parity is the drawn content (keypoints + status text, map
points with local-map coloring, keyframe frusta, covisibility/spanning
graph, current camera), not the windowing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from orbslam2_tpu_torch.config import SlamConfig


class FrameDrawer:
    """Draw the current frame with tracked keypoints
    (reference FrameDrawer::DrawFrame src/FrameDrawer.cc:42-141 and the
    status bar DrawTextInfo :144-185)."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg

    def draw(self, image: np.ndarray, xy: np.ndarray, tracked_mask: np.ndarray,
             state_text: str = "") -> "object":
        from PIL import Image, ImageDraw

        img = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
        rgb = np.stack([img] * 3, axis=-1)
        out = Image.fromarray(rgb)
        d = ImageDraw.Draw(out)
        xy = np.asarray(xy)
        tracked = np.asarray(tracked_mask)
        for (x, y), ok in zip(xy, tracked):
            if x <= 0 and y <= 0:
                continue
            color = (0, 255, 0) if ok else (120, 120, 120)
            r = 2 if ok else 1
            d.ellipse([x - r, y - r, x + r, y + r], outline=color)
        if state_text:
            d.rectangle([0, out.height - 14, out.width, out.height], fill=(0, 0, 0))
            d.text((4, out.height - 13), state_text, fill=(255, 255, 255))
        return out


class MapDrawer:
    """Top-down orthographic render of the map
    (reference MapDrawer::DrawMapPoints :45, DrawKeyFrames :85,
    DrawCurrentCamera :189)."""

    def __init__(self, cfg: SlamConfig, size: int = 640):
        self.cfg = cfg
        self.size = size

    def draw(
        self,
        mp_pos: np.ndarray,
        mp_valid: np.ndarray,
        kf_Tcw: np.ndarray,
        kf_valid: np.ndarray,
        covis: Optional[np.ndarray] = None,
        kf_parent: Optional[np.ndarray] = None,
        current_Tcw: Optional[np.ndarray] = None,
        axes=(0, 2),
    ) -> "object":
        from PIL import Image, ImageDraw

        pts = np.asarray(mp_pos)[np.asarray(mp_valid)]
        kfv = np.asarray(kf_valid)
        Ts = np.asarray(kf_Tcw)[kfv]
        centers = np.stack(
            [-T[:3, :3].T @ T[:3, 3] for T in Ts]
        ) if len(Ts) else np.zeros((0, 3))

        allp = np.concatenate([pts, centers]) if len(pts) or len(centers) else np.zeros((1, 3))
        a, b = axes
        lo = allp[:, [a, b]].min(0) - 0.5
        hi = allp[:, [a, b]].max(0) + 0.5
        span = np.maximum(hi - lo, 1e-3)

        def to_px(p):
            q = (p[[a, b]] - lo) / span
            return (q[0] * (self.size - 20) + 10, (1 - q[1]) * (self.size - 20) + 10)

        img = Image.new("RGB", (self.size, self.size), (255, 255, 255))
        d = ImageDraw.Draw(img)
        for p in pts:
            x, y = to_px(p)
            d.point((x, y), fill=(30, 30, 30))
        # graph edges
        kf_ids = np.nonzero(kfv)[0]
        id_to_center = {int(k): centers[i] for i, k in enumerate(kf_ids)}
        if covis is not None:
            cov = np.asarray(covis)
            for i in kf_ids:
                for j in kf_ids:
                    if j > i and cov[i, j] >= 100:
                        d.line([to_px(id_to_center[int(i)]), to_px(id_to_center[int(j)])],
                               fill=(120, 200, 120), width=1)
        if kf_parent is not None:
            par = np.asarray(kf_parent)
            for i in kf_ids:
                p = int(par[i])
                if p >= 0 and p in id_to_center:
                    d.line([to_px(id_to_center[int(i)]), to_px(id_to_center[p])],
                           fill=(180, 180, 255), width=1)
        for c in centers:
            x, y = to_px(c)
            d.rectangle([x - 2, y - 2, x + 2, y + 2], outline=(0, 0, 255))
        if current_Tcw is not None:
            T = np.asarray(current_Tcw)
            c = -T[:3, :3].T @ T[:3, 3]
            x, y = to_px(c)
            d.rectangle([x - 3, y - 3, x + 3, y + 3], outline=(255, 0, 0), width=2)
        return img


class Viewer:
    """Headless periodic snapshot writer (reference Viewer::Run
    src/Viewer.cc:56-189 — the render loop, minus the GUI)."""

    def __init__(self, cfg: SlamConfig, out_dir: str, every_n: int = 10):
        import os

        self.cfg = cfg
        self.out_dir = out_dir
        self.every_n = every_n
        self.frame_drawer = FrameDrawer(cfg)
        self.map_drawer = MapDrawer(cfg)
        self._count = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, system, image: np.ndarray, frame_xy, tracked_mask):
        import os

        if self._count % self.every_n == 0:
            st = {k: getattr(system.map, k).cpu().numpy()
                  for k in ("mp_pos", "mp_valid", "kf_Tcw", "kf_valid", "covis", "kf_parent")}
            fd = self.frame_drawer.draw(
                image, np.asarray(frame_xy), np.asarray(tracked_mask),
                state_text=f"{system.get_tracking_state().name}  "
                f"KFs:{system.num_keyframes()} MPs:{system.num_points()}",
            )
            fd.save(os.path.join(self.out_dir, f"frame_{self._count:05d}.png"))
            md = self.map_drawer.draw(
                st["mp_pos"], st["mp_valid"], st["kf_Tcw"], st["kf_valid"],
                covis=st["covis"], kf_parent=st["kf_parent"],
                current_Tcw=system.results[-1].Tcw if system.results else None,
            )
            md.save(os.path.join(self.out_dir, f"map_{self._count:05d}.png"))
        self._count += 1
