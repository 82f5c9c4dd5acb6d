"""Evaluation: per-frame render quality + point-cloud geometry metrics.

Port of ``rtgslam_tpu/slam/eval.py`` (reference ``SLAM/eval.py``):
  eval_frame  (:94) -> eval_picture (:39): PSNR / SSIM / MS-SSIM /
              depth-L1 (cm) / valid-pixel ratio / bin overflow, the
              comparison pictures and the per-frame JSON;
  eval_pcd    (:163): accuracy & completion (cm), precision/recall/F1 @ 3 cm
              against the GT mesh surface (KDTree nearest distances).

The pictures are PNG (``{name}_color.png``, ``{name}_depth.png``) where the
JAX package writes JPEG: the port writes images with numpy alone.

LPIPS needs pretrained AlexNet weights.  As in the JAX package, the one
gate is ``models/lpips.py``: ``LPIPS_WEIGHTS`` naming an npz puts an
``lpips`` value in every eval output; unset, the column is absent.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..models import losses
from ..models.gaussian_map import STABLE, to_numpy_dict
from ..models.lpips import lpips
from ..utils import image_io
from ..utils.ply import read_mesh, read_ply

_warned_lpips = [False]


def eval_picture(render_out: Dict, gt_color, gt_depth,
                 save_path: Optional[str] = None, name: str = "eval",
                 min_depth: float = 0.0, max_depth: float = 5.0) -> Dict[str, float]:
    """Score a render against the frame's RGBD (numpy or tensors); with
    ``save_path``, write the gt | render color and depth pictures."""
    img = render_out["render"].clamp(0, 1)
    depth = render_out["depth"][..., 0]
    gt_c = torch.as_tensor(gt_color, dtype=torch.float32, device=img.device)
    gt_d = torch.as_tensor(gt_depth, dtype=torch.float32, device=img.device)
    if gt_d.ndim == 3:
        gt_d = gt_d[..., 0]

    valid = (gt_d > 0) & (depth > 0)
    n_valid = int(valid.sum())
    depth_l1 = (float(torch.abs(depth - gt_d)[valid].mean() * 100)
                if n_valid else 0.0)
    metrics = {
        "psnr": float(losses.psnr(img, gt_c)),
        "ssim": float(losses.ssim(img, gt_c)),
        "ms_ssim": float(losses.ms_ssim(img, gt_c)),
        "depth_l1_cm": depth_l1,
        "valid_ratio": n_valid / max(int((gt_d > 0).sum()), 1),
        # dropped gaussian-tile entries: non-zero means the binning
        # capacities are undersized for this map/view
        "bin_overflow": int(render_out.get("overflow", 0)),
    }
    lp = lpips(img, gt_c)
    if lp is not None:
        metrics["lpips"] = lp
    elif not _warned_lpips[0]:
        _warned_lpips[0] = True
        print("[eval] lpips: unavailable (no AlexNet weights shipped; set "
              "LPIPS_WEIGHTS to an npz from scripts/export_lpips_weights.py)")

    if save_path:
        os.makedirs(save_path, exist_ok=True)
        img_np, gt_c_np = img.cpu().numpy(), gt_c.cpu().numpy()
        depth_np, gt_d_np = depth.cpu().numpy(), gt_d.cpu().numpy()
        row_color = np.concatenate([gt_c_np, img_np], axis=1)
        image_io.write_png(os.path.join(save_path, f"{name}_color.png"),
                           (row_color * 255).astype(np.uint8))
        span = max(max_depth - min_depth, 1e-6)
        row_depth = np.concatenate([gt_d_np, depth_np], axis=1)
        dn = ((row_depth - min_depth) / span).clip(0, 1)
        bgr = image_io.apply_jet((dn * 255).astype(np.uint8))
        image_io.write_png(os.path.join(save_path, f"{name}_depth.png"),
                           np.ascontiguousarray(bgr[..., ::-1]))
    return metrics


def eval_frame(mapper, frame, save_path: Optional[str] = None,
               min_depth: float = 0.0, max_depth: float = 5.0,
               save_picture: bool = False, run_pcd: bool = False,
               pcd_gt_path: Optional[str] = None,
               opaque_threshold_eval: Optional[float] = None,
               pcd_rec_path: Optional[str] = None,
               settings=None) -> Dict[str, float]:
    """Render the frame from the current map (every alive gaussian) and
    score it (``eval_frame`` :94, reference SLAM/eval.py:226-274).

    ``pcd_rec_path`` points geometry eval at a reconstruction PLY (the
    densified point cloud when one exists); ``settings`` overrides the
    mapper's RasterSettings and ``opaque_threshold_eval`` its opaque
    threshold.  With ``save_path`` the metrics also go to
    ``{save_path}/frame_XXXX.json``."""
    if settings is None:
        settings = mapper.settings
    if opaque_threshold_eval is not None:
        settings = dataclasses.replace(settings, opaque_threshold=opaque_threshold_eval)
    out = mapper._render(frame.device_dict(mapper.device), settings=settings)
    name = f"frame_{frame.uid:04d}"
    metrics = eval_picture(
        out, frame.image, frame.depth,
        save_path if save_picture else None, name, min_depth, max_depth)
    if run_pcd and pcd_gt_path and os.path.exists(pcd_gt_path):
        if pcd_rec_path and os.path.exists(pcd_rec_path):
            cols = read_ply(pcd_rec_path)
            pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
        else:
            pts = to_numpy_dict(mapper.state, STABLE)["xyz"]
        metrics.update(eval_pcd(pts, pcd_gt_path))
    if save_path:
        os.makedirs(save_path, exist_ok=True)
        with open(os.path.join(save_path, f"{name}.json"), "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


def sample_mesh_surface(vertices: np.ndarray, faces: np.ndarray,
                        n: int, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform sampling of a triangle mesh's surface (the
    ``trimesh.sample.sample_surface`` semantics of the reference GT side,
    ``SLAM/eval.py:193``): triangles picked with probability proportional
    to area, then a uniform barycentric point per pick."""
    rng = np.random.default_rng(seed)
    v0 = vertices[faces[:, 0]]
    e1 = vertices[faces[:, 1]] - v0
    e2 = vertices[faces[:, 2]] - v0
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    total = area.sum()
    if total <= 0:
        return vertices[rng.integers(0, len(vertices), n)]
    tri = rng.choice(len(faces), size=n, p=area / total)
    # uniform barycentric: fold (u, v) with u+v>1 back into the triangle
    u = rng.random(n)
    v = rng.random(n)
    over = u + v > 1.0
    u = np.where(over, 1.0 - u, u)
    v = np.where(over, 1.0 - v, v)
    return (v0[tri] + u[:, None] * e1[tri] + v[:, None] * e2[tri]).astype(np.float32)


def eval_pcd(points: np.ndarray, gt_mesh_path: str,
             threshold: float = 0.03, sample: int = 1_000_000) -> Dict[str, float]:
    """Accuracy / completion / P / R / F1 against the GT mesh, reference
    protocol (``SLAM/eval.py:176-223``): the GT side is ``sample`` points
    drawn area-weighted from the mesh surface, the reconstruction side is
    subsampled to the same budget, both scored with nearest-neighbour
    KDTree distances.  Meshes without faces fall back to their vertices."""
    from scipy.spatial import cKDTree

    verts, faces = read_mesh(gt_mesh_path)
    rng = np.random.default_rng(0)
    if faces is not None and len(faces):
        gt = sample_mesh_surface(verts, faces, sample)
    else:
        gt = verts
        if len(gt) > sample:
            gt = gt[rng.choice(len(gt), sample, replace=False)]
    if len(points) > sample:
        points = points[rng.choice(len(points), sample, replace=False)]

    d_p2g, _ = cKDTree(gt).query(points, k=1)
    d_g2p, _ = cKDTree(points).query(gt, k=1)
    precision = float((d_p2g < threshold).mean())
    recall = float((d_g2p < threshold).mean())
    f1 = 2 * precision * recall / max(precision + recall, 1e-8)
    return {
        "accuracy_cm": float(d_p2g.mean() * 100),
        "completion_cm": float(d_g2p.mean() * 100),
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }
