"""Plain PyTorch renderer of a Gaussian map: the reference the port's
renders and blend gradients are held to.

It follows the port's render semantics, frozen here so a later change to
the program cannot move them: EWA projection with the frustum-clamped
Jacobian and a 0.3 px dilation, real SH up to degree 3, the opaque-normal
gate, one stable depth sort, each 16x16 tile taking every Gaussian whose
3-sigma disc meets it (front to back), and the per-pixel blend of alpha =
min(0.99, opacity exp(power)) (zero below 1/255) in chunks of 128 entries
that a tile stops taking once every pixel's transmittance is at or below
1e-4.  Depth and the depth index come from the first opaque entry (an
eligible Gaussian with alpha at or above the opaque threshold).

It differs from the program in what a kernel is free to choose: no block
pre-binning (without overflow it selects the same entries), plain
expressions in place of the kernels' operation order, and the blend written
with out-of-place operations so that autograd differentiates it.  With
``tf32`` every product's inputs are rounded to TF32's 10-bit mantissa: the
control, one precision below the float32 the configurations state.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

TILE = 16
NPIX = TILE * TILE
CHUNK = 128
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
COV2D_DILATION = 0.3
DEPTH_NEAR = 0.2
C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits, to nearest even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def _normalize(v, eps=1e-8):
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps * eps)


def _rotmat(q):
    """Quaternion (w, x, y, z) -> [..., 3, 3] rotation."""
    q = _normalize(q)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def activate(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The rasterizer's inputs from a map's raw parameters: scales exp,
    rotations normalised, opacity sigmoid, SH stacked, the normal the
    rotation's column of the smallest scale."""
    R = _rotmat(state["rotation"])
    axis = torch.argmin(state["scaling"], dim=-1)
    normal = torch.gather(R, 2, axis[:, None, None].expand(-1, 3, 1))[..., 0]
    return {"xyz": state["xyz"], "scales": torch.exp(state["scaling"]),
            "rotations": _normalize(state["rotation"]),
            "opacity": torch.sigmoid(state["opacity"]).reshape(-1),
            "shs": torch.cat([state["features_dc"][:, None, :],
                              state["features_rest"]], dim=1),
            "normal": _normalize(normal)}


def project(g, w2c, K, width: int, height: int, low: bool = False):
    """Screen-space means [P, 2], conics [P, 3], depths [P], 3-sigma radii
    [P] and visibility [P]."""
    r = tf32 if low else (lambda x: x)
    R, t = r(w2c[:3, :3]), r(w2c[:3, 3])
    xyz = r(g["xyz"])
    p = xyz @ R.T + t
    x, y, z = p.unbind(-1)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    in_front = z > DEPTH_NEAR
    zs = torch.where(in_front, z, torch.ones_like(z))
    mean = torch.stack([fx * x / zs + cx, fy * y / zs + cy], dim=-1)
    tan_x, tan_y = (width / 2) / fx, (height / 2) / fy
    tx = torch.clamp(x / zs, -1.3 * tan_x, 1.3 * tan_x) * zs
    ty = torch.clamp(y / zs, -1.3 * tan_y, 1.3 * tan_y) * zs
    J = torch.zeros(p.shape[0], 2, 3, dtype=p.dtype, device=p.device)
    J[:, 0, 0], J[:, 0, 2] = fx / zs, -fx * tx / (zs * zs)
    J[:, 1, 1], J[:, 1, 2] = fy / zs, -fy * ty / (zs * zs)
    # W R S: the world-to-camera rotation of the scaled local axes
    A = r(R)[None] @ r(_rotmat(g["rotations"])) * r(g["scales"])[:, None, :]
    M = r(J) @ r(A)
    cov = M @ M.transpose(1, 2)
    a = cov[:, 0, 0] + COV2D_DILATION
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + COV2D_DILATION
    det = a * c - b * b
    det_ok = det > 0
    det_s = torch.where(det_ok, det, torch.ones_like(det))
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(
        torch.clamp(mid * mid - det, min=0.1))))
    on_screen = ((mean[:, 0] + radius > 0) & (mean[:, 0] - radius < width)
                 & (mean[:, 1] + radius > 0) & (mean[:, 1] - radius < height))
    visible = g["alive"] & in_front & det_ok & (radius > 0) & on_screen
    conic = torch.stack([c / det_s, -b / det_s, a / det_s], dim=-1)
    return mean, conic, z, torch.where(visible, radius, 0.0), visible


def shade(g, campos, degree: int, normal_threshold: float):
    """SH colour [P, 3] (+0.5, floored at 0) and the opaque-normal gate."""
    d = _normalize(g["xyz"] - campos, eps=1e-6)
    x, y, z = d.unbind(-1)
    basis = [torch.full_like(x, C0)]
    if degree >= 1:
        basis += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [C2[0] * x * y, C2[1] * y * z, C2[2] * (2.0 * zz - xx - yy),
                  C2[3] * x * z, C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [C3[0] * y * (3 * xx - yy), C3[1] * x * y * z,
                  C3[2] * y * (4 * zz - xx - yy),
                  C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
                  C3[6] * x * (xx - 3 * yy)]
    B = torch.stack(basis, dim=-1)                      # [P, k]
    rgb = torch.einsum("pk,pkc->pc", B, g["shs"][:, :B.shape[1]])
    rgb = torch.clamp(rgb + 0.5, min=0.0)
    elig = torch.abs(torch.sum(g["normal"] * d, dim=-1)) >= normal_threshold
    return rgb, elig


def tile_grid(height: int, width: int, device) -> torch.Tensor:
    """[T, 2] (x, y) origins of the tiles, row-major over the image."""
    ty, tx = -(-height // TILE), -(-width // TILE)
    oy, ox = torch.meshgrid(torch.arange(ty, device=device) * TILE,
                            torch.arange(tx, device=device) * TILE, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1).float()


def tile_lists(mean, radius, visible, depth, origins) -> Tuple[torch.Tensor, ...]:
    """Front-to-back lists of the Gaussians (indices into the depth order)
    whose 3-sigma disc meets each tile.  Returns (order [V], lists [T, K]
    padded with V, counts [T])."""
    keys = torch.where(visible, depth, torch.full_like(depth, float("inf")))
    order = torch.sort(keys, stable=True).indices
    order = order[: int(visible.sum())]
    m, r2 = mean[order], radius[order] ** 2
    V = order.shape[0]
    hits = []
    for o in origins.split(512):
        nx = torch.minimum(torch.maximum(m[None, :, 0], o[:, None, 0]), o[:, None, 0] + TILE)
        ny = torch.minimum(torch.maximum(m[None, :, 1], o[:, None, 1]), o[:, None, 1] + TILE)
        dx, dy = m[None, :, 0] - nx, m[None, :, 1] - ny
        hits.append(dx * dx + dy * dy <= r2[None])
    hit = torch.cat(hits) if hits else torch.zeros((0, V), dtype=torch.bool,
                                                    device=mean.device)
    counts = hit.sum(dim=1)
    K = max(int(counts.max()) if counts.numel() else 0, 1)
    K = -(-K // CHUNK) * CHUNK
    pos = torch.cumsum(hit, dim=1) - 1
    dest = torch.where(hit, pos, K)
    lists = torch.full((hit.shape[0], K + 1), V, dtype=torch.long, device=mean.device)
    lists.scatter_(1, dest, torch.arange(V, device=mean.device).expand_as(dest).contiguous())
    return order, lists[:, :K], counts


def tile_pixels(origins):
    ij = torch.arange(NPIX, device=origins.device)
    local = torch.stack([ij % TILE, ij // TILE], dim=-1).to(origins.dtype)
    return origins[:, None, :] + local[None]


def blend(feat, lists, counts, origins, opaque_threshold: float,
          T_threshold: float = 1e-4) -> Dict[str, torch.Tensor]:
    """Front-to-back blend of every tile's list: ``feat`` [V+1, 11] rows
    (mean x, mean y, conic a b c, depth, r, g, b, opacity, gate; row V
    zeros), ``lists`` [T, K] into them.  Returns colour [T, 256, 3], depth
    [T, 256], the depth hit's list value [T, 256] (-1: none) and the final
    transmittance [T, 256].  Differentiable in ``feat``."""
    T_tiles, K = lists.shape
    chunk = min(CHUNK, K)
    pix = tile_pixels(origins)
    n_chunks = (counts.long() + chunk - 1) // chunk
    dt, dev = feat.dtype, feat.device
    tri = torch.triu(torch.ones(chunk, chunk, dtype=dt, device=dev), diagonal=1)
    Tm = torch.ones((T_tiles, NPIX), dtype=dt, device=dev)
    colour = torch.zeros((T_tiles, NPIX, 3), dtype=dt, device=dev)
    depth = torch.zeros((T_tiles, NPIX), dtype=dt, device=dev)
    hit_row = torch.full((T_tiles, NPIX), -1, dtype=torch.long, device=dev)
    for c in range(K // chunk):
        active = (c < n_chunks) & (Tm.detach().amax(dim=1) > T_threshold)
        if not bool(active.any()):
            break
        rows = lists[:, c * chunk:(c + 1) * chunk].long()
        f = feat[rows]                                   # [T, C, 11]
        dx = pix[:, :, 0, None] - f[:, None, :, 0]
        dy = pix[:, :, 1, None] - f[:, None, :, 1]
        power = -0.5 * (f[:, None, :, 2] * dx * dx + f[:, None, :, 4] * dy * dy) \
            - f[:, None, :, 3] * dx * dy
        raw = f[:, None, :, 9] * torch.exp(torch.clamp(power, max=0.0))
        alpha = torch.where((power > 0) | (raw < ALPHA_EPS), torch.zeros_like(raw),
                            torch.clamp(raw, max=ALPHA_MAX))
        alpha = alpha * active[:, None, None]
        excl = torch.exp(torch.log1p(-alpha) @ tri)      # exclusive product
        w = alpha * (Tm[:, :, None] * excl)
        colour = colour + w @ f[:, :, 6:9]
        opaque = (f[:, None, :, 10] > 0.5) & (alpha >= opaque_threshold)
        first = torch.argmax(opaque.to(torch.uint8), dim=2, keepdim=True)
        new_hit = opaque.any(dim=2) & (hit_row < 0)
        z_first = f[:, :, 5][:, None, :].expand(-1, NPIX, -1).gather(2, first)[..., 0]
        depth = torch.where(new_hit, z_first, depth)
        hit_row = torch.where(new_hit, rows[:, None, :].expand(-1, NPIX, -1)
                              .gather(2, first)[..., 0], hit_row)
        Tm = Tm * excl[..., -1] * (1.0 - alpha[..., -1])
    return {"colour": colour, "depth": depth, "hit_row": hit_row, "T": Tm}


def features(g, mean, conic, depth, rgb, elig, order) -> torch.Tensor:
    """[V+1, 11] rows of the depth-sorted visible Gaussians, row V zeros."""
    f = torch.cat([mean[order], conic[order], depth[order, None], rgb[order],
                   g["opacity"][order, None], elig[order, None].to(mean.dtype)],
                  dim=-1)
    return torch.cat([f, f.new_zeros((1, 11))])


def render(state: Dict[str, torch.Tensor], camera: Dict[str, torch.Tensor],
           height: int, width: int, sh_degree: int, normal_threshold: float,
           opaque_threshold: float, low: bool = False) -> Dict[str, torch.Tensor]:
    """Render a map's raw parameters (alive slots only) at ``camera`` (w2c,
    K, campos): colour [H, W, 3] and depth [H, W]."""
    g = activate(state)
    g["alive"] = torch.ones(g["xyz"].shape[0], dtype=torch.bool,
                            device=g["xyz"].device)
    mean, conic, depth, radius, visible = project(
        g, camera["w2c"], camera["K"], width, height, low)
    rgb, elig = shade(g, camera["campos"], sh_degree, normal_threshold)
    origins = tile_grid(height, width, mean.device)
    order, lists, counts = tile_lists(mean, radius, visible, depth, origins)
    feat = features(g, mean, conic, depth, rgb, elig, order)
    out = blend(feat, lists, counts, origins, opaque_threshold)
    ty, tx = -(-height // TILE), -(-width // TILE)

    def image(v, ch):
        v = v.reshape(ty, tx, TILE, TILE, ch).permute(0, 2, 1, 3, 4)
        return v.reshape(ty * TILE, tx * TILE, ch)[:height, :width]

    return {"colour": image(out["colour"], 3),
            "depth": image(out["depth"][..., None], 1)[..., 0]}
