"""Fixed-capacity structure-of-arrays Gaussian map.

Port of ``rtgslam_tpu/models/gaussian_map.py``: ONE preallocated set of
``capacity`` slots with a per-slot ``status`` (FREE / UNSTABLE / STABLE).
"Delete" is a status clear, "fix" a status write, and the
stable/unstable/global renders are alive masks over the same arrays.  Raw
parameters are stored: log-scale, logit opacity, unnormalized quaternion.

Unlike the JAX pytree, :class:`MapState` is a dataclass of tensors that the
map operations update in place.  ``from_numpy`` / ``to_numpy`` carry a
state across packages, keyed by the JAX field names, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..utils.geometry import normalize, quat_to_rotmat

FREE, UNSTABLE, STABLE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class GaussianMapConfig:
    capacity: int = 262144
    temp_capacity: int = 65536
    max_sh_degree: int = 3
    init_opacity: float = 0.99
    scale_factor: float = 1.0
    min_radius: float = 0.001
    max_radius: float = 0.05
    xyz_factor: tuple = (1.0, 1.0, 0.1)

    @property
    def n_rest(self) -> int:
        return (self.max_sh_degree + 1) ** 2 - 1

    @classmethod
    def from_args(cls, args) -> "GaussianMapConfig":
        return cls(
            capacity=getattr(args, "map_capacity", 262144),
            temp_capacity=getattr(args, "temp_capacity", 65536),
            max_sh_degree=args.max_sh_degree,
            init_opacity=args.init_opacity,
            scale_factor=args.scale_factor,
            min_radius=args.min_radius,
            max_radius=args.max_radius,
            xyz_factor=tuple(args.xyz_factor),
        )


@dataclasses.dataclass
class MapState:
    """The complete map as [P, ...] tensors (same 11 fields, dtypes and slot
    layout as the JAX ``MapState`` :65)."""

    xyz: torch.Tensor                  # [P, 3]
    features_dc: torch.Tensor          # [P, 3]
    features_rest: torch.Tensor        # [P, R, 3]
    scaling: torch.Tensor              # [P, 3] log-scale
    rotation: torch.Tensor             # [P, 4] quaternion (w,x,y,z)
    opacity: torch.Tensor              # [P, 1] logit
    confidence: torch.Tensor           # [P, 1]
    add_tick: torch.Tensor             # [P, 1] int32
    depth_error_counter: torch.Tensor  # [P, 1] int32
    color_error_counter: torch.Tensor  # [P, 1] int32
    status: torch.Tensor               # [P] int32

    @classmethod
    def create(cls, config: GaussianMapConfig, device="cpu") -> "MapState":
        P, R = config.capacity, config.n_rest
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        rotation = torch.zeros((P, 4), **f32)
        rotation[:, 0] = 1.0
        return cls(
            xyz=torch.zeros((P, 3), **f32),
            features_dc=torch.zeros((P, 3), **f32),
            features_rest=torch.zeros((P, R, 3), **f32),
            scaling=torch.full((P, 3), -13.8, **f32),   # log(1e-6)
            rotation=rotation,
            opacity=torch.zeros((P, 1), **f32),
            confidence=torch.zeros((P, 1), **f32),
            add_tick=torch.zeros((P, 1), **i32),
            depth_error_counter=torch.zeros((P, 1), **i32),
            color_error_counter=torch.zeros((P, 1), **i32),
            status=torch.zeros((P,), **i32),
        )

    @classmethod
    def from_numpy(cls, data: Dict[str, np.ndarray], device="cpu") -> "MapState":
        """Load the arrays of a JAX ``MapState`` (field name -> numpy)."""
        return cls(**{f.name: torch.as_tensor(np.array(data[f.name]),
                                              device=device)
                      for f in dataclasses.fields(cls)})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def activated_scales(scaling: torch.Tensor) -> torch.Tensor:
    return torch.exp(scaling)


def activated_opacity(opacity: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(opacity)


def shs_from_features(features_dc: torch.Tensor,
                      features_rest: torch.Tensor) -> torch.Tensor:
    return torch.cat([features_dc[:, None, :], features_rest], dim=1)


def derived_normal(scaling: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """World normal = rotation column of the smallest scale axis (reference
    ``gaussian_pointcloud.py:539-550``); ties pick the first axis."""
    R = quat_to_rotmat(rotation)                   # columns are local axes
    min_axis = torch.argmin(scaling, dim=-1)
    n = torch.gather(R, 2, min_axis[:, None, None].expand(-1, 3, 1))[..., 0]
    return normalize(n)


def gaussian_radius(scaling: torch.Tensor) -> torch.Tensor:
    """Disc radius = mean of the two largest activated scales."""
    s = activated_scales(scaling)
    return (torch.sum(s, dim=-1) - torch.amin(s, dim=-1)) / 2.0


def render_inputs(state: MapState, alive: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Activated arrays for the rasterizer with the given alive mask."""
    return {
        "xyz": state.xyz,
        "scales": activated_scales(state.scaling),
        "rotations": normalize(state.rotation),
        "opacity": activated_opacity(state.opacity),
        "shs": shs_from_features(state.features_dc, state.features_rest),
        "normal": derived_normal(state.scaling, state.rotation),
        "alive": alive,
    }


def unstable_mask(state: MapState) -> torch.Tensor:
    return state.status == UNSTABLE


def stable_mask(state: MapState) -> torch.Tensor:
    return state.status == STABLE


def alive_mask(state: MapState) -> torch.Tensor:
    return state.status != FREE


def counts(state: MapState):
    """(unstable, stable) slot counts as device scalars (``counts`` :178)."""
    return (torch.sum(state.status == UNSTABLE),
            torch.sum(state.status == STABLE))


# ---------------------------------------------------------------------------
# host-side import/export (checkpoints)
# ---------------------------------------------------------------------------

_PLY_FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
               "rotation", "confidence")


def to_numpy_dict(state: MapState, which: int) -> Dict[str, np.ndarray]:
    """The rows with status ``which``, in slot order, as numpy arrays
    (``to_numpy_dict`` :190)."""
    sel = torch.nonzero(state.status == which).flatten()
    return {k: getattr(state, k)[sel].cpu().numpy() for k in _PLY_FIELDS}


def load_numpy_dict(state: MapState, data: Dict[str, np.ndarray],
                    status_value: int = STABLE, start: int = 0) -> MapState:
    """Write checkpoint rows into slots ``start..start+n`` with status
    ``status_value``, in place (``load_numpy_dict`` :205); a checkpoint of
    a lower SH degree is zero-padded."""
    n = data["xyz"].shape[0]
    rest = data["features_rest"]
    if rest.shape[1] < state.features_rest.shape[1]:
        pad = state.features_rest.shape[1] - rest.shape[1]
        rest = np.pad(rest, ((0, 0), (0, pad), (0, 0)))
    for k in _PLY_FIELDS:
        src = rest if k == "features_rest" else data[k]
        dst = getattr(state, k)
        dst[start:start + n] = torch.as_tensor(np.asarray(src), dtype=dst.dtype,
                                               device=dst.device)
    state.status[start:start + n] = status_value
    return state
