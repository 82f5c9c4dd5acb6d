"""A one-dimensional mesh of shard devices and its collectives.

Port of ``rtgslam_tpu/parallel/sharded.py::make_mesh`` (:34).  JAX's
``shard_map`` is single-controller: one Python process owns the mesh and
every device runs the same program on its shard.  Here one host thread
issues every shard's launches in shard order, and the collectives are
plain tensor code between those launches:

* :meth:`Mesh.sum` adds per-shard values as a pairwise tree in shard order
  ((s0 + s1) + (s2 + s3) ...) on the first shard's device; ``psum``,
  ``pmean`` and ``broadcast`` copy a result out to every shard.  Identical
  shard values therefore give a bitwise-exact ``pmean`` on a power-of-two
  mesh (g + g + g + g summed as (g + g) + (g + g) is exactly 4 g);
* the order does not depend on where the shards live, so a mesh of
  virtual shards of one device (``devices=["cuda:0"] * 4``, the counterpart
  of the JAX tests' ``--xla_force_host_platform_device_count``) and a mesh
  over several cards give bitwise-equal results.

Values are tensors, or dicts of tensors (summed key by key).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ordered shard devices (they may repeat) and the axis name."""

    devices: Tuple[torch.device, ...]
    axis: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)

    def sum(self, values: Sequence):
        """The shard-order pairwise tree sum of one value per shard, on the
        first shard's device."""
        if len(values) != self.size:
            raise ValueError(f"{len(values)} values for a mesh of {self.size} "
                             "shards")
        if isinstance(values[0], dict):
            return {k: self.sum([v[k] for v in values]) for k in values[0]}
        level = [v.to(self.devices[0]) for v in values]
        while len(level) > 1:
            pairs = [level[i] + level[i + 1] for i in range(0, len(level) - 1, 2)]
            level = pairs + level[len(pairs) * 2:]
        return level[0]

    def mean(self, values: Sequence):
        """:meth:`sum` over the shard count, on the first shard's device."""
        total = self.sum(values)
        if isinstance(total, dict):
            return {k: v / self.size for k, v in total.items()}
        return total / self.size

    def broadcast(self, value) -> List:
        """``value`` on every shard's device, in shard order (the same
        tensor where a shard's device already holds it; a value that is not
        a tensor, such as a loss weight, as it is)."""
        if isinstance(value, dict):
            per_key = {k: self.broadcast(v) for k, v in value.items()}
            return [{k: v[s] for k, v in per_key.items()}
                    for s in range(self.size)]
        if not torch.is_tensor(value):
            return [value] * self.size
        return [value.to(d) for d in self.devices]

    def psum(self, values: Sequence) -> List:
        return self.broadcast(self.sum(values))

    def pmean(self, values: Sequence) -> List:
        return self.broadcast(self.mean(values))


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (all of them when
    None); by default ``devices`` are the visible CUDA cards.  Building a
    mesh allocates nothing."""
    if devices is None:
        n_visible = torch.cuda.device_count()
        if n_visible == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible (give "
                               "devices=[...] for shards of another device)")
        devices = [f"cuda:{i}" for i in range(n_visible)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"make_mesh: {n_devices} shards asked of "
                             f"{len(devices)} devices")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(tuple(devices), axis)
