"""The inputs of a run, made from ``--seed`` on the device in a few large
calls: the weights, a vrig-like ray store and the cameras of a render.

Every seed gives the same sizes and the same work; only the values move.
Both the program and the reference are handed these same tensors.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from h100_bench.reference import model as ref


def derive(seed: int, *tags) -> int:
  """A 63-bit seed for one stream of draws of the run ``seed``."""
  digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
  return int.from_bytes(digest[:8], 'little') >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
  return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def params(model_cfg: Dict, num_embeds: int, seed: int,
           device) -> Dict[str, torch.Tensor]:
  """Every parameter from one uniform draw: kernels Glorot-uniform, biases
  zero, latent codes U[0, 0.05) as the GLO tables start. Heads are drawn
  like any kernel, so that the warp, the hyper sheet and the mask are far
  from their identity start, as in a model in the bulk of its training."""
  shapes = ref.param_shapes(model_cfg, num_embeds)
  sizes = [math.prod(s) for s in shapes.values()]
  u = torch.rand(sum(sizes), generator=generator(device, seed, 'params'),
                 device=device)
  out = {}
  for (name, shape), part in zip(shapes.items(), torch.split(u, sizes)):
    x = part.view(shape)
    if name.endswith('.kernel'):
      out[name] = (2.0 * x - 1.0) * math.sqrt(6.0 / (shape[0] + shape[1]))
    elif name.endswith('.embedding'):
      out[name] = 0.05 * x
    else:
      out[name] = torch.zeros_like(x)
  return out


def look_at(position: torch.Tensor) -> torch.Tensor:
  """[..., 3, 3] camera-to-world rotations whose z axis looks from
  ``position`` [..., 3] at the origin, with y down."""
  z = -position / torch.linalg.vector_norm(position, dim=-1, keepdim=True)
  up = torch.tensor([0.0, -1.0, 0.0], device=position.device).expand_as(z)
  x = torch.linalg.cross(up, z, dim=-1)
  x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
  y = torch.linalg.cross(z, x, dim=-1)
  return torch.stack([x, y, z], -1)


def pinhole_rays(positions: torch.Tensor, size: int):
  """(origins, unit directions), each [F, size*size, 3], of pinhole
  cameras at ``positions`` [F, 3] looking at the origin, focal 1.2 × size."""
  pix = torch.arange(size, dtype=torch.float32,
                     device=positions.device) + 0.5 - size / 2
  ys, xs = torch.meshgrid(pix, pix, indexing='ij')
  local = torch.stack([xs, ys, torch.full_like(xs, 1.2 * size)], -1)
  local = local / torch.linalg.vector_norm(local, dim=-1, keepdim=True)
  dirs = torch.einsum('fij,pj->fpi', look_at(positions),
                      local.reshape(-1, 3))
  origins = positions[:, None, :].expand_as(dirs)
  return origins.contiguous(), dirs.contiguous()


def rig_positions(frames: int, radius: float, angle0: torch.Tensor,
                  device) -> torch.Tensor:
  """Two cameras 0.2 rad apart on a circle about the object, the rig
  turning a quarter turn over the capture; frame f is camera f % 2 at
  time f // 2."""
  f = torch.arange(frames, dtype=torch.float32, device=device)
  t = torch.div(f, 2, rounding_mode='floor') / max(frames // 2, 1)
  angle = angle0 + 0.5 * math.pi * t + 0.2 * (f % 2 - 0.5)
  height = 0.25 * torch.sin(2 * math.pi * t)
  return torch.stack([radius * torch.cos(angle), height,
                      radius * torch.sin(angle)], -1)


def ray_store(frames: int, size: int, seed: int, device) -> Dict:
  """The training rays of a two-camera capture of ``frames`` frames of
  ``size``²: origins, unit directions, smooth procedural rgb targets, a
  moving disc as the foreground mask, and the frame index as the warp id
  (each [N, C]; ids int32)."""
  g = generator(device, seed, 'store')
  draw = lambda *shape: torch.rand(shape, generator=g, device=device)
  positions = rig_positions(frames, 1.1, 2 * math.pi * draw(1), device)
  origins, dirs = pinhole_rays(positions, size)
  pix = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
  v, u = torch.meshgrid(pix, pix, indexing='ij')
  # rgb: 0.5 + two seeded plane waves a channel, each of amplitude 0.2.
  freq, phase = 1.0 + 3.0 * draw(frames, 2, 3, 2), draw(frames, 2, 3)
  waves = torch.sin(2 * math.pi * (
      freq[..., 0, None, None] * u + freq[..., 1, None, None] * v
      + phase[..., None, None]))                          # [F, 2, 3, H, W]
  rgb = (0.5 + 0.2 * waves.sum(1)).permute(0, 2, 3, 1)     # [F, H, W, 3]
  # mask: a disc of radius 0.15-0.25 about a centre near the middle.
  centre, radius = 0.3 + 0.4 * draw(frames, 2), 0.15 + 0.1 * draw(frames)
  inside = ((u - centre[:, 0, None, None]) ** 2
            + (v - centre[:, 1, None, None]) ** 2) < radius[:, None,
                                                            None] ** 2
  ids = torch.arange(frames, dtype=torch.int32, device=device)
  n = frames * size * size
  return {
      'origins': origins.reshape(n, 3),
      'directions': dirs.reshape(n, 3),
      'rgb': rgb.reshape(n, 3).contiguous(),
      'mask': inside.to(torch.float32).reshape(n, 1),
      'warp': ids[:, None].expand(frames, size * size).reshape(n, 1)
              .contiguous(),
  }


def orbit_frame(index: int, size: int, num_embeds: int, seed: int,
                device) -> Dict:
  """Frame ``index`` of a render orbit: one camera 1.1 from the object,
  starting at a seeded angle and stepping 2π/48 a frame; the warp id runs
  over the embeddings."""
  angle0 = 2 * math.pi * (derive(seed, 'orbit') % 10 ** 6) / 10 ** 6
  angle = angle0 + 2 * math.pi * index / 48
  pos = torch.tensor([[1.1 * math.cos(angle), 0.1 * math.sin(angle),
                       1.1 * math.sin(angle)]], device=device)
  origins, dirs = pinhole_rays(pos, size)
  return {'origins': origins[0], 'directions': dirs[0],
          'warp': index % num_embeds}
