"""Procedural dynamic test scene (L2), counterpart of
``nerfds_tpu/datasets/synthetic.py``.

A deforming emissive sphere orbiting inside a static shell, with ground
truth rendered by ray-marching the analytic density and colour field with
the compositing math the model uses. The march runs in numpy (the JAX
package's ``gt_backend='numpy'`` path, number for number, and the
reference) or in torch on a device (``gt_backend='torch'``, the
counterpart of the JAX package's jitted ``gt_backend='jax'`` march, which
the port does not have). It provides

  * :class:`SyntheticDataSource`, an in-memory ``DataSource``, and the
    fields (numpy, and their torch twins) and orbit camera behind it;
  * :class:`VrigSyntheticDataSource`, a two-camera validation-rig capture
    with distorted lenses, marched in torch on ``cuda`` by default;
  * :func:`write_nerfies_dataset`, which writes a scene in the Nerfies
    directory layout (``datasets/nerfies.py``) with ``viz.save_png``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from nerfds_torch import viz
from nerfds_torch.camera import Camera, camera_to_rays
from nerfds_torch.datasets.core import DataSource
from nerfds_torch.device import resolve_device

def _sphere_center(t: float) -> np.ndarray:
  """Moving sphere center; t in [0, 1]."""
  angle = 2.0 * np.pi * t
  return np.array([0.25 * np.cos(angle), 0.25 * np.sin(angle), 0.0],
                  np.float32)


# Fixed directional light for the specular scene (unit vector).
_LIGHT_DIR = np.array([0.577, -0.577, -0.577], np.float32)


def field(points: np.ndarray, t: float, static: bool = False,
          viewdirs: Optional[np.ndarray] = None, specular: bool = False,
          specular_exponent: float = 25.0, light_mode: str = 'world'):
  """Analytic (density, color) field. points [..., 3] -> ([...], [..., 3]).

  With ``specular=True`` and ``viewdirs`` ([..., 3], camera→point unit
  vectors, broadcastable to points), the MOVING sphere gets a Blinn-Phong
  highlight computed from its analytic outward normal — a *dynamic specular
  surface*, the exact phenomenon NeRF-DS exists for: the radiance depends on (normal, viewdir), and the
  normal field moves with the warp. A model can only fit the moving
  highlight by recovering normals in the observation frame, so
  ``use_ref_radiance`` / predicted normals / back-facing losses become
  load-bearing on this scene instead of gradient-flow-only.

  ``light_mode``: 'world' (default) keeps the fixed directional light;
  'camera' anchors the light AT the camera (a headlight, L = −viewdir) —
  the adversarial construction from the NeRF-DS paper's motivation: the
  highlight then slides across the moving surface *against* the object's
  motion, so appearance changes cannot be explained by the deformation
  field carrying a static texture.
  """
  if static:
    t = 0.0
  center = _sphere_center(t)
  offset = points - center
  d_sphere = np.linalg.norm(offset, axis=-1)
  sigma_sphere = 40.0 * np.exp(-0.5 * (d_sphere / 0.12) ** 2)
  # A static dimmer blob off-axis gives the scene a persistent part.
  d_blob = np.linalg.norm(points - np.asarray([0.0, 0.0, 0.35]), axis=-1)
  sigma_blob = 25.0 * np.exp(-0.5 * (d_blob / 0.10) ** 2)
  sigma = sigma_sphere + sigma_blob
  two_pi_t = 2 * np.pi * t
  # Color varies smoothly with position and time (sphere) vs fixed (blob).
  color_sphere = 0.5 + 0.5 * np.stack([
      np.cos(4.0 * points[..., 0] + two_pi_t),
      np.sin(4.0 * points[..., 1]),
      np.cos(4.0 * points[..., 2] - two_pi_t),
  ], axis=-1)
  if specular and viewdirs is not None:
    # Outward analytic normal of the moving sphere (= normalize(-∇σ_sphere)).
    normal = offset / np.maximum(d_sphere, 1e-8)[..., None]
    if light_mode == 'camera':
      light = -viewdirs
    else:
      light = np.asarray(_LIGHT_DIR)[None]
    half = light - viewdirs                     # L + (−viewdir)
    half = half / np.maximum(
        np.linalg.norm(half, axis=-1, keepdims=True), 1e-8)
    n_dot_h = np.maximum((normal * half).sum(-1), 0.0)
    # Sharper exponents make the highlight a narrower function of
    # (normal, viewdir) — harder to fit without normal machinery (the
    # normals-ablation study raises this).
    highlight = 1.0 * n_dot_h ** specular_exponent
    # Keep the diffuse term bright enough that the all-black-fog local
    # minimum stays unattractive (a 0.35x dim measurably collapsed
    # training), while the moving highlight remains the dominant
    # view-dependent signal on the sphere.
    color_sphere = color_sphere * 0.6 + highlight[..., None]
  color_blob = np.broadcast_to(np.asarray([0.9, 0.6, 0.2]),
                               color_sphere.shape)
  w = (sigma_sphere / np.maximum(sigma, 1e-8))[..., None]
  color = w * color_sphere + (1.0 - w) * color_blob
  return sigma.astype(np.float32), color.astype(np.float32)


def shaded_field(points, t, viewdirs, light_mode: str = 'camera',
                 specular_exponent: float = 60.0):
  """NON-emissive Blinn-Phong variant: the paper-mechanism normals scene.

  The moving sphere carries a *material-anchored* albedo texture (a function
  of material coordinates ``points - center(t)``, so the texture travels
  with the object — exactly what a deformation field CAN explain) shaded by
  Lambertian diffuse + a sharp Blinn-Phong highlight from a camera-anchored
  light (``light_mode='camera'``; 'world' pins it instead). The highlight is
  the only appearance component a warp-carried texture CANNOT explain — the
  condition NeRF-DS claims corrupts mask-free deformation estimation.

  Returns (sigma, color) like :func:`field`.
  """
  center = _sphere_center(t)
  offset = points - center
  d_sphere = np.linalg.norm(offset, axis=-1)
  sigma_sphere = 40.0 * np.exp(-0.5 * (d_sphere / 0.12) ** 2)
  d_blob = np.linalg.norm(points - np.asarray([0.0, 0.0, 0.35]), axis=-1)
  sigma_blob = 25.0 * np.exp(-0.5 * (d_blob / 0.10) ** 2)
  sigma = sigma_sphere + sigma_blob
  normal = offset / np.maximum(d_sphere, 1e-8)[..., None]
  # Material-anchored two-tone albedo (moves WITH the sphere).
  albedo = 0.55 + 0.35 * np.stack([
      np.cos(24.0 * offset[..., 0]),
      np.cos(24.0 * offset[..., 1]),
      np.cos(24.0 * offset[..., 2]),
  ], axis=-1)
  if light_mode == 'camera':
    light = -viewdirs
  else:
    light = np.asarray(_LIGHT_DIR)[None]
  lambert = np.maximum((normal * light).sum(-1), 0.0)
  half = light - viewdirs
  half = half / np.maximum(
      np.linalg.norm(half, axis=-1, keepdims=True), 1e-8)
  n_dot_h = np.maximum((normal * half).sum(-1), 0.0)
  highlight = n_dot_h ** specular_exponent
  color_sphere = (albedo * (0.30 + 0.70 * lambert[..., None])
                  + 0.9 * highlight[..., None])
  color_blob = np.broadcast_to(np.asarray([0.9, 0.6, 0.2]),
                               color_sphere.shape)
  w = (sigma_sphere / np.maximum(sigma, 1e-8))[..., None]
  color = w * color_sphere + (1.0 - w) * color_blob
  return sigma.astype(np.float32), color.astype(np.float32)


def _eval_field(points, t, viewdirs, *, static, specular, specular_exponent,
                field_kind, light_mode):
  """Dispatch between the emissive field and the shaded mechanism field."""
  if field_kind == 'shaded':
    return shaded_field(points, 0.0 if static else t, viewdirs,
                        light_mode=light_mode,
                        specular_exponent=specular_exponent)
  return field(points, t, static=static, viewdirs=viewdirs,
               specular=specular, specular_exponent=specular_exponent,
               light_mode=light_mode)


# -- the torch twins of the fields, and the torch march ---------------------


def _blob_and_sphere(points: torch.Tensor, t: float):
  """(offset from the sphere centre, |offset|, σ of the sphere, σ of the
  static blob) at ``points``, float32 on their device."""
  center = torch.as_tensor(_sphere_center(t), device=points.device)
  offset = points - center
  d_sphere = torch.linalg.vector_norm(offset, dim=-1)
  sigma_sphere = 40.0 * torch.exp(-0.5 * (d_sphere / 0.12) ** 2)
  d_blob = torch.linalg.vector_norm(
      points - points.new_tensor([0.0, 0.0, 0.35]), dim=-1)
  sigma_blob = 25.0 * torch.exp(-0.5 * (d_blob / 0.10) ** 2)
  return offset, d_sphere, sigma_sphere, sigma_blob


def _blinn_half(points: torch.Tensor, viewdirs: torch.Tensor,
                light_mode: str):
  """(light direction, normalised half vector) of the Blinn-Phong terms."""
  if light_mode == 'camera':
    light = -viewdirs
  else:
    light = points.new_tensor(_LIGHT_DIR)[None]
  half = light - viewdirs
  half = half / torch.linalg.vector_norm(
      half, dim=-1, keepdim=True).clamp_min(1e-8)
  return light, half


def _with_blob(color_sphere, sigma_sphere, sigma_blob):
  """(σ, colour): the sphere's colour blended with the blob's by σ."""
  sigma = sigma_sphere + sigma_blob
  color_blob = color_sphere.new_tensor([0.9, 0.6, 0.2])
  w = (sigma_sphere / sigma.clamp_min(1e-8))[..., None]
  return sigma, w * color_sphere + (1.0 - w) * color_blob


def field_torch(points: torch.Tensor, t: float, static: bool = False,
                viewdirs: Optional[torch.Tensor] = None,
                specular: bool = False, specular_exponent: float = 25.0,
                light_mode: str = 'world'):
  """:func:`field` in torch, float32 on the points' device."""
  if static:
    t = 0.0
  offset, d_sphere, sigma_sphere, sigma_blob = _blob_and_sphere(points, t)
  two_pi_t = 2 * np.pi * t
  color_sphere = 0.5 + 0.5 * torch.stack([
      torch.cos(4.0 * points[..., 0] + two_pi_t),
      torch.sin(4.0 * points[..., 1]),
      torch.cos(4.0 * points[..., 2] - two_pi_t),
  ], dim=-1)
  if specular and viewdirs is not None:
    normal = offset / d_sphere.clamp_min(1e-8)[..., None]
    _, half = _blinn_half(points, viewdirs, light_mode)
    n_dot_h = (normal * half).sum(-1).clamp_min(0.0)
    highlight = 1.0 * n_dot_h ** specular_exponent
    color_sphere = color_sphere * 0.6 + highlight[..., None]
  return _with_blob(color_sphere, sigma_sphere, sigma_blob)


def shaded_field_torch(points: torch.Tensor, t: float,
                       viewdirs: torch.Tensor, light_mode: str = 'camera',
                       specular_exponent: float = 60.0):
  """:func:`shaded_field` in torch, float32 on the points' device."""
  offset, d_sphere, sigma_sphere, sigma_blob = _blob_and_sphere(points, t)
  normal = offset / d_sphere.clamp_min(1e-8)[..., None]
  albedo = 0.55 + 0.35 * torch.stack([
      torch.cos(24.0 * offset[..., 0]),
      torch.cos(24.0 * offset[..., 1]),
      torch.cos(24.0 * offset[..., 2]),
  ], dim=-1)
  light, half = _blinn_half(points, viewdirs, light_mode)
  lambert = (normal * light).sum(-1).clamp_min(0.0)
  n_dot_h = (normal * half).sum(-1).clamp_min(0.0)
  highlight = n_dot_h ** specular_exponent
  color_sphere = (albedo * (0.30 + 0.70 * lambert[..., None])
                  + 0.9 * highlight[..., None])
  return _with_blob(color_sphere, sigma_sphere, sigma_blob)


@torch.no_grad()
def _march_torch(o: torch.Tensor, d: torch.Tensor, t: float, z: np.ndarray,
                 span: float, *, static, specular, white_background,
                 specular_exponent, field_kind, light_mode):
  """The numpy march of :func:`_render_image` on tensors: (rgb [R, 3],
  moving-part weight [R]) of rays ``o``, ``d`` sampled at depths ``z``."""
  dists_np = np.diff(z, append=z[-1] + span).astype(np.float32)
  z = torch.from_numpy(z).to(o.device)
  pts = o[:, None, :] + z[None, :, None] * d[:, None, :]
  view = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(
      1e-8))[:, None, :]
  if field_kind == 'shaded':
    sigma, color = shaded_field_torch(
        pts, 0.0 if static else t, view, light_mode=light_mode,
        specular_exponent=specular_exponent)
  else:
    sigma, color = field_torch(
        pts, t, static=static, viewdirs=view, specular=specular,
        specular_exponent=specular_exponent, light_mode=light_mode)
  center = torch.as_tensor(_sphere_center(0.0 if static else t),
                           device=o.device)
  moving = (torch.linalg.vector_norm(pts - center, dim=-1) < 0.3).float()
  dists = torch.from_numpy(dists_np).to(o.device)[None] * (
      torch.linalg.vector_norm(d, dim=-1)[:, None])
  alpha = 1.0 - torch.exp(-sigma * dists)
  accum = torch.cat([
      torch.ones_like(alpha[:, :1]),
      torch.cumprod(1.0 - alpha[:, :-1] + 1e-10, dim=-1)], dim=-1)
  weights = alpha * accum
  rgb = (weights[..., None] * color).sum(dim=1)
  if white_background:
    rgb = rgb + (1.0 - weights.sum(dim=1))[..., None]
  return rgb, (weights * moving).sum(dim=1)


def _render_image(camera: Camera, t: float, near: float, far: float,
                  num_samples: int = 192, static: bool = False,
                  specular: bool = False, white_background: bool = False,
                  specular_exponent: float = 25.0,
                  field_kind: str = 'emissive', light_mode: str = 'world',
                  backend: str = 'numpy', device=None):
  """Ground-truth ray march of the analytic field. Returns (rgb, mask).

  ``white_background`` composites unfilled transmittance onto white (pair
  it with the model's ``use_white_background``). ``backend='torch'`` runs
  the same march on ``device`` in chunks of one shape (65,536 rays, or
  the whole image if smaller; the last chunk is padded by repeating its
  last ray); the numpy march is the reference.
  """
  rays = camera_to_rays(camera)
  origins = rays['origins'].reshape(-1, 3)
  directions = rays['directions'].reshape(-1, 3)
  z = np.linspace(near, far, num_samples, dtype=np.float32)
  # Chunked to bound memory.
  h, w = camera.image_shape
  out_rgb = np.zeros((h * w, 3), np.float32)
  out_fg = np.zeros((h * w,), np.float32)
  chunk = 65536
  if backend == 'torch':
    chunk = min(chunk, h * w)
    for start in range(0, h * w, chunk):
      o = origins[start:start + chunk]
      d = directions[start:start + chunk]
      n = o.shape[0]
      if n < chunk:
        o = np.concatenate([o, np.repeat(o[-1:], chunk - n, 0)], 0)
        d = np.concatenate([d, np.repeat(d[-1:], chunk - n, 0)], 0)
      rgb_chunk, fg_chunk = _march_torch(
          torch.from_numpy(o).to(device), torch.from_numpy(d).to(device), t,
          z, far - near, static=static, specular=specular,
          white_background=white_background,
          specular_exponent=specular_exponent, field_kind=field_kind,
          light_mode=light_mode)
      out_rgb[start:start + n] = rgb_chunk[:n].cpu().numpy()
      out_fg[start:start + n] = fg_chunk[:n].cpu().numpy()
  else:
    for start in range(0, h * w, chunk):
      o = origins[start:start + chunk]
      d = directions[start:start + chunk]
      pts = o[:, None, :] + z[None, :, None] * d[:, None, :]
      view = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
      sigma, color = _eval_field(
          pts, t, view[:, None, :], static=static, specular=specular,
          specular_exponent=specular_exponent, field_kind=field_kind,
          light_mode=light_mode)
      center = _sphere_center(0.0 if static else t)
      moving = (np.linalg.norm(pts - center, axis=-1) < 0.3
                ).astype(np.float32)
      dists = np.diff(z, append=z[-1] + (far - near)).astype(np.float32)
      dists = dists * np.linalg.norm(d, axis=-1)[:, None]
      alpha = 1.0 - np.exp(-sigma * dists)
      accum = np.concatenate([
          np.ones_like(alpha[:, :1]),
          np.cumprod(1.0 - alpha[:, :-1] + 1e-10, axis=-1)], axis=-1)
      weights = alpha * accum
      rgb_chunk = (weights[..., None] * color).sum(axis=1)
      if white_background:
        rgb_chunk = rgb_chunk + (1.0 - weights.sum(axis=1))[..., None]
      out_rgb[start:start + chunk] = rgb_chunk
      out_fg[start:start + chunk] = (weights * moving).sum(axis=1)
  rgb = out_rgb.reshape(h, w, 3).clip(0.0, 1.0)
  mask = (out_fg.reshape(h, w, 1) > 0.3).astype(np.float32)
  return rgb, mask


def make_orbit_camera(idx: int, num_frames: int, image_size: int = 64,
                      radius: float = 1.2) -> Camera:
  """Camera on a slow orbit, looking at the origin."""
  angle = 0.6 * np.sin(2 * np.pi * idx / max(num_frames, 1))
  position = np.array([radius * np.sin(angle), 0.35,
                       -radius * np.cos(angle)], np.float32)
  base = Camera(
      orientation=np.eye(3), position=position,
      focal_length=image_size * 1.2,
      principal_point=np.array([image_size / 2, image_size / 2]),
      image_size=np.array([image_size, image_size]))
  return base.look_at(position, np.zeros(3), np.array([0.0, -1.0, 0.0]))


class SyntheticDataSource(DataSource):
  """In-memory dynamic scene with analytic ground truth."""

  NEAR = 0.5
  FAR = 2.2

  def __init__(self, num_frames: int = 8, image_size: int = 64,
               static: bool = False, gt_samples: int = 192,
               specular: bool = False, white_background: bool = False,
               specular_exponent: float = 25.0,
               field_kind: str = 'emissive', light_mode: str = 'world',
               gt_backend: str = 'numpy', device=None, **kwargs):
    """``gt_backend``: 'numpy' (the reference march) or 'torch' (the same
    march on ``device``, ``cuda`` unless given; raises without a card). The
    JAX package's 'jax' march raises ``NotImplementedError``: 'torch' is
    its counterpart."""
    if gt_backend == 'jax':
      raise NotImplementedError(
          "gt_backend='jax': the port marches the ground truth in numpy or "
          "in torch (gt_backend='torch')")
    if gt_backend not in ('numpy', 'torch'):
      raise ValueError(f'unknown gt_backend {gt_backend!r}')
    self.device = resolve_device(device) if gt_backend == 'torch' else None
    ids = [f'{i:04d}' for i in range(num_frames)]
    train_ids = [i for k, i in enumerate(ids) if k % 4 != 3]
    val_ids = [i for k, i in enumerate(ids) if k % 4 == 3]
    kwargs.setdefault('use_warp_id', True)
    super().__init__(train_ids=train_ids, val_ids=val_ids, **kwargs)
    self.num_frames = num_frames
    self.image_size = image_size
    self.static = static
    self.gt_samples = gt_samples
    self.specular = specular
    self.white_background = white_background
    self.specular_exponent = specular_exponent
    self.field_kind = field_kind
    self.light_mode = light_mode
    self.gt_backend = gt_backend
    self._cache: Dict[str, tuple] = {}

  @property
  def near(self) -> float:
    return self.NEAR

  @property
  def far(self) -> float:
    return self.FAR

  def _time(self, item_id: str) -> float:
    return int(item_id) / max(self.num_frames, 1)

  # Public alias (normal-fidelity metric needs the frame's scene time).
  frame_time = _time

  def _render(self, item_id: str):
    if item_id not in self._cache:
      camera = self.load_camera(item_id)
      rgb, mask = _render_image(camera, self._time(item_id), self.NEAR,
                                self.FAR, num_samples=self.gt_samples,
                                static=self.static, specular=self.specular,
                                white_background=self.white_background,
                                specular_exponent=self.specular_exponent,
                                field_kind=self.field_kind,
                                light_mode=self.light_mode,
                                backend=self.gt_backend, device=self.device)
      self._cache[item_id] = (rgb, mask)
    return self._cache[item_id]

  def load_rgb(self, item_id: str) -> np.ndarray:
    return self._render(item_id)[0]

  def load_mask(self, item_id: str) -> Optional[np.ndarray]:
    return self._render(item_id)[1]

  def load_camera(self, item_id, scale_factor: float = 1.0) -> Camera:
    return make_orbit_camera(int(item_id), self.num_frames, self.image_size)

  def load_points(self, shuffle: bool = False) -> Optional[np.ndarray]:
    """Free-space background points (for the background regulariser)."""
    rng = np.random.RandomState(99)
    points = rng.uniform(-0.9, 0.9, size=(4096, 3)).astype(np.float32)
    sigma, _ = field(points, 0.0, static=True)
    points = points[sigma < 0.05][:2048]
    if shuffle:
      points = points[self.rng.permutation(len(points))]
    return points

  def get_warp_id(self, item_id) -> int:
    return int(item_id)

  def get_item_metadata(self, item_id: str):
    """Val frames are unseen *times*: their metadata is the
    (left, right, progression) interpolation triple between the neighbouring
    train frames (the reference's interp-benchmark convention), so
    evaluation doesn't read an untrained embedding."""
    if item_id in self.train_ids or not self.use_warp_id:
      return super().get_item_metadata(item_id)
    meta = super().get_item_metadata(item_id)
    idx = int(item_id)
    train_idxs = np.asarray([int(i) for i in self.train_ids])
    left = train_idxs[train_idxs < idx].max(initial=train_idxs.min())
    right = train_idxs[train_idxs > idx].min(initial=train_idxs.max())
    progression = 0.0 if right == left else (idx - left) / (right - left)
    triple = np.asarray([float(left), float(right), progression], np.float32)
    meta['warp'] = triple
    return meta

  def get_appearance_id(self, item_id) -> int:
    return int(item_id)

  def get_camera_id(self, item_id) -> int:
    return 0

  def get_time_id(self, item_id) -> int:
    return int(item_id)


# Mild-but-real lens parameters for the two vrig cameras (k1-k3 radial,
# p1-p2 tangential): the magnitudes of a phone wide lens, so the Newton
# undistortion (camera.py) does real work on every exported pixel.
_VRIG_LENSES = {
    'left': {'radial': (-0.12, 0.035, -0.004), 'tangential': (0.0012, -0.0008),
             'focal_mult': 1.18},
    'right': {'radial': (-0.09, 0.028, -0.003), 'tangential': (-0.0009, 0.0014),
              'focal_mult': 1.26},
}


def make_vrig_camera(side: str, idx: int, num_frames: int,
                     image_size: int = 480, radius: float = 1.2,
                     baseline: float = 0.18) -> Camera:
  """One camera of a two-camera validation rig (the NeRF-DS capture
  setup: train on the left camera, evaluate novel views from the right;
  ids ``left_NNNN`` and ``right_NNNN``).

  Both cameras ride a slowly orbiting handheld mount (a smooth sweep and a
  small deterministic wobble), separated by a rigid horizontal baseline,
  each aimed at the subject with its own intrinsics and nonzero
  radial/tangential distortion."""
  if side not in ('left', 'right'):
    raise ValueError(f"side must be 'left' or 'right', got {side!r}")
  u = idx / max(num_frames, 1)
  angle = 0.7 * np.sin(2 * np.pi * u)
  # Handheld wobble: small deterministic multi-frequency jitter.
  wobble = np.array([
      0.02 * np.sin(17.0 * u * 2 * np.pi),
      0.015 * np.cos(11.0 * u * 2 * np.pi),
      0.02 * np.sin(7.0 * u * 2 * np.pi + 1.3),
  ], np.float32)
  mount = np.array([radius * np.sin(angle), 0.35 + 0.1 * np.sin(np.pi * u),
                    -radius * np.cos(angle)], np.float32) + wobble
  # Rig-right direction (horizontal, perpendicular to the view direction).
  to_target = -mount / np.linalg.norm(mount)
  up = np.array([0.0, -1.0, 0.0], np.float32)
  right_dir = np.cross(to_target, up)
  right_dir = right_dir / np.linalg.norm(right_dir)
  offset = {'left': -0.5, 'right': 0.5}[side] * baseline * right_dir
  position = mount + offset
  lens = _VRIG_LENSES[side]
  base = Camera(
      orientation=np.eye(3), position=position,
      focal_length=image_size * lens['focal_mult'],
      principal_point=np.array([image_size / 2 + (2.5 if side == 'left'
                                                  else -3.5),
                                image_size / 2 + 1.5]),
      image_size=np.array([image_size, image_size]),
      radial_distortion=np.array(lens['radial'], np.float32),
      tangential_distortion=np.array(lens['tangential'], np.float32))
  # Both cameras aim at the subject (slightly above the origin).
  return base.look_at(position, np.array([0.0, 0.05, 0.0], np.float32), up)


class VrigSyntheticDataSource(SyntheticDataSource):
  """Two-camera validation-rig capture of the specular scene: train ids
  ``left_NNNN``, val ids ``right_NNNN`` at the same scene times, so a val
  item's metadata is the plain trained warp id (the vrig evaluation
  protocol), not the interpolation triple of the novel-time split. The
  ground truth is marched in torch on ``device`` (``cuda`` unless given)
  by default."""

  def __init__(self, num_frames: int = 100, image_size: int = 480,
               gt_samples: int = 192, specular: bool = True,
               white_background: bool = True,
               specular_exponent: float = 25.0,
               field_kind: str = 'emissive', light_mode: str = 'world',
               gt_backend: str = 'torch', baseline: float = 0.18,
               device=None, **kwargs):
    super().__init__(num_frames=num_frames, image_size=image_size,
                     gt_samples=gt_samples, specular=specular,
                     white_background=white_background,
                     specular_exponent=specular_exponent,
                     field_kind=field_kind, light_mode=light_mode,
                     gt_backend=gt_backend, device=device, **kwargs)
    self.baseline = baseline
    # Every frame exists under both cameras.
    self.train_ids = [f'left_{i:04d}' for i in range(num_frames)]
    self.val_ids = [f'right_{i:04d}' for i in range(num_frames)]

  @staticmethod
  def _parse(item_id: str):
    side, _, num = item_id.partition('_')
    return side, int(num)

  def _time(self, item_id: str) -> float:
    return self._parse(item_id)[1] / max(self.num_frames, 1)

  frame_time = _time

  def load_camera(self, item_id, scale_factor: float = 1.0) -> Camera:
    side, idx = self._parse(item_id)
    camera = make_vrig_camera(side, idx, self.num_frames, self.image_size,
                              baseline=self.baseline)
    if scale_factor != 1.0:
      camera = camera.scale(scale_factor)
    return camera

  def get_warp_id(self, item_id) -> int:
    return self._parse(item_id)[1]

  def get_appearance_id(self, item_id) -> int:
    return self._parse(item_id)[1]

  def get_camera_id(self, item_id) -> int:
    return 0 if self._parse(item_id)[0] == 'left' else 1

  def get_time_id(self, item_id) -> int:
    return self._parse(item_id)[1]

  def get_item_metadata(self, item_id: str):
    # Val (right-camera) frames are seen times: plain trained ids.
    return DataSource.get_item_metadata(self, item_id)


def write_nerfies_dataset(source: SyntheticDataSource, out_dir,
                          image_scale: int = 1,
                          scene_center=None, scene_scale: float = 1.0,
                          camera_path_frames: int = 0,
                          progress: bool = False) -> Path:
  """Writes the synthetic scene in the Nerfies directory layout.

  ``scene_center``/``scene_scale`` write the capture in raw
  (un-normalised) world coordinates with the matching ``scene.json``, so
  the loader's recentring and rescaling (``datasets/nerfies.py``) has real
  work to do and gives back the source's scene coordinates.

  The val cameras are always written as the trajectory
  ``camera-paths/orbit-mild``; ``camera_path_frames > 0`` also writes a
  novel smooth orbit of that many cameras under
  ``camera-paths/orbit-novel``.
  """
  out_dir = Path(out_dir)
  rgb_dir = out_dir / 'rgb' / f'{image_scale}x'
  mask_dir = out_dir / 'resized_mask' / f'{image_scale}x'
  cam_dir = out_dir / 'camera'
  for d in (rgb_dir, mask_dir, cam_dir):
    d.mkdir(parents=True, exist_ok=True)
  center = (np.zeros(3, np.float32) if scene_center is None
            else np.asarray(scene_center, np.float32))

  def raw(camera: Camera) -> Camera:
    # Scene coordinates -> raw world coordinates (the loader's inverse).
    camera = camera.copy()
    camera.position = camera.position / scene_scale + center
    return camera

  all_ids = sorted(source.train_ids + source.val_ids)
  metadata = {}
  for n, item_id in enumerate(all_ids):
    viz.save_png(rgb_dir / f'{item_id}.png',
                 (source.load_rgb(item_id) * 255).astype(np.uint8))
    mask = source.load_mask(item_id)
    # Stored masks use the raw polarity (static part = 1); the loader
    # inverts them again.
    viz.save_png(mask_dir / f'{item_id}.png.png',
                 ((1.0 - mask[..., 0]) * 255).astype(np.uint8))
    raw(source.load_camera(item_id)).save_json(cam_dir / f'{item_id}.json')
    metadata[item_id] = {
        'warp_id': source.get_warp_id(item_id),
        'appearance_id': source.get_appearance_id(item_id),
        'camera_id': source.get_camera_id(item_id),
        'time_id': source.get_time_id(item_id),
    }
    if progress and (n + 1) % 20 == 0:
      print(f'  exported {n + 1}/{len(all_ids)} frames', flush=True)
  (out_dir / 'scene.json').write_text(json.dumps({
      'center': center.tolist(), 'scale': scene_scale,
      'near': source.NEAR, 'far': source.FAR}))
  (out_dir / 'dataset.json').write_text(json.dumps({
      'count': len(all_ids), 'num_exemplars': len(source.train_ids),
      'ids': all_ids, 'train_ids': source.train_ids,
      'val_ids': source.val_ids}))
  (out_dir / 'metadata.json').write_text(json.dumps(metadata))
  np.save(out_dir / 'points.npy', source.load_points() / scene_scale + center)
  path_dir = out_dir / 'camera-paths' / 'orbit-mild'
  path_dir.mkdir(parents=True, exist_ok=True)
  for k, item_id in enumerate(source.val_ids):
    raw(source.load_camera(item_id)).save_json(path_dir / f'{k:06d}.json')
  if camera_path_frames:
    novel_dir = out_dir / 'camera-paths' / 'orbit-novel'
    novel_dir.mkdir(parents=True, exist_ok=True)
    for k in range(camera_path_frames):
      angle = 2 * np.pi * k / camera_path_frames
      position = np.array([1.1 * np.sin(0.5 * np.sin(angle)),
                           0.3 + 0.15 * np.cos(angle),
                           -1.1 * np.cos(0.5 * np.sin(angle))], np.float32)
      cam = Camera(
          orientation=np.eye(3), position=position,
          focal_length=source.image_size * 1.2,
          principal_point=np.array([source.image_size / 2,
                                    source.image_size / 2]),
          image_size=np.array([source.image_size, source.image_size]))
      cam = cam.look_at(position, np.zeros(3), np.array([0.0, -1.0, 0.0]))
      raw(cam).save_json(novel_dir / f'{k:06d}.json')
  return out_dir
