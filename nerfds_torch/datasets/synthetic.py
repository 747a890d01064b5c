"""Procedural dynamic test scene (L2), counterpart of
``nerfds_tpu/datasets/synthetic.py``.

A deforming emissive sphere orbiting inside a static shell, with ground
truth rendered by ray-marching the analytic density and colour field in
numpy, with the compositing math the model uses: the JAX package's
``gt_backend='numpy'`` path, number for number. It provides
:class:`SyntheticDataSource`, an in-memory ``DataSource``, and the fields
and orbit camera behind it. The jitted ground-truth march
(``gt_backend='jax'``), the two-camera vrig source and the Nerfies export
are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from nerfds_torch.camera import Camera, camera_to_rays
from nerfds_torch.datasets.core import DataSource

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


def _render_image(camera: Camera, t: float, near: float, far: float,
                  num_samples: int = 192, static: bool = False,
                  specular: bool = False, white_background: bool = False,
                  specular_exponent: float = 25.0,
                  field_kind: str = 'emissive', light_mode: str = 'world'):
  """Ground-truth ray march of the analytic field. Returns (rgb, mask).

  ``white_background`` composites unfilled transmittance onto white (pair
  it with the model's ``use_white_background``).
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
    moving = (np.linalg.norm(pts - center, axis=-1) < 0.3).astype(np.float32)
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
               gt_backend: str = 'numpy', **kwargs):
    if gt_backend != 'numpy':
      raise NotImplementedError(
          f"gt_backend={gt_backend!r}: the port marches the ground truth in "
          "numpy only; see ROADMAP.md, queue 1")
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
                                light_mode=self.light_mode)
      self._cache[item_id] = (rgb, mask)
    return self._cache[item_id]

  def load_rgb(self, item_id: str) -> np.ndarray:
    return self._render(item_id)[0]

  def load_mask(self, item_id: str) -> Optional[np.ndarray]:
    return self._render(item_id)[1]

  def load_camera(self, item_id, scale_factor: float = 1.0) -> Camera:
    return make_orbit_camera(int(item_id), self.num_frames, self.image_size)

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
