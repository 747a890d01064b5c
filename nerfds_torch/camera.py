"""Camera model (L1), counterpart of ``nerfds_tpu/camera.py``: full
intrinsics with radial/tangential distortion, in numpy.

The same JSON schema, Newton undistortion (10 iterations), +0.5 pixel
centres and world-space ray construction as the JAX package. Ray
generation runs once, on the host, when a dataset is built. The JAX
package's differentiable ``project_jnp`` is not ported.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np


def _compute_residual_and_jacobian(x, y, xd, yd, k1=0.0, k2=0.0, k3=0.0,
                                   p1=0.0, p2=0.0):
  """Residual + Jacobian of the distortion map, for Newton's method."""
  r = x * x + y * y
  d = 1.0 + r * (k1 + r * (k2 + k3 * r))
  fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
  fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
  d_r = k1 + r * (2.0 * k2 + 3.0 * k3 * r)
  d_x = 2.0 * x * d_r
  d_y = 2.0 * y * d_r
  fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
  fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
  fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
  fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
  return fx, fy, fx_x, fx_y, fy_x, fy_y


def radial_and_tangential_undistort(xd, yd, k1=0.0, k2=0.0, k3=0.0,
                                    p1=0.0, p2=0.0, eps=1e-9,
                                    max_iterations=10):
  """Newton inversion of the radial/tangential distortion."""
  x = xd.copy()
  y = yd.copy()
  for _ in range(max_iterations):
    fx, fy, fx_x, fx_y, fy_x, fy_y = _compute_residual_and_jacobian(
        x=x, y=y, xd=xd, yd=yd, k1=k1, k2=k2, k3=k3, p1=p1, p2=p2)
    denominator = fy_x * fx_y - fx_x * fy_y
    x_num = fx * fy_y - fy * fx_y
    y_num = fy * fx_x - fx * fy_x
    step_x = np.where(np.abs(denominator) > eps, x_num / denominator,
                      np.zeros_like(denominator))
    step_y = np.where(np.abs(denominator) > eps, y_num / denominator,
                      np.zeros_like(denominator))
    x = x + step_x
    y = y + step_y
  return x, y


class Camera:
  """Pinhole camera with distortion, world-from-camera ray generation."""

  def __init__(self,
               orientation: np.ndarray,
               position: np.ndarray,
               focal_length: Union[np.ndarray, float],
               principal_point: np.ndarray,
               image_size: np.ndarray,
               skew: Union[np.ndarray, float] = 0.0,
               pixel_aspect_ratio: Union[np.ndarray, float] = 1.0,
               radial_distortion: Optional[np.ndarray] = None,
               tangential_distortion: Optional[np.ndarray] = None,
               dtype=np.float32):
    if radial_distortion is None:
      radial_distortion = np.array([0.0, 0.0, 0.0], dtype)
    if tangential_distortion is None:
      tangential_distortion = np.array([0.0, 0.0], dtype)
    self.orientation = np.array(orientation, dtype)
    self.position = np.array(position, dtype)
    self.focal_length = np.array(focal_length, dtype)
    self.principal_point = np.array(principal_point, dtype)
    self.skew = np.array(skew, dtype)
    self.pixel_aspect_ratio = np.array(pixel_aspect_ratio, dtype)
    self.radial_distortion = np.array(radial_distortion, dtype)
    self.tangential_distortion = np.array(tangential_distortion, dtype)
    self.image_size = np.array(image_size, np.uint32)
    self.dtype = dtype
    self.mask = None  # optional per-camera foreground mask (NeRF-DS)

  # -- serialisation --------------------------------------------------------

  @classmethod
  def from_json(cls, path) -> "Camera":
    """Loads the Nerfies camera JSON schema."""
    with open(path, "r") as fp:
      camera_json = json.load(fp)
    if "tangential" in camera_json:
      camera_json["tangential_distortion"] = camera_json["tangential"]
    return cls(
        orientation=np.asarray(camera_json["orientation"]),
        position=np.asarray(camera_json["position"]),
        focal_length=camera_json["focal_length"],
        principal_point=np.asarray(camera_json["principal_point"]),
        skew=camera_json["skew"],
        pixel_aspect_ratio=camera_json["pixel_aspect_ratio"],
        radial_distortion=np.asarray(camera_json["radial_distortion"]),
        tangential_distortion=np.asarray(camera_json["tangential_distortion"]),
        image_size=np.asarray(camera_json["image_size"]),
    )

  def to_json(self):
    return {k: (v.tolist() if hasattr(v, "tolist") else v)
            for k, v in self.get_parameters().items()}

  def save_json(self, path):
    Path(path).write_text(json.dumps(self.to_json()))

  def get_parameters(self):
    return {
        "orientation": self.orientation,
        "position": self.position,
        "focal_length": self.focal_length,
        "principal_point": self.principal_point,
        "skew": self.skew,
        "pixel_aspect_ratio": self.pixel_aspect_ratio,
        "radial_distortion": self.radial_distortion,
        "tangential_distortion": self.tangential_distortion,
        "image_size": self.image_size,
    }

  # -- geometry -------------------------------------------------------------

  @property
  def scale_factor_x(self):
    return self.focal_length

  @property
  def scale_factor_y(self):
    return self.focal_length * self.pixel_aspect_ratio

  @property
  def principal_point_x(self):
    return self.principal_point[0]

  @property
  def principal_point_y(self):
    return self.principal_point[1]

  @property
  def has_tangential_distortion(self):
    return any(self.tangential_distortion != 0.0)

  @property
  def has_radial_distortion(self):
    return any(self.radial_distortion != 0.0)

  @property
  def image_size_y(self):
    return int(self.image_size[1])

  @property
  def image_size_x(self):
    return int(self.image_size[0])

  @property
  def image_shape(self) -> Tuple[int, int]:
    return self.image_size_y, self.image_size_x

  @property
  def optical_axis(self):
    return self.orientation[2, :]

  @property
  def translation(self):
    return -np.matmul(self.orientation, self.position)

  def pixel_to_local_rays(self, pixels: np.ndarray):
    """Camera-frame ray directions for pixel coordinates."""
    y = (pixels[..., 1] - self.principal_point_y) / self.scale_factor_y
    x = ((pixels[..., 0] - self.principal_point_x - y * self.skew)
         / self.scale_factor_x)
    if self.has_radial_distortion or self.has_tangential_distortion:
      x, y = radial_and_tangential_undistort(
          x, y,
          k1=self.radial_distortion[0],
          k2=self.radial_distortion[1],
          k3=self.radial_distortion[2],
          p1=self.tangential_distortion[0],
          p2=self.tangential_distortion[1])
    dirs = np.stack([x, y, np.ones_like(x)], axis=-1)
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

  def pixels_to_rays(self, pixels: np.ndarray) -> np.ndarray:
    """World-frame unit ray directions for pixels."""
    if pixels.shape[-1] != 2:
      raise ValueError("The last dimension of pixels must be 2.")
    batch_shape = pixels.shape[:-1]
    pixels = np.reshape(pixels, (-1, 2)).astype(self.dtype)
    local_rays_dir = self.pixel_to_local_rays(pixels)
    rays_dir = np.matmul(self.orientation.T,
                         local_rays_dir[..., np.newaxis])[..., 0]
    rays_dir = rays_dir / np.linalg.norm(rays_dir, axis=-1, keepdims=True)
    return rays_dir.reshape((*batch_shape, 3))

  def pixels_to_points(self, pixels: np.ndarray, depth: np.ndarray):
    rays = self.pixels_to_rays(pixels)
    cosa = np.matmul(rays, self.optical_axis)
    return rays * depth[..., None] / cosa[..., None] + self.position

  def points_to_local_points(self, points: np.ndarray):
    batch_shape = points.shape[:-1]
    points = points.reshape((-1, 3))
    translated = points - self.position
    local = np.matmul(self.orientation, translated.T).T
    return local.reshape([*batch_shape, 3])

  def project(self, points: np.ndarray):
    """3D world point -> pixel position."""
    batch_shape = points.shape[:-1]
    points = points.reshape((-1, 3))
    local_points = self.points_to_local_points(points)
    x = local_points[..., 0] / local_points[..., 2]
    y = local_points[..., 1] / local_points[..., 2]
    r2 = x ** 2 + y ** 2
    distortion = 1.0 + r2 * (
        self.radial_distortion[0] + r2 *
        (self.radial_distortion[1] + self.radial_distortion[2] * r2))
    x_times_y = x * y
    xd = (x * distortion + 2.0 * self.tangential_distortion[0] * x_times_y
          + self.tangential_distortion[1] * (r2 + 2.0 * x ** 2))
    yd = (y * distortion + 2.0 * self.tangential_distortion[1] * x_times_y
          + self.tangential_distortion[0] * (r2 + 2.0 * y ** 2))
    pixel_x = self.focal_length * xd + self.skew * yd + self.principal_point_x
    pixel_y = (self.focal_length * self.pixel_aspect_ratio * yd
               + self.principal_point_y)
    pixels = np.stack([pixel_x, pixel_y], axis=-1)
    return pixels.reshape((*batch_shape, 2))

  def get_pixel_centers(self):
    """Pixel-center grid at +0.5 offsets."""
    xx, yy = np.meshgrid(np.arange(self.image_size_x, dtype=self.dtype),
                         np.arange(self.image_size_y, dtype=self.dtype))
    return np.stack([xx, yy], axis=-1) + 0.5

  # -- editing --------------------------------------------------------------

  def scale(self, scale: float) -> "Camera":
    if scale <= 0:
      raise ValueError("scale needs to be positive.")
    return Camera(
        orientation=self.orientation.copy(),
        position=self.position.copy(),
        focal_length=self.focal_length * scale,
        principal_point=self.principal_point.copy() * scale,
        skew=self.skew,
        pixel_aspect_ratio=self.pixel_aspect_ratio,
        radial_distortion=self.radial_distortion.copy(),
        tangential_distortion=self.tangential_distortion.copy(),
        image_size=np.array((int(round(self.image_size[0] * scale)),
                             int(round(self.image_size[1] * scale)))),
    )

  def look_at(self, position, look_at, up, eps=1e-6) -> "Camera":
    """New camera at `position` looking at `look_at`."""
    camera = self.copy()
    optical_axis = look_at - position
    norm = np.linalg.norm(optical_axis)
    if norm < eps:
      raise ValueError("The camera center and look at position are too close.")
    optical_axis = optical_axis / norm
    right = np.cross(optical_axis, up)
    norm = np.linalg.norm(right)
    if norm < eps:
      raise ValueError("The up-vector is parallel to the optical axis.")
    right = right / norm
    rot = np.identity(3)
    rot[0, :] = right
    rot[1, :] = np.cross(optical_axis, right)
    rot[2, :] = optical_axis
    camera.position = np.asarray(position, self.dtype)
    camera.orientation = rot.astype(self.dtype)
    return camera

  def crop_image_domain(self, left=0, right=0, top=0, bottom=0) -> "Camera":
    crop_lt = np.array([left, top])
    crop_rb = np.array([right, bottom])
    new_resolution = self.image_size - crop_lt - crop_rb
    new_pp = self.principal_point - crop_lt
    if np.any(new_resolution <= 0):
      raise ValueError("Crop would result in non-positive image dimensions.")
    camera = self.copy()
    camera.image_size = np.array(
        [int(new_resolution[0]), int(new_resolution[1])], np.uint32)
    camera.principal_point = np.array(
        [new_pp[0], new_pp[1]], self.dtype)
    return camera

  def copy(self) -> "Camera":
    return copy.deepcopy(self)

  def set_mask(self, mask):
    self.mask = mask

  def get_mask(self):
    return self.mask


def camera_to_rays(camera: Camera):
  """Full-image ray bundle.

  Returns a dict of float32 [H, W, ·] arrays: origins, directions, pixels.
  """
  camera = camera.copy()
  image_shape = camera.image_shape
  origins = np.tile(camera.position[None, None, :], image_shape + (1,))
  pixels = camera.get_pixel_centers()
  directions = camera.pixels_to_rays(pixels)
  return {
      "origins": origins.astype(np.float32),
      "directions": directions.astype(np.float32),
      "pixels": pixels.astype(np.float32),
  }
