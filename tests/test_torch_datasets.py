"""The port's captured-scene data layer against the JAX package: the PNG
reader against OpenCV, the Nerfies loader on captures written by either
package, the torch ground-truth march, the vrig source and the
interpolation split.

The JAX side marches its scenes in numpy (``gt_backend='numpy'``) except
in the one case that holds the torch march against JAX's jitted one.
"""
import json
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from nerfds_tpu import datasets as jdatasets
from nerfds_tpu import gpath as jgpath
from nerfds_tpu.datasets import synthetic as jsynthetic
from nerfds_torch import datasets as tdatasets
from nerfds_torch import gpath
from nerfds_torch import image_utils, viz
from nerfds_torch.datasets import synthetic as tsynthetic

torch.set_num_threads(1)

# -- the PNG reader ---------------------------------------------------------

# cv2's PNG row-filter flags: each writes every row with that filter;
# ALL_FILTERS lets libpng choose a filter a row.
_CV2_FILTERS = ('IMWRITE_PNG_FILTER_NONE', 'IMWRITE_PNG_FILTER_SUB',
                'IMWRITE_PNG_FILTER_UP', 'IMWRITE_PNG_FILTER_AVG',
                'IMWRITE_PNG_FILTER_PAETH', 'IMWRITE_PNG_ALL_FILTERS')
# (channels, dtype) of each kind the reader takes; cv2 writes no gray +
# alpha, so that kind is written by viz.save_png only.
_KINDS = {'gray8': (1, np.uint8), 'gray_alpha8': (2, np.uint8),
          'rgb8': (3, np.uint8), 'rgba8': (4, np.uint8),
          'gray16': (1, np.uint16)}


def random_image(kind, seed, h=23, w=31):
  """Noise over a smooth ramp, so that libpng's filter choice varies from
  row to row."""
  channels, dtype = _KINDS[kind]
  rng = np.random.RandomState(seed)
  top = np.iinfo(dtype).max
  yy, xx = np.mgrid[:h, :w]
  ramp = (yy[..., None] * 7 + xx[..., None] * 3 * np.arange(1, channels + 1)
          ) * (top // 255)
  noise = rng.randint(0, top // 8, (h, w, channels))
  image = ((ramp + noise) % (top + 1)).astype(dtype)
  image[rng.rand(h) < 0.3] = rng.randint(0, top, (w, channels))
  return image[..., 0] if channels == 1 else image


def cv2_order(image):
  """RGB(A) -> the BGR(A) order cv2 reads and writes."""
  if image.ndim == 3 and image.shape[-1] in (3, 4):
    return image[..., [2, 1, 0, 3][:image.shape[-1]]]
  return image


def cv2_decode(data: bytes, kind: str):
  """cv2.imdecode(IMREAD_UNCHANGED) in the reader's channel order; cv2
  decodes gray + alpha as BGRA with B = G = R."""
  out = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
  if kind == 'gray_alpha8':
    assert np.array_equal(out[..., 0], out[..., 2])
    return out[..., [0, 3]]
  return cv2_order(out)


def row_filters(data: bytes):
  """The filter byte of every row of a PNG's inflated IDAT data."""
  width, height, depth, color_type = struct.unpack('>IIBB', data[16:26])
  pos, idat = 8, b''
  while pos < len(data):
    length, tag = struct.unpack('>I4s', data[pos:pos + 8])
    if tag == b'IDAT':
      idat += data[pos + 8:pos + 8 + length]
    pos += 12 + length
  stride = width * {0: 1, 2: 3, 4: 2, 6: 4}[color_type] * depth // 8 + 1
  return set(zlib.decompress(idat)[::stride][:height])


@pytest.fixture(scope='module')
def png_files(tmp_path_factory):
  """[(kind, writer, image, PNG bytes)] for every kind, written by cv2 with
  each filter flag and by viz.save_png."""
  tmp = tmp_path_factory.mktemp('png')
  files = []
  for k, kind in enumerate(_KINDS):
    image = random_image(kind, seed=k)
    if kind != 'gray_alpha8':
      for flag in _CV2_FILTERS:
        ok, buf = cv2.imencode('.png', cv2_order(image),
                               [cv2.IMWRITE_PNG_FILTER, getattr(cv2, flag)])
        assert ok
        files.append((kind, flag, image, buf.tobytes()))
    path = tmp / f'{kind}.png'
    viz.save_png(path, image)
    files.append((kind, 'viz.save_png', image, path.read_bytes()))
  return files


@pytest.mark.parametrize('kind', list(_KINDS))
def test_png_reader_matches_cv2(png_files, kind):
  for _, writer, image, data in (f for f in png_files if f[0] == kind):
    got = image_utils.decode_png(data)
    want = cv2_decode(data, kind)
    assert got.dtype == want.dtype == image.dtype, writer
    np.testing.assert_array_equal(got, want, err_msg=writer)
    np.testing.assert_array_equal(got, image, err_msg=writer)


def test_png_reader_sees_every_row_filter_and_refuses_others(png_files,
                                                             tmp_path):
  assert set().union(*(row_filters(f[3]) for f in png_files)) == {
      0, 1, 2, 3, 4}
  data = png_files[0][3]

  def with_header(depth, color_type, interlace):
    head = bytearray(data)
    head[24], head[25], head[28] = depth, color_type, interlace
    return bytes(head)

  with pytest.raises(ValueError, match='interlaced'):
    image_utils.decode_png(with_header(8, 0, 1))
  with pytest.raises(ValueError, match='palette'):
    image_utils.decode_png(with_header(8, 3, 0))
  with pytest.raises(ValueError, match='bit depth'):
    image_utils.decode_png(with_header(4, 0, 0))
  with pytest.raises(ValueError, match='not a PNG'):
    image_utils.decode_png(b'GIF89a' + data[6:])
  with pytest.raises(ValueError, match='gs://bucket/x.png'):
    image_utils.load_image('gs://bucket/x.png')
  # Depth maps: 16-bit millimetres, as the JAX package writes them.
  depth = np.random.RandomState(0).uniform(0.1, 3.0, (9, 7)).astype(
      np.float32)
  image_utils.save_depth(tmp_path / 'd.png', depth)
  from nerfds_tpu import image_utils as jimage_utils
  np.testing.assert_array_equal(image_utils.load_depth(tmp_path / 'd.png'),
                                jimage_utils.load_depth(tmp_path / 'd.png'))
  jimage_utils.save_depth(tmp_path / 'j.png', depth)
  np.testing.assert_array_equal(image_utils.load_depth(tmp_path / 'j.png'),
                                image_utils.load_depth(tmp_path / 'd.png'))


def test_image_helpers_match_jax():
  from nerfds_tpu import image_utils as jimage_utils
  rng = np.random.RandomState(1)
  image = rng.rand(33, 47, 3).astype(np.float32)
  for scale in (1, 2, 3):
    # Tolerance: float32 block means summed in another order than cv2's.
    np.testing.assert_allclose(
        image_utils.downsample_image(image, scale),
        jimage_utils.downsample_image(image, scale), atol=1e-6)
    # uint8: the same means, rounded; cv2 may round an exact half the
    # other way.
    as_uint8 = (image * 255).astype(np.uint8)
    diff = (image_utils.downsample_image(as_uint8, scale).astype(int)
            - jimage_utils.downsample_image(as_uint8, scale))
    assert np.abs(diff).max() <= 1
  for fn in ('image_to_uint8', 'image_to_uint16', 'image_to_float32'):
    np.testing.assert_array_equal(getattr(image_utils, fn)(image),
                                  getattr(jimage_utils, fn)(image))
  np.testing.assert_array_equal(image_utils.checkerboard(10, 12, 3),
                                jimage_utils.checkerboard(10, 12, 3))
  alpha = rng.rand(33, 47, 1).astype(np.float32)
  np.testing.assert_array_equal(image_utils.composite_alpha(image, alpha),
                                jimage_utils.composite_alpha(image, alpha))
  tiles = [image, image * 0.5, image]
  np.testing.assert_array_equal(image_utils.tile_images(tiles, pad=2),
                                jimage_utils.tile_images(tiles, pad=2))


# -- the Nerfies loader -----------------------------------------------------

CAPTURE = dict(scene_center=(0.3, -0.2, 1.1), scene_scale=0.7,
               camera_path_frames=5)


def add_half_scale(data_dir):
  """rgb/2x and resized_mask/2x from the 1x frames (the port's area
  downsample), so both loaders read the same bytes at image_scale 2."""
  for sub, suffix in (('rgb', '.png'), ('resized_mask', '.png.png')):
    out = data_dir / sub / '2x'
    out.mkdir(parents=True, exist_ok=True)
    for path in sorted((data_dir / sub / '1x').glob(f'*{suffix}')):
      viz.save_png(out / path.name, image_utils.downsample_image(
          image_utils.load_image(path), 2))


@pytest.fixture(scope='module')
def jax_capture(tmp_path_factory):
  """A 4-frame 32 px vrig capture written by the JAX package."""
  out = tmp_path_factory.mktemp('jax_vrig')
  src = jsynthetic.VrigSyntheticDataSource(num_frames=4, image_size=32,
                                           gt_samples=48, gt_backend='numpy')
  jsynthetic.write_nerfies_dataset(src, out, **CAPTURE)
  add_half_scale(out)
  return out


def assert_stores_equal(got, want):
  """Origins and directions within 1e-5 (the same numpy camera code, but
  float32 Newton steps may round apart); rgb, mask and metadata exactly:
  the same bytes decoded."""
  assert got.num_rays == want.num_rays
  for k in ('origins', 'directions'):
    np.testing.assert_allclose(getattr(got, k), getattr(want, k), atol=1e-5,
                               err_msg=k)
  for k in ('rgb', 'mask'):
    np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                  err_msg=k)
  assert got.metadata.keys() == want.metadata.keys()
  for k, v in want.metadata.items():
    assert got.metadata[k].dtype == v.dtype, k
    np.testing.assert_array_equal(got.metadata[k], v, err_msg=k)


def assert_cameras_equal(got, want, atol=1e-6):
  assert len(got) == len(want) > 0
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.position, w.position, atol=atol)
    np.testing.assert_allclose(g.orientation, w.orientation, atol=atol)
    assert g.image_shape == w.image_shape


@pytest.mark.parametrize('image_scale', [1, 2])
def test_nerfies_loader_matches_jax(jax_capture, image_scale):
  kw = dict(image_scale=image_scale, random_seed=3)
  want = jdatasets.NerfiesDataSource(jax_capture, **kw)
  got = tdatasets.NerfiesDataSource(jax_capture, **kw)
  assert got.train_ids == want.train_ids == [f'left_{i:04d}'
                                             for i in range(4)]
  assert got.val_ids == want.val_ids and got.all_ids == want.all_ids
  assert (got.near, got.far) == (want.near, want.far)
  assert got.has_masks and want.has_masks
  assert got.embeddings_dict == want.embeddings_dict
  for g, w in zip(tdatasets.nerfies.load_scene_info(jax_capture),
                  jdatasets.nerfies.load_scene_info(jax_capture)):
    np.testing.assert_array_equal(g, w)
  assert [got.get_time_id(i) for i in got.all_ids] == [
      want.get_time_id(i) for i in want.all_ids]
  assert_stores_equal(got.build_ray_store(got.all_ids),
                      want.build_ray_store(want.all_ids))
  # Tolerance: the same float32 arithmetic; 1e-5 allows reassociation.
  np.testing.assert_allclose(got.load_points(), want.load_points(),
                             atol=1e-5)
  np.testing.assert_allclose(got.load_points(shuffle=True),
                             want.load_points(shuffle=True), atol=1e-5)
  assert_cameras_equal(got.load_test_cameras(), want.load_test_cameras())
  assert_cameras_equal(got.load_test_cameras(count=2),
                       want.load_test_cameras(count=2))
  for source in (got, want):
    source.test_camera_trajectory = 'orbit-novel'
  assert_cameras_equal(got.load_test_cameras(), want.load_test_cameras())
  path = jax_capture / 'camera-paths' / 'orbit-novel' / '000002.json'
  assert_cameras_equal([got.load_camera(path)], [want.load_camera(path)])
  item = got.camera_rays_for_item('right_0001')
  np.testing.assert_array_equal(item['rgb'], got.load_rgb('right_0001'))
  assert item['rgb'].shape == (32 // image_scale, 32 // image_scale, 3)


def test_jax_loader_reads_the_ports_capture(jax_capture, tmp_path):
  """The port's writer (the torch march on the CPU) writes a capture that
  JAX's loader reads as the port's loader does, and whose rgb matches the
  JAX-written capture within the march's float32 differences."""
  src = tsynthetic.VrigSyntheticDataSource(num_frames=4, image_size=32,
                                           gt_samples=48, device='cpu')
  tsynthetic.write_nerfies_dataset(src, tmp_path, **CAPTURE)
  got = tdatasets.NerfiesDataSource(tmp_path)
  want = jdatasets.NerfiesDataSource(tmp_path)
  assert got.all_ids == want.all_ids
  assert_stores_equal(got.build_ray_store(got.all_ids),
                      want.build_ray_store(want.all_ids))
  assert_cameras_equal(got.load_test_cameras(), want.load_test_cameras())
  np.testing.assert_array_equal(got.load_points(), want.load_points())
  for name in ('scene.json', 'dataset.json', 'metadata.json'):
    assert json.loads((tmp_path / name).read_text()) == json.loads(
        (jax_capture / name).read_text()), name
  # The two captures hold the same frames up to one 8-bit level: the
  # torch march is within 1e-5 of the numpy march the JAX writer ran.
  jax_store = jdatasets.NerfiesDataSource(jax_capture).build_ray_store(
      want.all_ids)
  assert np.abs(got.build_ray_store(got.all_ids).rgb - jax_store.rgb).max(
      ) <= 1 / 255 + 1e-7


def test_ray_store_helpers_match_jax(jax_capture):
  got = tdatasets.NerfiesDataSource(jax_capture).build_ray_store(
      ['left_0000', 'right_0002'])
  want = jdatasets.NerfiesDataSource(jax_capture).build_ray_store(
      ['left_0000', 'right_0002'])
  assert got.nbytes == want.nbytes == 2 * 32 * 32 * (10 * 4 + 4)
  idx = np.array([5, 0, 2047, 1024])
  assert_stores_equal(got.take(idx), want.take(idx))
  on_device = got.to('cpu')
  assert on_device.nbytes == got.nbytes
  taken = on_device.take(torch.from_numpy(idx))
  np.testing.assert_array_equal(taken.rgb.numpy(), want.take(idx).rgb)


# -- the synthetic sources and the torch march ------------------------------


@pytest.mark.parametrize('scene', [
    {'specular': True, 'white_background': True},
    {'field_kind': 'shaded', 'light_mode': 'camera'}],
    ids=['emissive', 'shaded'])
def test_torch_march_matches_numpy_and_jax(scene):
  camera = tsynthetic.make_vrig_camera('left', 2, 8, image_size=32)
  jcamera = jsynthetic.make_vrig_camera('left', 2, 8, image_size=32)
  np.testing.assert_array_equal(camera.position, jcamera.position)
  np.testing.assert_array_equal(camera.orientation, jcamera.orientation)
  args = (0.4, 0.5, 2.2)
  want_rgb, want_mask = tsynthetic._render_image(camera, *args,
                                                 num_samples=48, **scene)
  np.testing.assert_array_equal(
      want_rgb, jsynthetic._render_image(jcamera, *args, num_samples=48,
                                         **scene)[0])
  got_rgb, got_mask = tsynthetic._render_image(
      camera, *args, num_samples=48, backend='torch', device='cpu', **scene)
  jax_rgb, jax_mask = jsynthetic._render_image(
      jcamera, *args, num_samples=48, backend='jax', **scene)
  # Tolerance: float32 in torch against numpy's float32/float64 mix and
  # XLA's float32, summed in other orders.
  np.testing.assert_allclose(got_rgb, want_rgb, atol=1e-5)
  np.testing.assert_allclose(got_rgb, jax_rgb, atol=1e-5)
  # Masks threshold the moving part's weight at 0.3: equal except where
  # that weight (marched here in float64) lies within 1e-5 of it.
  rays = tsynthetic.camera_to_rays(camera)
  _, fg = tsynthetic._march_torch(
      *(torch.from_numpy(rays[k].reshape(-1, 3)).double()
        for k in ('origins', 'directions')), args[0],
      np.linspace(0.5, 2.2, 48, dtype=np.float32), 2.2 - 0.5,
      static=False, specular=scene.get('specular', False),
      white_background=scene.get('white_background', False),
      specular_exponent=25.0, field_kind=scene.get('field_kind', 'emissive'),
      light_mode=scene.get('light_mode', 'world'))
  far_from_threshold = (np.abs(fg.numpy() - 0.3) >= 1e-5).reshape(32, 32)
  assert far_from_threshold.mean() > 0.99
  for mask in (got_mask, jax_mask):
    np.testing.assert_array_equal(mask[far_from_threshold],
                                  want_mask[far_from_threshold])


def test_vrig_and_synthetic_sources_match_jax():
  kw = dict(num_frames=3, image_size=16, gt_samples=16)
  got = tsynthetic.VrigSyntheticDataSource(gt_backend='numpy', **kw)
  want = jsynthetic.VrigSyntheticDataSource(gt_backend='numpy', **kw)
  assert (got.train_ids, got.val_ids) == (want.train_ids, want.val_ids)
  for item_id in ('left_0001', 'right_0002'):
    for k, v in want.load_item(item_id).items():
      if k == 'metadata':
        assert v.keys() == got.load_item(item_id)[k].keys()
        continue
      np.testing.assert_array_equal(got.load_item(item_id)[k], v, err_msg=k)
    assert got.get_camera_id(item_id) == want.get_camera_id(item_id)
    assert got.frame_time(item_id) == want.frame_time(item_id)
  for source in (tsynthetic.SyntheticDataSource(num_frames=4), got):
    jsource = (jsynthetic.SyntheticDataSource(num_frames=4)
               if type(source) is tsynthetic.SyntheticDataSource else want)
    np.testing.assert_array_equal(source.load_points(), jsource.load_points())
    np.testing.assert_array_equal(source.load_points(shuffle=True),
                                  jsource.load_points(shuffle=True))
  # The vrig source marches on the card by default: without one it raises
  # rather than march on the CPU.
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      tsynthetic.VrigSyntheticDataSource(**kw)
  with pytest.raises(NotImplementedError):
    tsynthetic.VrigSyntheticDataSource(gt_backend='jax', **kw)


# -- the interpolation split ------------------------------------------------


def test_interp_source_matches_jax(tmp_path):
  src = jsynthetic.SyntheticDataSource(num_frames=8, image_size=16,
                                       gt_samples=16)
  jsynthetic.write_nerfies_dataset(src, tmp_path)
  for interval in (4, 3):
    got = tdatasets.InterpDataSource(tmp_path, interval=interval)
    want = jdatasets.InterpDataSource(tmp_path, interval=interval)
    assert (got.train_ids, got.val_ids) == (want.train_ids, want.val_ids)
    assert got.embeddings_dict == want.embeddings_dict
    for item_id in got.train_ids + got.val_ids:
      assert got.get_time_id(item_id) == want.get_time_id(item_id)
      g, w = got.get_item_metadata(item_id), want.get_item_metadata(item_id)
      assert g.keys() == w.keys()
      for k in w:
        assert g[k].dtype == w[k].dtype
        np.testing.assert_array_equal(g[k], w[k])
    for v in want.val_ids:
      for k, triple in want.get_val_metadata(v).items():
        np.testing.assert_array_equal(got.get_val_metadata(v)[k], triple)
    assert_stores_equal(got.build_ray_store(got.val_ids),
                        want.build_ray_store(want.val_ids))
    assert_stores_equal(got.build_ray_store(got.train_ids),
                        want.build_ray_store(want.train_ids))
  with pytest.raises(ValueError, match='Not enough frames'):
    tdatasets.InterpDataSource(tmp_path, interval=8)


def test_gpath_matches_jax(tmp_path):
  for s in ('gs://bucket/scene', 'gs:bucket', 's3://b/k', 'file:///tmp/x',
            '/tmp/x', 'relative/dir', 'gsx/data', '', 'a/gs://b'):
    assert gpath.is_remote(s) == jgpath.is_remote(s), s
  # Local paths behave as the JAX package's GPath (epath where etils
  # imports, pathlib otherwise).
  got, want = gpath.GPath(tmp_path, 'a'), jgpath.GPath(tmp_path, 'a')
  assert str(got) == str(want) and str(got / 'b.json') == str(want / 'b.json')
  got.mkdir()
  (got / 'b.json').write_text('{"x": 1}')
  assert (want / 'b.json').exists()
  assert json.loads((want / 'b.json').read_text()) == {'x': 1}
  assert sorted(p.name for p in got.glob('*.json')) == sorted(
      p.name for p in want.glob('*.json'))
  with pytest.raises(ValueError, match='gs://bucket/scene'):
    gpath.GPath('gs://bucket/scene')
  with pytest.raises(ValueError, match='gs://bucket'):
    gpath.GPath('gs://bucket', 'scene.json')
