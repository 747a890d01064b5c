"""The port's host-side sampler (``datasets.core.HostRayIterator``) and
``Trainer(sampling='host')`` against the JAX package's.

* The iterator's first batches are bit-equal to JAX's on the same numpy
  store and seed; ``close()`` joins the worker, even with the queue full;
  a failure in the worker is raised by ``next()``.
* Two ``sampling='host'`` steps at the toy widths of
  ``tests/test_torch_training.py`` from the same parameters, against JAX's
  ``Trainer(sampling='host', use_mesh=False)``: both draw
  ``RandomState(random_seed)``'s indices from the same store, and neither
  model draws a random number.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from nerfds_tpu import config as jconfig
from nerfds_tpu.datasets import core as jcore
from nerfds_tpu.datasets import synthetic as jsynthetic
from nerfds_tpu.trainer import Trainer as JaxTrainer
from nerfds_torch.convert import params_from_jax
from nerfds_torch.datasets import core as tcore
from nerfds_torch.datasets import synthetic as tsynthetic
from nerfds_torch.trainer import Trainer
from nerfds_torch.training.step import TrainState
from tests import torch_parallel_worker as worker

torch.set_num_threads(1)


def numpy_store(n=1000, seed=0):
  rng = np.random.RandomState(seed)
  return dict(
      origins=rng.randn(n, 3).astype(np.float32),
      directions=rng.randn(n, 3).astype(np.float32),
      rgb=rng.rand(n, 3).astype(np.float32),
      mask=rng.rand(n, 1).astype(np.float32),
      metadata={'warp': rng.randint(0, 4, (n, 1)).astype(np.int32)})


def leaves(tree, path=()):
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from leaves(v, path + (k,))
    else:
      yield path + (k,), v


def test_batches_match_jax():
  store = numpy_store()
  got_it = tcore.HostRayIterator(tcore.RayStore.from_dict(store), 64,
                                 seed=7)
  want_it = jcore.HostRayIterator(jcore.RayStore.from_dict(store), 64,
                                  seed=7)
  try:
    for _ in range(5):
      got, want = next(got_it), next(want_it)
      want = dict(leaves(jax.device_get(want)))
      got = dict(leaves(got))
      assert got.keys() == want.keys()
      for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=str(k))
  finally:
    got_it.close()
    want_it.close()


def test_close_joins_the_worker_with_a_full_queue():
  before = set(threading.enumerate())
  it = tcore.HostRayIterator(tcore.RayStore.from_dict(numpy_store()), 16,
                             prefetch=1)
  deadline = time.monotonic() + 30
  while not it._queue.full():
    assert time.monotonic() < deadline, 'the sampler filled no queue'
    time.sleep(0.01)
  it.close()
  assert not it._thread.is_alive()
  assert set(threading.enumerate()) <= before


def test_worker_failure_is_raised_by_next():
  store = tcore.RayStore.from_dict({**numpy_store(), 'rgb': None})
  it = tcore.HostRayIterator(store, 16)
  try:
    with pytest.raises(TypeError):
      next(it)
  finally:
    it.close()
  assert not it._thread.is_alive()


def test_host_sampling_training_matches_jax():
  cfg = dict(sigma_gradient_mode='vmap')
  jtrainer = JaxTrainer.from_experiment(
      worker.model_cfg(jconfig, **cfg), worker.train_cfg(jconfig),
      jsynthetic.SyntheticDataSource(**worker.SOURCE), use_mesh=False,
      sampling='host')
  jstate = jtrainer.init_state(0)
  params = params_from_jax(jax.device_get(jstate.params))
  want = jax.device_get(jtrainer.train(num_steps=2, state=jstate))
  trainer = Trainer.from_experiment(
      worker.model_cfg(), worker.train_cfg(),
      tsynthetic.SyntheticDataSource(**worker.SOURCE), sampling='host',
      device='cpu')
  before = set(threading.enumerate())
  state = trainer.train(num_steps=2, state=TrainState.create(params))
  assert state.step == 2
  assert set(threading.enumerate()) <= before  # the sampler was joined
  # The Adam moments carry the gradients: within 1e-3 of each norm, as
  # one step's gradients in tests/test_torch_training.py.
  want_mu = params_from_jax(want.opt_state.mu)
  for name, w in want_mu.items():
    got = state.opt_state.mu[name]
    assert float((got - w).norm() / w.norm().clamp_min(1e-12)) < 1e-3, name
  # The params: tests/test_torch_paired_ab.py's 2e-4 (Adam's first steps
  # are about lr·sign(g), so the grads' rounding shows as about 1e-5),
  # where the first moment is above Adam's eps (1e-8). Below it the update
  # is a ratio of two rounding residues (measured: one element with
  # gradients near 1e-9 moved 3.9e-4 apart at lr 5e-3).
  for name, w in params_from_jax(want.params).items():
    determined = want_mu[name].abs() >= 1e-8
    torch.testing.assert_close(state.params[name][determined],
                               w[determined], rtol=0, atol=2e-4, msg=name)
