"""One rank of the port's two-process gloo checks, for
``tests/test_torch_parallel.py``.

  python tests/torch_parallel_worker.py <rank> <world> <dir>

Joins a gloo group through a ``FileStore`` in ``<dir>``, runs the data
mesh's paths on the CPU at toy widths, and saves what it found to
``<dir>/rank<rank>.pt`` for the test to compare with one process and with
the JAX package. Imports no JAX: the test process computes the references.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

if __name__ == '__main__':
  sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nerfds_torch import config as tconfig  # noqa: E402
from nerfds_torch.datasets import synthetic as tsynthetic  # noqa: E402
from nerfds_torch.evaluation.render import render_image  # noqa: E402
from nerfds_torch.models import NerfDSModel  # noqa: E402
from nerfds_torch.parallel import distributed  # noqa: E402
from nerfds_torch.parallel import mesh as mesh_lib  # noqa: E402
from nerfds_torch.trainer import Trainer, eval_extra_params  # noqa: E402
from nerfds_torch.training import step as tstep  # noqa: E402

# The toy nerf_ds of tests/test_torch_training.py: unstratified, no σ
# noise, so the steps draw no random number and match across packages.
TOY = dict(num_coarse_samples=6, num_fine_samples=4, nerf_trunk_depth=3,
           nerf_trunk_width=32, nerf_skips=(2,), se3_trunk_depth=3,
           se3_trunk_width=16, se3_skips=(2,), hyper_sheet_depth=3,
           hyper_sheet_width=16, hyper_sheet_skips=(2,), mask_mlp_depth=3,
           mask_mlp_width=16, mask_skips=(2,), use_stratified_sampling=False,
           noise_std=None, sigma_gradient_mode='fused')
# The render's model draws stratified samples and σ noise, so that the
# ranks' shares of each draw are held against one process's.
STRATIFIED = dict(use_stratified_sampling=True, noise_std=0.5)
NUM_EMBEDS = 4
GLOBAL_BATCH = 8
STEPS = 3
SOURCE = dict(num_frames=4, image_size=16, gt_samples=32)
RENDER_CHUNK = 49  # padded to 50 over two ranks; 256 rays leave a tail


def model_cfg(config_lib=tconfig, **overrides):
  return dataclasses.replace(config_lib.nerf_ds(), **{**TOY, **overrides})


def train_cfg(config_lib=tconfig, **overrides):
  """tests/test_torch_training.py's toy schedules."""
  return dataclasses.replace(
      config_lib.nerf_ds_train_config(max_steps=200,
                                      batch_size=GLOBAL_BATCH),
      warp_alpha_schedule=('linear', 1.5, 4, 50),
      norm_input_alpha_schedule=('constant', 2.5),
      sharp_mask_std_schedule=('constant', 0.5),
      lr_schedule=('exponential', 5e-3, 1e-4, 200), **overrides)


def toy_model(**overrides) -> NerfDSModel:
  return NerfDSModel(model_cfg(**overrides), num_warp_embeds=NUM_EMBEDS,
                     num_hyper_embeds=NUM_EMBEDS, device='cpu')


def toy_batch(seed: int, n: int = GLOBAL_BATCH):
  rng = np.random.RandomState(seed)
  directions = rng.randn(n, 3).astype(np.float32)
  directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
  return {
      'origins': rng.randn(n, 3).astype(np.float32) * 0.1,
      'directions': directions,
      'rgb': rng.rand(n, 3).astype(np.float32),
      'mask': rng.rand(n, 1).astype(np.float32),
      'metadata': {'warp': rng.randint(0, NUM_EMBEDS, (n, 1)).astype(
          np.int32)},
  }


def to_torch(tree):
  return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
          for k, v in tree.items()}


def explicit_steps(model, cfg, params, mesh=None):
  """The step-0 gradients and stats, and the params and stats after
  ``STEPS`` explicit steps on ``toy_batch(0..)``: under ``mesh`` each rank
  takes its rows of every global batch."""
  batches = [to_torch(toy_batch(s)) for s in range(STEPS)]
  if mesh is not None:
    batches = [mesh_lib.shard_batch(b, mesh) for b in batches]
  scalars = tstep.eval_schedules(tstep.build_schedules(cfg), 0)
  grads, stats = tstep._accum_grads(tstep.make_loss_fn(model, cfg, mesh),
                                    params, batches[0], None, scalars, 1)
  if mesh is not None and mesh.world_size > 1:
    grads, stats = tstep._mesh_reduce(grads, stats, mesh)
  step_fn = tstep.make_train_step(model, cfg, mesh)
  state = tstep.TrainState.create(params)
  for batch in batches:
    state, last_stats = step_fn(state, batch)
  return dict(grads=grads, stats=stats, params=state.params,
              last_stats=last_stats)


def render_rays(source):
  item = source.load_item(source.val_ids[0])
  return {k: item[k] for k in ('origins', 'directions', 'mask', 'metadata')}


def run(rank: int, world: int, out_dir: Path) -> None:
  torch.set_num_threads(1)
  distributed.initialize(init_method=f'file://{out_dir / "rendezvous"}',
                         world_size=world, rank=rank, backend='gloo')
  mesh = mesh_lib.create_mesh('cpu')
  params = torch.load(out_dir / 'params.pt')
  out = {'rank': rank, 'world': mesh.world_size}

  # The explicit step on every rank's rows of one global batch.
  out['explicit'] = explicit_steps(toy_model(), train_cfg(), params, mesh)

  # The process-local store and its placement.
  source = tsynthetic.SyntheticDataSource(**SOURCE)
  store = source.build_ray_store(source.train_ids, process_local=True)
  out['store'] = store.as_dict()
  out['store_slice'] = distributed.local_shard_slice(len(source.train_ids))
  out['placed_rays'] = store.to_mesh(mesh).num_rays

  # The render, each rank drawing its share of every chunk's draws.
  strat = toy_model(**STRATIFIED)
  strat.load_state_dict(params)
  extra = eval_extra_params(strat.config, train_cfg(), 0)
  out['render'] = render_image(
      strat, render_rays(source), extra, chunk=RENDER_CHUNK, mesh=mesh,
      generator=torch.Generator().manual_seed(0))

  # Trainer: rank 0's parameters on every rank, fused steps from the
  # rank's shard, a checkpoint written by rank 0 and resumed on both.
  cfg = train_cfg(save_every=2, print_every=1)
  trainer = Trainer.from_experiment(model_cfg(), cfg, source, device='cpu')
  out['init_params'] = trainer.init_state(seed=rank).params
  losses = []
  log = lambda step, data: losses.append(data['stats']['fine']['loss/total'])
  unbroken = trainer.train(num_steps=STEPS, log_fn=log)
  exp_dir = out_dir / 'exp'
  Trainer.from_experiment(model_cfg(), cfg, source, exp_dir=exp_dir,
                          device='cpu').train(num_steps=2)
  resumed = Trainer.from_experiment(model_cfg(), cfg, source,
                                    exp_dir=exp_dir,
                                    device='cpu').train(num_steps=STEPS)
  out.update(losses=losses, unbroken=unbroken.params, resumed=resumed.params,
             resumed_step=resumed.step)
  out['eval_mesh'] = trainer.eval_psnr(unbroken)
  alone = Trainer.from_experiment(model_cfg(), cfg, source, use_mesh=False,
                                  device='cpu')
  out['eval_alone'] = alone.eval_psnr(unbroken)

  # The host sampler under the mesh.
  host = Trainer.from_experiment(model_cfg(), cfg, source, sampling='host',
                                 device='cpu')
  out['host'] = host.train(num_steps=2).params

  # A 'batch' norm across ranks is refused.
  out['batch_norm_refused'] = []
  for fn in (lambda: tstep.make_train_step(toy_model(norm_type='batch'),
                                           cfg, mesh),
             lambda: render_image(toy_model(norm_type='batch'),
                                  render_rays(source), extra, mesh=mesh)):
    try:
      fn()
      out['batch_norm_refused'].append(False)
    except ValueError:
      out['batch_norm_refused'].append(True)

  # The collectives on rank-dependent values.
  values = {'a': torch.tensor([float(rank), -3.0 * rank]),
            'b': torch.full((2, 2), 2.0 + rank)}
  out['mean'] = mesh_lib.all_reduce_mean(values, mesh)
  out['max'] = mesh_lib.all_reduce_max(values, mesh)
  out['broadcast'] = mesh_lib.broadcast(values, mesh)
  out['gathered'] = mesh_lib.all_gather_rows(
      torch.full((rank + 1, 2), -0.5 - rank), mesh, counts=[1, 2])

  # The histogram rows: every stride-th row of the global rows.
  rows = torch.arange(2 * 1000 * 3, dtype=torch.float32).reshape(-1, 3)
  out['strided'] = tstep._strided_rows(
      mesh_lib.shard_batch(rows, mesh), mesh, limit=64)

  torch.save(out, out_dir / f'rank{rank}.pt')
  if torch.distributed.is_initialized():
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
  run(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
