"""Runs one cell of the benchmark once and prints its result's line.

  python -m h100_bench.run --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

From the root of a checkout on a machine with the NVIDIA cards the cell
asks for. The run sets up (its time is ``setup_s``, from the start of this
module; the kernel library's build, which a checkout's first run makes,
is also printed apart), measures for ``--seconds`` seconds (``--trace
1``: a profiled window of the mix's size, for the per-layer metrics),
checks what the timed path produced against the plain reference, and
prints each compared number beside its limit as the last lines of
standard error, and the result as one JSON object, the last line of
standard output. It exits non-zero, printing no result, without the
cards the cell asks for, and where ``jax``, ``jaxlib``, ``flax`` or
``nerfds_tpu`` has been imported.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from h100_bench import harness  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'nerfds_tpu')
# Build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds (the port's kernel library builds under
# nerfds_torch/kernels/build/, inside the checkout too).
CACHE = harness.ROOT / '.bench_cache'
CACHE_DIRS = {'TRITON_CACHE_DIR': 'triton',
              'TORCH_EXTENSIONS_DIR': 'torch_extensions',
              'TORCHINDUCTOR_CACHE_DIR': 'inductor'}


def forbidden_modules():
  return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
  try:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]
  except (OSError, IndexError, subprocess.SubprocessError) as e:
    return f'nvidia-smi unavailable: {e}'


def build_kernels() -> float:
  """Loads the program's kernel library, building it where the checkout
  has no build of the current sources; returns the build's seconds (0
  where none was needed), which ``setup_s`` includes, and prints them on
  a line of their own so that set-up can be read without them."""
  from nerfds_torch.kernels import build
  if build.library_path().exists():
    build.load_library()
    print('kernel build: 0 s (the checkout already has the library)',
          file=sys.stderr)
    return 0.0
  start = time.perf_counter()
  build.load_library()
  seconds = time.perf_counter() - start
  print(f'kernel build: {seconds!r} s', file=sys.stderr)
  return seconds


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(prog='python -m h100_bench.run')
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)

  bench = harness.load_json(harness.ROOT / 'BENCHMARK.json')
  cell = harness.find_cell(bench, args.workload)
  for var, sub in CACHE_DIRS.items():
    os.environ[var] = str(CACHE / sub)
  import torch
  if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
    print(f'{args.workload} needs {cell.chips} CUDA device(s); '
          f'torch.cuda.is_available()={torch.cuda.is_available()}, '
          f'device_count={torch.cuda.device_count()}: no result',
          file=sys.stderr)
    return 3
  device = torch.device('cuda', 0)
  build_s = build_kernels()
  kind = harness.traffic_module(cell.traffic['kind'])
  outcome = kind.run(cell, args.seed, args.seconds, bool(args.trace), device,
                     T0)
  found = forbidden_modules()
  if found:
    print(f'the run imported {found}: no result', file=sys.stderr)
    return 4
  device_line = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                 'count': cell.chips,
                 'memory_peak_bytes': outcome.memory_peak_bytes,
                 'power_limit': power_limit(), 'kernel_build_s': build_s}
  if args.trace:
    device_line.update(busy_s=outcome.view.trace.busy_s,
                       window_s=outcome.view.trace.window_s)
  line = harness.result_line(cell, outcome, bool(args.trace), device_line)
  from nerfds_torch import kernels
  print(f'kernel launches: {dict(kernels.launch_counts)}', file=sys.stderr)
  for text in harness.check_lines(outcome):
    print(text, file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(line), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
