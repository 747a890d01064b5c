"""Builds the CUDA sources under ``csrc/`` into one shared library and binds
it with ``ctypes``.

Each ``.cu`` file is compiled by its own ``nvcc`` process, all started
together, then linked into ``build/libnerfds_kernels_<hash>.so``; the hash
covers the sources, the ``.cuh`` headers beside them and the flags, so an
edited source never loads a stale library. The sources expose a plain C
interface (pointers, ints, the stream), so no PyTorch header is compiled.
Nothing here runs at import time: the first wrapper call on a CUDA tensor
builds and loads.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parent / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_PTRS = ctypes.POINTER(ctypes.c_uint64)
# The trunk kernels' float32 and bf16 entries take the same arguments in
# the forward, and in the backward after their inputs; the bf16 entries
# also take a buffer of weight norms before the stream.
_TRUNK_FWD = [_P, _PTRS, _I, _I, _I, ctypes.c_uint, _I, _I, _I, _P, _P, _P,
              _P, _P, _P]
_TRUNK_BWD = [_I, _I, _I, ctypes.c_uint, _I, _I, _I, _I, ctypes.c_long, _P,
              _P, _P, _P]
# name -> argtypes; every function returns cudaGetLastError() as an int.
SIGNATURES = {
    'composite_fwd': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, ctypes.c_float, _P],
    'fused_trunk_fwd': _TRUNK_FWD,
    'fused_trunk_fwd_bf16': [*_TRUNK_FWD[:-1], _P, _P],
    'fused_trunk_bwd': [_P, _P, _P, _P, _P, _PTRS, _PTRS, _P, *_TRUNK_BWD],
    'fused_trunk_bwd_bf16': [_P, _P, _P, _P, _P, _P, _P, _PTRS, _PTRS,
                             *_TRUNK_BWD[:-1], _P, _P],
    'fused_mlp_fwd': [_P, _I, _I, _I, ctypes.POINTER(ctypes.c_uint64),
                      ctypes.POINTER(ctypes.c_int), _I, _I, _P, _P],
}


def nvcc_path() -> str:
  cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
  candidates = [os.path.join(cuda_home, 'bin', 'nvcc')] if cuda_home else []
  candidates += [shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
  for c in candidates:
    if c and os.path.exists(c):
      return c
  raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def _digest(sources) -> str:
  """Hash of the flags, the sources and the headers they include."""
  h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for s in [*sources, *sorted(CSRC.glob('*.cuh'))]:
    h.update(s.name.encode())
    h.update(s.read_bytes())
  return h.hexdigest()[:16]


def _compile(sources, out: pathlib.Path, defines=()) -> None:
  """Compiles every source in parallel (with ``-D`` of each of
  ``defines``) and links ``out``; keeps the compiler's report (``-Xptxas
  -v``: registers, shared memory, spills) beside it as ``.log``."""
  nvcc = nvcc_path()
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
    objs, procs = [], []
    for src in sources:
      obj = pathlib.Path(tmp) / (src.stem + '.o')
      objs.append(obj)
      procs.append((src, subprocess.Popen(
          [nvcc, *NVCC_FLAGS, *(f'-D{d}' for d in defines), '-c', str(src),
           '-o', str(obj)],
          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report = []
    failed = []
    for src, proc in procs:
      text, _ = proc.communicate()
      report.append(f'== {src.name}\n{text}')
      if proc.returncode != 0:
        failed.append(src.name)
    if failed:
      raise RuntimeError(f'nvcc failed on {failed}:\n' + '\n'.join(report))
    tmp_out = pathlib.Path(tmp) / out.name
    link = subprocess.run(
        [nvcc, '-shared', '-o', str(tmp_out), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
      raise RuntimeError(f'nvcc link failed:\n{link.stdout}')
    out.with_suffix('.log').write_text('\n'.join(report))
    os.replace(tmp_out, out)


def library_path() -> pathlib.Path:
  """Where the library of the current sources is built."""
  sources = sorted(CSRC.glob('*.cu'))
  return BUILD_DIR / f'libnerfds_kernels_{_digest(sources)}.so'


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
  """Builds (once per source hash) and loads the kernel library."""
  out = library_path()
  if not out.exists():
    _compile(sorted(CSRC.glob('*.cu')), out)
  lib = ctypes.CDLL(str(out))
  for name, argtypes in SIGNATURES.items():
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
  return lib


def build_report() -> str:
  """The compiler's report of the loaded library's build, if kept."""
  log = library_path().with_suffix('.log')
  return log.read_text() if log.exists() else ''


def check(rc: int, name: str) -> None:
  """Raises if a launcher returned a nonzero ``cudaGetLastError()``."""
  if rc != 0:
    raise RuntimeError(f'{name}: CUDA launch failed with cudaError {rc}')
