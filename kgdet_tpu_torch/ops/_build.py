"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (all started
together) into ``build/<hash>/lib<name>.so`` for ``sm_90a``, at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/<hash>/lib<name>.so csrc/<name>.cu

The libraries have a plain C interface and are loaded with ``ctypes``; no
source includes PyTorch's headers, so a build takes seconds. ``<hash>``
covers every file under ``csrc/`` and the flags, so an edited source builds
anew. Every C entry point returns a ``cudaError_t`` code, which ``check``
turns into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / 'csrc'
BUILD = PKG / 'build'
SOURCES = ('deform_fused', 'deform_split', 'deform_bwd', 'deform_sample',
           'stem_layer1', 'resblock', 'greedy_nms', 'bn_epilogue')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
MAX_COLUMNS = 8


class ColumnTable(ctypes.Structure):
    """csrc/deform_gather.cuh::ColumnTable, passed by value: where the
    column gather writes. The K taps of a pixel are cut into ``n`` columns
    of ``taps[i]`` taps starting at tap ``first[i]``; column i of map m is a
    contiguous (B, P, taps[i], C) tensor at element offset ``off[m][i]`` of
    the output buffer."""
    _fields_ = [('n', _I), ('first', _I * MAX_COLUMNS),
                ('taps', _I * MAX_COLUMNS),
                ('off', (ctypes.c_longlong * MAX_COLUMNS) * 2)]


# argtypes of every C entry point: pointers and the stream as c_void_p
SIGNATURES = {
    'deform_fused': {
        'kgdet_deform_fused': [_P] * 4 + [_I] * 9 + [_P],
    },
    'deform_split': {
        'kgdet_deform_split': [_P] * 4 + [ColumnTable] + [_I] * 8 + [_P],
    },
    'deform_bwd': {
        'kgdet_deform_bwd': [_P] * 5 + [_I] * 8 + [_P],
    },
    'deform_sample': {
        'kgdet_deform_sample': [_P] * 3 + [_I] * 8 + [_P],
    },
    'stem_layer1': {
        'kgdet_stem_pool': [_P] * 4 + [_I] * 4 + [_P],
        'kgdet_frozen_bottleneck': [_P] * 10 + [_I] * 7 + [_P],
    },
    'resblock': {
        'kgdet_fused_bottleneck': [_P] * 10 + [_I] * 7 + [_P],
        'kgdet_fused_bottleneck_smem': [_I, _I],
    },
    'greedy_nms': {
        'kgdet_greedy_nms': [_P] * 5 + [_I] * 4 + [_L] * 3 + [_I, _F, _F, _P],
        'kgdet_greedy_nms_scratch': [_I],
    },
    'bn_epilogue': {
        'kgdet_bn_epilogue': [_P] * 4 + [_L] + [_I] * 4 + [_P],
    },
}

_LIBS: dict = {}


def find_nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME') and
                 os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'),
                 shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'of kgdet_tpu_torch are built from csrc/ with nvcc')


def source_hash() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):    # sources and the headers they share
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD / source_hash() / f'lib{name}.so'


def build_all() -> dict:
    """Compile every source whose library is missing, one nvcc process per
    source, all in parallel. Returns {name: nvcc output} for what was built
    (ptxas register/shared-memory reports included); raises on failure."""
    todo = [n for n in SOURCES if not lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    procs = {}
    for name in todo:
        out = lib_path(name)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed for ' + ', '.join(failed) + ':\n' +
                           '\n'.join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def dtype_code(t) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f'kernel takes float32 or bfloat16, got {t.dtype}')
    return DTYPE_CODES[t.dtype]


def vec_ok(channels: int, *tensors) -> int:
    """1 when the kernels' 16-byte channel packs apply: the channel count is
    a multiple of the pack of every tensor's dtype and every tensor starts
    on a 16-byte boundary; else 0 (the one-channel path)."""
    return int(all(channels % (16 // t.element_size()) == 0
                   and t.data_ptr() % 16 == 0 for t in tensors))


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str):
    if rc:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')


def require_cuda(*tensors):
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != 'cuda' or t.device != dev:
            raise ValueError(f'expected CUDA tensors on {dev}, got {t.device}')
        if not t.is_contiguous():
            raise ValueError('kernel operands must be contiguous')
