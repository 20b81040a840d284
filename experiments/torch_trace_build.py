"""Traced copies of the port's CUDA kernels, for the phase-trace scripts.

A phase trace (experiments/torch_*_phase_trace.py) names a kernel source in
parseq_tpu_torch/csrc/ and the anchor edits that put clock64() marks into a
copy of it. `build` writes each copy to build/kernels/ (the source in the
checkout is not changed), compiles the copies with nvcc all at once, and
loads each with the argument types of the real library's entries.
"""

import ctypes
import subprocess

from parseq_tpu_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, find_nvcc


def traced_source(name, edits):
    """csrc/<name> with `edits` applied in order. Each edit is (anchor, where,
    text): where None replaces the anchor with text, 'before' / 'after' puts
    text beside it, 'line' puts text before the line that holds it. Raises
    if an anchor is not found exactly once."""
    src = (CSRC / name).read_text()
    for anchor, where, text in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f'anchor not found once in csrc/{name}: {anchor!r}')
        if where == 'line':
            at = src.rindex('\n', 0, src.index(anchor)) + 1
            src = src[:at] + text + src[at:]
        else:
            new = {None: text, 'after': anchor + text, 'before': text + anchor}[where]
            src = src.replace(anchor, new)
    return src


def build(name, copies, ref, entries, pointer_entries):
    """Compiles one traced copy of csrc/<name> for each {kind: edits} of
    `copies`, all nvcc processes at once, and returns {kind: library}. The
    `entries` take the argument and result types of the same entries of
    `ref` (the real library); each of `pointer_entries` (the copy's own, such
    as the trace buffer's reader) takes one pointer and returns an int."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = name.rsplit('.', 1)[0]
    procs = {}
    for kind, edits in copies.items():
        cu, so = BUILD_DIR / f'{stem}_{kind}.cu', BUILD_DIR / f'lib{stem}_{kind}.so'
        cu.write_text(traced_source(name, edits))
        procs[kind] = so, subprocess.Popen([find_nvcc(), *NVCC_FLAGS, str(cu), '-o', str(so)],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)
    libs = {}
    for kind, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed on the {kind} copy of csrc/{name}:\n{out}')
        lib = libs[kind] = ctypes.CDLL(str(so))
        for entry in entries:
            getattr(lib, entry).argtypes = getattr(ref, entry).argtypes
            getattr(lib, entry).restype = getattr(ref, entry).restype
        for entry in pointer_entries:
            getattr(lib, entry).argtypes = [ctypes.c_void_p]
            getattr(lib, entry).restype = ctypes.c_int
    return libs
