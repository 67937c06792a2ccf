"""Native (C++) host runtime components + ctypes bindings.

The reference's host runtime is C++ end-to-end; here the compute path is
JAX/XLA/Pallas and the native layer covers the host-side hot spots — the
.bi4 serialization (`jbinary_native.cpp`, the JBinaryData analog).  The
library is built from source with g++ at first use (no pip deps; the built
file is not tracked); Python falls back to the pure implementation when no
compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(__file__)
_SO = os.path.join(_DIR, "libjbnative.so")
_SRC = os.path.join(_DIR, "jbinary_native.cpp")

_lib = None
_tried = False


def load():
    """Returns the ctypes library or None (pure-Python fallback)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            # build beside the target and rename: concurrent processes
            # never load a half-written library
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", _SRC,
                            "-o", tmp], check=True, capture_output=True)
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        lib.jb_writer_new.restype = ctypes.c_void_p
        lib.jb_writer_new.argtypes = [ctypes.c_char_p]
        lib.jb_item_child.restype = ctypes.c_int
        lib.jb_item_child.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_char_p]
        lib.jb_set_text.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_char_p]
        lib.jb_set_num.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_double, ctypes.c_double,
                                   ctypes.c_double]
        lib.jb_set_int.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_longlong]
        lib.jb_add_array.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_uint, ctypes.c_void_p]
        lib.jb_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.jb_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def write_item_native(path, root, filecode=None):
    """Serialize an io.jbinary.JItem tree through the native codec.
    Returns False if the native library is unavailable."""
    import numpy as np
    from ..io import jbinary as jb

    lib = load()
    if lib is None:
        return False
    filecode = (filecode or root.name).encode()
    h = lib.jb_writer_new(filecode)
    try:
        def emit(item, hid):
            for name, (t, v) in item.values.items():
                nm = name.encode()
                if t == jb.TEXT:
                    lib.jb_set_text(h, hid, nm, str(v).encode())
                elif t in (jb.FLOAT, jb.DOUBLE):
                    lib.jb_set_num(h, hid, nm, t, float(v), 0, 0)
                elif t in (jb.FLOAT3, jb.DOUBLE3):
                    lib.jb_set_num(h, hid, nm, t, *[float(x) for x in v])
                elif t in (jb.INT3, jb.UINT3):
                    lib.jb_set_int(h, hid, nm, t, *[int(x) for x in v])
                else:
                    lib.jb_set_int(h, hid, nm, t, int(v), 0, 0)
            for ar in item.arrays:
                data = np.ascontiguousarray(
                    ar.data.astype(jb._NP_DTYPE[ar.type], copy=False))
                lib.jb_add_array(h, hid, ar.name.encode(), ar.type,
                                 ar.count,
                                 data.ctypes.data_as(ctypes.c_void_p))
            for sub in item.items:
                sid = lib.jb_item_child(h, hid, sub.name.encode())
                emit(sub, sid)

        emit(root, 0)
        return lib.jb_write(h, str(path).encode()) == 0
    finally:
        lib.jb_free(h)
